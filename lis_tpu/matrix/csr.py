"""CSR — the hub storage format.

Reference: src/matrix/lis_matrix_csr.c (set :78, malloc :170) and the CSR
SpMV kernel src/matvec/lis_matvec_csr.c:53.  Here the row loop becomes a
gather of ``x`` at the column indices followed by a sorted segment-sum over
precomputed row ids — XLA lowers both to vectorised ops; the row-id array is
materialised once at construction (host side) so the device op has static
shapes and no ragged control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host, canonical_csr


@matrix_format("csr")
class CSRMatrix(SparseMatrix):
    ptr: jax.Array            # (n+1,) int32
    index: jax.Array          # (nnz,) int32 column indices
    value: jax.Array          # (nnz,)
    row_ids: jax.Array        # (nnz,) int32, row of each entry (sorted)
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape) -> "CSRMatrix":
        ptr, index, value = host(ptr), host(index), host(value)
        row_ids = np.repeat(np.arange(shape[0], dtype=np.int32), np.diff(ptr))
        out = cls(ptr=jnp.asarray(ptr, jnp.int32),
                  index=jnp.asarray(index, jnp.int32),
                  value=jnp.asarray(value),
                  row_ids=jnp.asarray(row_ids),
                  nrows=int(shape[0]), ncols=int(shape[1]),
                  nnz=int(len(value)))
        # host-side cache so to_csr_arrays() is free when built from host
        # data (no device->host pull of a large operator at SA-AMG or ILU
        # setup).  Not a pytree field: instances rebuilt by jit unflatten
        # simply miss the cache and fall back to device_get.
        object.__setattr__(out, "_host_csr",
                           (ptr, np.asarray(index), np.asarray(value)))
        return out

    @classmethod
    def from_dense(cls, dense) -> "CSRMatrix":
        import scipy.sparse as sp
        a = sp.csr_matrix(np.asarray(dense))
        a.sort_indices()
        return cls.from_csr_arrays(a.indptr, a.indices, a.data, dense.shape)

    def to_csr_arrays(self):
        cached = getattr(self, "_host_csr", None)
        if cached is not None:
            return cached
        out = (host(self.ptr), host(self.index), host(self.value))
        try:
            object.__setattr__(self, "_host_csr", out)
        except Exception:
            pass
        return out

    def matvec(self, x):
        prod = self.value * jnp.take(x, self.index, axis=0)
        return jax.ops.segment_sum(prod, self.row_ids,
                                   num_segments=self.nrows,
                                   indices_are_sorted=True)

    def matvech(self, x):
        v = jnp.conj(self.value) if jnp.iscomplexobj(self.value) else self.value
        prod = v * jnp.take(x, self.row_ids, axis=0)
        y = jnp.zeros(self.ncols, dtype=prod.dtype)
        return y.at[self.index].add(prod)

    def transpose(self) -> "CSRMatrix":
        import scipy.sparse as sp
        ptr, index, value = self.to_csr_arrays()
        at = sp.csr_matrix((value, index, ptr), shape=self.shape).T.tocsr()
        at.sort_indices()
        return CSRMatrix.from_csr_arrays(at.indptr, at.indices,
                                         np.conj(at.data) if np.iscomplexobj(at.data) else at.data,
                                         (self.ncols, self.nrows))

    def get_diagonal(self):
        # vectorised device version: pick entries where col == row
        isdiag = self.index == self.row_ids
        contrib = jnp.where(isdiag, self.value, 0)
        return jax.ops.segment_sum(contrib, self.row_ids,
                                   num_segments=self.nrows,
                                   indices_are_sorted=True)
