"""ELL (ELLPACK) format — the fixed-width general sparse layout.

Reference: src/matrix/lis_matrix_ell.c and kernel src/matvec/lis_matvec_ell.c:50.
Rows padded to ``maxnzr`` entries give a dense (n, maxnzr) value/index pair:
SpMV is one gather + one row reduction with fully static shapes.  Padding uses column 0 with value 0 so no masking is
needed at run time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host


@matrix_format("ell")
class ELLMatrix(SparseMatrix):
    index: jax.Array          # (n, maxnzr) int32, padded with 0
    value: jax.Array          # (n, maxnzr), padded with 0
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    maxnzr: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape) -> "ELLMatrix":
        ptr, index, value = host(ptr), host(index), host(value)
        n = shape[0]
        lens = np.diff(ptr)
        maxnzr = int(lens.max()) if n else 0
        eidx = np.zeros((n, maxnzr), dtype=np.int32)
        eval_ = np.zeros((n, maxnzr), dtype=value.dtype)
        # vectorised fill: position within row
        rows = np.repeat(np.arange(n), lens)
        pos = np.arange(len(index)) - np.repeat(ptr[:-1], lens)
        eidx[rows, pos] = index
        eval_[rows, pos] = value
        return cls(index=jnp.asarray(eidx), value=jnp.asarray(eval_),
                   nrows=int(n), ncols=int(shape[1]),
                   nnz=int(len(value)), maxnzr=maxnzr)

    def to_csr_arrays(self):
        idx, val = host(self.index), host(self.value)
        mask = val != 0
        # keep structural zeros that are real entries? conversion by value
        # mask matches lis ell2csr which drops padding (value==0 padding).
        lens = mask.sum(axis=1)
        ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        index = idx[mask].astype(np.int32)
        value = val[mask]
        return _sort_rows(ptr, index.copy(), value.copy())

    def matvec(self, x):
        return jnp.sum(self.value * jnp.take(x, self.index, axis=0), axis=1)

    def matvech(self, x):
        v = jnp.conj(self.value) if jnp.iscomplexobj(self.value) else self.value
        prod = (v * x[:, None]).reshape(-1)
        y = jnp.zeros(self.ncols, dtype=prod.dtype)
        return y.at[self.index.reshape(-1)].add(prod)


def _sort_rows(ptr, index, value):
    """Sort column indices within each CSR row (host, vectorised: one
    global lexsort by (row, col) replaces the per-row argsort loop)."""
    n = len(ptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    o = np.lexsort((index, rows))
    return ptr, index[o], value[o]
