"""Sparse-matrix base class and pytree plumbing.

The reference's LIS_MATRIX (include/lis.h:621-690) is one struct holding the
union of all 11 storage formats plus parallel-layout fields; conversion
rewrites the arrays in place.  This design instead gives every
format its own immutable pytree class: the arrays are jnp leaves (so a
matrix can be closed over / passed through jit and sharded with
jax.sharding), and the structural metadata (sizes, block shapes, diagonal
offsets) is static aux data so XLA sees fixed shapes.

Each format implements the L3 interface the solvers consume — exactly
``matvec``/``matvech`` (reference: lis_matvec dispatcher,
src/matvec/lis_matvec.c:55,191) plus ``to_csr``/``from_csr`` for the
CSR-hub conversion scheme (lis_matrix_convert, src/matrix/lis_matrix_ops.c:128).
Solvers never touch storage internals.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

_MATRIX_REGISTRY: dict[str, type] = {}


def matrix_format(name: str):
    """Class decorator: register a format + make it a jax pytree.

    Dataclass fields whose metadata has ``static=True`` become aux data;
    everything else is a child leaf (a jnp array).
    """
    def deco(cls):
        cls = dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        static_names = tuple(f.name for f in fields if f.metadata.get("static"))
        array_names = tuple(f.name for f in fields if not f.metadata.get("static"))

        def flatten(m):
            return (tuple(getattr(m, a) for a in array_names),
                    tuple(getattr(m, s) for s in static_names))

        def unflatten(aux, children):
            kw = dict(zip(array_names, children))
            kw.update(zip(static_names, aux))
            return cls(**kw)

        jax.tree_util.register_pytree_node(cls, flatten, unflatten)
        cls.format_name = name
        _MATRIX_REGISTRY[name] = cls
        return cls
    return deco


def get_format(name: str) -> type:
    return _MATRIX_REGISTRY[name]


def static(**extra):
    return dataclasses.field(metadata={"static": True, **extra})


class SparseMatrix:
    """Interface shared by every storage format."""

    format_name: str = "abstract"

    # -- shape/metadata ------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def n(self) -> int:
        return self.nrows

    # -- L3 interface --------------------------------------------------------
    def matvec(self, x):
        raise NotImplementedError

    def matvech(self, x):
        """y = Aᴴ x (conjugate transpose; plain transpose for real)."""
        raise NotImplementedError

    # -- conversion hub ------------------------------------------------------
    def to_csr_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side (ptr, index, value) in canonical CSR (sorted columns)."""
        raise NotImplementedError

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, **kw):
        raise NotImplementedError

    # -- common derived ops ----------------------------------------------
    def to_dense(self) -> np.ndarray:
        ptr, index, value = self.to_csr_arrays()
        ptr = np.asarray(ptr)
        index = np.asarray(index)
        value = np.asarray(value)
        n, m = self.shape
        dense = np.zeros((n, m), dtype=value.dtype)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        np.add.at(dense, (rows, index.astype(np.int64)), value)
        return dense

    def get_diagonal(self):
        """Diagonal as a jnp vector (lis_matrix_get_diagonal,
        src/matrix/lis_matrix_ops.c:728)."""
        ptr, index, value = self.to_csr_arrays()
        ptr = np.asarray(ptr)
        index = np.asarray(index)
        value = np.asarray(value)
        n = self.nrows
        d = np.zeros(n, dtype=value.dtype)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        isd = index.astype(np.int64) == rows
        np.add.at(d, rows[isd], value[isd])
        return jnp.asarray(d)

    def _rebuild_kwargs(self) -> dict:
        """Structure parameters a same-format rebuild must preserve
        (block sizes, partitions).  Default: none.  Overridden by the
        block formats so scale/shift/axpy round-trips don't silently
        replace a user-chosen block structure with the default one."""
        return {}

    def scale_rows(self, d):
        """Return a same-format matrix with rows scaled by vector d."""
        from lis_tpu.matrix.convert import convert_matrix
        from lis_tpu.matrix.csr import CSRMatrix
        ptr, index, value = self.to_csr_arrays()
        dn = np.asarray(d)
        value = value * dn[np.repeat(np.arange(self.nrows), np.diff(ptr))]
        out = CSRMatrix.from_csr_arrays(ptr, index, value, self.shape)
        if self.format_name not in _MATRIX_REGISTRY:
            return out          # composite formats (e.g. mbes): CSR result
        return convert_matrix(out, self.format_name,
                              **self._rebuild_kwargs())

    def scale_symm(self, dsqrt_inv):
        """D^-1/2 A D^-1/2 (symmetric diagonal scaling, -scale 2)."""
        from lis_tpu.matrix.convert import convert_matrix
        from lis_tpu.matrix.csr import CSRMatrix
        ptr, index, value = self.to_csr_arrays()
        dn = np.asarray(dsqrt_inv)
        rows = np.repeat(np.arange(self.nrows), np.diff(ptr))
        value = value * dn[rows] * dn[index]
        out = CSRMatrix.from_csr_arrays(ptr, index, value, self.shape)
        if self.format_name not in _MATRIX_REGISTRY:
            return out          # composite formats (e.g. mbes): CSR result
        return convert_matrix(out, self.format_name,
                              **self._rebuild_kwargs())

    def shift_diagonal(self, sigma):
        """A - sigma I (lis_matrix_shift_diagonal,
        src/matrix/lis_matrix_ops.c:781; note Lis subtracts)."""
        from lis_tpu.matrix.convert import convert_matrix
        from lis_tpu.matrix.csr import CSRMatrix
        import scipy.sparse as sp
        ptr, index, value = self.to_csr_arrays()
        a = sp.csr_matrix((value, index, ptr), shape=self.shape)
        a = (a - sigma * sp.eye(self.nrows, self.ncols, format="csr")).tocsr()
        a.sort_indices()
        out = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, self.shape)
        if self.format_name not in _MATRIX_REGISTRY:
            return out          # composite formats (e.g. mbes): CSR result
        return convert_matrix(out, self.format_name,
                              **self._rebuild_kwargs())

    def axpy(self, alpha, other):
        """B := B + alpha*A on matching nonzero structure
        (lis_matrix_axpy, src/matrix/lis_matrix_ops.c:489)."""
        from lis_tpu.matrix.convert import convert_matrix
        from lis_tpu.matrix.csr import CSRMatrix
        import scipy.sparse as sp
        p1, i1, v1 = self.to_csr_arrays()
        p2, i2, v2 = other.to_csr_arrays()
        a = sp.csr_matrix((v1, i1, p1), shape=self.shape)
        b = sp.csr_matrix((v2, i2, p2), shape=other.shape)
        c = (b + alpha * a).tocsr()
        c.sort_indices()
        out = CSRMatrix.from_csr_arrays(c.indptr, c.indices, c.data, self.shape)
        if self.format_name not in _MATRIX_REGISTRY:
            return out          # composite formats (e.g. mbes): CSR result
        return convert_matrix(out, self.format_name,
                              **self._rebuild_kwargs())


def host(x) -> np.ndarray:
    """Bring a (possibly device) array to host numpy."""
    return np.asarray(x)


def canonical_csr(ptr, index, value, shape):
    """Sort column indices within rows, sum duplicates; host-side."""
    import scipy.sparse as sp
    a = sp.csr_matrix((host(value), host(index), host(ptr)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data
