"""Hybrid DIA + remainder storage ("HDI") — an extension.

Not a reference format: the reference's closest precedent is MSR (diagonal
split off, src/matrix/lis_matrix_msr.c) and the classic GPU "HYB"
(ELL+COO) layout.  Diagonal streams run about 11x CSR's gather on an H100
(CHANGES.md), so a matrix that is MOSTLY banded with a few stragglers
should pay the gather price only for the stragglers.  auto_storage routes here when the strict
DIA fill guard fails but the dominant diagonals cover most of the nnz.
"""

from __future__ import annotations

import jax
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static


@matrix_format("hdi")
class HybridMatrix(SparseMatrix):
    dia: object                    # DIAMatrix: the dominant diagonals
    rem: object                    # CSRMatrix: remainder entries
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    def matvec(self, x):
        return self.dia.matvec(x) + self.rem.matvec(x)

    def matvech(self, x):
        return self.dia.matvech(x) + self.rem.matvech(x)

    def get_diagonal(self):
        return self.dia.get_diagonal() + self.rem.get_diagonal()

    def to_csr_arrays(self):
        import scipy.sparse as sp
        dp, di, dv = self.dia.to_csr_arrays()
        rp, ri, rv = self.rem.to_csr_arrays()
        a = (sp.csr_matrix((np.asarray(dv), np.asarray(di), np.asarray(dp)),
                           shape=self.shape)
             + sp.csr_matrix((np.asarray(rv), np.asarray(ri), np.asarray(rp)),
                             shape=self.shape)).tocsr()
        a.sort_indices()
        return a.indptr, a.indices, a.data

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, **kw):
        """convert_matrix hook: always succeeds — when no worthwhile
        diagonal split exists, everything lands in the CSR remainder."""
        h = cls.try_split(ptr, index, value, shape, **kw)
        if h is not None:
            return h
        import jax.numpy as jnp
        from lis_tpu.matrix.csr import CSRMatrix
        from lis_tpu.matrix.dia import DIAMatrix
        n, m = shape
        rem = CSRMatrix.from_csr_arrays(ptr, index, value, shape)
        dia = DIAMatrix(value=(jnp.zeros(n),), nrows=n, ncols=m, nnz=0,
                        offsets=(0,))
        return cls(dia=dia, rem=rem, nrows=n, ncols=m, nnz=len(value))

    @classmethod
    def try_split(cls, ptr, index, value, shape,
                  min_density: float = 0.5,
                  max_remainder: float = 0.25):
        """Split into dominant diagonals (per-offset density >=
        min_density) + CSR remainder; returns None if the remainder would
        exceed max_remainder of the nnz (not worth it)."""
        import scipy.sparse as sp
        from lis_tpu.matrix.csr import CSRMatrix
        from lis_tpu.matrix.dia import DIAMatrix
        ptr = np.asarray(ptr)
        index = np.asarray(index)
        value = np.asarray(value)
        n, m = shape
        nnz = len(value)
        if nnz == 0 or n != m:
            return None
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        offs_all = index.astype(np.int64) - rows
        uoffs, counts = np.unique(offs_all, return_counts=True)
        dense = uoffs[counts >= min_density * n]
        if len(dense) == 0 or len(dense) > 512:
            return None
        on_dia = np.isin(offs_all, dense)
        n_rem = nnz - int(on_dia.sum())
        if n_rem > max_remainder * nnz:
            return None

        dval = np.zeros((len(dense), n), dtype=value.dtype)
        pos = np.searchsorted(dense, offs_all[on_dia])
        np.add.at(dval, (pos, rows[on_dia]), value[on_dia])
        import jax.numpy as jnp
        dia = DIAMatrix(value=tuple(jnp.asarray(dval[k])
                                    for k in range(dval.shape[0])),
                        nrows=n, ncols=m, nnz=int(np.count_nonzero(dval)),
                        offsets=tuple(int(o) for o in dense))
        remmask = ~on_dia
        remc = sp.coo_matrix(
            (value[remmask], (rows[remmask], index[remmask])),
            shape=shape).tocsr()
        remc.sort_indices()
        rem = CSRMatrix.from_csr_arrays(remc.indptr, remc.indices, remc.data,
                                        shape)
        return cls(dia=dia, rem=rem, nrows=n, ncols=m, nnz=nnz)
