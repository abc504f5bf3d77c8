"""BSC — block sparse column (reference: src/matrix/lis_matrix_bsc.c).

Mirror of BSR: matvec is the scatter direction, matvech the fast sorted
segment-sum (BSC of A is BSR of Aᵀ with transposed blocks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host


@matrix_format("bsc")
class BSCMatrix(SparseMatrix):
    bptr: jax.Array           # (nc+1,) int32 over block columns
    bindex: jax.Array         # (bnnz,) int32 block-row indices
    value: jax.Array          # (bnnz, bnr, bnc)
    bcol_ids: jax.Array       # (bnnz,) int32
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    bnr: int = static()
    bnc: int = static()
    nr: int = static()
    nc: int = static()

    def _rebuild_kwargs(self):
        return {"bnr": self.bnr, "bnc": self.bnc}

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, bnr: int = 2,
                        bnc: int | None = None) -> "BSCMatrix":
        import scipy.sparse as sp
        bnc = bnc or bnr
        ptr, index, value = host(ptr), host(index), host(value)
        n, m = shape
        nr, nc = -(-n // bnr), -(-m // bnc)
        a = sp.csr_matrix((value, index, ptr), shape=shape)
        a.resize((nr * bnr, nc * bnc))
        # BSC(A) = blocks of BSR(Aᵀ), transposed back
        bt = sp.bsr_matrix(a.T.tocsr(), blocksize=(bnc, bnr))
        bt.sort_indices()
        bcol_ids = np.repeat(np.arange(nc, dtype=np.int32), np.diff(bt.indptr))
        blocks = np.transpose(bt.data, (0, 2, 1))  # (bnnz, bnr, bnc)
        return cls(bptr=jnp.asarray(bt.indptr.astype(np.int32)),
                   bindex=jnp.asarray(bt.indices.astype(np.int32)),
                   value=jnp.asarray(blocks),
                   bcol_ids=jnp.asarray(bcol_ids),
                   nrows=int(n), ncols=int(m), nnz=int(len(value)),
                   bnr=bnr, bnc=bnc, nr=nr, nc=nc)

    def to_csr_arrays(self):
        import scipy.sparse as sp
        bt = sp.bsr_matrix((np.transpose(host(self.value), (0, 2, 1)),
                            host(self.bindex), host(self.bptr)),
                           shape=(self.nc * self.bnc, self.nr * self.bnr))
        a = bt.T.tocsr()
        a.resize(self.shape)
        a = a.tocsr()
        a.eliminate_zeros()
        a.sort_indices()
        return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data

    def matvec(self, x):
        padded_c = self.nc * self.bnc
        xp = x if x.shape[0] == padded_c else jnp.pad(x, (0, padded_c - x.shape[0]))
        xb = xp.reshape(self.nc, self.bnc)
        xg = jnp.take(xb, self.bcol_ids, axis=0)            # (bnnz, bnc)
        yb = jnp.einsum("kij,kj->ki", self.value, xg,
                        precision="highest")
        y = jnp.zeros((self.nr, self.bnr), dtype=yb.dtype)
        y = y.at[self.bindex].add(yb)
        return y.reshape(-1)[: self.nrows]

    def matvech(self, x):
        v = jnp.conj(self.value) if jnp.iscomplexobj(self.value) else self.value
        padded_r = self.nr * self.bnr
        xp = x if x.shape[0] == padded_r else jnp.pad(x, (0, padded_r - x.shape[0]))
        xb = xp.reshape(self.nr, self.bnr)
        xg = jnp.take(xb, self.bindex, axis=0)              # (bnnz, bnr)
        yb = jnp.einsum("kij,ki->kj", v, xg, precision="highest")
        y = jax.ops.segment_sum(yb, self.bcol_ids, num_segments=self.nc,
                                indices_are_sorted=True)
        return y.reshape(-1)[: self.ncols]
