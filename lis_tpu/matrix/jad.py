"""JAD — jagged diagonal format.

Reference: src/matrix/lis_matrix_jad.c, kernel src/matvec/lis_matvec_jad.c:50.
JAD permutes rows by descending nonzero count then stores "jagged columns";
the reference targets vector machines (NEC pragmas).  This layout keeps the
row permutation but pads each
jagged column to n (index 0 / value 0), i.e. ELL over permuted rows stored
column-major: each jagged diagonal is one contiguous gather + fma, and the
leading (long) diagonals dominate where rows are dense.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host
from lis_tpu.matrix.ell import _sort_rows


@matrix_format("jad")
class JADMatrix(SparseMatrix):
    perm: jax.Array            # (n,) int32: sorted position -> original row
    inv_perm: jax.Array        # (n,) int32: original row -> sorted position
    index: jax.Array           # (maxnzr, n) int32, padded with 0
    value: jax.Array           # (maxnzr, n), padded with 0
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    maxnzr: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape) -> "JADMatrix":
        ptr, index, value = host(ptr), host(index), host(value)
        n = shape[0]
        lens = np.diff(ptr)
        perm = np.argsort(-lens, kind="stable").astype(np.int32)
        inv_perm = np.empty(n, dtype=np.int32)
        inv_perm[perm] = np.arange(n, dtype=np.int32)
        maxnzr = int(lens.max()) if n else 0
        jidx = np.zeros((maxnzr, n), dtype=np.int32)
        jval = np.zeros((maxnzr, n), dtype=value.dtype)
        rows = np.repeat(np.arange(n), lens)
        pos = np.arange(len(index)) - np.repeat(ptr[:-1], lens)
        jidx[pos, inv_perm[rows]] = index
        jval[pos, inv_perm[rows]] = value
        return cls(perm=jnp.asarray(perm), inv_perm=jnp.asarray(inv_perm),
                   index=jnp.asarray(jidx), value=jnp.asarray(jval),
                   nrows=int(n), ncols=int(shape[1]),
                   nnz=int(len(value)), maxnzr=maxnzr)

    def to_csr_arrays(self):
        idx, val = host(self.index), host(self.value)
        perm = host(self.perm)
        n = self.nrows
        mask = val != 0
        lens_sorted = mask.sum(axis=0)          # nnz per sorted position
        lens = np.zeros(n, dtype=np.int64)
        lens[perm] = lens_sorted
        ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        index = np.zeros(int(ptr[-1]), dtype=np.int32)
        value = np.zeros(int(ptr[-1]), dtype=val.dtype)
        for k in range(n):
            row = perm[k]
            sel = mask[:, k]
            s = ptr[row]
            cnt = int(sel.sum())
            index[s:s + cnt] = idx[sel, k]
            value[s:s + cnt] = val[sel, k]
        return _sort_rows(ptr, index, value)

    def matvec(self, x):
        acc = jnp.sum(self.value * jnp.take(x, self.index, axis=0), axis=0)
        return jnp.take(acc, self.inv_perm, axis=0)

    def matvech(self, x):
        v = jnp.conj(self.value) if jnp.iscomplexobj(self.value) else self.value
        xs = jnp.take(x, self.perm, axis=0)     # x at each sorted position's row
        prod = (v * xs[None, :]).reshape(-1)
        y = jnp.zeros(self.ncols, dtype=prod.dtype)
        return y.at[self.index.reshape(-1)].add(prod)
