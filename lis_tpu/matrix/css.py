"""CSS — chunk-sorted select-stream: the routed layout for GENERAL
sparsity (no band that RCM can expose: uniformly random patterns,
power-law graphs — spmvtest4/5-class inputs).

Reference capability matched: lis_matvec_csr serves *any* CSR at memory
bandwidth on CPUs (src/matvec/lis_matvec_csr.c:53).  CSS removes the
random gather on the x side: each entry reads x from its own 128-wide
chunk.  On an H100 it runs 1.4-1.5x CSR's gather + segment-sum at f64
(CHANGES.md):

- columns are partitioned into chunks of width W (``x.reshape(NC, W)``
  is free); entries are sorted by chunk at build time and padded to a
  dense (NC, E) layout (E = per-chunk entry cap);
- the matvec reads each entry's x value with a fused one-hot
  select-reduce against ITS OWN chunk's x slice — a broadcast over the
  (NC, E) entry grid, no gather anywhere (the einsum formulation of the
  same one-hot materialises the operand and runs out of memory — the
  where/sum form is load-bearing);
- the products then land in their rows with a single scatter-add
  (y-side).  Entry order within a chunk is row-sorted, which makes the
  scatter indices *piecewise* sorted;
- hot chunks (power-law hubs) would blow up E, so entries beyond the
  cap go to a plain-CSR remainder (bounded to a small fraction).

``matvech`` routes through a transpose CSS built at construction time
(the entry sort for Aᵀ is the column sort of A — same machinery).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host

W_DEFAULT = 128


@matrix_format("css")
class CSSMatrix(SparseMatrix):
    val: jax.Array            # (NC, E) entry values, 0 padding
    lidx: jax.Array           # (NC, E) int32 col-within-chunk, W padding
    rowf: jax.Array           # (NC*E,) int32 destination row, nrows padding
    rem: object               # CSRMatrix remainder (hot-chunk overflow)
    at: object                # CSSMatrix of Aᵀ (no nested .at) or None
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    W: int = static()

    @classmethod
    def profile(cls, index, ncols, W: int = W_DEFAULT,
                e_quantile: float = 0.995):
        """Acceptance statistics WITHOUT building the matrix: the
        (fill_blowup, rem_frac) a from_csr_arrays call with the same
        parameters would produce, from one O(nnz) bincount — lets
        auto_storage reject cheaply instead of constructing both the
        grid and the transpose grid first."""
        index = np.asarray(index)
        nnz = max(len(index), 1)
        nc = -(-ncols // W)
        counts = np.bincount(index // W, minlength=nc)
        E = max(int(np.quantile(counts, e_quantile)) if len(counts) else 1,
                1)
        spill = int(np.maximum(counts - E, 0).sum())
        return nc * E / nnz, spill / nnz

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, W: int = W_DEFAULT,
                        e_quantile: float = 0.995, transpose: bool = True):
        import scipy.sparse as sp
        from lis_tpu.matrix.csr import CSRMatrix
        ptr = np.asarray(ptr).astype(np.int64)
        index = np.asarray(index).astype(np.int64)
        value = np.asarray(value)
        n, m = shape
        nc = -(-m // W)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        chunk = index // W

        counts = np.bincount(chunk, minlength=nc)
        # entry cap: cover the bulk densely, spill hub chunks to CSR
        E = int(np.quantile(counts, e_quantile)) if len(counts) else 1
        E = max(E, 1)
        # keep the first E entries per chunk (row-sorted within chunk
        # because the CSR input is row-major), spill the rest
        # a stable sort of 16-bit keys is a radix sort: ~5x faster than
        # on int64 keys at 10^7+ entries
        order = np.argsort(chunk.astype(np.uint16) if nc <= 1 << 16
                           else chunk, kind="stable")
        pos_in_chunk = np.arange(len(order)) - np.concatenate(
            [[0], np.cumsum(counts)])[chunk[order]]
        keep = pos_in_chunk < E
        ko, so = order[keep], order[~keep]

        val = np.zeros((nc, E), dtype=value.dtype)
        lidx = np.full((nc, E), W, dtype=np.int32)
        rowf = np.full((nc, E), n, dtype=np.int32)
        ck = chunk[ko]
        pk = pos_in_chunk[keep]
        val[ck, pk] = value[ko]
        lidx[ck, pk] = (index[ko] - ck * W).astype(np.int32)
        rowf[ck, pk] = rows[ko].astype(np.int32)

        rem = None
        if len(so):
            rm = sp.coo_matrix((value[so], (rows[so], index[so])),
                               shape=shape).tocsr()
            rm.sort_indices()
            rem = CSRMatrix.from_csr_arrays(rm.indptr, rm.indices, rm.data,
                                            shape)

        at = None
        if transpose:
            a = sp.csr_matrix((value, index, ptr.astype(np.int64)),
                              shape=shape).T.tocsr()
            a.sort_indices()
            at = cls.from_csr_arrays(a.indptr, a.indices, a.data,
                                     (m, n), W=W, e_quantile=e_quantile,
                                     transpose=False)
        return cls(val=jnp.asarray(val), lidx=jnp.asarray(lidx),
                   rowf=jnp.asarray(rowf.reshape(-1)), rem=rem, at=at,
                   nrows=n, ncols=m, nnz=int(len(value)), W=int(W))

    @property
    def fill_blowup(self) -> float:
        return self.val.size / max(self.nnz, 1)

    def to_csr_arrays(self):
        import scipy.sparse as sp
        v = host(self.val).reshape(-1)
        li = host(self.lidx).reshape(-1)
        rf = host(self.rowf)
        nc, E = self.val.shape
        c = np.repeat(np.arange(nc), E)
        ok = li < self.W
        a = sp.coo_matrix((v[ok], (rf[ok], c[ok] * self.W + li[ok])),
                          shape=self.shape).tocsr()
        if self.rem is not None:
            rp, ri, rv = self.rem.to_csr_arrays()
            a = (a + sp.csr_matrix((np.asarray(rv), np.asarray(ri),
                                    np.asarray(rp)), shape=self.shape))
            a = a.tocsr()
        a.sort_indices()
        return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                a.data)

    def _select(self, x):
        """contrib[c, e] = val[c, e] * x[c*W + lidx[c, e]] via the fused
        one-hot select-reduce (zero gathers; padding lidx == W never
        matches)."""
        nc, E = self.val.shape
        xc = jnp.pad(x, (0, nc * self.W - self.ncols)).reshape(nc, self.W)
        iota = jnp.arange(self.W, dtype=self.lidx.dtype)
        sel = jnp.sum(
            jnp.where(self.lidx[:, :, None] == iota,
                      xc[:, None, :], 0), axis=-1)
        return self.val * sel

    def matvec(self, x):
        # promote to the RESULT dtype (never demote x: a complex vector
        # against a real matrix must stay complex)
        dt = jnp.result_type(x.dtype, self.val.dtype)
        contrib = self._select(x.astype(dt) if x.dtype != dt else x)
        y = jnp.zeros(self.nrows + 1, dtype=contrib.dtype)
        y = y.at[self.rowf].add(contrib.reshape(-1))
        y = y[: self.nrows]
        if self.rem is not None:
            y = y + self.rem.matvec(x)
        return y

    def matvech(self, x):
        if self.at is not None:
            # ``at`` was built from the FULL Aᵀ (including entries this
            # grid spilled to rem), so it is the complete transpose apply
            if jnp.iscomplexobj(self.val):
                return jnp.conj(self.at.matvec(jnp.conj(x)))
            return self.at.matvec(x)
        # fallback: gather x at rows, scatter into columns
        v = jnp.conj(self.val) if jnp.iscomplexobj(self.val) else self.val
        xr = jnp.pad(x, (0, 1))
        prod = v.reshape(-1) * jnp.take(xr, self.rowf, axis=0)
        nc, E = self.val.shape
        c = jnp.repeat(jnp.arange(nc, dtype=self.lidx.dtype), E)
        col = jnp.minimum(c * self.W + self.lidx.reshape(-1),
                          self.ncols)
        y = jnp.zeros(self.ncols + 1, dtype=prod.dtype)
        y = y.at[col].add(prod)[: self.ncols]
        if self.rem is not None:
            y = y + self.rem.matvech(x)
        return y

    def get_diagonal(self):
        nc, E = self.val.shape
        c = jnp.repeat(jnp.arange(nc, dtype=jnp.int32), E)
        col = c * self.W + jnp.minimum(self.lidx.reshape(-1), self.W - 1)
        isdiag = (col == self.rowf) & (self.lidx.reshape(-1) < self.W)
        d = jnp.zeros(self.nrows + 1, dtype=self.val.dtype)
        d = d.at[self.rowf].add(
            jnp.where(isdiag, self.val.reshape(-1), 0))[: self.nrows]
        if self.rem is not None:
            d = d + self.rem.get_diagonal()
        return d

    # ---- scaling (setup-time, once per solve) ---------------------------
    def _row_factor(self, d):
        dr = jnp.pad(jnp.asarray(d), (0, 1))       # rowf == nrows padding
        return jnp.take(dr, self.rowf, axis=0).reshape(self.val.shape)

    def _col_factor(self, d):
        """Per-entry column factors through the same gather-free select."""
        nc, E = self.val.shape
        dc = jnp.pad(jnp.asarray(d), (0, nc * self.W - self.ncols))
        xc = dc.reshape(nc, self.W)
        iota = jnp.arange(self.W, dtype=self.lidx.dtype)
        return jnp.sum(jnp.where(self.lidx[:, :, None] == iota,
                                 xc[:, None, :].astype(self.val.dtype), 0),
                       axis=-1)

    def _scaled(self, row_d=None, col_d=None):
        v = self.val
        if row_d is not None:
            v = v * self._row_factor(row_d).astype(v.dtype)
        if col_d is not None:
            v = v * self._col_factor(col_d).astype(v.dtype)
        out = dataclasses.replace(self, val=v)
        if self.rem is not None:
            out = dataclasses.replace(out, rem=_csr_scaled(self.rem, row_d,
                                                           col_d))
        return out

    def scale_rows(self, d):
        out = self._scaled(row_d=d)
        if self.at is not None:   # rows of A = columns of Aᵀ
            out = dataclasses.replace(out, at=self.at._scaled(col_d=d))
        return out

    def scale_symm(self, dsqrt_inv):
        out = self._scaled(row_d=dsqrt_inv, col_d=dsqrt_inv)
        if self.at is not None:
            out = dataclasses.replace(
                out, at=self.at._scaled(row_d=dsqrt_inv, col_d=dsqrt_inv))
        return out


def _csr_scaled(m, row_d=None, col_d=None):
    """Device-side row/column scaling of a CSRMatrix remainder."""
    v = m.value
    if row_d is not None:
        v = v * jnp.take(jnp.asarray(row_d), m.row_ids, axis=0).astype(
            v.dtype)
    if col_d is not None:
        v = v * jnp.take(jnp.asarray(col_d), m.index, axis=0).astype(
            v.dtype)
    return dataclasses.replace(m, value=v)
