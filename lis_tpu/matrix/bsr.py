"""BSR — block sparse row.

Reference: src/matrix/lis_matrix_bsr.c with unrolled kernels per block size
(src/matvec/lis_matvec_bsr.c:57+, all sizes ≤ 4×4).  Here the unrolled
scalar kernels become batched small matmuls (einsum, at
precision="highest" so f32 never drops to TF32).  Two layouts:

- **windowed slabs** (the fast path, chosen at construction when the block
  structure is band-local): blocks live DENSE in up to `max_windows`
  (nr, Wb, bnr, bnc) slabs, each over a sliding block-column window
  [t+c0, t+c0+Wb) — the multi-window BES layout at block granularity.
  Windows are found by run-clustering the block-displacement histogram,
  so separated block bands (e.g. a 2-D PDE operator kron'd with dof
  blocks: displacements {-nx, -1..1, +nx}) each get their own dense
  narrow window.  The x windows are Wb shifted contiguous reshapes (no
  gather anywhere) and each matvec window is one einsum contracting
  (Wb, bnc) jointly — dense streaming instead of a per-block gather;
- **gather** spill for blocks outside every window (and for matrices
  with no block-band structure at all): batched einsum over gathered x
  blocks + sorted segment-sum, the direct analogue of the reference's
  per-block dispatch.

Rows/cols are zero-padded up to a multiple of the block size at
construction (static), and sliced back after SpMV.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host


def _select_windows(disp, nr, max_windows, w_max, gap_max=2,
                    min_frac=0.02, blowup_max=8.0):
    """Run-cluster the distinct block displacements into windows.

    Returns a list of (c0, Wb) windows sorted by coverage, greedy until
    `max_windows`; displacements not covered spill to the gather path.
    A window is rejected when its slab would stream more than
    `blowup_max`× the blocks it covers (low-density run — random
    sparsity with near-contiguous displacements), since the memory
    blowup then outweighs the gather savings.
    """
    uniq, counts = np.unique(disp, return_counts=True)
    runs = []  # (count, lo, hi)
    lo = hi = int(uniq[0])
    cnt = int(counts[0])
    for u, c in zip(uniq[1:], counts[1:]):
        u = int(u)
        if u - hi <= gap_max and u - lo + 1 <= w_max:
            hi = u
            cnt += int(c)
        else:
            runs.append((cnt, lo, hi))
            lo = hi = u
            cnt = int(c)
    runs.append((cnt, lo, hi))
    runs.sort(reverse=True)
    total = len(disp)
    out = []
    for cnt, lo, hi in runs:
        if len(out) >= max_windows:
            break
        if cnt < min_frac * total and out:
            break  # diminishing returns: leave the tail to the spill path
        Wb = hi - lo + 1
        if nr * Wb > blowup_max * cnt:
            continue  # low-density run: gather spill is the better deal
        out.append((lo, Wb))
    return out


@matrix_format("bsr")
class BSRMatrix(SparseMatrix):
    bptr: jax.Array           # (nr+1,) int32
    bindex: jax.Array         # (bnnz,) int32 block-column indices (spill)
    value: jax.Array          # (bnnz, bnr, bnc) spill blocks
    brow_ids: jax.Array       # (bnnz,) int32 (spill)
    slabs: object             # tuple of (nr, Wb_i, bnr, bnc) window slabs
    nrows: int = static()     # true (unpadded) row count
    ncols: int = static()
    nnz: int = static()
    bnr: int = static()
    bnc: int = static()
    nr: int = static()        # number of block rows
    nc: int = static()        # number of block cols
    c0s: tuple = static(default=())  # per-window start offsets (blocks)
    has_spill: bool = static(default=True)  # any blocks outside the windows

    def _rebuild_kwargs(self):
        return {"bnr": self.bnr, "bnc": self.bnc}

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, bnr: int = 2,
                        bnc: int | None = None, w_max: int = 64,
                        max_windows: int = 8) -> "BSRMatrix":
        import scipy.sparse as sp
        bnc = bnc or bnr
        ptr, index, value = host(ptr), host(index), host(value)
        n, m = shape
        nr, nc = -(-n // bnr), -(-m // bnc)
        a = sp.csr_matrix((value, index, ptr), shape=shape)
        a.resize((nr * bnr, nc * bnc))
        b = sp.bsr_matrix(a, blocksize=(bnr, bnc))
        b.sort_indices()
        brow = np.repeat(np.arange(nr, dtype=np.int64), np.diff(b.indptr))
        bidx = b.indices.astype(np.int64)
        disp = bidx - brow

        slabs = []
        c0s = []
        spill = np.ones(len(disp), dtype=bool)
        if len(disp) and nr * bnr == nc * bnc:
            for c0, Wb in _select_windows(disp, nr, max_windows, w_max):
                fits = spill & (disp >= c0) & (disp < c0 + Wb)
                slab = np.zeros((nr, Wb, bnr, bnc), dtype=b.data.dtype)
                slab[brow[fits], disp[fits] - c0] = b.data[fits]
                slabs.append(jnp.asarray(slab))
                c0s.append(int(c0))
                spill &= ~fits
        bdat, bidx_k, brow_k = b.data[spill], bidx[spill], brow[spill]

        has_spill = len(bdat) > 0
        if not has_spill:  # shape-stable placeholders, path skipped in matvec
            bdat = np.zeros((1, bnr, bnc), dtype=b.data.dtype)
            bidx_k = np.zeros(1, np.int64)
            brow_k = np.zeros(1, np.int64)
        return cls(bptr=jnp.asarray(b.indptr.astype(np.int32)),
                   bindex=jnp.asarray(bidx_k.astype(np.int32)),
                   value=jnp.asarray(bdat),
                   brow_ids=jnp.asarray(brow_k.astype(np.int32)),
                   slabs=tuple(slabs),
                   nrows=int(n), ncols=int(m), nnz=int(len(value)),
                   bnr=bnr, bnc=bnc, nr=nr, nc=nc, c0s=tuple(c0s),
                   has_spill=has_spill)

    def to_csr_arrays(self):
        import scipy.sparse as sp
        acc = None
        for slab, c0 in zip(self.slabs, self.c0s):
            s = host(slab)
            t, w, i, j = np.nonzero(s)
            grow = t * self.bnr + i
            gcol = (t + c0 + w) * self.bnc + j
            ok = (gcol >= 0) & (gcol < self.nc * self.bnc)
            g = sp.coo_matrix((s[t, w, i, j][ok],
                               (grow[ok], gcol[ok])),
                              shape=(self.nr * self.bnr,
                                     self.nc * self.bnc)).tocsr()
            acc = g if acc is None else (acc + g).tocsr()
        if self.has_spill:
            v = host(self.value)
            bi = host(self.bindex)
            br = host(self.brow_ids)
            k, i, j = np.nonzero(v)
            g = sp.coo_matrix((v[k, i, j],
                               (br[k] * self.bnr + i, bi[k] * self.bnc + j)),
                              shape=(self.nr * self.bnr,
                                     self.nc * self.bnc)).tocsr()
            acc = g if acc is None else (acc + g).tocsr()
        if acc is None:
            acc = sp.csr_matrix((self.nr * self.bnr, self.nc * self.bnc))
        acc.resize(self.shape)
        a = acc.tocsr()
        a.eliminate_zeros()
        a.sort_indices()
        return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data

    def _pad_x(self, x):
        padded = self.nc * self.bnc
        if padded == x.shape[0]:
            return x
        return jnp.pad(x, (0, padded - x.shape[0]))

    def _bounds(self, c0, Wb):
        lo = max(-c0, 0)
        hi = max((self.nr - 1) + c0 + Wb - self.nc, 0) + 1
        return lo, hi

    def _xwindows(self, xp, c0, Wb):
        """(nr, Wb, bnc) sliding block windows — Wb shifted contiguous
        reshapes of x (gather-free; the BES trick at block stride)."""
        lo, hi = self._bounds(c0, Wb)
        xpad = jnp.pad(xp, (lo * self.bnc, hi * self.bnc))
        base = (c0 + lo) * self.bnc
        parts = [jax.lax.dynamic_slice(
            xpad, (base + w * self.bnc,), (self.nr * self.bnc,))
            .reshape(self.nr, 1, self.bnc) for w in range(Wb)]
        return jnp.concatenate(parts, axis=1)

    def matvec(self, x):
        xp = self._pad_x(x)
        y = None
        for slab, c0 in zip(self.slabs, self.c0s):
            # promote to the result dtype — never truncate a complex x
            dt = jnp.result_type(xp.dtype, slab.dtype)
            xw = self._xwindows(xp.astype(dt) if xp.dtype != dt else xp,
                                c0, slab.shape[1])
            t = jnp.einsum("twij,twj->ti", slab.astype(dt)
                           if slab.dtype != dt else slab, xw,
                           precision="highest")
            y = t if y is None else y + t
        if self.has_spill or y is None:
            xb = xp.reshape(self.nc, self.bnc)
            xg = jnp.take(xb, self.bindex, axis=0)          # (bnnz, bnc)
            yb = jnp.einsum("kij,kj->ki", self.value, xg,   # block matvecs
                            precision="highest")
            yg = jax.ops.segment_sum(yb, self.brow_ids,
                                     num_segments=self.nr,
                                     indices_are_sorted=True)
            y = yg if y is None else y + yg
        return y.reshape(-1)[: self.nrows]

    def matvech(self, x):
        padded_r = self.nr * self.bnr
        xp = x if x.shape[0] == padded_r else jnp.pad(
            x, (0, padded_r - x.shape[0]))
        xb = xp.reshape(self.nr, self.bnr)
        y = None
        for slab, c0 in zip(self.slabs, self.c0s):
            sl = jnp.conj(slab) if jnp.iscomplexobj(slab) else slab
            Wb = slab.shape[1]
            dt = jnp.result_type(xb.dtype, sl.dtype)
            z = jnp.einsum("twij,ti->twj",
                           sl.astype(dt) if sl.dtype != dt else sl,
                           xb.astype(dt)
                           if xb.dtype != dt else xb,   # (nr, Wb, bnc)
                           precision="highest")
            lo, hi = self._bounds(c0, Wb)
            base = (c0 + lo) * self.bnc
            yo = jnp.zeros((lo + self.nc + hi) * self.bnc, dtype=z.dtype)
            for w in range(Wb):
                seg = z[:, w].reshape(-1)
                cur = jax.lax.dynamic_slice(
                    yo, (base + w * self.bnc,), (self.nr * self.bnc,))
                yo = jax.lax.dynamic_update_slice(
                    yo, cur + seg, (base + w * self.bnc,))
            t = yo[lo * self.bnc: (lo + self.nc) * self.bnc]
            y = t if y is None else y + t
        if self.has_spill or y is None:
            v = jnp.conj(self.value) if jnp.iscomplexobj(self.value) \
                else self.value
            xg = jnp.take(xb, self.brow_ids, axis=0)        # (bnnz, bnr)
            yb = jnp.einsum("kij,ki->kj", v, xg,            # blockᵀ matvecs
                            precision="highest")
            yg = jnp.zeros((self.nc, self.bnc), dtype=yb.dtype)
            yg = yg.at[self.bindex].add(yb).reshape(-1)
            y = yg if y is None else y + yg
        return y[: self.ncols]
