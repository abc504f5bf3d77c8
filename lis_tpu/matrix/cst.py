"""CST — chunk-sorted, transpose-routed SpMV for LOCALITY-FREE sparsity.

Reference capability matched: lis_matvec_csr serves *any* CSR at memory
bandwidth per rank on CPUs (src/matvec/lis_matvec_csr.c:53) because the
random access to x hits the cache hierarchy.  CST rebuilds both halves of
the classic CSR loop as regular data movement, for devices where a general
gather or scatter is slow:

- **x side**: columns are chunked by 128 (one row of 128 values each);
  entries live grouped by chunk, so reading ``x[col]`` is ONE row-local
  gather against the entry's own chunk row (``ops/shuffle.py``) — the
  chunk row itself is materialised with a plain ``jnp.repeat``;
- **y side**: products are routed from chunk order into ELL row-major
  order by a build-time-fixed Benes shuffle plan (ops/shuffle.py), and
  the row reduction becomes a dense ``reshape(n, K').sum(axis=1)`` —
  no scatter anywhere;
- the routing permutation is made BLOCK-LOCAL by bucketing entries by
  (column chunk, row block) with a fixed per-bucket cap and moving
  between the two orders with one regular XLA transpose of the
  (CB, RBc, beta) bucket grid — the Benes plan then needs only its
  in-block levels (2 colorings, 5 passes).

Slot grid invariant: M = n_pad * K' slots serve both layouts; the load
factor is mean_nnz_row / K' (~0.5), which is exactly the slack the
randomized greedy routing needs.  Bucket overflow (> beta), row overflow
(> K') and strongly non-uniform patterns spill to a plain-CSR remainder.

``matvech`` routes through a transpose CST built at construction time.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host
from lis_tpu.ops.shuffle import (plan_shuffle, block_digits, _lane_shuffle,
                                 ShufflePlan)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 0)


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Position within its group for an array sorted by ``keys``."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    first = np.r_[True, keys[1:] != keys[:-1]]
    return idx - np.maximum.accumulate(np.where(first, idx, 0))


def _spread(rank, group, size):
    """Per-group affine bijection rank -> slot on [0, size) (pow2):
    slot = (a_g * rank + c_g) mod size with a_g odd."""
    g = group.astype(np.uint64)
    h = (g * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(17)
    a = (h | np.uint64(1)) & np.uint64(size - 1)
    c = (g * np.uint64(0xC2B2AE3D27D4EB4F)) >> np.uint64(31)
    return ((a * rank.astype(np.uint64) + c)
            & np.uint64(size - 1)).astype(np.int64)


@matrix_format("cst")
class CSTMatrix(SparseMatrix):
    val: jax.Array            # (M/128, 128) entry values in src order
    lidx: jax.Array           # (M/128, 128) int32 col-within-chunk
    rowf: jax.Array           # (M,) int32 destination row (nrows padding)
    plan: ShufflePlan         # post-transpose slot -> ELL slot
    diag: jax.Array           # (nrows,) diagonal (build-time)
    rem: object               # CSRMatrix remainder or None
    at: object                # CSTMatrix of A^T (no nested .at) or None
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    n_pad: int = static()     # power of two >= max(nrows, ncols)
    Kp: int = static()        # ELL width (power of two)
    beta: int = static()      # per-(chunk, row-block) bucket cap
    RBc: int = static()       # row blocks

    # ------------------------------------------------------------------
    @classmethod
    def profile(cls, ptr, index, shape, load: float = 0.72,
                Kp: int | None = None):
        """(fill_blowup, rem_frac) estimate without building: one
        bincount over buckets + row lengths.  ``Kp`` overrides the
        natural ELL width — escalating it grows M past 2^21, which
        COARSENS the bucket grid (RBc -> 1) and lets band-concentrated
        sparsity fit without spill at a modest fill cost (the
        auto_storage escalation loop uses this)."""
        ptr = np.asarray(ptr, dtype=np.int64)
        index = np.asarray(index, dtype=np.int64)
        n, m = shape
        nnz = max(ptr[-1], 1)
        n_pad = _next_pow2(max(n, m, 128 * 128))
        Kp = Kp or cls._pick_kp(nnz / max(n, 1), load)
        M = n_pad * Kp
        L = min(M, 1 << 21) if M >= (1 << 21) else (1 << 14)
        RB = L // Kp
        CB = n_pad // 128
        beta = L // CB
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        bucket = (index >> 7) * (M // L) + rows // RB
        bc = np.bincount(bucket, minlength=1)
        spill_b = np.maximum(bc - beta, 0).sum()
        rl = np.diff(ptr)
        spill_r = np.maximum(rl - Kp, 0).sum()
        return M / nnz, (spill_b + spill_r) / nnz

    @staticmethod
    def _pick_kp(mean_k: float, load: float = 0.72) -> int:
        Kp = _next_pow2(int(np.ceil(max(mean_k, 1.0))))
        while mean_k / Kp > load:
            Kp *= 2
        return min(max(Kp, 2), 256)

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        transpose: bool = True, load: float = 0.72,
                        Kp: int | None = None, n_pad: int | None = None,
                        return_spill: bool = False,
                        consistent_passes: bool = False):
        """``Kp``/``n_pad`` override the derived grid parameters (the
        distributed builder forces identical statics across shards);
        ``return_spill=True`` returns (matrix-with-rem=None,
        (rows, cols, vals)) so the caller can lay the overflow out its
        own way (DistCSTMatrix pads it per shard)."""
        import scipy.sparse as sp
        from lis_tpu.matrix.csr import CSRMatrix
        ptr = np.asarray(ptr).astype(np.int64)
        index = np.asarray(index).astype(np.int64)
        value = np.asarray(value)
        n, m = shape
        nnz = len(value)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))

        n_pad = n_pad or _next_pow2(max(n, m, 128 * 128))
        Kp = Kp or cls._pick_kp(nnz / max(n, 1), load)
        M = n_pad * Kp
        L = min(M, 1 << 21) if M >= (1 << 21) else (1 << 14)
        RB = L // Kp                  # rows per block
        RBc = M // L                  # number of row blocks
        CB = n_pad // 128             # column chunks
        beta = L // CB                # bucket cap

        cb = index >> 7
        rb = rows // RB
        bucket = cb * RBc + rb
        order = np.argsort(bucket, kind="stable")
        sl = np.empty(nnz, dtype=np.int64)
        sl[order] = _cumcount(bucket[order])
        keep = sl < beta
        # ELL slot within the row (entries are row-major in CSR order)
        kslot = np.full(nnz, Kp, dtype=np.int64)
        kk = _cumcount(rows[keep])
        keep2 = kk < Kp
        kslot[np.flatnonzero(keep)[keep2]] = kk[keep2]
        kept = keep.copy()
        kept[np.flatnonzero(keep)[~keep2]] = False
        # spread ranks pseudo-uniformly over the slot range (per-group
        # affine bijection, odd multiplier mod pow2): packed low slots
        # would cluster occupancy and starve the randomized Benes
        # routing of the slack it relies on (ops/shuffle.py greedy)
        sl = _spread(sl, bucket, beta)
        kslot = np.where(kslot < Kp, _spread(kslot, rows, Kp), Kp)

        r_, c_, v_ = rows[kept], index[kept], value[kept]
        cbk, rbk, slk = cb[kept], rb[kept], sl[kept]
        src = cbk * (RBc * beta) + rbk * beta + slk
        pos_t = rbk * (CB * beta) + cbk * beta + slk
        dst = r_ * Kp + kslot[kept]
        perm = np.full(M, -1, dtype=np.int64)
        perm[pos_t] = dst
        # exact_holes: every pass stays a true per-row permutation, so
        # hole slots (val = 0 at their sources) provably carry zeros to
        # every unreal destination — no dst mask is needed before the
        # row reduction
        # consistent_passes: never skip identity levels, so sibling
        # builds (one per shard) share one pass structure and stack
        plan = plan_shuffle(perm, digits=block_digits(M, L),
                            validate=False, exact_holes=True,
                            skip_identity=not consistent_passes)

        val = np.zeros(M, dtype=value.dtype)
        val[src] = v_
        # lane ids are < 128: uint8 quarters the select-phase index
        # traffic
        li = np.zeros(M, dtype=np.uint8)
        li[src] = (c_ & 127).astype(np.uint8)
        rf = np.full(M, n, dtype=np.int32)
        rf[src] = r_.astype(np.int32)

        rem = None
        spill = None
        if return_spill:
            so = np.flatnonzero(~kept)
            spill = (rows[so], index[so], value[so])
        elif (~kept).any():
            so = np.flatnonzero(~kept)
            rm = sp.coo_matrix((value[so], (rows[so], index[so])),
                               shape=shape).tocsr()
            rm.sort_indices()
            rem = CSRMatrix.from_csr_arrays(rm.indptr, rm.indices, rm.data,
                                            shape)

        d = np.zeros(n, dtype=value.dtype)
        dm = rows == index
        np.add.at(d, rows[dm], value[dm])

        at = None
        if transpose:
            a = sp.csr_matrix((value, index, ptr), shape=shape).T.tocsr()
            a.sort_indices()
            at = cls.from_csr_arrays(a.indptr, a.indices, a.data, (m, n),
                                     transpose=False, load=load)
        out = cls(val=jnp.asarray(val.reshape(-1, 128)),
                  lidx=jnp.asarray(li.reshape(-1, 128)),
                  rowf=jnp.asarray(rf),
                  plan=plan,
                  diag=jnp.asarray(d), rem=rem, at=at,
                  nrows=int(n), ncols=int(m), nnz=int(nnz),
                  n_pad=int(n_pad), Kp=int(Kp), beta=int(beta),
                  RBc=int(RBc))
        return (out, spill) if return_spill else out

    # ------------------------------------------------------------------
    @property
    def fill_blowup(self) -> float:
        return self.val.size / max(self.nnz, 1)

    def _select(self, x):
        """Entry-wise x values: chunk rows broadcast by repeat (regular)
        then ONE row-local gather."""
        CB = self.n_pad // 128
        xp = jnp.pad(x, (0, self.n_pad - x.shape[0]))
        # src layout: chunk cb occupies M/CB = Kp*128 consecutive slots
        xrep = jnp.repeat(xp.reshape(CB, 1, 128), self.Kp, axis=1)
        return _lane_shuffle(xrep.reshape(-1, 128), self.lidx)

    def matvec(self, x):
        dt = jnp.result_type(x.dtype, self.val.dtype)
        sel = self._select(x.astype(dt) if x.dtype != dt else x)
        contrib = sel * self.val.astype(dt)
        CB = self.n_pad // 128
        t = contrib.reshape(CB, self.RBc, self.beta)
        t = jnp.swapaxes(t, 0, 1).reshape(-1)
        # exact-holes plan: unreal slots carry zeros, so the row sums
        # need no destination mask (see from_csr_arrays)
        y = self.plan.apply_rowsum(t, self.Kp)[: self.nrows]
        if self.rem is not None:
            y = y + self.rem.matvec(x)
        return y

    def matvech(self, x):
        if self.at is not None:
            # ``at`` was built from the FULL A^T, including this grid's
            # spilled entries, so it is the complete transpose apply
            if jnp.iscomplexobj(self.val):
                return jnp.conj(self.at.matvec(jnp.conj(x)))
            return self.at.matvec(x)
        # no transpose grid (auto_storage skips it for solvers that
        # apply A^H at most once per solve, halving the build): one
        # correct XLA scatter-add, paid at most once per solve.
        # bicg/bicr get a transpose grid from the routing (need_at).
        conj = (jnp.conj if jnp.iscomplexobj(self.val) else (lambda a: a))
        xr = jnp.take(jnp.pad(conj(x), (0, 1)),
                      jnp.minimum(self.rowf, self.nrows), axis=0)
        contrib = conj(self.val).reshape(-1) * xr
        slot = np.arange(self.n_pad * self.Kp, dtype=np.int64)
        col = ((slot // (self.Kp * 128)) * 128).astype(np.int32)
        cols = jnp.asarray(col) + self.lidx.reshape(-1).astype(jnp.int32)
        y = jnp.zeros(self.n_pad, dtype=contrib.dtype).at[cols].add(
            contrib)[: self.ncols]
        if self.rem is not None:
            y = y + self.rem.matvech(x)
        return y

    def get_diagonal(self):
        return self.diag

    def to_csr_arrays(self):
        import scipy.sparse as sp
        v = host(self.val).reshape(-1)
        li = host(self.lidx).reshape(-1).astype(np.int64)
        rf = host(self.rowf).astype(np.int64)
        slot = np.arange(self.n_pad * self.Kp, dtype=np.int64)
        chunk = slot // (self.Kp * 128)
        ok = rf < self.nrows
        a = sp.coo_matrix((v[ok], (rf[ok], chunk[ok] * 128 + li[ok])),
                          shape=self.shape).tocsr()
        if self.rem is not None:
            rp, ri, rv = self.rem.to_csr_arrays()
            a = (a + sp.csr_matrix((np.asarray(rv), np.asarray(ri),
                                    np.asarray(rp)), shape=self.shape))
            a = a.tocsr()
        a.sort_indices()
        return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                a.data)

    # ---- scaling (setup-time, once per solve) -------------------------
    def _row_factor(self, d):
        dr = jnp.pad(jnp.asarray(d), (0, 1))
        return jnp.take(dr, self.rowf, axis=0).reshape(self.val.shape)

    def _col_factor(self, d):
        return self._select(jnp.asarray(d))

    def _scaled(self, row_d=None, col_d=None):
        v = self.val
        dg = self.diag
        if row_d is not None:
            v = v * self._row_factor(row_d).astype(v.dtype)
            dg = dg * jnp.asarray(row_d).astype(dg.dtype)
        if col_d is not None:
            v = v * self._col_factor(col_d).astype(v.dtype)
            dg = dg * jnp.asarray(col_d)[: self.nrows].astype(dg.dtype)
        out = dataclasses.replace(self, val=v, diag=dg)
        if self.rem is not None:
            from lis_tpu.matrix.css import _csr_scaled
            out = dataclasses.replace(out, rem=_csr_scaled(self.rem, row_d,
                                                           col_d))
        return out

    def scale_rows(self, d):
        out = self._scaled(row_d=d)
        if self.at is not None:      # rows of A = columns of A^T
            out = dataclasses.replace(out, at=self.at._scaled(col_d=d))
        return out

    def scale_symm(self, dsqrt_inv):
        out = self._scaled(row_d=dsqrt_inv, col_d=dsqrt_inv)
        if self.at is not None:
            out = dataclasses.replace(
                out, at=self.at._scaled(row_d=dsqrt_inv, col_d=dsqrt_inv))
        return out
