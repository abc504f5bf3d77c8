"""BES — block-dense sliding-window slabs: a gather-free layout for
GENERAL (non-banded) sparsity.

Reference capability matched: the per-format tuned SpMV kernels serving
arbitrary matrices (src/matvec/lis_matvec_csr.c:53, unrolled BSR
lis_matvec_bsr.c:57).  The layout was built for a device without a fast
general gather: everything the matvec reads is a stream.  On an H100 it
does not beat CSR (CHANGES.md), so the router never picks it:

- rows in blocks of R = 128; block t owns the
  x-window [t*R + c0, t*R + c0 + W) which slides AFFINELY with t, so the
  (T, W) window matrix is W/R contiguous shifted reshapes of x — no
  gather anywhere;
- the block's entries are stored DENSE in a (T, W, R) slab
  (slab[t, w, r] = A[t*R + r, t*R + c0 + w]); the matvec is a
  broadcast-multiply + reduction that streams the slab;
- effective CSR-equivalent bandwidth = slab rate / fill-blowup, where
  blowup = W / (avg in-window nnz per row).  Entries outside the window
  fall to a small CSR remainder (standard gather kernel);
- matrices whose locality is hidden by a bad ordering go through
  reverse-Cuthill-McKee first (lis_tpu.matrix.reorder) — RCM concentrates
  entries into exactly the sliding band the slabs cover.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host

R_DEFAULT = 128

# per-element SpMV costs on an NVIDIA H100 80GB HBM3 at 700 W, f64
# (CHANGES.md): a slab slot streams at ~1.1-1.5 TB/s (~6 ps for 8 bytes);
# a CSR entry costs 62-69 ps (gather + segment sum), about 10x a slot
SLAB_NS_PER_SLOT = 0.006
GATHER_NS = 0.065


@matrix_format("bes")
class BESMatrix(SparseMatrix):
    # slab[t, w, r] = A[t*R + r, t*stride + c0 + w].  stride == R for
    # square band structure; a smaller stride lets the windows advance
    # slower than the rows, covering RECTANGULAR operators whose columns
    # track rows at a slope (e.g. AMG prolongators, slope ~ ncols/nrows).
    slab: jax.Array           # (T, W, R)
    rem: object               # CSRMatrix remainder or None
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    R: int = static()
    W: int = static()
    c0: int = static()        # window start offset relative to t*stride
    stride: int = static(default=0)   # 0 -> R (square band)

    @property
    def s(self) -> int:
        return self.stride or self.R

    # ---- construction ---------------------------------------------------
    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, R: int = R_DEFAULT,
                        W: int | None = None, coverage: float = 0.97,
                        w_max: int = 4096, max_bytes: int = 6 << 30,
                        stride: int | None = None):
        """Build from CSR.  The window width W (multiple of the column
        stride) is chosen from the entry-displacement profile to cover
        ``coverage`` of the nnz, capped by ``w_max`` and the
        ``max_bytes`` slab budget; out-of-window entries go to the CSR
        remainder.  ``stride`` defaults to R (square band); for
        rectangular operators pass ~round(R*ncols/nrows) (or None with a
        non-square shape to pick it automatically)."""
        from lis_tpu.matrix.csr import CSRMatrix
        ptr = np.asarray(ptr).astype(np.int64)
        index = np.asarray(index).astype(np.int64)
        value = np.asarray(value)
        n, m = shape
        if stride is None:
            stride = R if n == m else max(1, round(R * m / max(n, 1)))
        T = -(-n // R)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        t_of = rows // R
        disp = index - t_of * stride     # displacement from window base

        if W is None or W % R:
            # cost-model window selection: W grows until the marginal
            # band of displacements it absorbs stops paying for the extra
            # slab (per-element costs above)
            if len(disp):
                # stride-granular displacement histogram + cumsum: sliding
                # window coverage in O(nbins) per candidate width
                dmin = int(disp.min())
                bins = (disp - dmin) // stride
                counts = np.bincount(bins)
                cum = np.concatenate([[0], np.cumsum(counts)])
                nb = len(counts)
                best_w, best_c0, best_cost = 2 * stride, dmin, None
                for wb in range(2, min(w_max, 1 << 14) // stride + 1):
                    w_try = wb * stride
                    if wb >= nb:
                        cover = np.array([cum[-1]])
                    else:
                        cover = cum[wb:] - cum[:-wb]
                    k = int(np.argmax(cover))
                    covered = int(cover[k])
                    cost = (T * w_try * R * SLAB_NS_PER_SLOT
                            + (len(disp) - covered) * GATHER_NS)
                    if best_cost is None or cost < best_cost:
                        best_w, best_c0 = w_try, dmin + k * stride
                        best_cost = cost
                    if covered == len(disp):
                        break
                W, c0 = best_w, best_c0
            else:
                W, c0 = 2 * stride, 0
        else:
            c0 = -((W - stride) // 2)
        while T * W * R * value.dtype.itemsize > max_bytes \
                and W > 2 * stride:
            W -= stride
        lc = disp - c0
        fits = (lc >= 0) & (lc < W)

        slab = np.zeros((T, W, R), dtype=value.dtype)
        fr = rows[fits] - t_of[fits] * R
        np.add.at(slab, (t_of[fits], lc[fits], fr), value[fits])

        rem = None
        nrem = int((~fits).sum())
        if nrem:
            import scipy.sparse as sp
            sel = ~fits
            rmm = sp.coo_matrix((value[sel], (rows[sel], index[sel])),
                                shape=shape).tocsr()
            rmm.sort_indices()
            rem = CSRMatrix.from_csr_arrays(rmm.indptr, rmm.indices,
                                            rmm.data, shape)
        return cls(slab=jnp.asarray(slab), rem=rem, nrows=n, ncols=m,
                   nnz=int(len(value)), R=R, W=int(W), c0=int(c0),
                   stride=int(stride))

    @property
    def fill_blowup(self) -> float:
        """Slab elements per true nonzero (traffic multiplier vs CSR)."""
        T, W, R = self.slab.shape
        return T * W * R / max(self.nnz, 1)

    def to_csr_arrays(self):
        import scipy.sparse as sp
        s = host(self.slab)
        T, W, R = s.shape
        t, w, r = np.nonzero(s)
        grow = t * R + r
        gcol = t * self.s + self.c0 + w
        keep = (grow < self.nrows) & (gcol >= 0) & (gcol < self.ncols)
        a = sp.coo_matrix((s[t, w, r][keep], (grow[keep], gcol[keep])),
                          shape=self.shape).tocsr()
        if self.rem is not None:
            rp, ri, rv = self.rem.to_csr_arrays()
            a = (a + sp.csr_matrix((np.asarray(rv), np.asarray(ri),
                                    np.asarray(rp)),
                                   shape=self.shape)).tocsr()
        a.sort_indices()
        return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                a.data)

    # ---- device compute -------------------------------------------------
    def _windows(self, x):
        """(T, W) sliding windows xw[t, j] = x[t*s + c0 + j] from W/s
        shifted contiguous reshapes (gather-free; s = column stride)."""
        s, W, c0 = self.s, self.W, self.c0
        T = self.slab.shape[0]
        lo = max(-c0, 0)
        hi = max((T - 1) * s + c0 + W - self.ncols, 0) + s
        base = c0 + lo                      # >= 0 by construction
        xpad = jnp.pad(x, (lo, hi))
        parts = [jax.lax.dynamic_slice(xpad, (base + c * s,), (T * s,))
                 .reshape(T, s) for c in range(W // s)]
        return jnp.concatenate(parts, axis=1)

    def matvec(self, x):
        xw = self._windows(x.astype(self.slab.dtype)
                           if x.dtype != self.slab.dtype else x)
        y = jnp.sum(self.slab * xw[:, :, None], axis=1)   # sublane reduce
        y = y.reshape(-1)[: self.nrows]
        if self.rem is not None:
            y = y + self.rem.matvec(x)
        return y

    def matvech(self, x):
        sl = jnp.conj(self.slab) if jnp.iscomplexobj(self.slab) \
            else self.slab
        T, W, R = sl.shape
        s = self.s
        xr = jnp.pad(x, (0, T * R - self.nrows)).reshape(T, R)
        win = jnp.sum(sl * xr[:, None, :], axis=2)         # (T, W)
        # overlap-add the windows: y[t*s + c0 + w] += win[t, w]
        lo = max(-self.c0, 0)
        hi = max((T - 1) * s + self.c0 + W - self.ncols, 0) + s
        base = self.c0 + lo
        y = jnp.zeros(lo + self.ncols + hi, dtype=win.dtype)
        for c in range(W // s):
            seg = win[:, c * s:(c + 1) * s].reshape(-1)
            cur = jax.lax.dynamic_slice(y, (base + c * s,), (T * s,))
            y = jax.lax.dynamic_update_slice(y, cur + seg, (base + c * s,))
        y = y[lo: lo + self.ncols]
        if self.rem is not None:
            y = y + self.rem.matvech(x)
        return y

    def get_diagonal(self):
        # global col == global row  =>  w == r - c0 (square, stride == R)
        if self.s != self.R:
            from lis_tpu.matrix.base import SparseMatrix as _S
            return _S.get_diagonal(self)
        T, W, R = self.slab.shape
        r = jnp.arange(R)
        w = r - self.c0
        ok = (w >= 0) & (w < W)
        d = jnp.where(ok, self.slab[:, jnp.clip(w, 0, W - 1), r], 0.0)
        d = d.reshape(-1)[: self.nrows]
        if self.rem is not None:
            d = d + self.rem.get_diagonal()
        return d

    def scale_rows(self, d):
        """Row scaling on device: slab[t, :, r] *= d[t*R + r] (no host
        CSR round trip)."""
        import dataclasses
        T, W, R = self.slab.shape
        d = jnp.asarray(d)
        dr = jnp.pad(d, (0, T * R - self.nrows)).reshape(T, 1, R)
        out = dataclasses.replace(self, slab=self.slab
                                  * dr.astype(self.slab.dtype))
        if self.rem is not None:
            out = dataclasses.replace(out, rem=self.rem.scale_rows(d))
        return out

    def scale_symm(self, dsqrt_inv):
        """D^-1/2 A D^-1/2 on device: row factor d[t*R+r], column factor
        d[t*R+c0+w] (the sliding windows of d)."""
        import dataclasses
        T, W, R = self.slab.shape
        d = jnp.asarray(dsqrt_inv)
        dr = jnp.pad(d, (0, T * R - self.nrows)).reshape(T, 1, R)
        dw = self._windows(d)[:, :, None]           # (T, W, 1)
        slab = self.slab * (dr * dw).astype(self.slab.dtype)
        out = dataclasses.replace(self, slab=slab)
        if self.rem is not None:
            out = dataclasses.replace(out, rem=self.rem.scale_symm(d))
        return out


class MultiBESMatrix(SparseMatrix):
    """Sum of BES slabs with different window intercepts (same stride).

    3-D stencil structure — and the prolongators of aggregated 3-D
    operators — puts columns in a FEW affine bands (one per plane
    neighbour): col ~ t*stride + {c0_1, c0_2, c0_3}.  One wide window
    would be mostly padding; a few NARROW windows at the band intercepts
    cover it at low blowup, each gather-free.  Built greedily: the
    cost-model single-window builder runs on the still-uncovered
    entries until the remainder is small or the window budget is spent.
    """

    def __init__(self, parts, rem, nrows, ncols, nnz):
        self.parts = tuple(parts)      # BESMatrix instances (rem=None)
        self.rem = rem                 # CSRMatrix or None
        self.nrows = nrows
        self.ncols = ncols
        self.nnz = nnz

    format_name = "mbes"

    def tree_flatten(self):
        return ((self.parts, self.rem), (self.nrows, self.ncols, self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, c):
        return cls(c[0], c[1], *aux)

    @property
    def fill_blowup(self):
        slots = sum(int(np.prod(p.slab.shape)) for p in self.parts)
        return slots / max(self.nnz, 1)

    def matvec(self, x):
        y = self.parts[0].matvec(x)
        for p in self.parts[1:]:
            y = y + p.matvec(x)
        if self.rem is not None:
            y = y + self.rem.matvec(x)
        return y

    def matvech(self, x):
        y = self.parts[0].matvech(x)
        for p in self.parts[1:]:
            y = y + p.matvech(x)
        if self.rem is not None:
            y = y + self.rem.matvech(x)
        return y

    def get_diagonal(self):
        d = self.parts[0].get_diagonal()
        for p in self.parts[1:]:
            d = d + p.get_diagonal()
        if self.rem is not None:
            d = d + self.rem.get_diagonal()
        return d

    def to_csr_arrays(self):
        import scipy.sparse as sp
        a = None
        for p in list(self.parts) + ([self.rem] if self.rem is not None
                                     else []):
            pp, pi, pv = p.to_csr_arrays()
            m = sp.csr_matrix((np.asarray(pv), np.asarray(pi),
                               np.asarray(pp)), shape=self.shape)
            a = m if a is None else (a + m).tocsr()
        a.sort_indices()
        return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                a.data)

    def scale_rows(self, d):
        return MultiBESMatrix([p.scale_rows(d) for p in self.parts],
                              None if self.rem is None
                              else self.rem.scale_rows(d),
                              self.nrows, self.ncols, self.nnz)

    def scale_symm(self, dsqrt_inv):
        return MultiBESMatrix([p.scale_symm(dsqrt_inv)
                               for p in self.parts],
                              None if self.rem is None
                              else self.rem.scale_symm(dsqrt_inv),
                              self.nrows, self.ncols, self.nnz)


jax.tree_util.register_pytree_node(
    MultiBESMatrix,
    lambda m: m.tree_flatten(),
    MultiBESMatrix.tree_unflatten)


def multi_bes_from_csr(ptr, index, value, shape, R: int = R_DEFAULT,
                       stride: int | None = None, max_windows: int = 4,
                       w_max: int = 4096, max_bytes: int = 4 << 30):
    """Greedy multi-window BES build: repeatedly run the single-window
    cost-model builder on the uncovered entries.  Returns a BESMatrix
    (one window sufficed), a MultiBESMatrix, or raises if nothing
    covers."""
    import scipy.sparse as sp
    from lis_tpu.matrix.csr import CSRMatrix
    n, m = shape
    cur_p = np.asarray(ptr)
    cur_i = np.asarray(index)
    cur_v = np.asarray(value)
    total_nnz = len(cur_v)
    parts = []
    budget = max_bytes
    for _ in range(max_windows):
        if len(cur_v) == 0:
            break
        B = BESMatrix.from_csr_arrays(cur_p, cur_i, cur_v, shape, R=R,
                                      stride=stride, w_max=w_max,
                                      max_bytes=budget)
        covered = B.nnz - (B.rem.nnz if B.rem is not None else 0)
        if covered <= 0.05 * len(cur_v) and parts:
            break                       # diminishing returns
        budget -= int(np.prod(B.slab.shape)) * cur_v.dtype.itemsize
        rem = B.rem
        parts.append(dataclasses_replace_rem_none(B))
        if rem is None:
            cur_p = np.zeros(n + 1, dtype=np.int32)
            cur_i = np.zeros(0, dtype=np.int32)
            cur_v = np.zeros(0, dtype=cur_v.dtype)
            break
        cur_p, cur_i, cur_v = [np.asarray(a) for a in rem.to_csr_arrays()]
        if budget <= 0:
            break
    rem = None
    if len(cur_v):
        rm = sp.csr_matrix((cur_v, cur_i, cur_p), shape=shape)
        rm.sort_indices()
        rem = CSRMatrix.from_csr_arrays(rm.indptr, rm.indices, rm.data,
                                        shape)
    if len(parts) == 1:
        import dataclasses
        return dataclasses.replace(parts[0], rem=rem, nnz=total_nnz)
    return MultiBESMatrix(parts, rem, n, m, total_nnz)


def dataclasses_replace_rem_none(B):
    import dataclasses
    covered = B.nnz - (B.rem.nnz if B.rem is not None else 0)
    return dataclasses.replace(B, rem=None, nnz=covered)
