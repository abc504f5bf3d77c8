"""Double-double ("quad") arithmetic — error-free transforms on array pairs.

Reference: src/precision/ — the scalar is a (hi, lo) double pair
(include/lis.h:295-311) with TWO_SUM (include/lis_precision.h:94),
TWO_DIFF (:105), SPLIT (:116), TWO_PROD (:128), QUAD_ADD/MUL/DIV/SQRT/FMA
(:162-296); vector kernels in src/precision/lis_precision_vec.c
(axpyex_mmm:82, dotex_mmm:265, nrm2ex_mm:387) and quad SpMV
(lis_precision_matvec.c:55).  MPI reduces with a custom two-double sum op
(lis_mpi_msum, lis_precision_vec.c:778).

Here a DD value is a pytree pair of arrays (hi, lo).  The error-free
transforms are branch-free elementwise code, so whole DD-BLAS1 expressions
fuse.  TWO_PROD splits by masking significand bits and sums exact partial
products, so it stays exact whether or not the compiler contracts a
multiply and an add into an FMA.  The psum reduction sums hi/lo parts
with a compensated final renormalisation, the analogue of the custom MPI
op.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

def _nb(x):
    """Optimization barrier: stops XLA's algebraic simplifier from folding
    the error-free transforms (without it, jitted two_sum/two_prod collapse
    to their real-arithmetic values and DD silently degrades to double —
    observed: quad BiCG stalls instead of reproducing the reference's
    finite-termination convergence)."""
    return jax.lax.optimization_barrier(x)


class DD(NamedTuple):
    """Double-double number/array: value = hi + lo, |lo| <= ulp(hi)/2."""
    hi: jax.Array
    lo: jax.Array

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape


def dd(hi, lo=None) -> DD:
    """Lift to a DD pair.  f32 input stays f32 (double-float pairs);
    everything else is cast to f64 pairs.
    A DD input passes through unchanged."""
    if isinstance(hi, DD):
        return hi
    hi = jnp.asarray(hi)
    if hi.dtype != jnp.float32:
        hi = hi.astype(jnp.float64)
    return DD(hi, jnp.zeros_like(hi) if lo is None else jnp.asarray(lo))


def to_float(x: DD):
    """Collapse to a plain float array.  f32 pairs are reconstructed in f64
    (when x64 is enabled) so the pair's full ~2^-48 accuracy survives."""
    import jax as _jax
    if x.hi.dtype == jnp.float32 and _jax.config.jax_enable_x64:
        return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)
    return x.hi + x.lo


def two_sum(a, b):
    """Knuth TWO_SUM (lis_precision.h:94)."""
    s = _nb(a + b)
    v = _nb(s - a)
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Fast path when |a| >= |b|."""
    s = _nb(a + b)
    e = b - (s - a)
    return s, e


def _split(a):
    """SPLIT (lis_precision.h:116) on the bits: ahi is a rounded to its
    leading 26 (f64) or 12 (f32) significand bits, and alo = a - ahi is
    exact and as short.

    Dekker's form (t = 2^27 a + a; ahi = t - (t - a)) rounds a product and
    subtracts from it, which a compiler may contract into one FMA — XLA's
    CPU and GPU code generators both do inside fusions — and then ahi is
    no longer short.  Rounding on the bits has no product to contract."""
    if a.dtype == jnp.float32:
        u, half, mask = jnp.uint32, 0x800, 0xFFFFF000
    else:
        u, half, mask = jnp.uint64, 0x4000000, 0xFFFFFFFFF8000000
    bits = jax.lax.bitcast_convert_type(a, u)
    ahi = jax.lax.bitcast_convert_type((bits + u(half)) & u(mask), a.dtype)
    return ahi, a - ahi


def two_prod(a, b):
    """TWO_PROD (lis_precision.h:128), contraction-proof: with short
    halves every partial product is exact, so an FMA formed from any of
    them changes nothing; p and e then come from error-free sums of the
    partials.  p + e equals a*b up to one rounding of e (< 2^-105 |ab|
    for f64), the unit of the DD arithmetic itself."""
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    s, e1 = two_sum(ahi * bhi, ahi * blo)
    s, e2 = two_sum(s, alo * bhi)
    p, e3 = two_sum(s, alo * blo)
    return quick_two_sum(p, (e1 + e2) + e3)


# ---- DD scalar/elementwise ops (QUAD_ADD / QUAD_MUL / ... equivalents) ----

def add(x: DD, y: DD) -> DD:
    """Accurate QUAD_ADD (lis_precision.h:186-193, the non-FAST default):
    two TWO_SUMs with double renormalisation."""
    sh, eh = two_sum(x.hi, y.hi)
    sl, el = two_sum(x.lo, y.lo)
    eh = eh + sl
    sh, eh = quick_two_sum(sh, eh)
    eh = eh + el
    sh, eh = quick_two_sum(sh, eh)
    return DD(sh, eh)


def sub(x: DD, y: DD) -> DD:
    return add(x, neg(y))


def neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    p, e = quick_two_sum(p, e)
    return DD(p, e)


def mul_d(x: DD, a) -> DD:
    """DD * double."""
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    p, e = quick_two_sum(p, e)
    return DD(p, e)


def div(x: DD, y: DD) -> DD:
    """QUAD_DIV (lis_precision.h): Newton-corrected quotient."""
    q1 = x.hi / y.hi
    r = sub(x, mul_d(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_d(y, q2))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    s, e = two_sum(s, q3 + e)
    return DD(s, e)


def sqrt(x: DD) -> DD:
    """QUAD_SQRT: one Newton step on the double sqrt."""
    s = jnp.sqrt(x.hi)
    safe = jnp.where(s == 0, 1.0, s)
    p, e = two_prod(safe, safe)
    d = DD(x.hi - p, x.lo - e)
    corr = (d.hi + d.lo) / (2.0 * safe)
    hi, lo = quick_two_sum(safe, corr)
    return DD(jnp.where(s == 0, 0.0, hi), jnp.where(s == 0, 0.0, lo))


def where(c, x: DD, y: DD) -> DD:
    return DD(jnp.where(c, x.hi, y.hi), jnp.where(c, x.lo, y.lo))


def zeros_like(x: DD) -> DD:
    return DD(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))


# ---- DD BLAS-1 (lis_precision_vec.c equivalents) ---------------------------

def axpy(alpha: DD, x: DD, y: DD) -> DD:
    """y + alpha*x (axpyex_mmm)."""
    return add(y, mul(_bcast(alpha, x), x))


def xpay(x: DD, alpha: DD, y: DD) -> DD:
    return add(x, mul(_bcast(alpha, y), y))


def scal(alpha: DD, x: DD) -> DD:
    return mul(_bcast(alpha, x), x)


def _bcast(a: DD, like: DD) -> DD:
    if a.hi.ndim == like.hi.ndim:
        return a
    # barrier the broadcast: XLA otherwise sinks it through the error-free
    # transforms and collapses the scalar·vector DD product to double
    return DD(_nb(jnp.broadcast_to(a.hi, like.hi.shape)),
              _nb(jnp.broadcast_to(a.lo, like.lo.shape)))


def _dd_sum(x: DD, axis_name=None) -> DD:
    """Reduction of a DD array to a DD scalar via a pairwise two_sum tree —
    fully vectorised (log₂ n elementwise steps), error O(log n · ulp²).  With an
    axis_name the per-shard partials are all_gathered and tree-reduced —
    the analogue of the custom lis_mpi_msum reduction op."""
    hi = x.hi.reshape(-1)
    lo = x.lo.reshape(-1)
    n = hi.shape[0]
    m = 1 << max((n - 1).bit_length(), 0) if n > 1 else 1
    if m != n:
        hi = jnp.concatenate([hi, jnp.zeros(m - n, hi.dtype)])
        lo = jnp.concatenate([lo, jnp.zeros(m - n, lo.dtype)])
    while m > 1:
        half = m // 2
        s = add(DD(hi[:half], lo[:half]), DD(hi[half:], lo[half:]))
        hi, lo = s.hi, s.lo
        m = half
    s, e = hi[0], lo[0]
    if axis_name is not None:
        s_all = jax.lax.all_gather(s, axis_name)
        e_all = jax.lax.all_gather(e, axis_name)
        p = s_all.shape[0]
        p2 = 1 << max((p - 1).bit_length(), 0) if p > 1 else 1
        if p2 != p:
            s_all = jnp.concatenate([s_all, jnp.zeros(p2 - p, s_all.dtype)])
            e_all = jnp.concatenate([e_all, jnp.zeros(p2 - p, e_all.dtype)])
            p = p2
        while p > 1:
            half = p // 2
            red = add(DD(s_all[:half], e_all[:half]),
                      DD(s_all[half:], e_all[half:]))
            s_all, e_all = red.hi, red.lo
            p = half
        s, e = s_all[0], e_all[0]
    s, e = quick_two_sum(s, e)
    return DD(s, e)


def dot(x: DD, y: DD, axis_name=None) -> DD:
    """dotex_mmm: elementwise DD products then compensated sum."""
    return _dd_sum(mul(x, y), axis_name)


def nrm2(x: DD, axis_name=None) -> DD:
    return sqrt(_dd_sum(mul(x, x), axis_name))


def nrm1(x: DD, axis_name=None) -> DD:
    return _dd_sum(DD(jnp.abs(x.hi), jnp.sign(x.hi) * x.lo), axis_name)


# ---- DD SpMV (lis_precision_matvec.c equivalent) ---------------------------

def _dd_row_reduce(p, e) -> DD:
    """(n, m) DD entries -> (n,) exact row sums via a pairwise two_sum tree
    along axis 1 (the vectorised analogue of the reference's per-row
    QUAD_FMA accumulation chain)."""
    m = p.shape[1]
    while m > 1:
        if m % 2:
            p = jnp.pad(p, ((0, 0), (0, 1)))
            e = jnp.pad(e, ((0, 0), (0, 1)))
            m += 1
        half = m // 2
        s = add(DD(p[:, :half], e[:, :half]), DD(p[:, half:], e[:, half:]))
        p, e = s.hi, s.lo
        m = half
    return DD(p[:, 0], e[:, 0])


def _split_limbs(value, limb):
    """f64 values -> (hi, lo) limb pairs in the requested limb dtype, so the
    operator itself carries full precision (casting A to single f32 would
    perturb the system by ~1e-7 relative)."""
    if limb is None or value.dtype == limb:
        return value, None
    vhi = value.astype(limb)
    vlo = (value - vhi.astype(value.dtype)).astype(limb)
    return vhi, vlo


def matvec_dd_ell(index, value, x: DD, value_lo=None) -> DD:
    """y = A x with a double ELL matrix (n, maxnzr) and DD vector:
    gather both limbs, TWO_PROD per entry, exact DD tree reduction per
    row.  This preserves the full double-double accumulation quality the
    quad solvers depend on."""
    xg_hi = jnp.take(x.hi, index, axis=0)
    xg_lo = jnp.take(x.lo, index, axis=0)
    p, e = two_prod(value, xg_hi)
    e = e + value * xg_lo
    if value_lo is not None:
        e = e + value_lo * xg_hi
    return _dd_row_reduce(p, e)


class DDOperator:
    """Matrix wrapped for DD matvec/matvech: ELL views of A and Aᴴ.
    With limb=float32 the values are stored as f32 pairs (double-float)."""

    def __init__(self, index, value, index_t, value_t,
                 value_lo=None, value_t_lo=None):
        self.index = index
        self.value = value
        self.index_t = index_t
        self.value_t = value_t
        self.value_lo = value_lo
        self.value_t_lo = value_t_lo

    def matvec(self, x: DD) -> DD:
        return matvec_dd_ell(self.index, self.value, x, self.value_lo)

    def matvech(self, x: DD) -> DD:
        return matvec_dd_ell(self.index_t, self.value_t, x, self.value_t_lo)

    @classmethod
    def from_matrix(cls, A, limb=None) -> "DDOperator":
        from lis_tpu.matrix.convert import convert_matrix
        from lis_tpu.matrix.ell import ELLMatrix
        ell = convert_matrix(A, "ell")
        ell_t = ELLMatrix.from_csr_arrays(
            *convert_matrix(A, "csr").transpose().to_csr_arrays(),
            (A.shape[1], A.shape[0]))
        v, vlo = _split_limbs(ell.value, limb)
        vt, vtlo = _split_limbs(ell_t.value, limb)
        return cls(ell.index, v, ell_t.index, vt, vlo, vtlo)


jax.tree_util.register_pytree_node(
    DDOperator,
    lambda o: ((o.index, o.value, o.index_t, o.value_t, o.value_lo,
                o.value_t_lo), None),
    lambda aux, c: DDOperator(*c))


class DDDiaOperator:
    """DIA (stencil) operator for DD matvec: per-diagonal two_prod streams,
    no gathers — the DD lift of the DIA SpMV (the ELL DDOperator serves
    general sparsity)."""

    def __init__(self, offsets, value, nrows, ncols, value_lo=None):
        self.offsets = offsets          # static tuple of ints
        self.value = value              # tuple of (n,) per-diagonal arrays
        self.nrows = nrows
        self.ncols = ncols
        self.value_lo = value_lo        # tuple of (n,) second limbs or None

    def _mv(self, offsets, value, x: DD, value_lo=None) -> DD:
        n = self.nrows
        pad = max((abs(o) for o in offsets), default=1) or 1
        zp = lambda a: jnp.pad(a, (pad, pad))
        xh, xl = zp(x.hi), zp(x.lo)
        acc = DD(jnp.zeros(n, x.hi.dtype), jnp.zeros(n, x.hi.dtype))
        for k, off in enumerate(offsets):
            sh = jax.lax.dynamic_slice(xh, (pad + off,), (n,))
            sl = jax.lax.dynamic_slice(xl, (pad + off,), (n,))
            ph, pe = two_prod(value[k], sh)
            pe = pe + value[k] * sl
            if value_lo is not None:
                pe = pe + value_lo[k] * sh
            acc = add(acc, DD(ph, pe))
        return acc

    def matvec(self, x: DD) -> DD:
        return self._mv(self.offsets, self.value, x, self.value_lo)

    def matvech(self, x: DD) -> DD:
        # Aᵀ[i, i-o] = A[i-o, i] = value[k, i-o]: negate each offset and
        # shift its value stream by +o with zero fill (no wraparound)
        offs = tuple(-o for o in self.offsets)

        def shift(vrow, off):
            if jnp.iscomplexobj(vrow):
                vrow = jnp.conj(vrow)
            if off > 0:
                return jnp.concatenate([jnp.zeros(off, vrow.dtype),
                                        vrow[:-off]])
            if off < 0:
                return jnp.concatenate([vrow[-off:],
                                        jnp.zeros(-off, vrow.dtype)])
            return vrow

        vt = tuple(shift(self.value[k], off)
                   for k, off in enumerate(self.offsets))
        vt_lo = (None if self.value_lo is None else
                 tuple(shift(self.value_lo[k], off)
                       for k, off in enumerate(self.offsets)))
        op = DDDiaOperator(offs, vt, self.ncols, self.nrows, vt_lo)
        return op._mv(offs, vt, x, vt_lo)

    @classmethod
    def from_matrix(cls, A, limb=None) -> "DDDiaOperator":
        pairs = [_split_limbs(vk, limb) for vk in A.value]
        v = tuple(p[0] for p in pairs)
        vlo = (None if (not pairs or pairs[0][1] is None)
               else tuple(p[1] for p in pairs))
        return cls(tuple(int(o) for o in A.offsets), v,
                   A.nrows, A.ncols, vlo)


jax.tree_util.register_pytree_node(
    DDDiaOperator,
    lambda o: ((o.value, o.value_lo), (o.offsets, o.nrows, o.ncols)),
    lambda aux, c: DDDiaOperator(aux[0], c[0], aux[1], aux[2], c[1]))




class DDBesOperator:
    """BES (dense sliding slab) operator for DD matvec.  The slab product
    accumulates in f64 — one f64 accumulation at 2^-53 is tighter than
    the f32-pair DD unit roundoff
    of ~2^-48 — then splits the result back into the f32 limb pair the DD
    solvers carry.  Keeps general-sparsity matrices on the gather-free
    slab path under -f df / -f switch_df."""

    def __init__(self, bes, slab64):
        self.bes = bes              # BESMatrix (f32 slab, window plumbing)
        self.slab64 = slab64        # (T, W, R) float64

    def _mv(self, x: DD, transpose: bool) -> DD:
        import jax
        b = self.bes
        xs = x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)
        if not transpose:
            xw = b._windows(xs)
            y = jnp.sum(self.slab64 * xw[:, :, None], axis=1)
            y = y.reshape(-1)[: b.nrows]
        else:
            T, W, R = self.slab64.shape
            xr = jnp.pad(xs, (0, T * R - b.nrows)).reshape(T, R)
            win = jnp.sum(self.slab64 * xr[:, None, :], axis=2)
            lo = max(-b.c0, 0)
            hi = max((T - 1) * R + b.c0 + W - b.ncols, 0) + R
            base = b.c0 + lo
            y = jnp.zeros(lo + b.ncols + hi, dtype=jnp.float64)
            for c in range(W // R):
                seg = win[:, c * R:(c + 1) * R].reshape(-1)
                cur = jax.lax.dynamic_slice(y, (base + c * R,), (T * R,))
                y = jax.lax.dynamic_update_slice(y, cur + seg,
                                                 (base + c * R,))
            y = y[lo: lo + b.ncols]
        if b.rem is not None:
            rp = b.rem.matvech(xs) if transpose else b.rem.matvec(xs)
            y = y + rp.astype(jnp.float64)
        h = y.astype(x.hi.dtype)
        return DD(h, (y - h.astype(jnp.float64)).astype(x.hi.dtype))

    def matvec(self, x: DD) -> DD:
        return self._mv(x, False)

    def matvech(self, x: DD) -> DD:
        return self._mv(x, True)

    @property
    def nrows(self):
        return self.bes.nrows

    @property
    def ncols(self):
        return self.bes.ncols

    @classmethod
    def from_matrix(cls, A, limb=None) -> "DDBesOperator":
        slab64 = A.slab.astype(jnp.float64)
        return cls(A, slab64)


jax.tree_util.register_pytree_node(
    DDBesOperator,
    lambda o: ((o.bes, o.slab64), None),
    lambda aux, c: DDBesOperator(*c))

class DDF64Operator:
    """Generic DD operator: run the format's OWN matvec with all float
    leaves lifted to (emulated) f64, split the result back to the limb
    pair.  Used for composite formats (multi-window BES) whose dedicated
    DD kernels would be redundant — same accuracy rationale as
    DDBesOperator."""

    def __init__(self, A64):
        self.A64 = A64

    def _mv(self, x, transpose):
        xs = x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)
        y = self.A64.matvech(xs) if transpose else self.A64.matvec(xs)
        h = y.astype(x.hi.dtype)
        return DD(h, (y - h.astype(jnp.float64)).astype(x.hi.dtype))

    def matvec(self, x):
        return self._mv(x, False)

    def matvech(self, x):
        return self._mv(x, True)

    @classmethod
    def from_matrix(cls, A, limb=None):
        import jax
        A64 = jax.tree.map(
            lambda a: a.astype(jnp.float64)
            if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
            else a, A)
        return cls(A64)


jax.tree_util.register_pytree_node(
    DDF64Operator, lambda o: ((o.A64,), None),
    lambda aux, c: DDF64Operator(*c))


def make_dd_operator(A, limb=None):
    """Wrap a format object for DD iterations: DIA stays DIA (stream
    kernel), BES/multi-BES stay on their slab paths (f64-emulated
    accumulation), and everything else goes through the ELL gather pair.
    With limb=float32 the operator carries its values as f32 pairs
    ("double-float") so no precision is lost casting the system."""
    fmt = getattr(A, "format_name", None)
    if fmt == "dia":
        return DDDiaOperator.from_matrix(A, limb)
    if fmt == "bes":
        return DDBesOperator.from_matrix(A, limb)
    if fmt == "mbes":
        return DDF64Operator.from_matrix(A, limb)
    return DDOperator.from_matrix(A, limb)


def matvec_dd(A, x: DD) -> DD:
    """y = A x; A is a DD operator (driver wraps matrices for quad runs)."""
    return A.matvec(x)


def matvech_dd(A, x: DD) -> DD:
    return A.matvech(x)
