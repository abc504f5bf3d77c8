"""SA-AMG — smoothed-aggregation algebraic multigrid preconditioner.

Reference: the one Fortran-90 component (src/fortran/amg/, 12.5k LoC):
setup = independent-set aggregation (lis_m_aggregate_mod.F90:45) +
smoothed prolongator + Galerkin RAP coarse matrices
(lis_m_data_creation_AMGCG.F90:61), apply = V-cycle with symmetric
Gauss-Seidel smoothing and a direct coarsest solve
(v_cycle_ssi_amg / sgs / ll_slv, lis_m_solver_AMGCG.F90:50+).
Options: -saamg_theta (strength threshold, 0.05), -saamg_unsym.

Design: the irregular graph work (strength-of-connection, greedy
aggregation, RAP) runs once on host with scipy; each level becomes a
static pytree (CSR operator + prolongator + SGS trisolve plans), and the
V-cycle unrolls over the static level list inside jit — per level it is
SpMV + two level-scheduled triangular sweeps, all device-resident.  The
coarsest level applies a precomputed dense inverse.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from lis_tpu.matrix.csr import CSRMatrix
from lis_tpu.ops.trisolve import TriSolvePlan, make_plan, trisolve
from lis_tpu.precon.base import register_precon


@dataclass(frozen=True)
class AMGLevel:
    A: CSRMatrix
    P: CSRMatrix              # prolongator level l+1 -> l
    fwd: TriSolvePlan         # (D+L) plan for SGS pre/post smoothing
    bwd: TriSolvePlan         # (D+U) plan
    dinv: object = None       # 1/diag for the weighted-Jacobi smoother
    Ls: object = None         # strict-lower DIA (relaxed-sweep SGS)
    Us: object = None         # strict-upper DIA
    R: object = None          # Petrov-Galerkin restriction (-saamg_unsym:
                              # smoothed with A^T; None -> use P^T)
    fwdh: object = None       # (D+L(Aᵀ)) = (D+U)ᵀ plan — the unsym
    bwdh: object = None       # (D+U(Aᵀ)) = (D+L)ᵀ plan   adjoint cycle

jax.tree_util.register_pytree_node(
    AMGLevel,
    lambda l: ((l.A, l.P, l.fwd, l.bwd, l.dinv, l.Ls, l.Us, l.R,
                l.fwdh, l.bwdh), None),
    lambda aux, c: AMGLevel(*c))


@dataclass(frozen=True)
class SAAMGPrecon:
    levels: tuple             # tuple[AMGLevel]
    coarse_inv: jax.Array     # dense inverse of the coarsest operator
    smoother: str = "sgs"     # "sgs" (reference parity) | "jacobi"
                              # (pure streams, where level-scheduled
                              # trisolves gather)

    def _gs(self, level, b, lower, nsweeps=2):
        """One (relaxed) Gauss-Seidel half-sweep solve (D+T)x = b: exact
        level-scheduled plan when present, else Jacobi-relaxed diagonal
        sweeps on the split DIA triangle (the reference's own OpenMP
        relaxation precedent, lis_matrix_csr.c:1577-1605) — every op a
        diagonal stream, no gathers."""
        if level.Ls is not None:
            T = level.Ls if lower else level.Us
            x = b * level.dinv
            for _ in range(nsweeps):
                x = (b - T.matvec(x)) * level.dinv
            return x
        return trisolve(level.fwd if lower else level.bwd, b)

    def _presmooth(self, level, b):
        if self.smoother == "jacobi":
            w = 2.0 / 3.0
            x = w * level.dinv * b
            return x + w * level.dinv * (b - level.A.matvec(x))
        x = self._gs(level, b, lower=True)
        return x + self._gs(level, b - level.A.matvec(x), lower=False)

    def _postsmooth(self, level, x, b):
        if self.smoother == "jacobi":
            w = 2.0 / 3.0
            x = x + w * level.dinv * (b - level.A.matvec(x))
            return x + w * level.dinv * (b - level.A.matvec(x))
        x = x + self._gs(level, b - level.A.matvec(x), lower=True)
        return x + self._gs(level, b - level.A.matvec(x), lower=False)

    def _cycle(self, lev: int, b):
        if lev == len(self.levels):
            return jnp.matmul(self.coarse_inv, b, precision="highest")
        level = self.levels[lev]
        x = self._presmooth(level, b)
        # coarse-grid correction
        r = b - level.A.matvec(x)
        rc = (level.R.matvec(r) if level.R is not None
              else level.P.matvech(r))
        ec = self._cycle(lev + 1, rc)
        x = x + level.P.matvec(ec)
        return self._postsmooth(level, x, b)

    # ---- adjoint cycle (the -saamg_unsym Petrov-Galerkin hierarchy makes
    # M nonsymmetric, so BiCG-family psolveh must apply M^-T exactly).
    # Because Post_x = I - F A (post-smoothing is two corrections of the
    # same smoother F the pre-smoother applies), the adjoint of the
    # V-cycle is ITSELF a V-cycle of identical shape on the transposed
    # hierarchy: A -> Aᵀ, prolongator -> Rᵀ, restriction -> Pᵀ, and the
    # SGS half-sweeps swap triangles ((D+L(Aᵀ)) = (D+U)ᵀ etc.).
    def _gs_h(self, level, b, lower, nsweeps=2):
        if level.Ls is not None:
            # transpose of the truncated Neumann sweeps: Σ D⁻¹(-TᵀD⁻¹)^j.
            # The adjoint swaps triangles: the "lower" solve of the
            # transposed cycle is G_Uᵀ, built from Us (matching the plan
            # branch's fwdh = (D+L(Aᵀ)) = (D+U)ᵀ).  Unreached today —
            # Ls/Us exist only on lattice levels and the lattice path is
            # disabled for -saamg_unsym — but kept adjoint-correct.
            T = level.Us if lower else level.Ls
            z = b
            for _ in range(nsweeps):
                z = b - T.matvech(level.dinv * z)
            return level.dinv * z
        return trisolve(level.fwdh if lower else level.bwdh, b)

    def _presmooth_h(self, level, b):
        if self.smoother == "jacobi":
            w = 2.0 / 3.0
            x = w * level.dinv * b
            return x + w * level.dinv * (b - level.A.matvech(x))
        x = self._gs_h(level, b, lower=True)
        return x + self._gs_h(level, b - level.A.matvech(x), lower=False)

    def _postsmooth_h(self, level, x, b):
        if self.smoother == "jacobi":
            w = 2.0 / 3.0
            x = x + w * level.dinv * (b - level.A.matvech(x))
            return x + w * level.dinv * (b - level.A.matvech(x))
        x = x + self._gs_h(level, b - level.A.matvech(x), lower=True)
        return x + self._gs_h(level, b - level.A.matvech(x), lower=False)

    def _cycle_h(self, lev: int, b):
        if lev == len(self.levels):
            return jnp.matmul(self.coarse_inv.T, b, precision="highest")
        level = self.levels[lev]
        x = self._presmooth_h(level, b)
        r = b - level.A.matvech(x)
        rc = level.P.matvech(r)                     # restriction = Pᵀ
        ec = self._cycle_h(lev + 1, rc)
        x = x + level.R.matvech(ec)                 # prolongation = Rᵀ
        return self._postsmooth_h(level, x, b)

    def psolve(self, r):
        return self._cycle(0, r)

    def psolveh(self, r):
        # symmetric-Galerkin hierarchy (R = Pᵀ, symmetric A): M is
        # symmetric because Post_x = I - F A with the same smoother F
        # pre and post, so the forward cycle IS the adjoint.  The
        # Petrov-Galerkin hierarchy runs the exact transposed cycle.
        if any(l.R is not None for l in self.levels):
            return self._cycle_h(0, r)
        return self._cycle(0, r)

jax.tree_util.register_pytree_node(
    SAAMGPrecon,
    lambda p: ((p.levels, p.coarse_inv), (p.smoother,)),
    lambda aux, c: SAAMGPrecon(c[0], c[1], aux[0]))


def _aggregate(S: sp.csr_matrix) -> np.ndarray:
    """Greedy independent-set aggregation (the reference's aggregate_mod
    scheme): pick unaggregated root nodes, absorb their strong neighbors,
    then attach leftovers to a neighboring aggregate.  Native C++ engine
    (O(nnz), production sizes) with this Python loop as the fallback."""
    from lis_tpu import _native
    out = _native.amg_aggregate(S.indptr, S.indices)
    if out is not None:
        return out[1].astype(np.int64)
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0
    # phase 1: roots whose strong neighborhood is unaggregated
    for i in range(n):
        if agg[i] != -1:
            continue
        neigh = S.indices[S.indptr[i]:S.indptr[i + 1]]
        if (agg[neigh] == -1).all():
            agg[i] = nagg
            agg[neigh] = nagg
            nagg += 1
    # phase 2: attach stragglers to an adjacent aggregate
    for i in range(n):
        if agg[i] != -1:
            continue
        neigh = S.indices[S.indptr[i]:S.indptr[i + 1]]
        hit = neigh[agg[neigh] != -1]
        if len(hit):
            agg[i] = agg[hit[0]]
        else:
            agg[i] = nagg
            nagg += 1
    return agg


def _strength(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    d = np.abs(A.diagonal())
    d[d == 0] = 1.0
    C = A.tocoo()
    keep = (np.abs(C.data) > theta * np.sqrt(d[C.row] * d[C.col])) \
        & (C.row != C.col)
    return sp.csr_matrix((np.ones(keep.sum()),
                          (C.row[keep], C.col[keep])), shape=A.shape)


# ---------------------------------------------------------------------------
# Lattice (structured) fast path
#
# The reference's aggregation on a lexicographic stencil operator produces
# geometric blobs; the streaming formulation is to RECOGNISE the
# lattice (dims recovered from the band offsets) and aggregate by 3x index
# boxes per dimension.  The tentative prolongator then never materialises:
# Pt x = broadcast (repeat 3x per dim, crop), Ptᵀ r = box-sum (pad,
# reshape, sum) — pure HBM streams — and the smoothed prolongator applies
# implicitly as P = (I - ω D⁻¹A) Pt, i.e. ONE fast fine-level matvec plus
# a stream.  This is what makes the V-cycle run at DIA-matvec speed
# instead of gather speed.
# ---------------------------------------------------------------------------

def detect_lattice(A_csr: sp.csr_matrix, max_band: int = 13):
    """Recover tensor-lattice dims (slowest..fastest) from the band
    offsets, or None.  A d-D lexicographic stencil operator has offsets
    {a + b*L + c*L*M : small a,b,c}; the positive offsets cluster around
    the strides, which this extracts by gap-splitting."""
    n = A_csr.shape[0]
    if A_csr.shape[0] != A_csr.shape[1] or n < 27:
        return None
    C = A_csr.tocoo()
    offs = np.unique(C.col - C.row)
    if len(offs) > 343:
        return None
    pos = offs[offs > 0]
    if len(pos) == 0:
        return None
    # split into clusters where the gap exceeds the current magnitude
    groups = [[int(pos[0])]]
    for o in pos[1:]:
        if o - groups[-1][-1] > max(2, groups[-1][-1]):
            groups.append([int(o)])
        else:
            groups[-1].append(int(o))
    if len(groups) > 3:
        return None
    r1 = groups[0][-1] if groups[0][0] <= max_band else 0
    if groups[0][0] > max_band:
        return None                      # no unit-stride band
    if r1 > max_band:
        return None
    strides = [1]
    for g in groups[1:]:
        strides.append(int(round(float(np.mean(g)))))
    # dims from strides
    for a, b in zip(strides, strides[1:]):
        if b % a != 0:
            return None
    if n % strides[-1] != 0:
        return None
    dims = []
    prev = n
    for s in reversed(strides):
        dims.append(prev // s)
        prev = s
    # dims is slowest..fastest already: (n/LM, LM/L, L) for strides [1,L,LM]
    if any(d < 3 for d in dims):
        return None
    # validate every offset decomposes with small digits
    sts = list(reversed(strides))        # [LM, L, 1]
    for o in offs:
        rem = int(o)
        for s in sts:
            d = int(round(rem / s))      # nearest digit (offsets can be
            rem -= d * s                 # e.g. -(LM+L+1): digits -1,-1,-1)
            if abs(d) > max(2, r1):
                return None
        if rem != 0:
            return None
    return tuple(int(d) for d in dims)


def _lattice_agg(fdims, cdims):
    """Aggregate ids (3x box decimation) for every fine index."""
    coords = np.unravel_index(np.arange(int(np.prod(fdims))), fdims)
    return np.ravel_multi_index([c // 3 for c in coords], cdims)


@dataclass(frozen=True)
class LatticeTent:
    """Tentative prolongator of a 3x-per-dim box decimation, applied as
    reshape/broadcast streams (no gathers, no materialised matrix).
    Pt[i, c] = wc[c] when box(i) == c, wc = 1/sqrt(|box|)."""
    wc: jax.Array             # (nc,) column normalisation
    fdims: tuple              # static fine dims, slowest..fastest
    cdims: tuple              # static coarse dims

    def matvec(self, xc):
        x = (xc * self.wc.astype(xc.dtype)).reshape(self.cdims)
        for ax in range(len(self.cdims)):
            x = jnp.repeat(x, 3, axis=ax)
        return x[tuple(slice(0, f) for f in self.fdims)].reshape(-1)

    def matvech(self, r):
        r_nd = jnp.pad(r.reshape(self.fdims),
                       [(0, 3 * c - f)
                        for f, c in zip(self.fdims, self.cdims)])
        shape = []
        for c in self.cdims:
            shape += [c, 3]
        s = r_nd.reshape(shape).sum(axis=tuple(
            range(1, 2 * len(self.cdims), 2)))
        return s.reshape(-1) * self.wc.astype(r.dtype)

jax.tree_util.register_pytree_node(
    LatticeTent,
    lambda t: ((t.wc,), (t.fdims, t.cdims)),
    lambda aux, c: LatticeTent(c[0], *aux))


@dataclass(frozen=True)
class ImplicitP:
    """Smoothed prolongator P = (I - ω D⁻¹A) Pt applied WITHOUT forming P:
    prolongation = tent-broadcast + one fine matvec, restriction
    Pᵀr = Ptᵀ(r - ω Aᵀ(D⁻¹r)) = one fine matvec + box-sum.  A is the
    level's fast (DIA/BES-routed) operator — the prolongator rides the
    streaming kernel instead of its own gather-bound sparsity."""
    A: object                 # fast fine-level operator
    dinv: jax.Array
    tent: LatticeTent
    omega: float = 2.0 / 3.0

    def matvec(self, xc):
        z = self.tent.matvec(xc)
        return z - self.omega * self.dinv.astype(z.dtype) * self.A.matvec(z)

    def matvech(self, r):
        z = r - self.omega * self.A.matvech(self.dinv.astype(r.dtype) * r)
        return self.tent.matvech(z)

jax.tree_util.register_pytree_node(
    ImplicitP,
    lambda p: ((p.A, p.dinv, p.tent), (p.omega,)),
    lambda aux, c: ImplicitP(*c, omega=aux[0]))


def build_hierarchy_lattice(A_csr: sp.csr_matrix, fdims,
                            max_levels: int = 12, coarse_size: int = 300):
    """Box-decimation hierarchy on a detected lattice: every level keeps
    lattice structure (the Galerkin coarse operator of a 3x box decimation
    is again a <=27-point stencil on the coarse lattice), so every level
    gets the streaming Pt and a DIA-routable operator."""
    levels = []
    A = A_csr.tocsr()
    dims = tuple(fdims)
    while (A.shape[0] > coarse_size and min(dims) >= 3
           and len(levels) < max_levels - 1):
        cdims = tuple((d + 2) // 3 for d in dims)
        agg = _lattice_agg(dims, cdims)
        nc = int(np.prod(cdims))
        counts = np.bincount(agg, minlength=nc).astype(float)
        wc = 1.0 / np.sqrt(counts)
        Pt = sp.csr_matrix((wc[agg], (np.arange(A.shape[0]), agg)),
                           shape=(A.shape[0], nc))
        dinv = 1.0 / np.where(A.diagonal() != 0, A.diagonal(), 1.0)
        P = (Pt - (2.0 / 3.0) * sp.diags(dinv) @ (A @ Pt)).tocsr()
        Ac = (P.T @ A @ P).tocsr()
        Ac.sort_indices()
        levels.append((A, P, dims, cdims, wc, dinv))
        A = Ac
        dims = cdims
    return levels, A


def build_hierarchy(A_csr: sp.csr_matrix, theta: float = 0.05,
                    max_levels: int = 10, coarse_size: int = 32,
                    unsym: bool = False):
    """Aggregation + smoothed prolongator + Galerkin RAP per level.

    unsym=True is the -saamg_unsym variant (reference
    data_creation_unsym_ssi_amg + smooth_aggregate_unsym/RAP_unsym,
    src/fortran/amg/lis_m_data_creation_AMGCG.F90:158): strength on the
    symmetrised graph, restriction smoothed with A^T (Petrov-Galerkin
    R A P coarse operators) instead of P^T."""
    levels = []
    A = A_csr.tocsr()
    while A.shape[0] > coarse_size and len(levels) < max_levels - 1:
        # adaptive strength threshold: a theta above the operator's
        # off-diagonal strength ratio (e.g. the 27-pt HPCG stencil at
        # 1/26 ~ 0.038 vs the 0.05 default) leaves every node isolated
        # and aggregation stalls — relax theta until coarsening happens
        th = theta
        Astr = (0.5 * (abs(A) + abs(A.T.tocsr()))).tocsr() if unsym else A
        while True:
            S = _strength(Astr, th)
            agg = _aggregate(S)
            nc = int(agg.max()) + 1
            if nc < A.shape[0] or th < 1e-4:
                break
            th = th / 4.0
        if nc >= A.shape[0]:      # aggregation stalled even at theta~0
            break
        # tentative piecewise-constant prolongator, column-normalised
        counts = np.bincount(agg, minlength=nc).astype(float)
        Pt = sp.csr_matrix((1.0 / np.sqrt(counts[agg]),
                            (np.arange(A.shape[0]), agg)),
                           shape=(A.shape[0], nc))
        # Jacobi smoothing: P = (I - ω D⁻¹ A) Pt, ω = 2/3
        dinv = 1.0 / np.where(A.diagonal() != 0, A.diagonal(), 1.0)
        P = (Pt - (2.0 / 3.0) * sp.diags(dinv) @ (A @ Pt)).tocsr()
        if unsym:
            # restriction smoothed with A^T: R = ((I - w D^-1 A^T) Pt)^T
            W = (Pt - (2.0 / 3.0) * sp.diags(dinv) @ (A.T.tocsr() @ Pt))
            R = W.T.tocsr()
            Ac = (R @ A @ P).tocsr()
        else:
            R = None
            Ac = (P.T @ A @ P).tocsr()
        Ac.sort_indices()
        levels.append((A, P, R))
        A = Ac
    return levels, A


def _sgs_plans(A: sp.csr_matrix):
    n = A.shape[0]
    C = A.tocoo()
    d = np.zeros(n)
    dm = C.row == C.col
    np.add.at(d, C.row[dm], C.data[dm])
    with np.errstate(divide="ignore"):
        dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)

    def tri(mask, lower):
        r, c, v = C.row[mask], C.col[mask], C.data[mask]
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        ptr = np.zeros(n + 1, dtype=np.int32)
        np.add.at(ptr, r + 1, 1)
        ptr = np.cumsum(ptr).astype(np.int32)
        return make_plan(ptr, c.astype(np.int32), v, dinv, lower=lower)

    return tri(C.row > C.col, True), tri(C.row < C.col, False)


def _fast_level_op(m):
    """Level operator through auto_storage (DIA/HDI/BES when the structure
    allows; CSR fallback)."""
    from lis_tpu.solvers.driver import auto_storage
    return auto_storage(CSRMatrix.from_csr_arrays(
        m.indptr, m.indices, m.data, m.shape))


def _lattice_levels(raw_levels, smoother):
    """Device levels for the lattice hierarchy: fast (DIA-routed) level
    operators, implicit streamed prolongators, relaxed-DIA SGS triangles
    when the operator routed to DIA (plan-based trisolve fallback)."""
    levels = []
    for (Al, Pl_unused, fd, cd, wc, dinv_np) in raw_levels:
        Aop = _fast_level_op(Al)
        dinv = jnp.asarray(dinv_np)
        tent = LatticeTent(wc=jnp.asarray(wc), fdims=fd, cdims=cd)
        Pop = ImplicitP(A=Aop, dinv=dinv, tent=tent)
        Ls = Us = fwd = bwd = None
        if smoother != "jacobi":
            if getattr(Aop, "format_name", None) == "dia":
                from lis_tpu.precon.ssor import _split_dia
                Ls, Us, _d = _split_dia(Aop)
            else:
                fwd, bwd = _sgs_plans(Al)
        levels.append(AMGLevel(A=Aop, P=Pop, fwd=fwd, bwd=bwd, dinv=dinv,
                               Ls=Ls, Us=Us))
    return levels


@register_precon("saamg")
def create_saamg(A, opts):
    ptr, index, value = A.to_csr_arrays()
    if np.iscomplexobj(value):
        # parity with the reference: its SA-AMG is the real-only F90
        # module (src/fortran/amg/, no _COMPLEX variant)
        raise NotImplementedError(
            "saamg does not support complex operators "
            "(the reference's F90 AMG is real-only)")
    A_sp = sp.csr_matrix((value, index, ptr), shape=A.shape)
    theta = getattr(opts, "saamg_theta", 0.05)
    smoother = getattr(opts, "saamg_smoother", "sgs")

    fdims = detect_lattice(A_sp)
    if fdims is not None and getattr(opts, "saamg_lattice", True) \
            and not getattr(opts, "saamg_unsym", False):
        raw_levels, A_coarse = build_hierarchy_lattice(A_sp, fdims)
        if raw_levels and A_coarse.shape[0] <= 4096:
            levels = _lattice_levels(raw_levels, smoother)
            coarse_inv = jnp.asarray(np.linalg.inv(A_coarse.toarray()))
            return SAAMGPrecon(levels=tuple(levels), coarse_inv=coarse_inv,
                               smoother=smoother)

    unsym = bool(getattr(opts, "saamg_unsym", False))
    raw_levels, A_coarse = build_hierarchy(A_sp, theta=theta, unsym=unsym)

    def _fast_op(m):
        """Level operator through auto_storage (DIA/HDI/BES when the
        structure allows — the V-cycle's matvecs then stream instead of
        gathering; CSR fallback otherwise)."""
        from lis_tpu.solvers.driver import auto_storage
        return auto_storage(CSRMatrix.from_csr_arrays(
            m.indptr, m.indices, m.data, m.shape))

    def _fast_prolongator(m):
        """Prolongators track rows at slope ncols/nrows, with one affine
        band per plane neighbour of the fine stencil: the multi-window
        strided BES covers them gather-free (e.g. exactly 3 windows for
        an aggregated 3-D operator); CSR fallback when the profile is
        too scattered."""
        from lis_tpu.matrix.bes import (multi_bes_from_csr, GATHER_NS,
                                        SLAB_NS_PER_SLOT)
        try:
            # a 3-D fine stencil puts the prolongator's columns in up to
            # 9 affine bands (3 z-planes x 3 y-rows) — give the greedy
            # builder enough windows to find them all.  Acceptance is a
            # cost comparison per entry against the CSR fallback, at the
            # per-element costs of matrix/bes.py's window model
            bp = multi_bes_from_csr(m.indptr, m.indices, m.data, m.shape,
                                    max_windows=12, max_bytes=2 << 30)
            rem_frac = (bp.rem.nnz / max(bp.nnz, 1)
                        if bp.rem is not None else 0.0)
            if (bp.fill_blowup * SLAB_NS_PER_SLOT + rem_frac * GATHER_NS
                    < GATHER_NS):
                return bp
        except Exception:
            pass
        return CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data,
                                         m.shape)

    levels = []
    for (Al, Pl, Rl) in raw_levels:
        fwd, bwd = _sgs_plans(Al)
        Al.sort_indices()
        Pl.sort_indices()
        d = Al.diagonal()
        with np.errstate(divide="ignore"):
            dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)
        Rf = None
        fwdh = bwdh = None
        if Rl is not None:
            Rl.sort_indices()
            Rf = CSRMatrix.from_csr_arrays(Rl.indptr, Rl.indices, Rl.data,
                                           Rl.shape)
            # plans for the adjoint cycle: lower/upper triangles of Aᵀ
            fwdh, bwdh = _sgs_plans(Al.T.tocsr())
        levels.append(AMGLevel(
            A=_fast_op(Al), P=_fast_prolongator(Pl),
            fwd=fwd, bwd=bwd, dinv=jnp.asarray(dinv), R=Rf,
            fwdh=fwdh, bwdh=bwdh))
    if A_coarse.shape[0] > 4096:
        raise ValueError(
            f"saamg: hierarchy failed to coarsen (coarsest level "
            f"{A_coarse.shape[0]} rows); the operator has no usable "
            "strength structure — use -p ssor/ilu instead")
    coarse_inv = jnp.asarray(np.linalg.inv(A_coarse.toarray()))
    return SAAMGPrecon(levels=tuple(levels), coarse_inv=coarse_inv,
                       smoother=smoother)
