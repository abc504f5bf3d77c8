"""lis_solve-equivalent driver.

Reference: lis_solve / lis_solve_kernel (src/solver/lis_solver.c:367,441-953):
option parsing, scaling (none/jacobi/symm_diag with the CG+jacobi upgrade at
:702-705), optional storage conversion (-storage), preconditioner creation,
registry dispatch, residual history, true-residual recomputation (:910-924)
and per-phase timing (:902-908).

The iteration itself is one jitted function per (solver, spec, pytree
structure) — the whole Krylov loop compiles to a single XLA while-loop, so
per-iteration overhead is two device-side psums, not Python.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.utils.trace import traced
from lis_tpu import config as C
from lis_tpu.core import vector as v
from lis_tpu.matrix.base import SparseMatrix
from lis_tpu.matrix.convert import convert_matrix
from lis_tpu.runtime.options import SolverOptions, STORAGE_NAMES
from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec

# import for registry side effects — every solver family registers itself
from lis_tpu.solvers import cg as _cg                      # noqa: F401
from lis_tpu.solvers import bicg as _bicg                  # noqa: F401
from lis_tpu.solvers import cgs as _cgs                    # noqa: F401
from lis_tpu.solvers import bicgstab as _bicgstab          # noqa: F401
from lis_tpu.solvers import gmres as _gmres                # noqa: F401
from lis_tpu.solvers import stationary as _stationary      # noqa: F401
from lis_tpu.solvers import minres as _minres              # noqa: F401
from lis_tpu.solvers import tfqmr as _tfqmr                # noqa: F401
from lis_tpu.solvers import orthomin as _orthomin          # noqa: F401
from lis_tpu.solvers import gpbicg as _gpbicg              # noqa: F401
from lis_tpu.solvers import bicgsafe as _bicgsafe          # noqa: F401
from lis_tpu.solvers import bicgstabl as _bicgstabl        # noqa: F401
from lis_tpu.solvers import idrs as _idrs                  # noqa: F401
from lis_tpu.solvers import cocg as _cocg                  # noqa: F401
from lis_tpu.solvers import quad as _quad                  # noqa: F401
from lis_tpu.solvers import quad_ext as _quad_ext          # noqa: F401
from lis_tpu.precon.base import PRECON_REGISTRY, NonePrecon, create_precon
from lis_tpu.precon import jacobi as _pjac                 # noqa: F401
from lis_tpu.precon import ssor as _pssor                  # noqa: F401
from lis_tpu.precon import ilu as _pilu                    # noqa: F401
from lis_tpu.precon import hybrid as _phybrid              # noqa: F401
from lis_tpu.precon import is_precon as _pis               # noqa: F401
from lis_tpu.precon import sainv as _psainv                # noqa: F401
from lis_tpu.precon import saamg as _psaamg                # noqa: F401

SOLVER_REGISTRY = SOLVER_FNS

_STORAGE_BY_ID = {i: n for n, i in STORAGE_NAMES.items()}


# csr-equivalent SpMV rates (GB/s, f64) measured on an NVIDIA H100 80GB
# HBM3 at 700 W, recorded in CHANGES.md: CSS reached 286-297 at fill
# blowup 1.04-1.05, CSR 188-212, on 2^22-row locality-free and 2^21-row
# band-clustered matrices.  BES (115-249) never beat CSS there, CST
# (84-88, no grid for the band) never beat CSR, so neither is a candidate.
_CSS_GBS = 300.0              # per stored slot: rate ~ _CSS_GBS / blowup
_CSR_GBS = 200.0


def _css_wins(blowup: float, rem_frac: float) -> bool:
    """True when CSS's estimated time per CSR byte (its slots plus the
    spilled entries, which run as CSR) is below CSR's own."""
    return blowup / _CSS_GBS + rem_frac / _CSR_GBS < 1.0 / _CSR_GBS


def auto_storage(A, need_at: bool = True):
    """Default storage: the layout whose SpMV measured fastest on the card
    (rates above and in CHANGES.md).  The reference leaves storage to the
    user (-storage); here banded operators go to DIA (3000 vs 261 GB/s
    csr-equivalent for CSR on the 27-point 216^3 operator), quasi-banded
    ones to HDI (DIA + a CSR remainder), general sparsity to CSS where
    its estimated rate beats CSR, and everything else stays CSR.  Opt
    out with -auto_storage false or an explicit -storage.  Fill guard
    for DIA: nnd diagonals must pad the nnz by at most 4x (nnd <= 512).

    ``need_at``: the solver applies A^H every iteration, so CSS builds
    its transpose grid; others use CSS's scatter matvech at most once."""
    if A.format_name in ("dia", "hdi"):
        return A
    if A.format_name in ("bsr", "vbr"):
        # a user-assembled block format is a semantic choice, not just a
        # layout: -p ilu runs the BLOCK factorization on these
        # (lis_precon_iluk.c:1289/:2220).  Re-routing would silently
        # swap it for scalar ILU; keep the user's format like the
        # reference does (it never converts without -storage — the
        # block-Jacobi scaling branch, by contrast, keys on the -storage
        # OPTION there too, lis_solve_kernel :659).
        return A
    from lis_tpu.matrix.css import CSSMatrix
    cached = getattr(A, "_auto_dia", None)
    if cached is not None and not (need_at and isinstance(cached, CSSMatrix)
                                   and cached.at is None):
        # (a transpose-free CSS cached for a matvec-only solver is
        # rebuilt with its transpose grid for a solver that needs it)
        return cached if cached is not False else A
    from lis_tpu.matrix.convert import is_banded
    try:
        banded = is_banded(A)
    except NotImplementedError:
        banded = False
    if banded:
        out = convert_matrix(A, "dia")
    else:
        from lis_tpu.matrix.hybrid import HybridMatrix
        try:
            out = HybridMatrix.try_split(*A.to_csr_arrays(), A.shape)
        except NotImplementedError:
            out = None
        if out is None:
            ptr, idx, val = A.to_csr_arrays()
            if _css_wins(*CSSMatrix.profile(idx, A.shape[1])):
                out = CSSMatrix.from_csr_arrays(ptr, idx, val, A.shape,
                                                transpose=need_at)
        if out is None:
            out = False
    try:
        # cache on the (frozen) format object so repeated solves with the
        # same matrix skip the O(nnz) host analysis and re-conversion
        object.__setattr__(A, "_auto_dia", out)
    except Exception:
        pass
    return out if out is not False else A


@dataclass
class SolveResult:
    x: jax.Array
    status: int
    iters: int
    resid: float              # final (recursive) relative residual
    true_resid: float         # ||b - Ax|| / ||b|| on the unscaled system
    rhistory: np.ndarray      # relative residuals, [0] = initial
    time: float               # total solve time (s)
    itime: float              # iteration time (includes XLA compilation on
                              # the first call for a given solver/precon/
                              # shape/precision combination — warm the
                              # cache before timing)
    ptime: float              # preconditioner-creation time
    options: SolverOptions

    def __repr__(self):
        names = {C.LIS_SUCCESS: "SUCCESS", C.LIS_MAXITER: "MAXITER",
                 C.LIS_BREAKDOWN: "BREAKDOWN"}
        return (f"SolveResult({self.options.solver}+{self.options.precon}: "
                f"{names.get(self.status, self.status)}, iters={self.iters}, "
                f"resid={self.resid:.6e})")


def _bucket(mi: int) -> int:
    """Round maxiter up to a power-of-two history capacity so solves
    differing only in maxiter/tol share ONE compiled program."""
    return max(64, 1 << (max(mi, 1) - 1).bit_length())


@partial(jax.jit, static_argnums=(5,))
def _execute_dyn(A, b, x0, M, aux, spec_key: SolverSpec, dyn):
    spec = spec_key._replace(tol=dyn["tol"], tol_w=dyn["tol_w"],
                             maxiter=dyn["maxiter"])
    return SOLVER_FNS[spec_key.solver](A, b, x0, M, spec, aux=aux)


def _execute(A, b, x0, M, aux, spec: SolverSpec):
    """Run a solver with tol/tol_w/maxiter as DYNAMIC operands: the jit
    cache key is the spec with those zeroed + a bucketed rhistory
    capacity, so tolerance/iteration-budget changes never recompile."""
    spec_key = spec._replace(tol=0.0, tol_w=0.0, maxiter=0,
                             rh_cap=_bucket(spec.maxiter))
    dyn = {"tol": jnp.asarray(spec.tol),
           "tol_w": jnp.asarray(spec.tol_w),
           "maxiter": jnp.asarray(spec.maxiter, jnp.int32)}
    return _execute_dyn(A, b, x0, M, aux, spec_key, dyn)


def _make_spec(opts: SolverOptions, axis_name=None) -> SolverSpec:
    return SolverSpec(solver=opts.solver, tol=opts.tol, tol_w=opts.tol_w,
                      maxiter=opts.maxiter, conv_cond=opts.conv_cond,
                      restart=opts.restart, ell=opts.ell, m=opts.m,
                      omega=opts.omega, irestart=opts.irestart,
                      axis_name=axis_name,
                      live_print=bool(opts.print_ & 2) and axis_name is None)


def _effective_scale(opts) -> int:
    """The scale mode solve() will actually run (lis_solve_kernel
    :613-721): CG+Jacobi auto-upgrades -scale 1 to symmetric scaling
    (lis_solver.c:702-705), and I+S FORCES Jacobi scaling — the
    truncated-U approximate inverse assumes a unit diagonal (measured
    508 vs 26 BiCGSTAB iterations on testmat.mtx without it)."""
    scale = opts.scale
    if _is_bscale(opts):
        # the BSR block branch (lis_solve_kernel :659) is checked before
        # the scalar branch's CG upgrade — block scaling stays block
        return scale
    if scale == 1 and opts.solver == "cg" and opts.precon == "jacobi":
        scale = 2
    if opts.precon == "is" and scale == 0:
        scale = 1
    return scale


def _is_bscale(opts) -> bool:
    """True when the reference would take the block-Jacobi scaling path:
    an explicit -scale 1 with -storage bsr (lis_solve_kernel :659-691).
    The I+S branch is checked FIRST there (:613), so -p is always
    scalar-Jacobi-scales regardless of storage."""
    return opts.scale == 1 and opts.storage == 7 and opts.precon != "is"


def _scale_operator(A, scale):
    """Scale A per mode; returns (A', svec) where svec also multiplies b
    (and divides x0 for the symmetric mode)."""
    if scale == 1:
        d = A.get_diagonal()
        s = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 1.0)
        return A.scale_rows(s), s
    if scale == 2:
        d = A.get_diagonal()
        s = jnp.where(d > 0, 1.0 / jnp.sqrt(jnp.where(d > 0, d, 1)),
                      jnp.where(d != 0,
                                1.0 / jnp.sqrt(jnp.abs(
                                    jnp.where(d != 0, d, 1))),
                                1.0))
        return A.scale_symm(s), s
    return A, None


def _bscale_operator(A, bs: int):
    """Block-Jacobi scaling for the ``-scale 1 -storage bsr`` path
    (lis_solve_kernel :659-691: convert to BSR, split, invert the block
    diagonal via lis_matrix_diag_inverse, then lis_matrix_bscale_bsr
    A <- D_b^-1 A and b <- D_b^-1 b).  Done at CSR level before the BSR
    conversion — left-scaling by the block diagonal mixes only rows
    within a block, so it commutes with the uniform-block conversion and
    preserves the block sparsity pattern.

    Returns (A', binv) with binv (nb, bs, bs); the caller applies binv
    to b."""
    import scipy.sparse as sp
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.precon.jacobi import _diag_blocks, inv_blocks
    blocks = _diag_blocks(A, bs)
    binv = inv_blocks(blocks, singular="eye")
    ptr, index, value = (np.asarray(t) for t in A.to_csr_arrays())
    n, m = A.shape
    nb = binv.shape[0]
    a = sp.csr_matrix((value, index, ptr), shape=(n, m))
    a.resize((nb * bs, m))
    d = sp.bsr_matrix(
        (binv, np.arange(nb), np.arange(nb + 1)),
        shape=(nb * bs, nb * bs))
    scaled = (d @ a).tocsr()
    scaled.resize((n, m))
    scaled.sort_indices()
    A2 = CSRMatrix.from_csr_arrays(scaled.indptr, scaled.indices,
                                   scaled.data, (n, m))
    return A2, jnp.asarray(binv)


def _block_matvec(binv, r):
    # the padded batched block apply lives on BlockJacobiPrecon
    from lis_tpu.precon.jacobi import BlockJacobiPrecon
    return BlockJacobiPrecon(binv=binv, n=r.shape[0]).psolve(r)


def _convert_storage(A, opts):
    if opts.storage:
        name = _STORAGE_BY_ID[opts.storage]
        return convert_matrix(A, name,
                              **({"bnr": opts.storage_block}
                                 if opts.storage in (7, 8) else {}))
    if opts.auto_storage:
        # solvers applying A^H every iteration need the CSS transpose
        # grid; everything else uses it at most once per solve (shadow
        # residual setup) and rides the scatter fallback
        need_at = (opts.solver in ("bicg", "bicr") or opts.use_at
                   or opts.precision not in ("double", "single"))
        return auto_storage(A, need_at=need_at)
    return A


def transform_operator(A, opts):
    """The exact operator solve() hands the Krylov kernel: effective
    scaling + storage conversion.  The PSD workflow builds external
    preconditioners on THIS operator so the factors match what
    lis_solve_kernel solves (the reference builds psd factors inside the
    same scaled kernel pipeline, lis_precon.c psd hooks)."""
    if _is_bscale(opts):
        A, _ = _bscale_operator(A, opts.storage_block or 2)
    else:
        A, _ = _scale_operator(A, _effective_scale(opts))
    return _convert_storage(A, opts)


@traced
def solve(A: SparseMatrix, b, x0=None, options=None, M=None,
          **overrides) -> SolveResult:
    """Solve Ax = b (the lis_solve equivalent).

    ``options`` may be a SolverOptions, an option string
    (e.g. ``"-i gmres -p ssor -tol 1e-10"``), or None for defaults.
    """
    if isinstance(options, SolverOptions):
        opts = options
        for k, val in overrides.items():
            setattr(opts, k, val)
    else:
        opts = SolverOptions.from_string(options, **overrides)

    if opts.solver not in SOLVER_FNS:
        raise NotImplementedError(f"solver {opts.solver!r} not implemented; "
                                  f"have {sorted(SOLVER_FNS)}")

    t_total = C.wtime()
    b = jnp.asarray(b)

    # ---- bandwidth-reducing reordering (-reorder rcm) ----------------------
    # extension: solve (P A Pt)(P x) = P b so the gather-free
    # formats (DIA/HDI/BES) see the locality RCM exposes; b permutes once
    # here, x unpermutes once at exit (matrix/reorder.py).
    perm = None
    if getattr(opts, "reorder", "none") == "rcm":
        from lis_tpu.matrix.reorder import rcm_permutation, permute_symmetric
        perm = rcm_permutation(A)
        A = permute_symmetric(A, perm)
        b = jnp.asarray(np.asarray(b)[perm])
        if x0 is not None and not opts.initx_zeros:
            x0 = jnp.asarray(np.asarray(x0)[perm])

    b0 = b
    A0 = A
    n = A.nrows
    if x0 is None or opts.initx_zeros:
        x0 = jnp.zeros_like(b)
    else:
        x0 = jnp.asarray(x0)

    # ---- scaling (lis_solve_kernel :613-721) -------------------------------
    # NOTE on ordering vs the reference: lis_solve creates the
    # preconditioner BEFORE lis_solve_kernel scales A and b
    # (lis_solver.c:385→441), so reference preconditioners factor the
    # UNSCALED matrix while the iteration runs the scaled one.  For
    # Jacobi/ILU/ILUT the resulting preconditioned operator is invariant
    # under row scaling, so iteration counts match either way (verified
    # against the rebuilt binary).  SSOR is not invariant under that
    # mixed pairing: the reference's -scale + -p ssor combo degrades
    # itself (22 vs 12 BiCGSTAB iterations on testmat); we precondition
    # the operator actually iterated and keep the unscaled counts.
    scale = _effective_scale(opts)
    dscale = None
    if _is_bscale(opts):
        # block-Jacobi scaling (lis_solve_kernel :659-691): A <- D_b^-1 A,
        # b <- D_b^-1 b with D_b the BSR block diagonal; x is unchanged
        A, binv = _bscale_operator(A, opts.storage_block or 2)
        b = _block_matvec(binv, b)
    else:
        A, svec = _scale_operator(A, scale)
        if scale == 1:
            b = svec * b
        elif scale == 2:
            dscale = svec
            b = svec * b
            if not opts.initx_zeros:
                x0 = x0 / dscale

    # ---- storage conversion (-storage N) -----------------------------------
    A = _convert_storage(A, opts)

    # ---- explicit transpose for the BiCG family (-use_at) ------------------
    if opts.use_at:
        from lis_tpu.matrix.useat import with_explicit_transpose
        A = with_explicit_transpose(A)

    # ---- preconditioner -----------------------------------------------------
    t_p = C.wtime()
    if M is not None:
        pass                       # caller-supplied preconditioner object
    elif opts.precon == "none":
        M = NonePrecon()
    else:
        if opts.precon not in PRECON_REGISTRY:
            raise NotImplementedError(
                f"preconditioner {opts.precon!r} not implemented; "
                f"have {sorted(PRECON_REGISTRY)}")
        M = create_precon(opts.precon, A, opts)
        if opts.adds:
            from lis_tpu.precon.ads import wrap_additive_schwarz
            M = wrap_additive_schwarz(A, M, opts)
    ptime = C.wtime() - t_p

    # ---- execute ------------------------------------------------------------
    spec = _make_spec(opts)
    from lis_tpu.solvers.base import SOLVER_PREPARE
    prepare = SOLVER_PREPARE.get(opts.solver)
    aux = prepare(A, spec) if prepare else None
    t_i = C.wtime()
    extra_iters = 0
    def _cast32(t):
        return jax.tree.map(
            lambda a: a.astype(jnp.float32)
            if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, t)

    if opts.precision in ("quad", "switch", "df", "switch_df"):
        if jnp.iscomplexobj(b):
            # parity: the reference's LIS_QUAD machinery is real-only
            # (the error-free transforms in src/precision/ operate on
            # double scalars; _COMPLEX has no quad registry)
            raise NotImplementedError(
                f"-f {opts.precision} does not support complex operands "
                "(the reference's quad precision is real-only)")
        # DD paths: f64 pairs for quad/switch; f32 pairs ("double-float",
        # unit roundoff 2^-48) for df/switch_df.
        from lis_tpu.core.ddreal import make_dd_operator
        qname = opts.solver + "_quad"
        if qname not in SOLVER_FNS:
            raise NotImplementedError(
                f"no quad variant of {opts.solver!r}; have "
                f"{sorted(k for k in SOLVER_FNS if k.endswith('_quad'))}")
        b_dd = b
        if opts.precision in ("df", "switch_df"):
            # vectors/preconditioner run on f32 limbs; the OPERATOR and the
            # RHS keep full precision as f32 pairs (casting either to
            # single would perturb the system by ~1e-7 relative)
            from lis_tpu.core.ddreal import DD
            A_dd = make_dd_operator(A, limb=jnp.float32)
            b64 = b
            A, b, x0, M, aux = _cast32((A, b, x0, M, aux))
            b_dd = DD(b, (b64 - b.astype(b64.dtype)).astype(jnp.float32))
        else:
            A_dd = make_dd_operator(A)
        if opts.precision in ("switch", "switch_df"):
            # lower-precision phase to -switch_tol, then DD continues from
            # its x (lis_solver.c switch dispatch :121-144)
            sw_maxiter = (opts.switch_maxiter if opts.switch_maxiter > 0
                          else opts.maxiter)
            # in switch_df the first phase is f32: past ~1e-6 its recursive
            # residual no longer tracks the true one, so don't burn
            # iterations below that floor
            sw_tol = (opts.switch_tol if opts.precision == "switch"
                      else max(opts.switch_tol, 1.0e-6))
            dspec = spec._replace(tol=sw_tol, maxiter=sw_maxiter)
            out1 = _execute(A, b, x0, M, aux, dspec)
            x0 = out1.x
            extra_iters = int(out1.iters)
        out = _execute(A_dd, b_dd, x0, M, aux, spec._replace(solver=qname))
    elif opts.precision == "single":
        # pure f32; true residual plateaus near 1e-7
        A32, b32, x032, M32, aux32 = _cast32((A, b, x0, M, aux))
        out = _execute(A32, b32, x032, M32, aux32, spec)
        out = out._replace(x=out.x.astype(b.dtype))
    else:
        out = _execute(A, b, x0, M, aux, spec)
    x = out.x.block_until_ready()
    itime = C.wtime() - t_i

    # ---- unscale + true residual (lis_solve_kernel :877-924) ----------------
    if dscale is not None:
        x = x * dscale
    rtrue = b0 - A0.matvec(x)
    bn = v.nrm2(b0)
    true_resid = float(v.nrm2(rtrue) / jnp.where(bn == 0, 1.0, bn))
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        x = jnp.asarray(np.asarray(x)[inv])

    iters = int(out.iters) + extra_iters
    rh = np.asarray(out.rhistory)[: iters + 1]
    result = SolveResult(x=x, status=int(out.status), iters=iters,
                         resid=float(out.resid), true_resid=true_resid,
                         rhistory=rh, time=C.wtime() - t_total,
                         itime=itime, ptime=ptime, options=opts)

    if opts.print_ & 2:
        _print_banner(result, n, live=bool(opts.print_ & 2))
    return result


def _print_banner(res: SolveResult, n: int, file=sys.stdout,
                  live=False):
    """Rank-0 style report (reference banner, lis_solver.c:760-825)."""
    o = res.options
    print(f"linear solver         : {o.solver.upper()}", file=file)
    print(f"preconditioner        : {o.precon}", file=file)
    print(f"matrix size           : {n}", file=file)
    if not live:
        for it, r in enumerate(res.rhistory):
            print(f"iteration: {it:5d}  relative residual = {r:e}",
                  file=file)
    print(f"number of iterations  : {res.iters}", file=file)
    print(f"relative residual     : {res.resid:e}", file=file)
