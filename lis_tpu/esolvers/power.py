"""Power-family eigensolvers: PI, II, RQI (+ generalized variants).

Reference: lis_epi (src/esolver/lis_esolver_pi.c:127), lis_eii
(lis_esolver_ii.c:127 — one inner Krylov solve per outer iteration via
lis_solve_kernel at :216), lis_erqi (lis_esolver_rqi.c:129).

The outer loops run in Python on host (each outer iteration launches jitted
device work: a matvec for PI, a whole compiled Krylov solve for II/RQI) —
the same structure as the reference, where the inner solve dominates.
Generalized problems Ax = λBx use the reference's reduction: iterate on
B⁻¹A (inner solves with B).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from lis_tpu import config as C
from lis_tpu.core import vector as v
from lis_tpu.esolvers.base import register_esolver

import jax as _jax
from functools import lru_cache as _lru_cache, partial as _partial


def _result(evalue, x, iters, resid, status, rh):
    from lis_tpu.esolvers.driver import EsolveResult
    ev = np.asarray([evalue])
    return EsolveResult(evalue=float(np.real(evalue)), evector=x, iters=iters,
                        resid=float(resid), status=status,
                        evalues=np.real(ev), evectors=np.asarray(x)[None, :],
                        iters_all=np.asarray([iters]),
                        resids_all=np.asarray([resid]),
                        rhistory=np.asarray(rh))


def _inner_precision(opts):
    """-ef {quad,df,...} runs the INNER Krylov solves in extended precision
    (matching the reference, whose esolver quad registry is empty —
    lis_esolver.c:69-72 — and whose quad support routes through the inner
    lis_solve)."""
    p = getattr(opts, "precision", "double")
    return p if p != "double" else opts.inner.precision


def _bsolve(B, rhs, opts):
    """Solve B y = rhs for the generalized reduction."""
    if not hasattr(B, "to_csr_arrays"):
        # operator-only B (e.g. the distributed GlobalView adapter):
        # raw registry solve — the driver's scaling/storage analysis
        # needs host arrays the adapter can't provide
        from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
        from lis_tpu.precon.base import NonePrecon
        name = _jit_inner_name(opts)
        spec = SolverSpec(solver=name, tol=max(opts.tol * 1e-2, 1e-14),
                          maxiter=opts.inner.maxiter, conv_cond=0)
        rhs = jnp.asarray(rhs)
        return SOLVER_FNS[name](B, rhs, jnp.zeros_like(rhs), NonePrecon(),
                                spec).x
    from lis_tpu.solvers.driver import solve
    r = solve(B, rhs, options=None,
              solver=opts.inner.solver, precon=opts.inner.precon,
              maxiter=opts.inner.maxiter, tol=max(opts.tol * 1e-2, 1e-14),
              precision=_inner_precision(opts))
    return r.x


@register_esolver("pi")
def epi(A, B, x0, opts):
    """Power iteration (lis_epi). For Ax=λBx iterates B⁻¹A.

    Both the standard and generalized problems run as ONE compiled
    while_loop (the generalized step nests the inner B-solve — a Python
    loop costs a host dispatch round-trip per iteration)."""
    if B is None:
        return _epi_jit(A, x0, opts)
    if _jit_inner_ok(opts):
        return _egpi_jit(A, B, x0, opts)
    x = x0 / v.nrm2(x0)
    evalue, resid = 0.0, np.inf
    rh = []
    status = C.LIS_MAXITER
    iters = opts.maxiter
    for it in range(1, opts.maxiter + 1):
        z = A.matvec(x)
        if B is not None:
            z = _bsolve(B, z, opts)
        evalue = complex(v.dot(x, z)).real
        znrm = v.nrm2(z)
        x = z / znrm
        # residual: ||Ax - λx|| with the new normalized x
        az = A.matvec(x) if B is None else _bsolve(B, A.matvec(x), opts)
        resid = float(v.nrm2(az - evalue * x) /
                      (abs(evalue) if evalue != 0 else 1.0))
        rh.append(resid)
        if resid <= opts.tol:
            status, iters = C.LIS_SUCCESS, it
            break
    return _result(evalue, x, iters, resid, status, rh)


@_partial(_jax.jit, static_argnums=(2, 3, 4))
def _epi_run(A, x0, maxiter, tol, axis_name=None):
    dot = _partial(v.dot, axis_name=axis_name)
    nrm2 = _partial(v.nrm2, axis_name=axis_name)
    x = x0 / nrm2(x0)
    z = A.matvec(x)
    rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=jnp.real(x0).dtype)

    def cond(s):
        it, x, z, lam, resid, rh = s
        return (it <= maxiter) & (resid > tol)

    def step(s):
        it, x, z, lam, resid, rh = s
        lam = dot(x, z)
        xn = z / nrm2(z)
        azn = A.matvec(xn)
        den = jnp.where(lam == 0, 1.0, jnp.abs(lam))
        resid = nrm2(azn - lam * xn) / den
        rh = rh.at[it].set(jnp.real(resid))
        return (it + 1, xn, azn, lam, resid, rh)

    it0 = jnp.asarray(1)
    big = jnp.asarray(jnp.inf, jnp.real(x0).dtype)
    lam0 = jnp.zeros((), x0.dtype)
    it, x, z, lam, resid, rh = _jax.lax.while_loop(
        cond, step, (it0, x, z, lam0, big, rh0))
    return it - 1, x, lam, resid, rh


def _epi_jit(A, x0, opts):
    iters, x, lam, resid, rh = _epi_run(A, jnp.asarray(x0), opts.maxiter,
                                        opts.tol)
    iters = int(iters)
    status = C.LIS_SUCCESS if float(resid) <= opts.tol else C.LIS_MAXITER
    return _result(complex(lam) if jnp.iscomplexobj(x) else float(lam),
                   x, iters, float(resid), status,
                   np.asarray(rh)[1:iters + 1])


class _GenOp:
    """B⁻¹A as a pytree operator: matvec nests the inner Krylov B-solve,
    so the standard-problem compiled eigensolver loops work unchanged on
    the generalized pencil."""

    def __init__(self, A, B, inner_key, axis_name=None):
        self.A = A
        self.B = B
        self.inner_key = inner_key      # (solver_name, tol, maxiter) static
        self.axis_name = axis_name      # threads psum into the nested solve

    def matvec(self, x):
        from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
        from lis_tpu.precon.base import NonePrecon
        name, tol, mi = self.inner_key
        spec = SolverSpec(solver=name, tol=tol, maxiter=mi, conv_cond=0,
                          axis_name=self.axis_name)
        return SOLVER_FNS[name](self.B, self.A.matvec(x),
                                jnp.zeros_like(x), NonePrecon(), spec).x


_jax.tree_util.register_pytree_node(
    _GenOp,
    lambda m: ((m.A, m.B), (m.inner_key, m.axis_name)),
    lambda aux, c: _GenOp(c[0], c[1], *aux))


_JIT_INNER_SOLVERS = ("cg", "bicgstab", "cgs", "bicg", "minres")


def _jit_inner_name(opts):
    """Inner solver used by the COMPILED nested-Krylov paths: the
    requested -i when it is one of the jit-supported simple kinds, else
    bicgstab.  One definition — the single- and multi-device eigensolvers
    all route through this so the fallback can't drift between them."""
    s = opts.inner.solver
    return s if s in _JIT_INNER_SOLVERS else "bicgstab"


def _gen_inner_key(opts):
    name = _jit_inner_name(opts)
    return (name, opts.inner.tol, opts.inner.maxiter)


def _jit_inner_ok(opts):
    """The compiled nested paths support unpreconditioned double inner
    solves of the simple Krylov kinds; anything else (inner -p, -ef
    quad/df, exotic inner solvers) keeps the host loop, which honors the
    full inner option surface via the driver."""
    return (opts.inner.precon == "none"
            and getattr(opts, "precision", "double") == "double"
            and opts.inner.precision == "double"
            and opts.inner.solver in _JIT_INNER_SOLVERS)


@_lru_cache(maxsize=32)
def _egpi_runner(solver_name, inner_tol, inner_maxiter, axis_name=None):
    from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
    from lis_tpu.precon.base import NonePrecon
    inner = SolverSpec(solver=solver_name, tol=inner_tol,
                       maxiter=inner_maxiter, conv_cond=0,
                       axis_name=axis_name)
    solver_fn = SOLVER_FNS[solver_name]
    M = NonePrecon()
    dot = _partial(v.dot, axis_name=axis_name)
    nrm2 = _partial(v.nrm2, axis_name=axis_name)

    @_partial(_jax.jit, static_argnums=(3, 4))
    def run(A, B, x0, maxiter, tol):
        dt = jnp.real(x0).dtype
        x = x0 / nrm2(x0)
        rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=dt)

        def bsolve(rhs):
            return solver_fn(B, rhs, jnp.zeros_like(rhs), M, inner).x

        def cond(s):
            it, x, ev, resid, rh = s
            return (it <= maxiter) & (resid > tol)

        def step(s):
            it, x, ev, resid, rh = s
            z = bsolve(A.matvec(x))
            evn = dot(x, z)
            xn = z / nrm2(z)
            az = bsolve(A.matvec(xn))
            den = jnp.where(evn == 0, 1.0, jnp.abs(evn))
            residn = nrm2(az - evn * xn) / den
            rh = rh.at[it].set(jnp.real(residn))
            return (it + 1, xn, evn, residn, rh)

        big = jnp.asarray(jnp.inf, dt)
        it, x, ev, resid, rh = _jax.lax.while_loop(
            cond, step, (jnp.asarray(1), x, jnp.zeros((), x0.dtype), big,
                         rh0))
        return it - 1, x, ev, resid, rh

    return run


def _egpi_jit(A, B, x0, opts):
    run = _egpi_runner(opts.inner.solver, opts.inner.tol,
                       opts.inner.maxiter)
    iters, x, ev, resid, rh = run(A, B, jnp.asarray(x0), opts.maxiter,
                                  opts.tol)
    iters = int(iters)
    status = C.LIS_SUCCESS if float(resid) <= opts.tol else C.LIS_MAXITER
    return _result(float(jnp.real(ev)), x, iters, float(resid), status,
                   np.asarray(rh)[1:iters + 1])


def _egii_jit(A, B, x0, opts):
    name = _jit_inner_name(opts)
    run = _egii_runner(name, opts.inner.tol, opts.inner.maxiter)
    iters, x, ev, resid, rh = run(A, B, jnp.asarray(x0),
                                  jnp.asarray(float(opts.rval)),
                                  opts.maxiter, opts.tol)
    iters = int(iters)
    status = C.LIS_SUCCESS if float(resid) <= opts.tol else C.LIS_MAXITER
    return _result(float(jnp.real(ev)), x, iters, float(resid), status,
                   np.asarray(rh)[1:iters + 1])


def _egrqi_jit(A, B, x0, opts):
    name = _jit_inner_name(opts)
    run = _egrqi_runner(name, opts.inner.tol, opts.inner.maxiter)
    iters, x, ev, resid, rh, dead = run(A, B, jnp.asarray(x0),
                                        opts.maxiter, opts.tol)
    iters = int(iters)
    resid = float(resid)
    if resid <= opts.tol:
        status = C.LIS_SUCCESS
    elif bool(dead):
        status = C.LIS_BREAKDOWN
    else:
        status = C.LIS_MAXITER
    return _result(float(jnp.real(ev)), x, iters, resid, status,
                   np.asarray(rh)[1:iters + 1])


def _shift_solve(A, B, sigma, rhs, opts):
    """Solve (A - σB) y = rhs (inner Krylov solve of II/RQI,
    reference lis_esolver_ii.c:216 via lis_solve_kernel)."""
    from lis_tpu.solvers.driver import solve
    if B is None and not hasattr(A, "to_csr_arrays"):
        # operator-only A (e.g. the distributed GlobalView adapter):
        # raw registry solve, unpreconditioned — the driver's scaling/
        # storage analysis needs host arrays the adapter can't provide
        from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
        from lis_tpu.precon.base import NonePrecon
        As = _Shifted(A, jnp.asarray(float(sigma))) if sigma != 0.0 else A
        name = _jit_inner_name(opts)
        spec = SolverSpec(solver=name, tol=opts.inner.tol,
                          maxiter=opts.inner.maxiter, conv_cond=0)
        out = SOLVER_FNS[name](As, rhs, jnp.zeros_like(rhs), NonePrecon(),
                               spec)
        return out.x
    if B is not None and not (hasattr(A, "to_csr_arrays")
                              and hasattr(B, "to_csr_arrays")):
        # operator-only pencil (distributed GlobalView adapters): shifted
        # pencil operator + raw registry solve
        from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
        from lis_tpu.precon.base import NonePrecon
        As = _ShiftedPencil(A, B, jnp.asarray(float(sigma)))
        name = _jit_inner_name(opts)
        spec = SolverSpec(solver=name, tol=opts.inner.tol,
                          maxiter=opts.inner.maxiter, conv_cond=0)
        rhs = jnp.asarray(rhs)
        return SOLVER_FNS[name](As, rhs, jnp.zeros_like(rhs), NonePrecon(),
                                spec).x
    if B is None:
        As = A.shift_diagonal(sigma)          # A - σI
    else:
        As = B.axpy(-sigma, A)                # A + (-σ)·B
    r = solve(As, rhs, options=None,
              solver=opts.inner.solver, precon=opts.inner.precon,
              maxiter=opts.inner.maxiter, tol=opts.inner.tol,
              precision=_inner_precision(opts))
    return r.x


@register_esolver("ii")
def eii(A, B, x0, opts):
    """Inverse iteration (lis_eii): one inner solve per outer iteration;
    eigenvalue from the Rayleigh quotient of the inverse map.

    Standard problem: the OUTER loop nests the compiled inner Krylov solve
    inside one while_loop — the whole eigensolve is a single XLA program
    (the reference dispatches lis_solve_kernel per outer step,
    lis_esolver_ii.c:216)."""
    sigma = opts.rval
    if B is None and _jit_inner_ok(opts):
        return _eii_jit(A, x0, opts)
    if B is not None and _jit_inner_ok(opts):
        return _egii_jit(A, B, x0, opts)
    x = x0 / v.nrm2(x0)
    evalue, resid = 0.0, np.inf
    rh = []
    status = C.LIS_MAXITER
    iters = opts.maxiter
    for it in range(1, opts.maxiter + 1):
        rhs = x if B is None else B.matvec(x)
        y = _shift_solve(A, B, sigma, rhs, opts)
        theta = complex(v.dot(x, y)).real        # ≈ 1/(λ - σ)
        ynrm = v.nrm2(y)
        x = y / ynrm
        evalue = sigma + 1.0 / theta
        az = A.matvec(x)
        bx = x if B is None else B.matvec(x)
        resid = float(v.nrm2(az - evalue * bx) /
                      (abs(evalue) if evalue != 0 else 1.0))
        rh.append(resid)
        if resid <= opts.tol:
            status, iters = C.LIS_SUCCESS, it
            break
    return _result(evalue, x, iters, resid, status, rh)


@_lru_cache(maxsize=32)
def _eii_runner(solver_name, inner_tol, inner_maxiter, axis_name=None):
    from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
    from lis_tpu.precon.base import NonePrecon
    inner = SolverSpec(solver=solver_name, tol=inner_tol,
                       maxiter=inner_maxiter, conv_cond=0,
                       axis_name=axis_name)
    solver_fn = SOLVER_FNS[solver_name]
    M = NonePrecon()
    dot = _partial(v.dot, axis_name=axis_name)
    nrm2 = _partial(v.nrm2, axis_name=axis_name)

    @_partial(_jax.jit, static_argnums=(4, 5))
    def run(As, A, x0, sigma, maxiter, tol):
        dt = jnp.real(x0).dtype
        x = x0 / nrm2(x0)
        rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=dt)

        def cond(s):
            it, x, ev, resid, rh = s
            return (it <= maxiter) & (resid > tol)

        def step(s):
            it, x, ev, resid, rh = s
            y = solver_fn(As, x, jnp.zeros_like(x), M, inner).x
            y = jnp.where(jnp.isfinite(y), y, 0.0)
            theta = dot(x, y)
            xn = y / nrm2(y)
            evn = sigma + 1.0 / theta
            az = A.matvec(xn)
            den = jnp.where(evn == 0, 1.0, jnp.abs(evn))
            residn = nrm2(az - evn * xn) / den
            rh = rh.at[it].set(jnp.real(residn))
            return (it + 1, xn, evn, residn, rh)

        big = jnp.asarray(jnp.inf, dt)
        it, x, ev, resid, rh = _jax.lax.while_loop(
            cond, step, (jnp.asarray(1), x, jnp.zeros((), x0.dtype), big,
                         rh0))
        return it - 1, x, ev, resid, rh

    return run


def _eii_jit(A, x0, opts):
    sigma = opts.rval
    As = A.shift_diagonal(sigma) if sigma != 0.0 else A
    name = _jit_inner_name(opts)
    run = _eii_runner(name, opts.inner.tol, opts.inner.maxiter)
    iters, x, ev, resid, rh = run(As, A, jnp.asarray(x0),
                                  jnp.asarray(float(sigma)),
                                  opts.maxiter, opts.tol)
    iters = int(iters)
    status = C.LIS_SUCCESS if float(resid) <= opts.tol else C.LIS_MAXITER
    return _result(float(jnp.real(ev)), x, iters, float(resid), status,
                   np.asarray(rh)[1:iters + 1])


class _Shifted:
    """(A - sigma I) with sigma as a traced leaf, so RQI's moving shift
    lives inside one compiled loop (no per-step matrix rebuild)."""

    def __init__(self, A, sigma):
        self.A = A
        self.sigma = sigma

    def matvec(self, x):
        return self.A.matvec(x) - self.sigma * x

    def matvech(self, x):
        s = jnp.conj(self.sigma) if jnp.iscomplexobj(self.sigma) \
            else self.sigma
        return self.A.matvech(x) - s * x


_jax.tree_util.register_pytree_node(
    _Shifted,
    lambda m: ((m.A, m.sigma), ()),
    lambda aux, c: _Shifted(*c))


class _ShiftedPencil:
    """(A - sigma B) as an operator pytree with sigma a traced leaf —
    the generalized shift-solve operator of II/RQI on a pencil
    (reference lis_esolver_ii.c generalized branch).  Works on any
    matvec-capable pair, including block-row sharded matrices inside
    shard_map."""

    def __init__(self, A, B, sigma):
        self.A = A
        self.B = B
        self.sigma = sigma

    def matvec(self, x):
        return self.A.matvec(x) - self.sigma * self.B.matvec(x)

    def matvech(self, x):
        s = jnp.conj(self.sigma) if jnp.iscomplexobj(self.sigma) \
            else self.sigma
        return self.A.matvech(x) - s * self.B.matvech(x)


_jax.tree_util.register_pytree_node(
    _ShiftedPencil,
    lambda m: ((m.A, m.B, m.sigma), ()),
    lambda aux, c: _ShiftedPencil(*c))


@_lru_cache(maxsize=32)
def _egii_runner(solver_name, inner_tol, inner_maxiter, axis_name=None):
    """Generalized inverse iteration on the pencil: one nested Krylov
    solve of (A - σB) y = Bx per outer step, the whole eigensolve one
    compiled while_loop.  Shared between single-device and shard_map
    execution (axis_name threads the psum reductions)."""
    from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
    from lis_tpu.precon.base import NonePrecon
    inner = SolverSpec(solver=solver_name, tol=inner_tol,
                       maxiter=inner_maxiter, conv_cond=0,
                       axis_name=axis_name)
    solver_fn = SOLVER_FNS[solver_name]
    M = NonePrecon()
    dot = _partial(v.dot, axis_name=axis_name)
    nrm2 = _partial(v.nrm2, axis_name=axis_name)

    @_partial(_jax.jit, static_argnums=(4, 5))
    def run(A, B, x0, sigma, maxiter, tol):
        dt = jnp.real(x0).dtype
        As = _ShiftedPencil(A, B, sigma)
        x = x0 / nrm2(x0)
        rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=dt)

        def cond(s):
            it, x, ev, resid, rh = s
            return (it <= maxiter) & (resid > tol)

        def step(s):
            it, x, ev, resid, rh = s
            rhs = B.matvec(x)
            y = solver_fn(As, rhs, jnp.zeros_like(rhs), M, inner).x
            y = jnp.where(jnp.isfinite(y), y, 0.0)
            theta = dot(x, y)
            xn = y / nrm2(y)
            evn = sigma + 1.0 / theta
            az = A.matvec(xn)
            bx = B.matvec(xn)
            den = jnp.where(evn == 0, 1.0, jnp.abs(evn))
            residn = nrm2(az - evn * bx) / den
            rh = rh.at[it].set(jnp.real(residn))
            return (it + 1, xn, evn, residn, rh)

        big = jnp.asarray(jnp.inf, dt)
        it, x, ev, resid, rh = _jax.lax.while_loop(
            cond, step, (jnp.asarray(1), x, jnp.zeros((), x0.dtype), big,
                         rh0))
        return it - 1, x, ev, resid, rh

    return run


@_lru_cache(maxsize=32)
def _egrqi_runner(solver_name, inner_tol, inner_maxiter, axis_name=None):
    """Generalized RQI: the shift follows the pencil Rayleigh quotient
    x·Ax / x·Bx, with the same guarded-update safeguards as the standard
    compiled RQI loop."""
    from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
    from lis_tpu.precon.base import NonePrecon
    inner = SolverSpec(solver=solver_name, tol=inner_tol,
                       maxiter=inner_maxiter, conv_cond=0,
                       axis_name=axis_name)
    solver_fn = SOLVER_FNS[solver_name]
    M = NonePrecon()
    dot = _partial(v.dot, axis_name=axis_name)
    nrm2 = _partial(v.nrm2, axis_name=axis_name)

    @_partial(_jax.jit, static_argnums=(3, 4))
    def run(A, B, x0, maxiter, tol):
        dt = jnp.real(x0).dtype
        x = x0 / nrm2(x0)
        sigma0 = dot(x, A.matvec(x)) / dot(x, B.matvec(x))
        rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=dt)

        def cond(s):
            it, x, sigma, ev, resid, rh, badcnt = s
            return (it <= maxiter) & (resid > tol) & (badcnt < 3)

        def step(s):
            it, x, sigma, ev, resid, rh, badcnt = s
            rhs = B.matvec(x)
            y = solver_fn(_ShiftedPencil(A, B, sigma), rhs,
                          jnp.zeros_like(rhs), M, inner).x
            y = jnp.where(jnp.isfinite(y), y, 0.0)
            ynrm = nrm2(y)
            bad = ~jnp.isfinite(ynrm) | (ynrm == 0.0)
            xn = jnp.where(bad, x, y / jnp.where(ynrm == 0, 1.0, ynrm))
            bxn = B.matvec(xn)
            evn = dot(xn, A.matvec(xn)) / dot(xn, bxn)
            den = jnp.where(evn == 0, 1.0, jnp.abs(evn))
            residn = nrm2(A.matvec(xn) - evn * bxn) / den
            move = (residn < 0.5 * resid) | ~jnp.isfinite(resid)
            sigman = jnp.where(move, evn, sigma)
            rh = rh.at[it].set(jnp.real(residn))
            keep = lambda new, old: jnp.where(bad, old, new)
            sig_retry = sigma * (1.0 + 1e-6) + jnp.asarray(1e-12, dt)
            return (it + 1, keep(xn, x),
                    jnp.where(bad, sig_retry, sigman),
                    keep(evn, ev), keep(residn, resid), rh,
                    jnp.where(bad, badcnt + 1, 0))

        big = jnp.asarray(jnp.inf, dt)
        it, x, sigma, ev, resid, rh, badcnt = _jax.lax.while_loop(
            cond, step, (jnp.asarray(1), x, sigma0, sigma0, big, rh0,
                         jnp.asarray(0)))
        return it - 1, x, ev, resid, rh, badcnt >= 3

    return run


@_lru_cache(maxsize=32)
def _erqi_runner(solver_name, inner_tol, inner_maxiter, axis_name=None):
    from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
    from lis_tpu.precon.base import NonePrecon
    inner = SolverSpec(solver=solver_name, tol=inner_tol,
                       maxiter=inner_maxiter, conv_cond=0,
                       axis_name=axis_name)
    solver_fn = SOLVER_FNS[solver_name]
    M = NonePrecon()
    dot = _partial(v.dot, axis_name=axis_name)
    nrm2 = _partial(v.nrm2, axis_name=axis_name)

    @_partial(_jax.jit, static_argnums=(2, 3))
    def run(A, x0, maxiter, tol):
        dt = jnp.real(x0).dtype
        x = x0 / nrm2(x0)
        sigma0 = dot(x, A.matvec(x)) / dot(x, x)
        rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=dt)

        def cond(s):
            it, x, sigma, ev, resid, rh, badcnt = s
            return (it <= maxiter) & (resid > tol) & (badcnt < 3)

        def step(s):
            it, x, sigma, ev, resid, rh, badcnt = s
            y = solver_fn(_Shifted(A, sigma), x, jnp.zeros_like(x), M,
                          inner).x
            # a near-singular shift makes the inner Krylov blow up in the
            # target eigendirection — that's RQI working; keep the finite
            # part (the host path gets the same effect from the driver's
            # breakdown handling)
            y = jnp.where(jnp.isfinite(y), y, 0.0)
            ynrm = nrm2(y)
            bad = ~jnp.isfinite(ynrm) | (ynrm == 0.0)
            xn = jnp.where(bad, x, y / jnp.where(ynrm == 0, 1.0, ynrm))
            evn = dot(xn, A.matvec(xn)) / dot(xn, xn)
            den = jnp.where(evn == 0, 1.0, jnp.abs(evn))
            residn = nrm2(A.matvec(xn) - evn * xn) / den
            # guarded shift update (see the host-path comment)
            move = (residn < 0.5 * resid) | ~jnp.isfinite(resid)
            sigman = jnp.where(move, evn, sigma)
            rh = rh.at[it].set(jnp.real(residn))
            keep = lambda new, old: jnp.where(bad, old, new)
            # an unusable inner solve (all-nonfinite, e.g. emulated-f64
            # breakdown on a near-singular shift): nudge the shift off the
            # eigenvalue and retry; give up after 3 consecutive failures
            sig_retry = sigma * (1.0 + 1e-6) + jnp.asarray(1e-12, dt)
            return (it + 1, keep(xn, x),
                    jnp.where(bad, sig_retry, sigman),
                    keep(evn, ev), keep(residn, resid), rh,
                    jnp.where(bad, badcnt + 1, 0))

        big = jnp.asarray(jnp.inf, dt)
        it, x, sigma, ev, resid, rh, badcnt = _jax.lax.while_loop(
            cond, step, (jnp.asarray(1), x, sigma0, sigma0, big, rh0,
                         jnp.asarray(0)))
        return it - 1, x, ev, resid, rh, badcnt >= 3

    return run


def _erqi_jit(A, x0, opts):
    name = _jit_inner_name(opts)
    run = _erqi_runner(name, opts.inner.tol, opts.inner.maxiter)
    iters, x, ev, resid, rh, dead = run(A, jnp.asarray(x0), opts.maxiter,
                                        opts.tol)
    iters = int(iters)
    resid = float(resid)
    if resid <= opts.tol:
        status = C.LIS_SUCCESS
    elif bool(dead):
        status = C.LIS_BREAKDOWN
    else:
        status = C.LIS_MAXITER
    return _result(float(jnp.real(ev)), x, iters, resid, status,
                   np.asarray(rh)[1:iters + 1])


@register_esolver("rqi")
def erqi(A, B, x0, opts):
    """Rayleigh-quotient iteration (lis_erqi): the shift follows the
    Rayleigh quotient, giving cubic local convergence."""
    if B is None and opts.rval == 0.0 and _jit_inner_ok(opts):
        return _erqi_jit(A, x0, opts)
    if B is not None and opts.rval == 0.0 and _jit_inner_ok(opts):
        return _egrqi_jit(A, B, x0, opts)
    x = x0 / v.nrm2(x0)
    bx = x if B is None else B.matvec(x)
    sigma = complex(v.dot(x, A.matvec(x)) / v.dot(x, bx)).real
    evalue, resid = sigma, np.inf
    rh = []
    status = C.LIS_MAXITER
    iters = opts.maxiter
    for it in range(1, opts.maxiter + 1):
        rhs = x if B is None else B.matvec(x)
        y = _shift_solve(A, B, sigma, rhs, opts)
        ynrm = float(v.nrm2(y))
        if not np.isfinite(ynrm) or ynrm == 0.0:
            # the shifted system went singular at convergence — keep the
            # last good iterate (the reference's inner BiCG breaks down
            # the same way once σ hits the eigenvalue)
            status, iters = (C.LIS_SUCCESS if resid <= opts.tol * 1e3
                             else C.LIS_BREAKDOWN), it
            break
        x = y / ynrm
        bx = x if B is None else B.matvec(x)
        evalue = complex(v.dot(x, A.matvec(x)) / v.dot(x, bx)).real
        new_resid = float(v.nrm2(A.matvec(x) - evalue * bx) /
                          (abs(evalue) if evalue != 0 else 1.0))
        # safeguard for inexact inner solves: move the shift only while the
        # residual is improving; otherwise hold it fixed, falling back to
        # plain inverse iteration (which converges linearly regardless).
        # A shift parked exactly on an eigenvalue makes the inner system
        # singular and stalls the Krylov solve — the unguarded textbook
        # update oscillates here.
        if new_resid < 0.5 * resid or not np.isfinite(resid):
            sigma = evalue
        resid = new_resid
        rh.append(resid)
        if resid <= opts.tol:
            status, iters = C.LIS_SUCCESS, it
            break
    return _result(evalue, x, iters, resid, status, rh)
