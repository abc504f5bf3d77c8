"""CG and CR eigensolvers (smallest eigenvalue).

Reference: lis_ecg (src/esolver/lis_esolver_cg.c:126) — Rayleigh-Ritz
conjugate-gradient on the 3-space span{w, x, p} with the small 3×3
generalized eigenproblem solved by inverse iteration; and lis_ecr (:780) —
conjugate-residual minimisation of ||Ax - λx|| with explicit α/β formulas.
Both support the spectral shift -shift σ (A - σI) and a psolve from the
inner options (default none).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from lis_tpu import config as C
from lis_tpu.core import vector as v
from lis_tpu.esolvers.base import register_esolver
from lis_tpu.esolvers.power import _result
from lis_tpu.precon.base import NonePrecon, PRECON_REGISTRY, create_precon


def _make_psolve(A, opts):
    name = opts.inner.precon if opts.inner else "none"
    if name == "none":
        return NonePrecon()
    return create_precon(name, A, opts.inner)


@register_esolver("cg")
def ecg(A, B, x0, opts):
    """CG eigensolver (lis_ecg): smallest eigenvalue of A (or pencil via
    B-reduction like the other esolvers)."""
    if B is not None:
        # generalized: work on B⁻¹A through inner solves (reference GCG
        # reduces the pencil the same way as the other G* solvers)
        from lis_tpu.esolvers.power import _bsolve
        matvec = lambda z: _bsolve(B, A.matvec(z), opts)
    else:
        matvec = A.matvec
    sigma = opts.rval
    if sigma != 0.0:
        A = A.shift_diagonal(sigma)
        matvec = A.matvec if B is None else matvec
    M = _make_psolve(A, opts)

    x = x0 / v.nrm2(x0)
    Ax = matvec(x)
    # p = A⁻¹ x (one inner CG solve, lis_esolver_cg.c:213)
    from lis_tpu.solvers.driver import solve as lsolve
    p = lsolve(A, np.asarray(x), solver="cg", precon="none", tol=1e-10,
               maxiter=opts.inner.maxiter).x
    if B is None:
        # standard problem: one compiled while_loop; A·p = A·A⁻¹x = x
        iters, x, lam, resid, rh = _ecg_run(A, M, x, Ax, p, x,
                                            opts.maxiter, opts.tol)
    else:
        # generalized pencil, reference style (lis_egcg): explicit A- and
        # B-matvecs, Rayleigh-Ritz on the 3x3 pencil — no nested solves
        iters, x, lam, resid, rh = _egcg_run(A, B, M, x, p,
                                             opts.maxiter, opts.tol)
    iters = int(iters)
    status = (C.LIS_SUCCESS if float(resid) < opts.tol
              else C.LIS_MAXITER)
    return _result(float(jnp.real(lam)) + sigma, x, iters, float(resid), status,
                   np.asarray(rh)[1:iters + 1])


import jax as _jax
from functools import partial as _partial


@_partial(_jax.jit, static_argnums=(6, 7, 8))
def _ecg_run(A, M, x, Ax, p, Ap, maxiter, tol, axis_name=None):
    dt = jnp.real(x).dtype
    rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=dt)
    nrm2 = _partial(v.nrm2, axis_name=axis_name)

    def cond(s):
        it, x, Ax, p, Ap, lam, resid, rh = s
        return (it <= maxiter) & (resid >= tol)

    def step(s):
        it, x, Ax, p, Ap, lam, resid, rh = s
        lam = v.dot(x, Ax, axis_name=axis_name)
        r = x - (1.0 / lam) * Ax
        resid = nrm2(r)
        rh = rh.at[it].set(resid)
        w = M.psolve(r)
        w = w / nrm2(w)
        Aw = A.matvec(w)
        d = lambda a, b: v.dot(a, b, axis_name=axis_name)
        A3 = jnp.array([[d(w, Aw), d(x, Aw), d(p, Aw)],
                        [d(x, Aw), d(x, Ax), d(p, Ax)],
                        [d(p, Aw), d(p, Ax), d(p, Ap)]])
        B3 = jnp.array([[d(w, w), d(x, w), d(p, w)],
                        [d(x, w), d(x, x), d(p, x)],
                        [d(p, w), d(p, x), d(p, p)]])

        def solve3(Mm, rhs):
            # Cramer's rule: a closed form, no LU call inside the loop
            c0 = jnp.cross(Mm[:, 1], Mm[:, 2])
            det = jnp.dot(Mm[:, 0], c0)
            det = jnp.where(det == 0, 1.0, det)
            x0 = jnp.dot(rhs, c0)
            x1 = jnp.dot(Mm[:, 0], jnp.cross(rhs, Mm[:, 2]))
            x2 = jnp.dot(Mm[:, 0], jnp.cross(Mm[:, 1], rhs))
            return jnp.stack([x0, x1, x2]) / det

        def inv_it(_, v3):
            v3 = v3 / jnp.linalg.norm(v3)
            z3 = solve3(A3, jnp.matmul(B3, v3, precision="highest"))
            return jnp.where(jnp.all(jnp.isfinite(z3)), z3, v3)
        v3 = _jax.lax.fori_loop(0, 30, inv_it, jnp.ones(3, A3.dtype))

        w2 = v3[0] * w + v3[2] * p
        xn = w2 + v3[1] * x
        pn = w2
        Aw2 = v3[0] * Aw + v3[2] * Ap
        Axn = Aw2 + v3[1] * Ax
        Apn = Aw2
        nx = nrm2(xn)
        xn, Axn = xn / nx, Axn / nx
        npn = nrm2(pn)
        pn, Apn = pn / npn, Apn / npn
        # on convergence this step's updates are masked out by the cond
        # check at the NEXT evaluation; keep = converged-this-step
        keep = resid < tol
        sel = lambda new, old: jnp.where(keep, old, new)
        return (it + 1, sel(xn, x), sel(Axn, Ax), sel(pn, p),
                sel(Apn, Ap), lam, resid, rh)

    big = jnp.asarray(jnp.inf, dt)
    it, x, Ax, p, Ap, lam, resid, rh = _jax.lax.while_loop(
        cond, step, (jnp.asarray(1), x, Ax, p, Ap,
                     jnp.zeros((), x.dtype), big, rh0))
    return it - 1, x, lam, resid, rh


@register_esolver("cr")
def ecr(A, B, x0, opts):
    """CR eigensolver (lis_ecr): conjugate-residual iteration on the
    Rayleigh quotient; the reference's default esolver."""
    sigma = opts.rval
    if sigma != 0.0:
        A = A.shift_diagonal(sigma)
    M = _make_psolve(A, opts)

    x = x0 / v.nrm2(x0)
    from lis_tpu.esolvers.power import _GenOp, _gen_inner_key
    op = A if B is None else _GenOp(A, B, _gen_inner_key(opts))
    iters, x, lam, resid, rh = _ecr_run(op, M, x, opts.maxiter, opts.tol)
    iters = int(iters)
    status = (C.LIS_SUCCESS if float(resid) < opts.tol
              else C.LIS_MAXITER)
    return _result(float(jnp.real(lam)) + sigma, x, iters, float(resid), status,
                   np.asarray(rh)[1:iters + 1])


@_partial(_jax.jit, static_argnums=(3, 4, 5))
def _ecr_run(A, M, x, maxiter, tol, axis_name=None):
    """The ecr iteration as one compiled while_loop (standard problem)."""
    dt = jnp.real(x).dtype
    nrm2 = _partial(v.nrm2, axis_name=axis_name)
    Ax = A.matvec(x)
    lam = v.dot(x, Ax, axis_name=axis_name)
    r = -(Ax - lam * x)
    p = r
    Ap = A.matvec(p)
    rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=dt)

    def cond(s):
        it, x, lam, r, p, Ap, resid, rh = s
        return (it <= maxiter) & (resid >= tol)

    def step(s):
        it, x, lam, r, p, Ap, resid, rh = s
        d = lambda a, b: v.dot(a, b, axis_name=axis_name)
        rAp, rp = d(r, Ap), d(r, p)
        ApAp, pAp, pp = d(Ap, Ap), d(p, Ap), d(p, p)
        den = ApAp - 2.0 * lam * pAp + lam * lam * pp
        den = jnp.where(den == 0, 1.0, den)
        alpha = (rAp - lam * rp) / den
        x = x + alpha * p
        Ax = A.matvec(x)
        lam = d(x, Ax) / (nrm2(x) ** 2)
        r = -(Ax - lam * x)
        w = M.psolve(r)
        Aw = A.matvec(w)
        beta = -(d(Aw, Ap) - lam * (d(p, Aw) + d(w, Ap))
                 + lam * lam * d(w, p)) / den
        p = w + beta * p
        Ap = Aw + beta * Ap
        resid = nrm2(r) / jnp.abs(jnp.where(lam == 0, 1.0, lam))
        rh = rh.at[it].set(jnp.real(resid))
        return (it + 1, x, lam, r, p, Ap, resid, rh)

    big = jnp.asarray(jnp.inf, dt)
    it, x, lam, r, p, Ap, resid, rh = _jax.lax.while_loop(
        cond, step, (jnp.asarray(1), x, lam, r, p, Ap, big, rh0))
    return it - 1, x / nrm2(x), lam, resid, rh


@_partial(_jax.jit, static_argnums=(5, 6, 7))
def _egcg_run(A, B, M, x, p, maxiter, tol, axis_name=None):
    """Generalized CG eigeniteration (lis_egcg, lis_esolver_cg.c): pencil
    Rayleigh-Ritz on span{w, x, p} with explicit A/B images; the residual
    is r = Bx - Ax/lam with lam = (Ax·Bx)/(Bx·Bx), as in the reference."""
    dt = jnp.real(x).dtype
    d = _partial(v.dot, axis_name=axis_name)
    nrm2 = _partial(v.nrm2, axis_name=axis_name)
    Ax = A.matvec(x)
    Bx = B.matvec(x)
    Ap = x                      # p = A⁻¹x from the setup solve
    Bp = B.matvec(p)
    rh0 = jnp.full(maxiter + 1, jnp.nan, dtype=dt)

    def solve3(Mm, rhs):
        c0 = jnp.cross(Mm[:, 1], Mm[:, 2])
        det = jnp.dot(Mm[:, 0], c0)
        det = jnp.where(det == 0, 1.0, det)
        x0 = jnp.dot(rhs, c0)
        x1 = jnp.dot(Mm[:, 0], jnp.cross(rhs, Mm[:, 2]))
        x2 = jnp.dot(Mm[:, 0], jnp.cross(Mm[:, 1], rhs))
        return jnp.stack([x0, x1, x2]) / det

    def cond(s):
        it, x, Ax, Bx, p, Ap, Bp, lam, resid, rh = s
        return (it <= maxiter) & (resid >= tol)

    def step(s):
        it, x, Ax, Bx, p, Ap, Bp, lam, resid, rh = s
        lam = d(Ax, Bx) / d(Bx, Bx)
        r = Bx - (1.0 / lam) * Ax
        resid = nrm2(r)
        rh = rh.at[it].set(jnp.real(resid))
        w = M.psolve(r)
        w = w / nrm2(w)
        Aw = A.matvec(w)
        Bw = B.matvec(w)
        A3 = jnp.array([[d(w, Aw), d(x, Aw), d(p, Aw)],
                        [d(x, Aw), d(x, Ax), d(p, Ax)],
                        [d(p, Aw), d(p, Ax), d(p, Ap)]])
        B3 = jnp.array([[d(w, Bw), d(x, Bw), d(p, Bw)],
                        [d(x, Bw), d(x, Bx), d(p, Bx)],
                        [d(p, Bw), d(p, Bx), d(p, Bp)]])

        def inv_it(_, v3):
            v3 = v3 / jnp.linalg.norm(v3)
            z3 = solve3(A3, jnp.matmul(B3, v3, precision="highest"))
            return jnp.where(jnp.all(jnp.isfinite(z3)), z3, v3)
        v3 = _jax.lax.fori_loop(0, 30, inv_it, jnp.ones(3, A3.dtype))

        w2 = v3[0] * w + v3[2] * p
        xn = w2 + v3[1] * x
        pn = w2
        Aw2 = v3[0] * Aw + v3[2] * Ap
        Axn = Aw2 + v3[1] * Ax
        Apn = Aw2
        Bw2 = v3[0] * Bw + v3[2] * Bp
        Bxn = Bw2 + v3[1] * Bx
        Bpn = Bw2
        nx = nrm2(xn)
        xn, Axn, Bxn = xn / nx, Axn / nx, Bxn / nx
        npn = nrm2(pn)
        pn, Apn, Bpn = pn / npn, Apn / npn, Bpn / npn
        keep = resid < tol
        sel = lambda new, old: jnp.where(keep, old, new)
        return (it + 1, sel(xn, x), sel(Axn, Ax), sel(Bxn, Bx),
                sel(pn, p), sel(Apn, Ap), sel(Bpn, Bp), lam, resid, rh)

    big = jnp.asarray(jnp.inf, dt)
    st = (jnp.asarray(1), x, Ax, Bx, p, Ap, Bp, jnp.zeros((), x.dtype),
          big, rh0)
    it, x, Ax, Bx, p, Ap, Bp, lam, resid, rh = _jax.lax.while_loop(
        cond, step, st)
    return it - 1, x, lam, resid, rh
