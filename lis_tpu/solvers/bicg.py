"""BiCG and BiCR (reference: src/solver/lis_solver_bicg.c:138,788).

BiCG walks A and Aᴴ simultaneously (the transpose SpMV reduces with a
scatter-add — the analogue of the reference's lis_reduce transpose
communication); BiCR is its conjugate-residual twin.  Shadow residual
r̃₀ = conj(r₀) (lis_solver_set_shadowresidual default LIS_RESID,
src/solver/lis_solver.c:1816).
"""

from __future__ import annotations

import jax.numpy as jnp

from lis_tpu import config as C
from lis_tpu.core import vector as v
from lis_tpu.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                  init_residual, krylov_loop, loop_output,
                                  new_rhistory, record, register_solver,
                                  residual_norm)


def _cj(x):
    return jnp.conj(x) if jnp.iscomplexobj(x) else x


@register_solver("bicg")
def bicg(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, jnp.real(b).dtype)
    one = jnp.asarray(1.0, dtype=b.dtype)
    rtld = _cj(r)
    z = jnp.zeros_like(b)

    state = dict(it=jnp.asarray(1), flag=jnp.asarray(RUNNING),
                 x=x0, r=r, rtld=rtld, p=z, ptld=z, rho_old=one,
                 nrm=nrm0, rh=rh)

    def step(s):
        z = M.psolve(s["r"])
        ztld = M.psolveh(s["rtld"])
        rho = v.dot(s["rtld"], z, spec.axis_name)
        broke1 = rho == 0.0
        beta = rho / s["rho_old"]
        p = v.xpay(z, beta, s["p"])
        q = A.matvec(p)
        ptld = v.xpay(ztld, _cj(beta), s["ptld"])
        qtld = A.matvech(ptld)
        tmpdot1 = v.dot(ptld, q, spec.axis_name)
        broke = broke1 | (tmpdot1 == 0.0)
        alpha = rho / jnp.where(tmpdot1 == 0.0, one, tmpdot1)
        x = s["x"] + alpha * p
        r = s["r"] - alpha * q
        rtld = s["rtld"] - _cj(alpha) * qtld
        nrm = residual_norm(r, bnrm_inv, spec)
        keep = lambda new, old: jnp.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=jnp.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]),
                    rtld=keep(rtld, s["rtld"]), p=p, ptld=ptld,
                    rho_old=jnp.where(broke, s["rho_old"], rho),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], jnp.where(broke, s["nrm"], nrm)))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("bicr")
def bicr(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, jnp.real(b).dtype)
    one = jnp.asarray(1.0, dtype=b.dtype)
    rtld = _cj(r)

    z = M.psolve(r)
    ztld = M.psolveh(rtld)
    p, ptld = z, ztld
    ap = A.matvec(z)
    rho_old = v.dot(ztld, ap, spec.axis_name)

    state = dict(it=jnp.asarray(1), flag=jnp.asarray(RUNNING),
                 x=x0, r=r, rtld=rtld, z=z, ztld=ztld, p=p, ptld=ptld,
                 ap=ap, rho_old=rho_old, nrm=nrm0, rh=rh)

    def step(s):
        aptld = A.matvech(s["ptld"])
        map_ = M.psolve(s["ap"])
        tmpdot1 = v.dot(aptld, map_, spec.axis_name)
        broke1 = tmpdot1 == 0.0
        alpha = s["rho_old"] / jnp.where(broke1, one, tmpdot1)
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * s["ap"]
        nrm = residual_norm(r, bnrm_inv, spec)
        conv = nrm <= tol_eff
        rtld = s["rtld"] - _cj(alpha) * aptld
        z = s["z"] - alpha * map_
        ztld = M.psolveh(rtld)
        az = A.matvec(z)
        rho = v.dot(ztld, az, spec.axis_name)
        broke2 = (rho == 0.0) & ~conv
        broke = broke1 | broke2
        beta = rho / jnp.where(s["rho_old"] == 0.0, one, s["rho_old"])
        p = v.xpay(z, beta, s["p"])
        ptld = v.xpay(ztld, _cj(beta), s["ptld"])
        ap = v.xpay(az, beta, s["ap"])
        keep1 = lambda new, old: jnp.where(broke1, old, new)
        return dict(it=s["it"] + 1,
                    flag=jnp.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep1(x, s["x"]), r=keep1(r, s["r"]),
                    rtld=keep1(rtld, s["rtld"]),
                    z=keep1(z, s["z"]), ztld=keep1(ztld, s["ztld"]),
                    p=keep1(p, s["p"]), ptld=keep1(ptld, s["ptld"]),
                    ap=keep1(ap, s["ap"]),
                    rho_old=jnp.where(broke, s["rho_old"], rho),
                    nrm=keep1(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"],
                              jnp.where(broke1, s["nrm"], nrm)))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
