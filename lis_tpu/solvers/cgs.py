"""CGS and CRS — transpose-free squared methods.

Reference: lis_cgs (src/solver/lis_solver_cgs.c:134) and lis_crs (:805).
Both avoid Aᴴ in the loop (CRS applies it once at setup to form the shadow
vector), which means the iteration is pure gather/segment-sum SpMV —
no scatter-adds — at the price of squared residual polynomials.
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


@register_solver("cgs")
def cgs(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, jnp.real(b).dtype)
    one = jnp.asarray(1.0, dtype=b.dtype)
    z = jnp.zeros_like(b)

    state = dict(it=jnp.asarray(1), flag=jnp.asarray(RUNNING),
                 x=x0, r=r, rtld=_cj(r), p=z, q=z, rho_old=one,
                 nrm=nrm0, rh=rh)

    def step(s):
        rho = v.dot(s["rtld"], s["r"], spec.axis_name)
        broke1 = rho == 0.0
        beta = rho / s["rho_old"]
        u = s["r"] + beta * s["q"]
        p = u + beta * (s["q"] + beta * s["p"])
        phat = M.psolve(p)
        vhat = A.matvec(phat)
        tmpdot1 = v.dot(s["rtld"], vhat, spec.axis_name)
        broke = broke1 | (tmpdot1 == 0.0)
        alpha = rho / jnp.where(tmpdot1 == 0.0, one, tmpdot1)
        q = u - alpha * vhat
        uhat = M.psolve(u + q)
        x = s["x"] + alpha * uhat
        qhat = A.matvec(uhat)
        r = s["r"] - alpha * qhat
        nrm = residual_norm(r, bnrm_inv, spec)
        keep = lambda new, old: jnp.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=jnp.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]), rtld=s["rtld"],
                    p=p, q=keep(q, s["q"]),
                    rho_old=jnp.where(broke, s["rho_old"], rho),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], jnp.where(broke, s["nrm"], nrm)))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("crs")
def crs(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, jnp.real(b).dtype)
    one = jnp.asarray(1.0, dtype=b.dtype)
    rtld = A.matvech(_cj(r))        # shadow = Aᴴ·conj(r₀) (lis_crs setup)
    z = jnp.zeros_like(b)

    state = dict(it=jnp.asarray(1), flag=jnp.asarray(RUNNING),
                 x=x0, r=r, rtld=rtld, p=z, q=z, rho_old=one,
                 nrm=nrm0, rh=rh)

    def step(s):
        z = M.psolve(s["r"])
        rho = v.dot(s["rtld"], z, spec.axis_name)
        broke1 = rho == 0.0
        beta = rho / s["rho_old"]
        u = z + beta * s["q"]
        p = u + beta * (s["q"] + beta * s["p"])
        ap = A.matvec(p)
        map_ = M.psolve(ap)
        tmpdot1 = v.dot(s["rtld"], map_, spec.axis_name)
        broke = broke1 | (tmpdot1 == 0.0)
        alpha = rho / jnp.where(tmpdot1 == 0.0, one, tmpdot1)
        q = u - alpha * map_
        uq = u + q
        auq = A.matvec(uq)
        x = s["x"] + alpha * uq
        r = s["r"] - alpha * auq
        nrm = residual_norm(r, bnrm_inv, spec)
        keep = lambda new, old: jnp.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=jnp.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]), rtld=s["rtld"],
                    p=p, q=keep(q, s["q"]),
                    rho_old=jnp.where(broke, s["rho_old"], rho),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], jnp.where(broke, s["nrm"], nrm)))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
