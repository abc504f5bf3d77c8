"""IDR(s) and IDR(1) (reference: lis_idrs src/solver/lis_solver_idrs.c:526,
lis_idr1 :223).

Induced dimension reduction with an s-dimensional random shadow space P,
seeded from MT19937 with the reference's init_by_array seed
{0x123,0x234,0x345,0x456} (lis_solver_idrs.c:538) and orthonormalised the
same way (lis_idrs_orth :202), so the shadow space matches the reference
bit-for-bit (numpy's RandomState is the same MT19937 generator).
Right-preconditioned (the reference's PRE_RIGHT build default, :50).

The dX/dR difference stacks are (s, n) device matrices; the small s×s
Petrov-Galerkin system solves with jnp.linalg.solve inside the loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu import config as C
from lis_tpu.core import vector as v
from lis_tpu.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                  init_residual, loop_output, new_rhistory,
                                  register_prepare, register_solver,
                                  residual_norm)


def _shadow_space(s: int, n: int, dtype) -> np.ndarray:
    """P = MT19937 randoms (genrand_real1 = u32/(2³²-1)) then the
    reference's normalize-then-project Gram-Schmidt."""
    rs = np.random.RandomState(np.array([0x123, 0x234, 0x345, 0x456],
                                        dtype=np.uint32))
    draws = rs.randint(0, 2**32, size=(s, n), dtype=np.uint64).astype(np.float64)
    P = (draws / 4294967295.0).astype(dtype)
    for j in range(s):
        P[j] /= np.linalg.norm(P[j])
        for i in range(j + 1, s):
            P[i] -= (P[j] @ P[i]) * P[j]
    return P


@register_prepare("idrs")
def prepare_idrs(A, spec):
    return jnp.asarray(_shadow_space(spec.irestart, A.nrows, np.float64))


@register_prepare("idr1")
def prepare_idr1(A, spec):
    return jnp.asarray(_shadow_space(1, A.nrows, np.float64))


def _mm(a, b):
    """a @ b at full f32 accuracy (a GPU may otherwise use TF32)."""
    return jnp.matmul(a, b, precision="highest")


def _pmat(P, vec, axis_name):
    """P @ vec with a psum over the sharded vector axis (the s shadow dots
    are global reductions, like every other dot)."""
    local = jnp.matmul(P, vec, precision="highest")
    if axis_name is None:
        return local
    return jax.lax.psum(local, axis_name)


def _idrs_core(A, b, x0, M, spec: SolverSpec, P) -> SolverOutput:
    s = P.shape[0]
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, jnp.real(b).dtype)
    one = jnp.asarray(1.0, dtype=b.dtype)
    n = b.shape[0]
    dt = b.dtype

    # ---- initial s steps: build dX, dR, Mmat -------------------------------
    def init_step(k, carry):
        x, r, dX, dR, Mmat, nrm, rh, done, itk = carry
        active = ~done
        dx = M.psolve(r)
        dr = A.matvec(dx)
        h = v.dot(dr, dr, spec.axis_name)
        om = v.dot(dr, r, spec.axis_name) / jnp.where(h == 0, one, h)
        dx = om * dx
        dr = -om * dr
        x = jnp.where(active, x + dx, x)
        r = jnp.where(active, r + dr, r)
        dX = dX.at[k].set(jnp.where(active, dx, dX[k]))
        dR = dR.at[k].set(jnp.where(active, dr, dR[k]))
        nrm_new = jnp.where(active, residual_norm(r, bnrm_inv, spec), nrm)
        rh = rh.at[k + 1].set(jnp.where(active, nrm_new, rh[k + 1]))
        Mmat = Mmat.at[:, k].set(jnp.where(active, _pmat(P, dR[k], spec.axis_name), Mmat[:, k]))
        itk = jnp.where(active, itk + 1, itk)
        done = done | (nrm_new <= tol_eff)
        return (x, r, dX, dR, Mmat, nrm_new, rh, done, itk)

    dX = jnp.zeros((s, n), dtype=dt)
    dR = jnp.zeros((s, n), dtype=dt)
    Mmat = jnp.zeros((s, s), dtype=dt)
    x, r, dX, dR, Mmat, nrm, rh, done, itk = jax.lax.fori_loop(
        0, s, init_step, (x0, r, dX, dR, Mmat, nrm0, rh,
                          nrm0 <= tol_eff, jnp.asarray(0)))

    m = _pmat(P, r, spec.axis_name)

    state = dict(it=itk, flag=jnp.asarray(RUNNING),
                 x=x, r=r, dX=dX, dR=dR, Mmat=Mmat, m=m,
                 om=jnp.asarray(1.0, dt), oldest=jnp.asarray(0),
                 nrm=nrm, rh=rh)

    def step(st):
        c = jnp.linalg.solve(st["Mmat"], st["m"])
        vvec = st["r"] - _mm(c, st["dR"])
        refresh = (st["it"] % (s + 1)) == s
        av = M.psolve(vvec)

        def do_refresh(_):
            t = A.matvec(av)
            h = v.dot(t, t, spec.axis_name)
            om = v.dot(t, vvec, spec.axis_name) / jnp.where(h == 0, one, h)
            dx = om * av - _mm(c, st["dX"])
            dr = -om * t - _mm(c, st["dR"])
            return dx, dr, om

        def do_normal(_):
            dx = st["om"] * av - _mm(c, st["dX"])
            dr = -A.matvec(dx)
            return dx, dr, st["om"]

        dx, dr, om = jax.lax.cond(refresh, do_refresh, do_normal, None)
        oldest = st["oldest"]
        dX = st["dX"].at[oldest].set(dx)
        dR = st["dR"].at[oldest].set(dr)
        r = st["r"] + dr
        x = st["x"] + dx
        it = st["it"] + 1
        nrm = residual_norm(r, bnrm_inv, spec)
        rh = st["rh"].at[jnp.minimum(it, spec.maxiter + 1)].set(nrm)
        h = _pmat(P, dr, spec.axis_name)
        m = st["m"] + h
        Mmat = st["Mmat"].at[:, oldest].set(h)
        return dict(it=it, flag=st["flag"], x=x, r=r, dX=dX, dR=dR,
                    Mmat=Mmat, m=m, om=om,
                    oldest=(oldest + 1) % s, nrm=nrm, rh=rh)

    def cond(st):
        return (st["it"] <= spec.maxiter) & (st["nrm"] > tol_eff) \
            & (st["flag"] == RUNNING)

    final = jax.lax.while_loop(cond, step, state)
    out = dict(final)
    out["it"] = final["it"] + 1     # loop_output's it-1 convention
    return loop_output(spec, tol_eff, out)


@register_solver("idrs")
def idrs(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _idrs_core(A, b, x0, M, spec, aux)


@register_solver("idr1")
def idr1(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _idrs_core(A, b, x0, M, spec, aux)
