"""GMRES(m) and FGMRES(m).

Reference: lis_gmres (src/solver/lis_solver_gmres.c:135) and lis_fgmres
(:1128) — right-preconditioned restarted GMRES with modified Gram-Schmidt
and on-the-fly Givens rotations; restart m default 40
(src/solver/lis_solver.c:246).

Design: the Krylov basis lives as a (m+1, n) matrix on device; the MGS
and rotation loops are masked fori_loops inside one jitted outer
while_loop (restart cycles), and the small Hessenberg solve at each restart
is a padded dense triangular solve — no host round-trips, no dynamic
shapes.  The residual-norm estimate |s[i+1]| drives convergence exactly as
in the reference; the restart residual is recomputed with a fresh matvec
(the reference reconstructs it by un-applying rotations — same math,
different rounding).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lis_tpu.core import vector as v
from lis_tpu.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                  init_residual, loop_output, new_rhistory,
                                  register_solver, residual_norm)


def _gmres_core(A, b, x0, M, spec: SolverSpec, flexible: bool) -> SolverOutput:
    m = spec.restart
    n = b.shape[0]
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, jnp.real(b).dtype)
    dt = b.dtype

    def inner_step(carry):
        (i, it, V, Z, H, cs, sn, svec, nrm, rh) = carry
        vi = V[i]
        z = M.psolve(vi)
        w = A.matvec(z)
        Z = Z.at[i].set(z) if flexible else Z

        # modified Gram-Schmidt against v_0..v_{i-1} (masked full loop)
        def mgs(k, wh):
            w, H = wh
            t = v.dot(w, V[k], spec.axis_name)
            use = k <= i
            w = jnp.where(use, w - t * V[k], w)
            H = H.at[k, i].set(jnp.where(use, t, H[k, i]))
            return (w, H)
        w, H = jax.lax.fori_loop(0, i + 1, mgs, (w, H))

        t = v.nrm2(w, spec.axis_name)
        H = H.at[i + 1, i].set(t)
        V = V.at[i + 1].set(w / jnp.where(t == 0, 1.0, t))

        # apply previous Givens rotations to column i
        def rot(k, H):
            a = cs[k] * H[k, i] + sn[k] * H[k + 1, i]
            bval = -sn[k] * H[k, i] + cs[k] * H[k + 1, i]
            return H.at[k, i].set(a).at[k + 1, i].set(bval)
        H = jax.lax.fori_loop(0, i, rot, H)

        aa, bb = H[i, i], H[i + 1, i]
        rr = jnp.sqrt(aa * aa + bb * bb)
        rr = jnp.where(rr == 0.0, 1.0e-17, rr)
        ci, si = aa / rr, bb / rr
        cs, sn = cs.at[i].set(ci), sn.at[i].set(si)
        svec = svec.at[i + 1].set(-si * svec[i])
        svec = svec.at[i].set(ci * svec[i])
        H = H.at[i, i].set(ci * H[i, i] + si * H[i + 1, i])

        nrm = jnp.abs(svec[i + 1]) * (bnrm_inv if spec.conv_cond != 2 else 1.0)
        rh = rh.at[jnp.minimum(it, spec.maxiter + 1)].set(nrm)
        return (i + 1, it + 1, V, Z, H, cs, sn, svec, nrm, rh)

    def inner_cond(carry):
        i, it, nrm = carry[0], carry[1], carry[8]
        return (i < m) & (it <= spec.maxiter) & (nrm > tol_eff)

    def outer_step(s):
        x, r, it, nrm, rh = s["x"], s["r"], s["it"], s["nrm"], s["rh"]
        rnorm = v.nrm2(r, spec.axis_name)
        V = jnp.zeros((m + 1, n), dtype=dt)
        V = V.at[0].set(r / jnp.where(rnorm == 0, 1.0, rnorm))
        Z = jnp.zeros((m if flexible else 1, n), dtype=dt)
        H = jnp.zeros((m + 1, m), dtype=dt)
        cs = jnp.zeros(m + 1, dtype=dt)
        sn = jnp.zeros(m + 1, dtype=dt)
        svec = jnp.zeros(m + 2, dtype=dt).at[0].set(rnorm)

        carry = (jnp.asarray(0), it, V, Z, H, cs, sn, svec, nrm, rh)
        carry = jax.lax.while_loop(inner_cond, inner_step, carry)
        (i_fin, it, V, Z, H, cs, sn, svec, nrm, rh) = carry

        # padded upper-triangular solve H[:i,:i] y = s[:i]
        valid = jnp.arange(m) < i_fin
        Hm = H[:m, :m]
        Hm = jnp.where(jnp.eye(m, dtype=bool) & ~valid[None, :], 1.0, Hm)
        rhs = jnp.where(valid, svec[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Hm, rhs, lower=False)
        y = jnp.where(valid, y, 0.0)

        if flexible:
            dx = jnp.matmul(Z.T, y[: Z.shape[0]], precision="highest")
        else:
            dx = M.psolve(jnp.matmul(V[:m].T, y, precision="highest"))
        x = x + dx
        r = b - A.matvec(x)
        return dict(x=x, r=r, it=it, nrm=nrm, rh=rh,
                    flag=s["flag"])

    state = dict(x=x0, r=r, it=jnp.asarray(1), nrm=nrm0, rh=rh,
                 flag=jnp.asarray(RUNNING))

    def outer_cond(s):
        return (s["it"] <= spec.maxiter) & (s["nrm"] > tol_eff)

    final = jax.lax.while_loop(outer_cond, outer_step, state)
    return loop_output(spec, tol_eff, final)


@register_solver("gmres")
def gmres(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _gmres_core(A, b, x0, M, spec, flexible=False)


@register_solver("fgmres")
def fgmres(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _gmres_core(A, b, x0, M, spec, flexible=True)
