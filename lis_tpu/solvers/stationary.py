"""Stationary solvers: Jacobi, Gauss-Seidel, SOR.

Reference: lis_jacobi (src/solver/lis_solver_jacobi.c:113), lis_gs
(lis_solver_gs.c:113), lis_sor (lis_solver_sor.c:123).  All three are
right-preconditioned defect-correction loops: s = M⁻¹x, r = b - A s,
x += W r, exiting with x = M⁻¹x.  W is D⁻¹ (Jacobi), (D+L)⁻¹ (GS),
(D/ω+L)⁻¹ (SOR, -omega default 1.9).  The triangular solves use the
level-scheduled plan (ops/trisolve), built host-side in the prepare hook —
the analogue of the reference's lis_matrix_split + WD setup.  Convergence
measures the raw ||r||₂/||b||₂ regardless of conv_cond, like the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.core import vector as v
from lis_tpu.ops.trisolve import make_plan, trisolve
from lis_tpu.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                  krylov_loop, loop_output, new_rhistory,
                                  record, register_prepare, register_solver)


def _stationary(A, b, x0, M, spec, apply_w):
    bn = v.nrm2(b, spec.axis_name)
    bnrm_inv = jnp.where(bn == 0, 1.0, 1.0 / jnp.where(bn == 0, 1.0, bn))
    r0 = b - A.matvec(M.psolve(x0))
    nrm0 = v.nrm2(r0, spec.axis_name) * bnrm_inv
    rh = new_rhistory(spec, nrm0, jnp.real(b).dtype)

    state = dict(it=jnp.asarray(1), flag=jnp.asarray(RUNNING),
                 x=x0, nrm=nrm0, rh=rh)

    def step(s):
        t = A.matvec(M.psolve(s["x"]))
        r = b - t
        nrm = v.nrm2(r, spec.axis_name) * bnrm_inv
        x = s["x"] + apply_w(r)
        return dict(it=s["it"] + 1, flag=s["flag"], x=x,
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    final = krylov_loop(spec, spec.tol, state, step)
    out = loop_output(spec, spec.tol, final)
    # exit psolve like the reference (x = M⁻¹x on return)
    return out._replace(x=M.psolve(out.x))


class _LowerSweep:
    """(D/w + L)⁻¹ by Jacobi-relaxed diagonal-stream sweeps — the path
    for DIA operators (exact level-scheduled solves gather row by row;
    the reference's own OpenMP tri-solve relaxes dependencies the same
    way, lis_matrix_csr.c:1577-1605)."""

    def __init__(self, L, wd, nsweeps=3):
        self.L = L
        self.wd = wd
        self.nsweeps = nsweeps

    def apply(self, r):
        y = r * self.wd
        for _ in range(self.nsweeps):
            y = (r - self.L.matvec(y)) * self.wd
        return y


jax.tree_util.register_pytree_node(
    _LowerSweep,
    lambda m: ((m.L, m.wd), (m.nsweeps,)),
    lambda aux, c: _LowerSweep(*c, *aux))


def _lower_plan(A, w: float = 1.0):
    """(D/w + L) solve setup: WD = (D/w)⁻¹ (lis_solver_sor.c diag setup).
    DIA operators get the relaxed-sweep apply; others a level plan.
    The truncated-sweep Neumann terms decay like (w·|L|/D)^k, so the fast
    path is gated at w <= 1.5 (the SOR default 1.9 barely decays on
    Poisson-class operators and needs the exact solve)."""
    if getattr(A, "format_name", None) == "dia" and w <= 1.5:
        from lis_tpu.precon.ssor import _split_dia
        L, _, d = _split_dia(A)
        wd = jnp.where(d != 0, w / jnp.where(d != 0, d, 1), 1.0)
        return _LowerSweep(L, wd)
    from lis_tpu.matrix.split import split_matrix
    s = split_matrix(A)
    ptr, index, value = s.L.to_csr_arrays()
    d = np.asarray(s.D)
    with np.errstate(divide="ignore"):
        dinv = np.where(d != 0, w / np.where(d != 0, d, 1), 1.0)
    return make_plan(ptr, index, value, dinv, lower=True)


@register_prepare("gs")
def prepare_gs(A, spec):
    return _lower_plan(A, 1.0)


@register_prepare("sor")
def prepare_sor(A, spec):
    return _lower_plan(A, spec.omega)


@register_solver("jacobi")
def jacobi(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    d = A.get_diagonal()
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 1.0)
    return _stationary(A, b, x0, M, spec, lambda r: dinv * r)


def _w_apply(aux):
    return aux.apply if hasattr(aux, "apply") else (lambda r: trisolve(aux, r))


@register_solver("gs")
def gs(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _stationary(A, b, x0, M, spec, _w_apply(aux))


@register_solver("sor")
def sor(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _stationary(A, b, x0, M, spec, _w_apply(aux))
