"""Double-double ("quad") precision tests.

The headline parity check reproduces the reference's test5 demonstration
(test/test.sh:41-45): on the ill-conditioned gamma matrix, double BiCG
stalls at maxiter while quad converges (reference: 231 iterations; this
implementation: ~228 — identical trajectories for the first ~38 iterations,
then rounding-chaos separation, converging at the same Krylov-exhaustion
point).
"""

import numpy as np
import pytest
import jax.numpy as jnp

import lis_tpu
from lis_tpu import solve
from lis_tpu.core import ddreal as q
from tests.problems import gamma_matrix, poisson2d


def test_eft_exactness():
    from fractions import Fraction
    import jax
    rng = np.random.default_rng(0)
    x = q.DD(jnp.asarray(rng.standard_normal(64)),
             jnp.asarray(rng.standard_normal(64) * 1e-17))
    alpha = q.DD(jnp.float64(1 / 3), jnp.float64(6.1e-18))
    res = jax.jit(q.axpy)(alpha, x, x)
    fa = Fraction(1 / 3) + Fraction(6.1e-18)
    worst = 0.0
    for i in range(64):
        fx = Fraction(float(x.hi[i])) + Fraction(float(x.lo[i]))
        exact = fx + fa * fx
        got = Fraction(float(res.hi[i])) + Fraction(float(res.lo[i]))
        worst = max(worst, abs(float((got - exact) / exact)))
    assert worst < 1e-29, worst     # double-double, not double


def test_dd_dot_precision():
    import jax
    from fractions import Fraction
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000)
    y = rng.standard_normal(1000)
    d = jax.jit(lambda a, b: q.dot(q.dd(a), q.dd(b)))(jnp.asarray(x),
                                                      jnp.asarray(y))
    exact = sum(Fraction(a) * Fraction(b) for a, b in zip(x, y))
    got = Fraction(float(d.hi)) + Fraction(float(d.lo))
    assert abs(float((got - exact) / exact)) < 1e-30


def test_quad_beats_double_on_gamma_matrix():
    """The reference's test5 200 2.0: double -> LIS_MAXITER, quad -> SUCCESS
    in ≈231 iterations."""
    g = gamma_matrix(200, 2.0)
    b = np.asarray(g.to_dense() @ np.ones(200))
    rd = solve(g, b, options="-i bicg -f double -tol 1e-12 -maxiter 1000")
    assert rd.status == lis_tpu.LIS_MAXITER
    rq = solve(g, b, options="-i bicg -f quad -tol 1e-12 -maxiter 1000")
    assert rq.status == lis_tpu.LIS_SUCCESS
    assert 150 < rq.iters < 350           # reference: 231
    err = np.linalg.norm(np.asarray(rq.x) - 1.0) / np.sqrt(200)
    assert err < 1e-10


def test_switch_variant():
    g = gamma_matrix(120, 2.0)
    b = np.asarray(g.to_dense() @ np.ones(120))
    r = solve(g, b, options="-i bicg -f switch -switch_maxiter 300 "
                            "-switch_tol 1e-10 -tol 1e-12 -maxiter 1000")
    assert r.status == lis_tpu.LIS_SUCCESS
    err = np.linalg.norm(np.asarray(r.x) - 1.0) / np.sqrt(120)
    assert err < 1e-10


@pytest.mark.parametrize("name", ["cg", "cr", "bicg", "cgs", "bicgstab",
                                  "bicr", "crs", "bicrstab", "gpbicg",
                                  "gpbicr", "bicgsafe", "bicrsafe",
                                  "tfqmr", "orthomin", "bicgstabl",
                                  "gmres", "fgmres"])
def test_quad_variants_converge(name):
    a = poisson2d(8, 8)
    b = np.ones(64)
    r = solve(a, b, options=f"-i {name} -f quad -tol 1e-14 -maxiter 500")
    assert r.status == lis_tpu.LIS_SUCCESS, (name, r)
    x = np.asarray(r.x)
    tr = np.linalg.norm(b - a.to_dense() @ x) / np.linalg.norm(b)
    assert tr < 1e-12, (name, tr)


def test_quad_gmres_beats_double_accuracy():
    """-tol 1e-14 with conv on the recursive residual: quad GMRES reaches a
    true residual double cannot represent through the Givens recurrences."""
    a = poisson2d(10, 10)
    ad = a.to_dense()
    b = np.ones(100)
    rq = solve(a, b, options="-i gmres -f quad -tol 1e-15 -maxiter 400")
    tr = np.linalg.norm(b - np.asarray(ad) @ np.asarray(rq.x)) / np.linalg.norm(b)
    assert rq.status == lis_tpu.LIS_SUCCESS
    assert tr < 5e-15, tr


def test_df_matches_double_accuracy():
    """-f df (f32-pair double-float, the f32-limb extended precision):
    solution accuracy matches -f double on the same problem."""
    a = poisson2d(20, 20)
    xs = np.linspace(1, 2, 400)
    b = np.asarray(a.to_dense() @ xs)
    rd = solve(a, b, options="-i cg -f double -tol 1e-10")
    rf = solve(a, b, options="-i cg -f df -tol 1e-10")
    ed = np.abs(np.asarray(rd.x) - xs).max()
    ef = np.abs(np.asarray(rf.x) - xs).max()
    assert rf.status == lis_tpu.LIS_SUCCESS
    assert ef < 10 * max(ed, 1e-12), (ef, ed)


def test_single_and_switch_df():
    a = poisson2d(20, 20)
    xs = np.linspace(1, 2, 400)
    b = np.asarray(a.to_dense() @ xs)
    rs = solve(a, b, options="-i cg -f single -tol 1e-7")
    assert rs.status == lis_tpu.LIS_SUCCESS
    assert np.asarray(rs.x).dtype == np.float64  # driver returns host dtype
    rsw = solve(a, b, options="-i cg -f switch_df -tol 1e-10")
    assert rsw.status == lis_tpu.LIS_SUCCESS
    assert np.abs(np.asarray(rsw.x) - xs).max() < 1e-9
