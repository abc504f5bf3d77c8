"""Linear-solver end-to-end tests (test1/test2-equivalent behavior)."""

import numpy as np
import pytest
import jax.numpy as jnp

import lis_tpu
from lis_tpu import solve
from tests.problems import poisson2d, random_sparse, tridiag


def _check(res, a, b, tol=1e-8):
    assert res.status == lis_tpu.LIS_SUCCESS, res
    x = np.asarray(res.x)
    r = np.asarray(b) - a.to_dense() @ x
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < tol, res


def test_cg_poisson2d():
    a = poisson2d(10, 10)
    xref = np.ones(100)
    b = a.to_dense() @ xref
    res = solve(a, b, options="-i cg -tol 1e-12")
    _check(res, a, b, 1e-10)
    np.testing.assert_allclose(np.asarray(res.x), xref, rtol=1e-8)
    assert res.iters < 100
    assert res.rhistory[0] == 1.0 or res.rhistory[0] > 0


def test_cg_jacobi_precon():
    a = random_sparse(80, density=0.05, seed=1, spd=True)
    b = np.ones(80)
    res = solve(a, b, options="-i cg -p jacobi -tol 1e-12")
    _check(res, a, b, 1e-10)


def test_cr_poisson():
    a = poisson2d(8, 8)
    b = np.ones(64)
    res = solve(a, b, options="-i cr -tol 1e-12")
    _check(res, a, b, 1e-10)


def test_conv_cond_variants():
    a = tridiag(50)
    b = np.ones(50)
    for cc in ("nrm2_r", "nrm2_b"):
        res = solve(a, b, options=f"-i cg -conv_cond {cc} -tol 1e-10")
        _check(res, a, b, 1e-8)
    # nrm1_b measures the raw ||r||_1 against ||b||_1*tol_w + tol
    # (lis_solver.c:1804 + :1052-1057); with tol_w=0 it is absolute.
    res = solve(a, b, options="-i cg -conv_cond nrm1_b -tol_w 0 -tol 1e-9")
    _check(res, a, b, 1e-8)
    # with the default tol_w=1 the criterion is satisfied immediately
    res2 = solve(a, b, options="-i cg -conv_cond nrm1_b -tol 1e-9")
    assert res2.iters == 1


def test_scaling_modes():
    a = random_sparse(60, density=0.08, seed=2, spd=True)
    b = np.ones(60)
    for sc in (0, 1, 2):
        res = solve(a, b, options=f"-i cg -tol 1e-12 -scale {sc}")
        _check(res, a, b, 1e-9)


def test_maxiter_status():
    a = poisson2d(12, 12)
    b = np.ones(144)
    res = solve(a, b, options="-i cg -tol 1e-14 -maxiter 3")
    assert res.status == lis_tpu.LIS_MAXITER
    assert res.iters == 3


def test_rhistory_monotone_recording():
    a = poisson2d(6, 6)
    b = np.ones(36)
    res = solve(a, b, options="-i cg -tol 1e-12")
    assert len(res.rhistory) == res.iters + 1
    assert res.rhistory[-1] <= 1e-12


def test_option_string_parsing():
    from lis_tpu.runtime.options import SolverOptions
    o = SolverOptions.from_string(
        "-i gmres -p ilu -ilu_fill 1 -tol 1e-10 -maxiter 500 -restart 30 "
        "-print all -scale jacobi -conv_cond nrm2_b -f quad")
    assert o.solver == "gmres" and o.precon == "ilu"
    assert o.ilu_fill == 1 and o.tol == 1e-10 and o.maxiter == 500
    assert o.restart == 30 and o.print_ == 3 and o.scale == 1
    assert o.conv_cond == 1 and o.precision == "quad"
    # numeric ids accepted like the reference
    o2 = SolverOptions.from_string("-i 1 -p 2")
    assert o2.solver == "cg" and o2.precon == "ilu"


def test_formats_solve_identically():
    a = poisson2d(7, 7)
    b = np.ones(49)
    iters = {}
    for fmt in ("csr", "ell", "dia", "msr", "jad", "bsr", "dns"):
        from lis_tpu.matrix.convert import convert_matrix
        m = convert_matrix(a, fmt)
        res = solve(m, b, options="-i cg -tol 1e-12")
        _check(res, a, b, 1e-10)
        iters[fmt] = res.iters
    assert len(set(iters.values())) == 1, iters  # same math in every format


def test_nonzero_x0_and_conv_conds():
    """-initx_zeros false honors the caller's x0; all three -conv_cond
    criteria converge (lis_solver_get_residual[], lis_solver.c:157-161)."""
    from tests.problems import poisson2d
    a = poisson2d(10, 10)
    b = np.asarray(a.to_dense() @ np.ones(100))
    x0 = np.random.default_rng(3).standard_normal(100)
    r = solve(a, b, options="-i cg -initx_zeros false -tol 1e-10", x0=x0)
    assert r.status == lis_tpu.LIS_SUCCESS
    r0 = solve(a, b, options="-i cg -tol 1e-10")
    # the nonzero guess was actually used: different convergence trajectory
    k = min(r.iters, r0.iters)
    assert not np.allclose(r.rhistory[:k], r0.rhistory[:k])
    # nrm1_b needs -tol_w: its criterion is ||r||_1 <= tol_w*||b||_1 + tol
    # and the reference's default tol_w=1.0 converges trivially
    # (lis_solver.c:271,814) — reproduce that too
    rt = solve(a, b, options="-i bicgstab -conv_cond nrm1_b -tol 1e-9")
    assert rt.status == lis_tpu.LIS_SUCCESS and rt.iters == 1
    for copt in ("-conv_cond nrm2_r", "-conv_cond nrm2_b",
                 "-conv_cond nrm1_b -tol_w 0"):
        rc = solve(a, b, options=f"-i bicgstab {copt} -tol 1e-9")
        assert rc.status == lis_tpu.LIS_SUCCESS, copt
        assert np.abs(np.asarray(rc.x) - 1).max() < 1e-6, copt


def test_print_mem_records_history():
    """-print mem records rhistory without console output (lis.h:141-144)."""
    from tests.problems import poisson2d
    a = poisson2d(8, 8)
    r = solve(a, np.ones(64), options="-i cg -print mem -tol 1e-10")
    assert len(r.rhistory) == r.iters + 1
    assert r.rhistory[0] == 1.0
    assert r.rhistory[-1] < 1e-9


def test_debug_trace_stream():
    """Per-function trace (LIS_DEBUG_FUNC_IN/OUT analogue, lis_error.c:67):
    nested IN/OUT lines appear only while enabled."""
    import io
    import numpy as np
    import lis_tpu
    from tests.problems import tridiag
    buf = io.StringIO()
    lis_tpu.set_debug_trace(True, stream=buf)
    try:
        lis_tpu.solve(tridiag(10), np.ones(10), options="-i cg -tol 1e-10")
    finally:
        lis_tpu.set_debug_trace(False)
    out = buf.getvalue()
    assert "IN : driver.solve" in out and "OUT: driver.solve" in out
    buf2 = io.StringIO()
    lis_tpu.set_debug_trace(False, stream=buf2)
    lis_tpu.solve(tridiag(10), np.ones(10), options="-i cg -tol 1e-10")
    assert buf2.getvalue() == ""


def test_tol_maxiter_change_does_not_recompile():
    """tol/tol_w/maxiter are dynamic operands of the compiled solver: a
    tolerance or budget change within the same power-of-two history
    bucket reuses the compiled program (compiles take tens of seconds at
    10M-row shapes)."""
    import numpy as np
    import lis_tpu
    from lis_tpu.solvers.driver import _execute_dyn
    from tests.problems import poisson2d
    a = poisson2d(10, 10)
    b = np.ones(100)
    lis_tpu.solve(a, b, options="-i bicgstab -tol 1e-8 -maxiter 600")
    n0 = _execute_dyn._cache_size()
    for opt in ("-tol 1e-10 -maxiter 900", "-tol 1e-6 -maxiter 1000",
                "-tol 1e-12 -maxiter 513"):
        r = lis_tpu.solve(a, b, options=f"-i bicgstab {opt}")
        assert r.status == lis_tpu.LIS_SUCCESS
    assert _execute_dyn._cache_size() == n0


def test_live_print_out(capfd):
    """-print out emits each iteration's residual DURING the solve via a
    host callback (reference lis_print_rhistory, lis_solver_cg.c:217-221),
    and the final banner does not replay the history."""
    import jax
    r = lis_tpu.solve(tridiag(40), np.ones(40),
                      options="-i cg -tol 1e-10 -print out")
    jax.effects_barrier()          # host callbacks drain asynchronously
    import sys
    sys.stdout.flush()
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("iteration:")]
    # live per-iteration lines, each exactly once (the banner must NOT
    # replay the history when live printing is on)
    assert len(lines) >= max(r.iters - 1, 1), out[-500:]
    assert len(lines) == len(set(lines))
    assert "relative residual" in lines[0]
