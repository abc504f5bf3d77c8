#!/usr/bin/env python3
"""On-card smoke test of lis_tpu's solve path.

Drives the library's own entry points (``solve``, ``esolve``,
``dist_solve`` and the CLIs' ``main``) once on a GPU, at the size the
repository's targets name, and checks every answer against a plain
numpy/scipy reference.  Everything runs in this one process: a second JAX
process could not get the card's memory.

    python chip_smoke.py                  # phases 0-6 on one GPU
    python chip_smoke.py --four           # the four-GPU mesh phase only
    python chip_smoke.py --phases 1,3     # a subset of the one-GPU phases

Each check prints one line: what was checked, its error against the
reference, the tolerance and why, and its seconds.  Any failed check makes
the exit code 1.  The last line of standard output is one JSON object
naming the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Sizes:
    stencil: int        # 27-point Poisson grid edge (rows = edge^3)
    lf_rows: int        # locality-free matrix: rows, 16 random nnz per row
    band_rows: int      # band-clustered matrix: rows, 20 nnz within +-160
    amg: int            # SA-AMG jump-coefficient grid edge
    grid2d: int         # 2-D Poisson edge for precision/eigen/complex
    cli: int            # 2-D Poisson edge of the CLI's Matrix Market file
    stream: int         # elements of the bandwidth probe (f64)
    calls: int          # timed calls per median


# FULL is the default: 216^3 is BASELINE.md's 10M-row target;
# 2^22 x 16 nnz is ~800 MB of CSR, > 4x the card's 50 MB L2
FULL = Sizes(stencil=216, lf_rows=1 << 22, band_rows=1 << 21, amg=128,
             grid2d=256, cli=64, stream=1 << 28, calls=20)
TINY = Sizes(stencil=8, lf_rows=1 << 12, band_rows=1 << 11, amg=10,
             grid2d=12, cli=8, stream=1 << 12, calls=3)


class Report:
    """Collects checks; a phase fails if any of its checks failed."""

    def __init__(self, out=None):
        self.out = out or sys.stdout
        self.failed: list[str] = []
        self.phase = "-"

    def say(self, msg: str):
        print(f"[{self.phase}] {msg}", file=self.out, flush=True)

    def check(self, name, err, tol, why, seconds, extra=""):
        ok = err is not None and err == err and err <= tol
        self.say(f"{'ok  ' if ok else 'FAIL'} {name}: err={err:.3e} "
                 f"tol={tol:.1e} ({why}) {seconds:.2f}s"
                 + (f" {extra}" if extra else ""))
        if not ok:
            self.failed.append(f"{self.phase}:{name}")
        return ok

    def expect(self, name, cond, detail, seconds=0.0):
        self.say(f"{'ok  ' if cond else 'FAIL'} {name}: {detail} "
                 f"{seconds:.2f}s")
        if not cond:
            self.failed.append(f"{self.phase}:{name}")
        return cond


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _rel(got, want):
    import numpy as np
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-300))


def _median_seconds(f, *args, calls=20):
    """Median wall time of ``calls`` synchronised calls after two warm-up
    calls (the first compiles)."""
    import jax
    import numpy as np
    jax.block_until_ready(f(*args))
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def csr_bytes(n, nnz, itemsize=8):
    """Bytes a CSR SpMV must move at least: values + int32 column indices
    + int32 row pointers + x read once + y written once."""
    return nnz * (itemsize + 4) + (n + 1) * 4 + 2 * n * itemsize


def _cond27(edge):
    """2-norm condition number of the 27-point operator (26 on the
    diagonal, -1 off it) on an edge^3 grid: A = 27 I - T(x)T(x)T with
    T = tridiag(1, 1, 1), whose eigenvalues are 1 + 2 cos(k pi/(edge+1))."""
    import numpy as np
    t = 1 + 2 * np.cos(np.arange(1, edge + 1) * np.pi / (edge + 1))
    lam_min = 27 - t.max() ** 3
    lam_max = 27 - t.max() ** 2 * t.min()
    return float(lam_max / lam_min)


def _route_name(A):
    """Format that solve()'s auto-routing picked for A (cached on A)."""
    routed = getattr(A, "_auto_dia", None)
    return routed.format_name if routed else A.format_name


def _free():
    """Drop device buffers held by caches between phases."""
    import jax
    from lis_tpu.ops.shuffle import clear_plan_cache
    clear_plan_cache()
    gc.collect()
    jax.clear_caches()


def _stream_gbs(rep, S):
    """Bandwidth of a plain scale y = a x in this run (read + write)."""
    import jax
    import jax.numpy as jnp
    x = jnp.ones(S.stream, jnp.float64)
    f = jax.jit(lambda v: v * 1.000001)
    t = _median_seconds(f, x, calls=S.calls)
    gbs = 2 * S.stream * 8 / t / 1e9
    rep.say(f"stream y=a*x f64 {S.stream * 8 / 2**30:.2f} GiB: "
            f"{t * 1e3:.3f} ms  {gbs:.1f} GB/s")
    return gbs


# ---------------------------------------------------------------------------
# phase 0: device
# ---------------------------------------------------------------------------

def phase_device(rep):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices only",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    for line in smi.stdout.strip().splitlines():
        rep.say(f"card: {line.strip()}")
    rep.say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")


# ---------------------------------------------------------------------------
# phase 1: the main path (BASELINE.md's 10M-row solves, hpcg_kernel)
# ---------------------------------------------------------------------------

def phase_main(rep, S):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import lis_tpu
    from lis_tpu.utils.testmat import poisson3d27

    e = S.stencil
    t0 = time.perf_counter()
    A = poisson3d27(e, e, e)
    n = A.nrows
    ones = jnp.ones(n)
    b = A.matvec(ones)
    rep.say(f"poisson3d27 {e}^3: {n} rows, {A.nnz} nnz, CSR built in "
            f"{time.perf_counter() - t0:.1f}s")
    kappa = _cond27(e)
    tol_x = 2 * kappa * 1e-10
    for name, opts in (
            ("cg+ilu0", "-i cg -p ilu -ilu_fill 0"),
            ("gmres30+ssor", "-i gmres -restart 30 -p ssor")):
        t0 = time.perf_counter()
        r = lis_tpu.solve(A, b, options=f"{opts} -tol 1e-10 -maxiter 5000")
        dt = time.perf_counter() - t0
        fmt = _route_name(A)
        info = (f"iters={r.iters} status={r.status} route={fmt} "
                f"setup={r.time - r.itime:.2f}s iter={r.itime:.2f}s")
        rep.check(f"{name} f64 true residual", r.true_resid, 1e-10,
                  "BASELINE.md target", dt, info)
        rep.check(f"{name} x vs ones", _rel(r.x, ones), tol_x,
                  f"2 cond(A) tol, cond(A)={kappa:.0f}", 0.0)
        del r
    Ad = A._auto_dia
    rep.expect("auto-routing of the stencil", _route_name(A) == "dia",
               f"route={_route_name(A)}")
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n))
    want = A.matvec(x)
    for name, M in (("csr", A), ("dia", Ad)):
        f = jax.jit(lambda M, v: M.matvec(v))
        err = _rel(f(M, x), want)
        t = _median_seconds(f, M, x, calls=S.calls)
        gbs = csr_bytes(n, A.nnz) / t / 1e9
        rep.check(f"spmv {name} {e}^3 vs csr", err, 1e-13,
                  "f64, 27 terms summed in another order", t,
                  f"median={t * 1e3:.3f}ms csr-equiv={gbs:.1f}GB/s")
    _stream_gbs(rep, S)
    del A, Ad, b, ones, x, want
    _free()

    # the CLI's own entry: CG + SSOR + additive Schwarz, default tol 1e-12
    from lis_tpu.cli import hpcg
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = hpcg.main([str(e), str(e), str(e)])
    dt = time.perf_counter() - t0
    out = buf.getvalue()
    vals = {ln.split("=")[0].strip(): ln.split("=")[1].strip()
            for ln in out.splitlines() if "=" in ln}
    tr = float(vals.get("true residual", "nan"))
    rep.check("hpcg_kernel cg+ssor+adds true residual", tr, 1e-12,
              "the CLI's default -tol 1e-12", dt,
              f"rc={rc} iters={vals.get('number of iterations')} "
              f"max|x-1|={vals.get('max abs error vs ones')}")
    _free()


# ---------------------------------------------------------------------------
# phase 2: format oracles
# ---------------------------------------------------------------------------

FORMATS = ["csr", "csc", "msr", "dia", "ell", "jad", "bsr", "bsc", "vbr",
           "coo", "dns", "bes", "css", "cst", "hdi", "mbes"]


def _oracle_matrix(fmt):
    """A scipy CSR oracle matrix: small and random for the Lis formats,
    quasi-banded for hdi, two affine bands for mbes."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(3)
    if fmt == "hdi":
        from lis_tpu.utils.testmat import poisson2d
        p, i, v = poisson2d(20, 20).to_csr_arrays()
        a = sp.csr_matrix((v, i, p), shape=(400, 400)) \
            + sp.random(400, 400, density=0.0015, random_state=7)
    elif fmt == "mbes":
        n = 8000
        rows = np.repeat(np.arange(n), 8)
        off = np.where(rng.random(n * 8) < 0.5,
                       rng.integers(-40, 41, size=n * 8),
                       5000 + rng.integers(-40, 41, size=n * 8))
        cols = np.clip(rows + off, 0, n - 1)
        a = sp.coo_matrix((rng.standard_normal(n * 8), (rows, cols)),
                          shape=(n, n)) + sp.eye(n)
    else:
        a = sp.random(37, 37, density=0.15, random_state=rng) \
            + 37 * sp.eye(37)
    a = a.tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return a


def _build(fmt, a):
    if fmt == "mbes":
        from lis_tpu.matrix.bes import multi_bes_from_csr
        return multi_bes_from_csr(a.indptr, a.indices, a.data, a.shape)
    from lis_tpu.matrix.convert import convert_matrix
    from lis_tpu.matrix.csr import CSRMatrix
    return convert_matrix(CSRMatrix.from_csr_arrays(
        a.indptr, a.indices, a.data, a.shape), fmt)


def phase_formats(rep, S):
    import jax
    import jax.numpy as jnp
    import numpy as np
    for fmt in FORMATS:
        a64 = _oracle_matrix(fmt)
        for dt, tol, why in (
                (np.float64, 1e-12, "f64 rounding"),
                (np.float32, 2e-5, "f32 rounding; f32 products run at "
                                   "precision=HIGHEST, TF32 would miss")):
            a = a64.astype(dt)
            t0 = time.perf_counter()
            M = _build(fmt, a)
            if fmt == "mbes" and M.format_name != "mbes":
                rep.expect(f"{fmt} {np.dtype(dt).name} build", False,
                           f"got {M.format_name}")
                continue
            x = np.random.default_rng(7).standard_normal(a.shape[1]) \
                .astype(dt)
            # numpy dense where it is small; scipy in f64 for mbes
            ref = (a.toarray() if a.shape[0] <= 2000 else a) \
                .astype(np.float64)
            xd = x.astype(np.float64)
            y = jax.jit(lambda M, v: M.matvec(v))(M, jnp.asarray(x))
            yh = jax.jit(lambda M, v: M.matvech(v))(M, jnp.asarray(x))
            err = max(_rel(np.asarray(y, np.float64), ref @ xd),
                      _rel(np.asarray(yh, np.float64), ref.T @ xd))
            rep.check(f"{fmt} {np.dtype(dt).name} matvec+matvech vs dense",
                      err, tol, why, time.perf_counter() - t0)
    _free()


# ---------------------------------------------------------------------------
# phase 3: general sparsity at real size
# ---------------------------------------------------------------------------

def _routes(A, rep):
    """Every general-sparsity layout the router could pick for A."""
    from lis_tpu.matrix.bes import multi_bes_from_csr
    from lis_tpu.matrix.cst import CSTMatrix
    p, i, v = A.to_csr_arrays()
    out = {"csr": A}
    t0 = time.perf_counter()
    try:
        bes = multi_bes_from_csr(p, i, v, A.shape, max_bytes=4 << 30)
        out[bes.format_name] = bes
        rep.say(f"  {bes.format_name}: fill blowup {bes.fill_blowup:.2f}, "
                f"built in {time.perf_counter() - t0:.1f}s")
    except Exception as e:          # not representable: recorded, not fatal
        rep.say(f"  bes: not built ({type(e).__name__}: {e})"[:200])
    from lis_tpu.matrix.css import CSSMatrix
    t0 = time.perf_counter()
    blowup, rem_frac = CSSMatrix.profile(i, A.shape[1])
    if blowup <= 4.0 and rem_frac <= 0.05:
        out["css"] = CSSMatrix.from_csr_arrays(p, i, v, A.shape,
                                               transpose=False)
        rep.say(f"  css: fill blowup {blowup:.2f}, built in "
                f"{time.perf_counter() - t0:.1f}s")
    else:
        rep.say(f"  css: fill blowup {blowup:.2f} spill {rem_frac:.3f} "
                f"outside 4 / 5%")
    t0 = time.perf_counter()
    # CST at its natural ELL width, even past the 2% spill guard that
    # fit_kp applies (spilled entries run as its CSR remainder), so that
    # the table shows what the layout costs at this size
    kp = CSTMatrix._pick_kp(len(v) / max(A.nrows, 1))
    blowup, rem_frac = CSTMatrix.profile(p, i, A.shape, Kp=kp)
    if rem_frac > 0.1:
        rep.say(f"  cst: Kp={kp} spills {rem_frac:.1%} of the entries; "
                f"not built")
    else:
        cst = CSTMatrix.from_csr_arrays(p, i, v, A.shape, Kp=kp,
                                        transpose=False)
        out["cst"] = cst
        rep.say(f"  cst: Kp={kp} fill blowup {cst.fill_blowup:.2f}, spill "
                f"{rem_frac:.1%}, built in {time.perf_counter() - t0:.1f}s")
    return out


def general_matrices(S):
    """The two general-sparsity matrices, as (label, k, build)."""
    from lis_tpu.utils.testmat import random_rows
    return (("locality-free", 16,
             lambda: random_rows(S.lf_rows, 16, seed=1)),
            ("band-clustered", 20,
             lambda: random_rows(S.band_rows, 20, band=160, seed=1)))


def time_routes(rep, S, label, A, k, table):
    """Check and time the SpMV of every route for A; rows go to table."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp
    n = A.nrows
    p, i, v = A.to_csr_arrays()
    a = sp.csr_matrix((v, i, p), shape=A.shape)
    rep.say(f"{label}: {n} rows, {A.nnz} nnz, "
            f"{csr_bytes(n, A.nnz) / 1e6:.0f} MB CSR f64")
    x = np.random.default_rng(2).standard_normal(n)
    want = a @ x
    xd = jnp.asarray(x)
    for name, M in _routes(A, rep).items():
        f = jax.jit(lambda M, v: M.matvec(v))
        t0 = time.perf_counter()
        err = _rel(f(M, xd), want)
        t = _median_seconds(f, M, xd, calls=S.calls)
        gbs = csr_bytes(n, A.nnz) / t / 1e9
        table.append((label, name, t, gbs))
        rep.check(f"spmv {label} {name} vs scipy", err, 1e-12,
                  f"f64, <= {k + 1} terms in another order",
                  time.perf_counter() - t0,
                  f"median={t * 1e3:.3f}ms csr-equiv={gbs:.1f}GB/s")
        del M
    _free()


def print_table(rep, S, table, stream):
    rep.say(f"timing table (median of {S.calls} calls, csr-equivalent "
            f"GB/s; stream {stream:.1f} GB/s):")
    for label, name, t, gbs in table:
        rep.say(f"  {label:15s} {name:5s} {t * 1e3:9.3f} ms "
                f"{gbs:8.1f} GB/s")


def phase_general(rep, S):
    import numpy as np
    import lis_tpu

    stream = _stream_gbs(rep, S)
    table = []
    for label, k, build in general_matrices(S):
        t0 = time.perf_counter()
        A = build()
        rep.say(f"{label}: built in {time.perf_counter() - t0:.1f}s")
        time_routes(rep, S, label, A, k, table)
        b = np.asarray(A.matvec(np.ones(A.nrows)))
        t0 = time.perf_counter()
        r = lis_tpu.solve(A, b, options="-i bicgstab -p jacobi -tol 1e-10 "
                                        "-maxiter 2000")
        rep.check(f"bicgstab+jacobi {label} true residual", r.true_resid,
                  1e-10, "stated solve tolerance",
                  time.perf_counter() - t0,
                  f"iters={r.iters} route={_route_name(A)}")
        del A, r
        _free()
    print_table(rep, S, table, stream)


# ---------------------------------------------------------------------------
# phase 4: precision modes
# ---------------------------------------------------------------------------

def phase_precision(rep, S):
    import numpy as np
    import lis_tpu
    from lis_tpu.utils.testmat import gamma_matrix, poisson2d

    g = gamma_matrix(200, 2.0)
    b = np.asarray(g.to_dense() @ np.ones(200))
    t0 = time.perf_counter()
    rd = lis_tpu.solve(g, b, options="-i bicg -f double -tol 1e-12 "
                                     "-maxiter 1000")
    rep.expect("gamma(200,2) bicg -f double stalls",
               rd.status == lis_tpu.LIS_MAXITER,
               f"status={rd.status} iters={rd.iters} resid={rd.resid:.2e}",
               time.perf_counter() - t0)
    t0 = time.perf_counter()
    rq = lis_tpu.solve(g, b, options="-i bicg -f quad -tol 1e-12 "
                                     "-maxiter 1000")
    rep.expect("gamma(200,2) bicg -f quad converges",
               rq.status == lis_tpu.LIS_SUCCESS,
               f"status={rq.status} iters={rq.iters} (reference: 231)",
               time.perf_counter() - t0)
    rep.check("gamma(200,2) quad x vs ones",
              float(np.linalg.norm(np.asarray(rq.x) - 1.0) / np.sqrt(200)),
              1e-10, "test_quad.py bound", 0.0)

    m = S.grid2d
    A = poisson2d(m, m)
    xs = np.linspace(1.0, 2.0, A.nrows)
    p, i, v = A.to_csr_arrays()
    import scipy.sparse as sp
    b = sp.csr_matrix((v, i, p), shape=A.shape) @ xs
    for f, opts, bound, why in (
            ("switch_df", "-tol 1e-10", 1e-10, "f32-pair limbs reach the "
                                               "f64 tolerance"),
            ("single", "-tol 1e-5", 1e-4, "-tol 1e-5 on the f32 recursive "
                                          "residual, which drifts from the "
                                          "true one by ~6e-8 per iteration")):
        t0 = time.perf_counter()
        r = lis_tpu.solve(A, b, options=f"-i cg -p jacobi -f {f} {opts} "
                                        "-maxiter 20000")
        rep.check(f"poisson2d {m}^2 cg -f {f} true residual", r.true_resid,
                  bound, why, time.perf_counter() - t0,
                  f"iters={r.iters} status={r.status}")
    _free()


# ---------------------------------------------------------------------------
# phase 5: preconditioner, eigen, complex
# ---------------------------------------------------------------------------

def phase_precon_eigen_complex(rep, S):
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import lis_tpu
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.utils.testmat import poisson2d, poisson3d_jump

    e = S.amg
    t0 = time.perf_counter()
    A = poisson3d_jump(e, e, e)
    b = np.ones(A.nrows)
    r = lis_tpu.solve(A, b, options="-i cg -p saamg -tol 1e-10 "
                                    "-maxiter 2000")
    dt = time.perf_counter() - t0
    # with a 1e4 coefficient jump the f64 residual of any x has a rounding
    # floor eps || |A| |x| || / ||b|| above 1e-10 at this size
    p, i, v = A.to_csr_arrays()
    absx = np.abs(np.asarray(r.x))
    floor = float(np.finfo(np.float64).eps * np.linalg.norm(
        abs(sp.csr_matrix((v, i, p), shape=A.shape)) @ absx)
        / np.linalg.norm(b))
    rep.check(f"cg+saamg poisson3d_jump {e}^3 f64 true residual",
              r.true_resid, max(1e-10, 4 * floor),
              f"-tol 1e-10, or 4x the f64 floor {floor:.1e} where higher",
              dt, f"iters={r.iters} status={r.status} "
              f"setup={r.time - r.itime:.2f}s iter={r.itime:.2f}s")
    del A, r
    _free()

    m = S.grid2d
    A = poisson2d(m, m)
    lam = 8 * np.sin(np.pi / (2 * (m + 1))) ** 2
    t0 = time.perf_counter()
    # -etol 1e-10: the relative eigen-residual floor is ~eps ||A|| / lam,
    # 5e-12 at m = 256
    r = lis_tpu.esolve(A, options="-e ii -etol 1e-10 -emaxiter 2000")
    rep.expect(f"esolve -e ii poisson2d {m}^2 converges",
               r.status == lis_tpu.LIS_SUCCESS,
               f"status={r.status} iters={r.iters}")
    rep.check(f"esolve -e ii poisson2d {m}^2 smallest eigenvalue",
              abs(r.evalue - lam) / lam, 1e-8,
              "analytic 8 sin^2(pi/(2(m+1))); eigenvalue error ~ "
              "square of the vector error", time.perf_counter() - t0,
              f"evalue={r.evalue:.12e} iters={r.iters}")

    p, i, v = A.to_csr_arrays()
    n = A.nrows
    L = sp.csr_matrix((v, i, p), shape=(n, n)).astype(np.complex128)
    Z = (L + 0.5j * sp.eye(n)).tocsr()
    Z.sort_indices()
    bz = np.random.default_rng(4).standard_normal(n) * (1 + 1j)
    Az = CSRMatrix.from_csr_arrays(Z.indptr, Z.indices, Z.data, Z.shape)
    t0 = time.perf_counter()
    r = lis_tpu.solve(Az, bz, options="-i cocg -tol 1e-12 -maxiter 5000")
    want = spla.spsolve(Z.tocsc(), bz)
    rep.check(f"cocg complex-shifted poisson2d {m}^2 vs scipy spsolve",
              _rel(r.x, want), 1e-9,
              "cond <= 8/0.5 = 16 times -tol 1e-12, with margin",
              time.perf_counter() - t0,
              f"iters={r.iters} status={r.status}")
    _free()


# ---------------------------------------------------------------------------
# phase 6: CLI
# ---------------------------------------------------------------------------

def phase_cli(rep, S):
    import numpy as np
    import lis_tpu
    from lis_tpu.cli import lsolve
    from lis_tpu.utils.testmat import poisson2d

    A = poisson2d(S.cli, S.cli)
    with tempfile.TemporaryDirectory() as d:
        mtx = os.path.join(d, "A.mtx")
        sol = os.path.join(d, "x.mtx")
        lis_tpu.write_matrix_market(mtx, A)
        buf = io.StringIO()
        t0 = time.perf_counter()
        # the live -print callback hung on another backend: a hang fails
        # this phase instead of stalling the run
        faulthandler.dump_traceback_later(300, exit=True)
        try:
            with contextlib.redirect_stdout(buf):
                rc = lsolve.main([mtx, "0", sol])
        finally:
            faulthandler.cancel_dump_traceback_later()
        dt = time.perf_counter() - t0
        x = np.asarray(lis_tpu.read_vector_mm(sol))
    lines = buf.getvalue().splitlines()
    live = sum(ln.startswith("iteration:") or "residual" in ln
               for ln in lines)
    rep.expect("lsolve default options exit code", rc == 0,
               f"rc={rc}, {live} residual lines printed live", dt)
    rep.check("lsolve solution vs ones", _rel(x, np.ones(A.nrows)), 1e-8,
              "default -tol 1e-12 times cond(A) ~ 2e3, with margin", 0.0)


# ---------------------------------------------------------------------------
# --four: the mesh path
# ---------------------------------------------------------------------------

def phase_mesh(rep, S, ndev=4):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import lis_tpu
    from lis_tpu.parallel import make_mesh
    from lis_tpu.parallel.dist import distribute_matrix, dist_solve
    from lis_tpu.utils.testmat import poisson3d27, random_rows

    if len(jax.devices()) < ndev:
        rep.expect(f"{ndev} devices", False,
                   f"only {len(jax.devices())} visible")
        return
    mesh = make_mesh(ndev)
    e = S.stencil
    for label, build, opts in (
            (f"poisson3d27 {e}^3", lambda: poisson3d27(e, e, e),
             "-i cg -p jacobi"),
            ("locality-free", lambda: random_rows(S.lf_rows, 16, seed=1),
             "-i bicgstab -p jacobi")):
        A = build()
        b = np.asarray(A.matvec(jnp.ones(A.nrows)))
        o = f"{opts} -tol 1e-10 -maxiter 5000"
        t0 = time.perf_counter()
        r1 = lis_tpu.solve(A, b, options=o)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        Ad = distribute_matrix(A, mesh)
        rd = dist_solve(Ad, b, mesh, options=o)
        td = time.perf_counter() - t0
        rep.say(f"{label}: layout {type(Ad).__name__}, one card "
                f"{r1.iters} iters {t1:.2f}s, mesh {rd.iters} iters "
                f"{td:.2f}s")
        rep.check(f"{label} dist true residual", rd.true_resid, 1e-10,
                  "stated solve tolerance", td)
        rep.expect(f"{label} iteration counts agree",
                   abs(rd.iters - r1.iters) <= 2,
                   f"|{rd.iters} - {r1.iters}| <= 2 (psum reduction order "
                   f"differs)")
        del A, Ad, r1, rd
        _free()


# ---------------------------------------------------------------------------

PHASES = {1: ("main path", phase_main),
          2: ("format oracles", phase_formats),
          3: ("general sparsity", phase_general),
          4: ("precision modes", phase_precision),
          5: ("precon, eigen, complex", phase_precon_eigen_complex),
          6: ("cli", phase_cli)}


def _run(rep, label, fn, *args):
    rep.phase = label
    t0 = time.perf_counter()
    try:
        fn(rep, *args)
    except Exception:                 # a crashed phase is a failed phase
        traceback.print_exc()
        rep.failed.append(f"{label}:crashed")
    rep.say(f"phase done in {time.perf_counter() - t0:.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh phase, on four GPUs")
    ap.add_argument("--phases", default="1,2,3,4,5,6",
                    help="comma-separated one-GPU phases to run")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "lis_tpu")):
        print("chip_smoke.py must run from a lis_tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import lis_tpu
    lis_tpu.config.enable_compile_cache()
    rep = Report()
    rep.phase = "0"
    phase_device(rep)
    import jax
    if args.four:
        _run(rep, "mesh", phase_mesh, FULL, 4)
    else:
        for k in sorted(int(p) for p in args.phases.split(",")):
            name, fn = PHASES[k]
            _run(rep, f"{k} {name}", fn, FULL)
    if rep.failed:
        print(f"FAILED: {', '.join(rep.failed)}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
