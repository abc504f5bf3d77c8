"""Benchmark entry point — prints ONE JSON line.

Metric: SpMV effective bandwidth on the 3-D 27-point Poisson operator
(the reference's spmvtest3b problem, test/spmvtest3b.c) in DIA format —
the stencil layout — at float32 on one device.

MFLOPS convention matches spmvtest: 2·nnz·iter/time.

Timing methodology: the iteration loop runs inside one compiled program
(as the solvers do), each call is synchronised on its result, and the
medians of two loop lengths are differenced to cancel the fixed
per-dispatch cost.

Fault isolation: every leg runs under its own try/except and the JSON
prints whatever survived, with per-leg errors recorded in
``extra.leg_errors`` — one failing leg does not hide the others'
results (the reference's spmvtest programs time each format
independently for the same reason, test/spmvtest1.c:200-231).
"""

from __future__ import annotations

import json
import time
import traceback

import numpy as np

LEG_ERRORS = {}


LEG_SECONDS = {}


def _leg(name, fn):
    """Run one benchmark leg; on failure record the error and move on."""
    t0 = time.perf_counter()
    try:
        return fn()
    except Exception as e:
        LEG_ERRORS[name] = f"{type(e).__name__}: {e}"[:300]
        traceback.print_exc()
        return None
    finally:
        LEG_SECONDS[name] = round(time.perf_counter() - t0, 1)


def _timed(fn, arg, iters_a: int, iters_b: int, repeats: int = 10):
    """Per-iteration time with the fixed dispatch cost differenced out:
    the median of ``repeats`` synchronised calls at each of two loop
    lengths, differenced."""
    import jax
    fa, fb = fn(iters_a), fn(iters_b)
    jax.block_until_ready(fa(arg))          # compile a
    jax.block_until_ready(fb(arg))          # compile b

    def median(f):
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(arg))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))
    return max((median(fb) - median(fa)) / (iters_b - iters_a), 1e-12)


def _headline():
    """DIA SpMV bandwidth on poisson3d27(96^3) — the headline."""
    import jax
    import jax.numpy as jnp
    from lis_tpu.matrix.convert import convert_matrix
    from lis_tpu.utils.testmat import poisson3d27

    dtype = jnp.float32
    L = M = N = 96                       # ~885k rows, ~23.3M nnz
    A = poisson3d27(L, M, N)
    Ad = convert_matrix(A, "dia")
    n, nnz = Ad.nrows, Ad.nnz
    nnd = len(Ad.offsets)
    Af = jax.tree.map(lambda a: a.astype(dtype)
                      if a.dtype.kind == "f" else a, Ad)
    x = jnp.ones(n, dtype=dtype)

    def make_spmv(iters):
        @jax.jit
        def run(v):
            def body(i, vv):
                return Af.matvec(vv) * jnp.float32(1.0 / 32.0)
            return jnp.sum(jax.lax.fori_loop(0, iters, body, v))
        return run

    t = _timed(make_spmv, x, 20, 220)
    esize = np.dtype(np.float32).itemsize
    bytes_moved = (nnd * n + 2 * n) * esize      # diagonals + x read + y write
    return {"gbs": bytes_moved / t / 1e9, "mflops": 2.0 * nnz / t / 1e6,
            "rows": n, "nnz": nnz}


def _solve_rates():
    """Warm-cache whole-solve iteration rate (CG+Jacobi on 64^3, the
    hpcg-style problem) per precision mode."""
    import lis_tpu
    from lis_tpu.utils.testmat import poisson3d27
    A2 = poisson3d27(64, 64, 64)
    b2 = np.ones(A2.nrows)
    solve_ms = {}
    for f in ("single", "double", "switch_df"):
        opts = f"-i cg -p jacobi -tol 1e-8 -f {f} -maxiter 300"
        lis_tpu.solve(A2, b2, options=opts)          # compile
        r = lis_tpu.solve(A2, b2, options=opts)
        solve_ms[f] = round(r.itime / max(r.iters, 1) * 1e3, 3)
    return solve_ms


def _make_loop():
    import jax
    import jax.numpy as jnp

    def make(iters):
        @jax.jit
        def run(arg):
            M, v = arg
            def body(i, vv):
                return M.matvec(vv) * jnp.float32(1.0 / 32.0)
            return jnp.sum(jax.lax.fori_loop(0, iters, body, v))
        return run
    return make


def _bes_leg():
    """General-sparsity path: BES dense sliding slabs on an unstructured
    band matrix (spmvtest5-class input; csr-equivalent GB/s)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from lis_tpu.matrix.convert import convert_matrix
    from lis_tpu.matrix.csr import CSRMatrix
    rng = np.random.default_rng(0)
    nb = 1 << 19
    rows_ = np.repeat(np.arange(nb), 20)
    cols_ = np.clip(rows_ + rng.integers(-160, 161, size=nb * 20), 0, nb - 1)
    mb = sp.coo_matrix((rng.standard_normal(nb * 20).astype(np.float32),
                        (rows_, cols_)), shape=(nb, nb)).tocsr()
    mb.sort_indices()
    Ab = convert_matrix(CSRMatrix.from_csr_arrays(
        mb.indptr, mb.indices, mb.data, mb.shape), "bes")
    xb = jnp.ones(nb, dtype=jnp.float32)
    # NOTE: the slab is passed as an ARGUMENT (closing over it would embed
    # ~0.5 GB as an HLO constant)
    t_bes = _timed(_make_loop(), (Ab, xb), 5, 55)
    return round(Ab.nnz * 8 / t_bes / 1e9, 1)


def _cst_leg():
    """Locality-free sparsity (uniformly random, no band at all): CST —
    gather- and scatter-free lane-shuffle SpMV (matrix/cst.py)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from lis_tpu.matrix.cst import CSTMatrix
    rng = np.random.default_rng(1)
    nc_ = 1 << 18
    rows_c = np.repeat(np.arange(nc_), 16)
    cols_c = rng.integers(0, nc_, size=nc_ * 16)
    mc = sp.coo_matrix((rng.standard_normal(nc_ * 16).astype(np.float32),
                        (rows_c, cols_c)), shape=(nc_, nc_)).tocsr()
    mc.sum_duplicates(); mc.sort_indices()
    Ac = CSTMatrix.from_csr_arrays(mc.indptr, mc.indices, mc.data,
                                   mc.shape, transpose=False)
    xc = jnp.ones(nc_, dtype=jnp.float32)
    # correctness gate before timing: a fast wrong kernel is no headline
    import jax
    got = np.asarray(jax.jit(Ac.matvec)(xc))
    want = mc @ np.ones(nc_, dtype=np.float32)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel < 1e-5, f"cst matvec wrong: rel={rel}"
    t_cst = _timed(_make_loop(), (Ac, xc), 10, 60)
    return round((mc.nnz * 8 + 2 * nc_ * 4) / t_cst / 1e9, 1)


def _saamg_leg():
    """SA-AMG lattice V-cycle ms/apply at 128^3 (reference flagship
    lis_m_solver_AMGCG.F90:50)."""
    import jax
    import jax.numpy as jnp
    from lis_tpu.utils.testmat import poisson3d_jump
    from lis_tpu.precon.base import create_precon
    from lis_tpu.runtime.options import SolverOptions
    dim = 128
    A = poisson3d_jump(dim, dim, dim, jump=1e4)
    M = create_precon("saamg", A, SolverOptions.from_string("-p saamg"))
    x = jnp.ones(dim ** 3,
                 dtype=jnp.float64 if jax.config.jax_enable_x64
                 else jnp.float32)

    def make(iters):
        @jax.jit
        def run(v):
            def body(i, vv):
                return M.psolve(vv) * jnp.asarray(1.0 / 32.0, vv.dtype)
            return jnp.sum(jax.lax.fori_loop(0, iters, body, v))
        return run

    t = _timed(make, x, 3, 13)
    return round(t * 1e3, 2)


def _bsr_leg():
    """BSR windowed-slab matvec, bsr-equivalent GB/s (reference
    lis_matvec_bsr.c:57)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from lis_tpu.matrix.bsr import BSRMatrix
    nx, bs = 512, 4
    lap1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    lap2 = (sp.kron(sp.eye(nx), lap1) + sp.kron(lap1, sp.eye(nx))).tocsr()
    rng = np.random.default_rng(0)
    blk = rng.standard_normal((bs, bs)).astype(np.float32)
    blk += bs * np.eye(bs, dtype=np.float32)
    A = sp.kron(lap2, sp.csr_matrix(blk)).tocsr()
    A.sort_indices()
    n, nnz = A.shape[0], A.nnz
    Ab = BSRMatrix.from_csr_arrays(A.indptr, A.indices,
                                   A.data.astype(np.float32), A.shape,
                                   bnr=bs, bnc=bs)
    x = jnp.ones(n, dtype=jnp.float32)
    bnnz = nnz // (bs * bs)
    bytes_equiv = nnz * 4 + bnnz * 4 + 2 * n * 4
    t = _timed(_make_loop(), (Ab, x), 5, 55)
    return round(bytes_equiv / t / 1e9, 1)


def main():
    import jax
    from lis_tpu.config import enable_compile_cache
    enable_compile_cache()

    head = _leg("headline_dia", _headline)
    solve_ms = _leg("solve_rates", _solve_rates)
    bes_gbs = _leg("bes", _bes_leg)
    cst_gbs = _leg("cst", _cst_leg)
    saamg_ms = _leg("saamg", _saamg_leg)
    bsr_gbs = _leg("bsr", _bsr_leg)

    dev = jax.devices()[0]
    gbs = head["gbs"] if head else 0.0
    extra = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "format": "dia", "dtype": "float32",
        "spmv_convention": "2*nnz*iter/comptime (test/spmvtest3b.c:247)",
    }
    if head:
        extra.update(mflops=round(head["mflops"], 1),
                     rows=head["rows"], nnz=head["nnz"])
    if solve_ms:
        extra["cg_jacobi_64cubed_ms_per_iter"] = solve_ms
    if bes_gbs:
        extra["bes_general_sparsity_csr_equiv_gbs"] = bes_gbs
    if cst_gbs:
        extra["cst_locality_free_csr_equiv_gbs"] = cst_gbs
    if saamg_ms:
        extra["saamg_vcycle_ms_128"] = saamg_ms
    if bsr_gbs:
        extra["bsr_slab_gbs"] = bsr_gbs
    extra["leg_seconds"] = LEG_SECONDS
    if LEG_ERRORS:
        extra["leg_errors"] = LEG_ERRORS

    print(json.dumps({
        "metric": "spmv_dia_poisson3d27_bandwidth",
        "value": round(gbs, 2),
        "unit": "GB/s",
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
