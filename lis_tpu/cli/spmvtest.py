"""spmvtest1-5 — per-format SpMV benchmark sweep.

Reference: test/spmvtest1.c (1-D tridiag), spmvtest2/2b (2-D 5-pt),
spmvtest3/3b (3-D 7-pt/27-pt), spmvtest4 (file list), spmvtest5 (one file);
metric MFLOPS = 2·nnz·iter/comptime (spmvtest1.c:225).

Usage:
  python -m lis_tpu.cli.spmvtest 1 n iter
  python -m lis_tpu.cli.spmvtest 2 m n iter
  python -m lis_tpu.cli.spmvtest 3 l m n iter        (7-point)
  python -m lis_tpu.cli.spmvtest 3b l m n iter       (27-point)
  python -m lis_tpu.cli.spmvtest 5 matrix.mtx iter
"""

from __future__ import annotations

import sys
import time

import numpy as np

FORMATS = ["csr", "csc", "msr", "dia", "ell", "jad", "bsr", "bsc", "vbr",
           "coo", "dns",
           # extensions: hybrid DIA+remainder and dense sliding slabs
           # for general sparsity
           "hdi", "bes"]


def _sync(x):
    return float(np.asarray(x.sum() if hasattr(x, "sum") else x))


def run_sweep(A0, iters: int, formats=None, dense_ok=True):
    import jax
    import jax.numpy as jnp
    from lis_tpu.matrix.convert import convert_matrix

    n, nnz = A0.nrows, A0.nnz
    x = jnp.ones(n)
    print(f"matrix size = {n} x {A0.ncols} ({nnz} nonzero entries)\n")
    results = {}
    for fmt in (formats or FORMATS):
        if fmt == "dns" and (not dense_ok or n > 20000):
            continue
        try:
            A = convert_matrix(A0, fmt)
        except Exception as e:
            print(f"{fmt:4s}: conversion failed ({e})")
            continue

        # two loop lengths differenced: cancels the fixed dispatch cost
        import functools

        @functools.partial(jax.jit, static_argnames=("k",))
        def loop(v, A, k):
            def body(_, vv):
                return A.matvec(vv) * (1.0 / 4.0)
            return jnp.sum(jax.lax.fori_loop(0, k, body, v))

        la, lb = max(1, iters // 10), iters + max(1, iters // 10)
        _sync(loop(x, A, k=la))            # compile
        _sync(loop(x, A, k=lb))

        def best(k):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                _sync(loop(x, A, k=k))
                ts.append(time.perf_counter() - t0)
            return min(ts)

        t = (best(lb) - best(la)) / (lb - la)
        if t <= 0:
            # below timer noise — bound by the whole-loop time instead
            t = best(lb) / lb
        mflops = 2.0 * nnz / t / 1e6
        results[fmt] = mflops
        print(f"format = {fmt.upper():4s} ({FORMATS.index(fmt)+1:2d}), "
              f"computation = {t:.6e} sec, {mflops:10.2f} MFLOPS")
    return results


def main(argv=None):
    import lis_tpu
    from lis_tpu.utils.testmat import poisson2d, poisson3d, poisson3d27, tridiag

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    which = argv[0]
    lis_tpu.initialize(argv)
    lis_tpu.config.enable_compile_cache()
    if which == "1":
        n, iters = int(argv[1]), int(argv[2])
        A = tridiag(n)
    elif which in ("2", "2b"):
        m, n, iters = int(argv[1]), int(argv[2]), int(argv[3])
        A = poisson2d(m, n)
    elif which == "3":
        l, m, n, iters = (int(a) for a in argv[1:5])
        A = poisson3d(l, m, n)
    elif which == "3b":
        l, m, n, iters = (int(a) for a in argv[1:5])
        A = poisson3d27(l, m, n)
    elif which == "4":
        # reference spmvtest4: argv[1] is a list file, one matrix path per
        # line (test/spmvtest4.c); run the sweep on each
        from lis_tpu.io import lis_input
        iters = int(argv[2])
        with open(argv[1]) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        for p in paths:
            print(f"\n=== {p} ===")
            A, _, _ = lis_input(p)
            run_sweep(A, iters)
        return 0
    elif which == "5":
        from lis_tpu.io import lis_input
        A, _, _ = lis_input(argv[1])
        iters = int(argv[2])
    else:
        print(__doc__)
        return 1
    run_sweep(A, iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
