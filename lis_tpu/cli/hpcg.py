"""hpcg_kernel — HPCG-style benchmark solve.

Reference: test/test3b.c (installed as hpcg_kernel, doc/man/man1/
hpcg_kernel.1): CG + SSOR(+additive Schwarz) on the 27-point 3-D Poisson
operator with diag 26 / off-diag -1 (test3b.c:127,172).

Usage: python -m lis_tpu.cli.hpcg l m n [options]
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    import jax.numpy as jnp
    import lis_tpu
    from lis_tpu import solve
    from lis_tpu.utils.testmat import poisson3d27

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        print("Usage: hpcg_kernel l m n [options]")
        return 1
    l, m, n = int(argv[0]), int(argv[1]), int(argv[2])
    options = " ".join(argv[3:])
    # the reference defaults hpcg to CG + SSOR + additive Schwarz
    if "-i" not in options:
        options = "-i cg " + options
    if "-p" not in options:
        options = "-p ssor -adds true " + options

    lis_tpu.initialize(argv)
    lis_tpu.config.enable_compile_cache()
    if l * m * n > 1_000_000:
        # direct DIA construction: O(27N) memory (the COO assembly path
        # peaks at ~50 bytes/nnz and cannot build very large grids)
        from lis_tpu.utils.testmat import poisson3d27_dia
        A = poisson3d27_dia(l, m, n)
    else:
        A = poisson3d27(l, m, n)
    b = A.matvec(jnp.ones(A.nrows))
    res = solve(A, b, options=options)
    gn = A.nrows
    print(f"matrix size = {gn} x {gn} ({A.nnz} nonzero entries)")
    print(f"linear solver         : {res.options.solver.upper()}")
    print(f"preconditioner        : {res.options.precon}"
          f"{' + adds' if res.options.adds else ''}")
    print(f"number of iterations  = {res.iters}")
    print(f"elapsed time          = {res.time:e} sec.")
    print(f"relative residual     = {res.resid:e}")
    print(f"true residual         = {res.true_resid:e}")
    err = float(jnp.max(jnp.abs(res.x - 1.0)))
    print(f"max abs error vs ones = {err:e}")
    return 0 if res.status == lis_tpu.LIS_SUCCESS else res.status


if __name__ == "__main__":
    sys.exit(main())
