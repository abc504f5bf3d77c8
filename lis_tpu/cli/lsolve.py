"""lsolve — solve Ax=b from a file (the reference's installed `lsolve`
binary = test/test1.c; see doc/man/man1/lsolve.1).

Usage: python -m lis_tpu.cli.lsolve matrix_filename rhs_setting
       [solution_filename] [rhistory_filename] [options]

rhs_setting: 0 = use the rhs bundled in the file (or b = A·1 if absent),
1 = all ones, 2 = b = A·1, or a filename of a MatrixMarket vector.
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    import jax.numpy as jnp
    import lis_tpu
    from lis_tpu import read_matrix_market, solve
    from lis_tpu.io.mm import read_vector_mm, write_vector_mm

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("Usage: lsolve matrix_filename rhs_setting "
              "[solution_filename] [rhistory_filename] [options]")
        return 1
    path, rhs = argv[0], argv[1]
    opt_start = 2
    while opt_start < len(argv) and not argv[opt_start].startswith("-"):
        opt_start += 1
    # positional filenames stop at the first option token — option VALUES
    # are not filenames
    pos = argv[2:opt_start][:2]
    options = " ".join(argv[opt_start:])

    lis_tpu.initialize(argv)
    lis_tpu.config.enable_compile_cache()
    A, b, _ = lis_tpu.lis_input(path)   # MM / Lis / HB auto-detected

    n = A.nrows
    if rhs == "1":
        b = jnp.ones(n)
    elif rhs == "2":
        b = A.matvec(jnp.ones(n))
    elif rhs == "0":
        if b is None:                   # no rhs bundled in the file
            b = A.matvec(jnp.ones(n))
    else:
        from lis_tpu.io import lis_input_vector
        b = lis_input_vector(rhs)

    kw = {} if "-print" in options else {"print_": 2}
    res = solve(A, b, options=options or None, **kw)
    print(f"{res.options.solver.upper()}: number of iterations = {res.iters}")
    print(f"{res.options.solver.upper()}: relative residual    = "
          f"{res.resid:e}")
    if len(pos) >= 1:
        write_vector_mm(pos[0], np.asarray(res.x))
    if len(pos) >= 2:
        with open(pos[1], "w") as f:
            for i, r in enumerate(res.rhistory):
                f.write(f"{i} {r:e}\n")
    return 0 if res.status == lis_tpu.LIS_SUCCESS else res.status


if __name__ == "__main__":
    sys.exit(main())
