"""Runtime initialisation, status codes, timing.

Mirrors the behavior of the reference runtime layer (lis_initialize /
lis_finalize / lis_wtime, src/system/lis_init.c, src/system/lis_time.c) in a
JAX-native way: there is no MPI to initialise — device meshes are ambient —
so ``initialize`` only fixes the numerics configuration (x64) and records
command-line args for the Lis-compatible option parser
(reference: lis_solver_set_optionC, src/solver/lis_solver.c:1095).

Status codes match include/lis.h:1052-1063 numerically so downstream
tooling that matches on exit codes keeps working.
"""

from __future__ import annotations

import os
import time

import jax

# Status codes (values match the reference's include/lis.h).
LIS_SUCCESS = 0
LIS_FAILS = -1
LIS_ILL_OPTION = 1
LIS_ERR_ILL_ARG = 1          # alias (lis.h:1057 — same value as ILL_OPTION)
LIS_BREAKDOWN = 2
LIS_OUT_OF_MEMORY = 3
LIS_MAXITER = 4
LIS_ERR_NOT_IMPLEMENTED = 5
LIS_ERR_FILE_IO = 6

# Matrix type ids (include/lis.h:252-284).
LIS_MATRIX_CSR = 1
LIS_MATRIX_CSC = 2
LIS_MATRIX_MSR = 3
LIS_MATRIX_DIA = 4
LIS_MATRIX_ELL = 5
LIS_MATRIX_JAD = 6
LIS_MATRIX_BSR = 7
LIS_MATRIX_BSC = 8
LIS_MATRIX_VBR = 9
LIS_MATRIX_COO = 10
LIS_MATRIX_DNS = 11
LIS_MATRIX_RCO = 255

MATRIX_TYPE_NAMES = {
    LIS_MATRIX_CSR: "csr", LIS_MATRIX_CSC: "csc", LIS_MATRIX_MSR: "msr",
    LIS_MATRIX_DIA: "dia", LIS_MATRIX_ELL: "ell", LIS_MATRIX_JAD: "jad",
    LIS_MATRIX_BSR: "bsr", LIS_MATRIX_BSC: "bsc", LIS_MATRIX_VBR: "vbr",
    LIS_MATRIX_COO: "coo", LIS_MATRIX_DNS: "dns", LIS_MATRIX_RCO: "rco",
}

_initialized = False
_cmd_args: list[str] = []

# The reference is a double-precision library (tolerances default to 1e-12);
# enable x64 at import so the default dtype matches.  Opt out with
# LIS_TPU_DISABLE_X64=1 (f32 everywhere).
if os.environ.get("LIS_TPU_DISABLE_X64") != "1":
    jax.config.update("jax_enable_x64", True)


def initialize(argv: list[str] | None = None, enable_x64: bool = True) -> int:
    """Framework init (analogue of lis_initialize, src/system/lis_init.c:121).

    Enables float64 (the reference is a double-precision library) and
    stores ``argv`` so option objects can
    pull ``-i``/``-p``/... flags from the command line like the reference's
    ``lis_solver_set_optionC``.
    """
    global _initialized, _cmd_args
    if enable_x64 and os.environ.get("LIS_TPU_DISABLE_X64") != "1":
        jax.config.update("jax_enable_x64", True)
    if argv:
        _cmd_args = list(argv)
    _initialized = True
    return LIS_SUCCESS


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
    lives at the fixed path ``<checkout>/.jax_cache``, so a later process
    from the same checkout finds what an earlier one compiled.  Call it
    before the first compilation: JAX opens the cache once."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    # keep every program: a solve is many programs of a second or less
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path


def finalize() -> int:
    """Analogue of lis_finalize (no-op: no MPI to tear down)."""
    global _initialized
    _initialized = False
    return LIS_SUCCESS


def get_cmd_args() -> list[str]:
    return _cmd_args


def wtime() -> float:
    """Wall-clock timer (analogue of lis_wtime, src/system/lis_time.c:63)."""
    return time.perf_counter()
