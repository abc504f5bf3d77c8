"""Test configuration: run on CPU with 8 virtual devices.

Mirrors the reference's test strategy (SURVEY.md §4): the same code paths
are exercised serially and distributed — here via a virtual 8-device CPU
mesh (the stand-in for `mpirun -np 2`) — asserting identical convergence
behavior, plus per-kernel unit tests the reference lacks.
"""

import os

# --xla_disable_hlo_passes=fusion: the XLA CPU fusion pass duplicates
# subexpressions with inconsistent FMA contraction between the copies,
# which breaks the double-double error-free transforms (see
# lis_tpu/core/ddreal.py).  CPU tests run without fusion so quad paths
# keep their full 2^-106 accuracy.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           + " --xla_disable_hlo_passes=fusion")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# the CLIs turn on the persistent compile cache; test workers share a
# checkout, so they keep to their in-memory caches
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


# whole modules whose tests are dominated by 8-device shard_map compiles
# or large problems — the `-m "not slow"` smoke tier skips them (the
# reference's `make check` equivalent; full suite nightly)
_SLOW_MODULES = {"test_dist", "test_quad", "test_all_solvers"}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__.rsplit(".", 1)[-1] in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(scope="module", autouse=True)
def _clear_xla_caches_per_module():
    """Bound in-process XLA/LLVM JIT accumulation: past ~400 compiled
    programs in one process the CPU backend segfaults inside
    backend_compile_and_load (observed deterministically once the suite
    grew past ~300 tests).  Clearing the jit caches at each module
    boundary keeps the live-executable count bounded by the largest
    module; cross-module cache reuse was minimal anyway."""
    yield
    jax.clear_caches()
