"""Tracing / profiling utilities (the reference's aux subsystem).

Reference: per-function debug tracing (LIS_DEBUG_FUNC_IN/OUT,
include/lis.h:286-292 → lis_debug_trace_func src/system/lis_error.c:67),
solver phase timers (time/itime/ptime/p_c_time/p_i_time, lis.h:747-751),
and the spmvtest comm-vs-comp split.

Here: a PhaseTimer that synchronises on device results
(block-until-materialised), plus wrappers around jax.profiler for trace
capture.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

import numpy as np

_trace_enabled = os.environ.get("LIS_TPU_DEBUG_TRACE") == "1"


def set_trace(on: bool):
    global _trace_enabled
    _trace_enabled = on


def traced(fn):
    """Per-function enter/exit trace (LIS_DEBUG_FUNC_IN/OUT analogue)."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if _trace_enabled:
            print(f"IN  : {fn.__module__}.{fn.__qualname__}")
        try:
            return fn(*a, **kw)
        finally:
            if _trace_enabled:
                print(f"OUT : {fn.__module__}.{fn.__qualname__}")
    return wrapper


def sync(x):
    """Force full materialisation of a device value (returns it)."""
    import jax
    for leaf in jax.tree.leaves(x):
        if hasattr(leaf, "block_until_ready"):
            np.asarray(leaf)        # host copy forces completion
    return x


class PhaseTimer:
    """Accumulating phase timers (itime/ptime/p_c_time... analogue).

    >>> t = PhaseTimer()
    >>> with t.phase("precon"):
    ...     M = create_precon(...)
    >>> t.report()
    """

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                sync(sync_value)
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, file=None):
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            print(f"{name:24s}: {t:.6e} s ({self.counts[name]} calls)",
                  file=file)


@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/lis_tpu_trace"):
    """Capture a jax profiler trace around a region (the gprof analogue)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
