"""lis_esolve / lis_gesolve equivalent driver.

Reference: src/esolver/lis_esolver.c — lis_esolve (:263) = lis_gesolve with
B=None (:285); registry at :63-66, defaults at :143-183 (default esolver CR,
maxiter 1000, tol 1e-12, subspace ss=1, inner esolver II).

Standard problem Ax = λx and generalized Ax = λBx.  Subspace methods
(SI/LI/AI) return ``ss`` eigenpairs; the getter-rich result object mirrors
the reference's lis_esolver_get_* API (include/lis.h:1004-1011).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.utils.trace import traced
from lis_tpu import config as C
from lis_tpu.runtime.options import EsolverOptions
from lis_tpu.esolvers.base import ESOLVER_FNS

# registry side effects
from lis_tpu.esolvers import power as _p      # noqa: F401
from lis_tpu.esolvers import subspace as _s   # noqa: F401
from lis_tpu.esolvers import cgcr as _c       # noqa: F401


@dataclass
class EsolveResult:
    evalue: float                 # principal eigenvalue (mode 0)
    evector: jax.Array            # principal eigenvector
    iters: int
    resid: float
    status: int
    # all computed pairs (ss ≥ 1 for subspace solvers)
    evalues: np.ndarray = field(default=None)
    evectors: np.ndarray = field(default=None)
    iters_all: np.ndarray = field(default=None)
    resids_all: np.ndarray = field(default=None)
    rhistory: np.ndarray = field(default=None)

    def get_evalues(self):
        return self.evalues

    def get_evectors(self):
        return self.evectors

    def get_residualnorms(self):
        return self.resids_all

    def get_iters(self):
        return self.iters_all


@traced
def gesolve(A, B, options=None, x0=None, **overrides) -> EsolveResult:
    """Solve the generalized eigenproblem Ax = λBx (lis_gesolve)."""
    if isinstance(options, EsolverOptions):
        opts = options
        for k, val in overrides.items():
            setattr(opts, k, val)
    else:
        opts = EsolverOptions.from_string(options, **overrides)

    name = opts.esolver
    if B is not None and not name.startswith("g"):
        name = "g" + name
    base = name[1:] if name.startswith("g") and name != "gcg" else name
    if name.startswith("g"):
        base = name[1:]
    if base not in ESOLVER_FNS:
        raise NotImplementedError(f"eigensolver {base!r} not implemented; "
                                  f"have {sorted(ESOLVER_FNS)}")

    # -estorage: convert the operator before iterating (lis_esolver.c
    # storage-convert step, mirroring lis_solve_kernel's -storage)
    if opts.estorage:
        from lis_tpu.matrix.convert import convert_matrix
        from lis_tpu.solvers.driver import _STORAGE_BY_ID
        kw = ({"bnr": opts.estorage_block}
              if opts.estorage in (7, 8) else {})
        A = convert_matrix(A, _STORAGE_BY_ID[opts.estorage], **kw)
        if B is not None:
            B = convert_matrix(B, _STORAGE_BY_ID[opts.estorage], **kw)
    else:
        # default: the operator iterates in its routed storage (see
        # lis_tpu.solvers.driver.auto_storage)
        from lis_tpu.solvers.driver import auto_storage
        A = auto_storage(A)
        if B is not None:
            B = auto_storage(B)

    n = A.nrows
    # -initx_ones true (default) overwrites any given x0 with ones; false
    # keeps the caller's x0 (the reference's LIS_EOPTIONS_INITGUESS_ONES)
    if x0 is None or opts.initx_ones:
        x0 = jnp.ones(n, dtype=A.get_diagonal().dtype)
    else:
        x0 = jnp.asarray(x0)
    res = ESOLVER_FNS[base](A, B, x0, opts)
    # -m: report the mode-th eigenpair of a subspace run (lis_esolver.c
    # LIS_EOPTIONS_MODE — etest5 prints the chosen mode)
    if opts.mode and res.evalues is not None and len(res.evalues) > opts.mode:
        import dataclasses as _dc
        res = _dc.replace(
            res, evalue=float(res.evalues[opts.mode]),
            evector=res.evectors[opts.mode],
            resid=float(res.resids_all[opts.mode]))
    return res


@traced
def esolve(A, options=None, x0=None, **overrides) -> EsolveResult:
    """Standard eigenproblem Ax = λx (lis_esolve = lis_gesolve(A, NULL))."""
    return gesolve(A, None, options, x0, **overrides)
