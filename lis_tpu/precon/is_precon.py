"""I+S approximate-inverse preconditioner.

Reference: lis_precon_is.c — for Krylov outer solvers the apply is
y = x - α·S_m x where S_m keeps only the first m+1 entries of each row of
the strictly-upper part U (lis_psolve_is :417-459; α = -is_alpha,
m = -is_m).  One truncated SpMV.  (The reference's alternate
path for stationary outer solvers, which rebuilds the system as (I+S)A,
is a system transformation rather than a psolve and is not reproduced.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.split import split_matrix
from lis_tpu.precon.base import precon_pytree, register_precon


@precon_pytree
class ISPrecon:
    index: jax.Array          # (n, m) truncated-U column indices (0-padded)
    value: jax.Array          # (n, m) truncated-U values (0-padded)
    _static = ("alpha",)
    alpha: float = 1.0

    def psolve(self, r):
        t = jnp.sum(self.value * jnp.take(r, self.index, axis=0), axis=1)
        return r - self.alpha * t

    def psolveh(self, r):
        v = jnp.conj(self.value) if jnp.iscomplexobj(self.value) else self.value
        prod = (v * r[:, None]).reshape(-1)
        t = jnp.zeros_like(r).at[self.index.reshape(-1)].add(prod)
        return r - self.alpha * t


@register_precon("is")
def create_is(A, opts):
    if getattr(opts, "is_level", 1) == 0:
        # -is_level 0 disables the I+S apply (the reference routes
        # psolve to psolve_none, lis_precon_is.c:100-104 — its own
        # build segfaults on this path, but the intent is identity;
        # the forced Jacobi scaling still happens in the driver)
        from lis_tpu.precon.base import NonePrecon
        return NonePrecon()
    m = getattr(opts, "m", 3) + 1
    alpha = getattr(opts, "is_alpha", 1.0)
    s = split_matrix(A)
    up, ui, uv = s.U.to_csr_arrays()
    up = np.asarray(up).astype(np.int64)
    ui = np.asarray(ui)
    uv = np.asarray(uv)
    n = A.nrows
    # vectorised truncation: keep the first min(m, rownnz) entries per row
    idx = np.zeros((n, m), dtype=np.int32)
    val = np.zeros((n, m), dtype=uv.dtype)
    if len(uv):
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(up))
        slot = np.arange(len(uv), dtype=np.int64) - up[rows]
        keep = slot < m
        idx[rows[keep], slot[keep]] = ui[keep]
        val[rows[keep], slot[keep]] = uv[keep]
    return ISPrecon(index=jnp.asarray(idx), value=jnp.asarray(val),
                    alpha=alpha)
