"""SSOR preconditioner.

Reference: lis_precon_create_ssor / lis_psolve_ssor
(src/precon/lis_precon_ssor.c:58,99): M = (D/ω + L)(I + ωD⁻¹U), applied by
the forward+backward sweep of lis_matrix_solve(...,LIS_MATRIX_SSOR)
(src/matrix/lis_matrix_csr.c SSOR branch) with WD = (D/ω)⁻¹.

Here: two level-scheduled triangular plans.  The backward sweep
x[i] -= WD[i]·Σ U[i,j]x[j] is algebraically (D̃+U)x = D̃y with D̃ = D/ω,
so it reuses the same trisolve kernel with rhs y·D̃.

psolveh solves Mᵀ = (I + ωUᵀD⁻¹)(D/ω + Lᵀ) with the transposed triangles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from lis_tpu.matrix.split import split_matrix
from lis_tpu.ops.trisolve import TriSolvePlan, make_plan, trisolve
from lis_tpu.precon.base import precon_pytree, register_precon


@precon_pytree
class SSORPrecon:
    fwd: TriSolvePlan         # (D/ω + L)
    bwd: TriSolvePlan         # (D/ω + U)
    fwd_t: TriSolvePlan       # (I + ωUᵀD⁻¹)
    bwd_t: TriSolvePlan       # (D/ω + Lᵀ)
    dtil: jax.Array           # D/ω

    def psolve(self, r):
        y = trisolve(self.fwd, r)
        return trisolve(self.bwd, y * self.dtil)

    def psolveh(self, r):
        z = trisolve(self.fwd_t, r)
        return trisolve(self.bwd_t, z)


@precon_pytree
class SSORRelaxPrecon:
    """SSOR applied by Jacobi-relaxed triangular sweeps on split DIA
    operators — the DIA variant.  Exact level-scheduled triangular
    solves gather row by row; the reference's own OpenMP
    path already relaxes cross-thread dependencies
    (src/matrix/lis_matrix_csr.c:1577-1605), and this extends the same
    truncated-sweep idea to the whole (DIA-structured) triangle, keeping
    every op a diagonal stream.  Sweep count: -ssor_sweeps (default 2)."""
    L: object                 # strict-lower DIA
    U: object                 # strict-upper DIA
    wd: jax.Array             # (D/ω)⁻¹
    dtil: jax.Array           # D/ω
    nsweeps: int
    _static = ("nsweeps",)

    def _fwd(self, r):
        y = r * self.wd
        for _ in range(self.nsweeps):
            y = (r - self.L.matvec(y)) * self.wd
        return y

    def _bwd(self, rhs):
        y = rhs * self.wd
        for _ in range(self.nsweeps):
            y = (rhs - self.U.matvec(y)) * self.wd
        return y

    def psolve(self, r):
        return self._bwd(self._fwd(r) * self.dtil)

    def psolveh(self, r):
        # Mᵀ = (I + ωUᵀD⁻¹)ᵀ-order: solve (I + ωUᵀD⁻¹) y = r, then
        # (D/ω + Lᵀ) z = y — the transposed triangles in the right order
        y = r
        for _ in range(self.nsweeps):
            y = r - self.U.matvech(self.wd * y)
        z = y * self.wd
        for _ in range(self.nsweeps):
            z = (y - self.L.matvech(z)) * self.wd
        return z


def _split_dia(A):
    """Split a DIA matrix into strict-lower / strict-upper DIA + diagonal.

    Zero-copy: DIAMatrix stores one device array per diagonal, so the
    triangles just re-group REFERENCES to the same buffers — no
    device_get / re-upload of the operator.  The returned diagonal is a
    device array."""
    from lis_tpu.matrix.dia import DIAMatrix
    offs = tuple(int(o) for o in A.offsets)
    n = A.nrows
    dtype = A.value[0].dtype if A.value else np.float64
    low = [k for k, o in enumerate(offs) if o < 0]
    up = [k for k, o in enumerate(offs) if o > 0]
    dk = [k for k, o in enumerate(offs) if o == 0]
    d = A.value[dk[0]] if dk else jnp.zeros(n, dtype)

    def sub(ks):
        if not ks:
            return DIAMatrix(value=(jnp.zeros(n, dtype),), nrows=n,
                             ncols=n, nnz=0, offsets=(0,))
        # ONE device sync for all diagonals, not one per diagonal
        counts = jax.device_get(
            jnp.stack([jnp.count_nonzero(A.value[k]) for k in ks]))
        nnz = int(counts.sum())
        return DIAMatrix(value=tuple(A.value[k] for k in ks),
                         nrows=n, ncols=n, nnz=nnz,
                         offsets=tuple(offs[k] for k in ks))
    return sub(low), sub(up), d


@register_precon("ssor")
def create_ssor(A, opts):
    if getattr(A, "format_name", None) == "dia":
        w = getattr(opts, "ssor_omega", 1.0)
        ns = getattr(opts, "ssor_sweeps", 2)
        L, U, d = _split_dia(A)
        wd = jnp.where(d != 0, w / jnp.where(d != 0, d, 1), 1.0)
        dtil = jnp.where(wd != 0, 1.0 / wd, 1.0)
        return SSORRelaxPrecon(L=L, U=U, wd=wd, dtil=dtil, nsweeps=ns)
    w = getattr(opts, "ssor_omega", 1.0)
    s = split_matrix(A)
    n = A.nrows
    d = np.asarray(s.D)
    with np.errstate(divide="ignore"):
        wd = np.where(d != 0, w / np.where(d != 0, d, 1), 1.0)   # (D/ω)⁻¹
    dtil = np.where(wd != 0, 1.0 / wd, 1.0)                      # D/ω

    lp, li, lv = s.L.to_csr_arrays()
    up, ui, uv = s.U.to_csr_arrays()
    fwd = make_plan(lp, li, lv, wd, lower=True)
    bwd = make_plan(up, ui, uv, wd, lower=False)

    # transposed triangles for psolveh
    Lt = sp.csr_matrix((lv, li, lp), shape=A.shape).T.tocsr()
    Ut = sp.csr_matrix((uv, ui, up), shape=A.shape).T.tocsr()
    Lt.sort_indices(); Ut.sort_indices()
    # (I + ωUᵀD⁻¹): strictly lower Uᵀ with column scaling 1/d[col]·ω,
    # unit diagonal multiplier
    utv = Ut.data * (w / d[Ut.indices])
    fwd_t = make_plan(Ut.indptr, Ut.indices, utv, np.ones(n), lower=True)
    bwd_t = make_plan(Lt.indptr, Lt.indices, Lt.data, wd, lower=False)

    return SSORPrecon(fwd=fwd, bwd=bwd, fwd_t=fwd_t, bwd_t=bwd_t,
                      dtil=jnp.asarray(dtil))
