"""SAINV — stabilized approximate-inverse preconditioner.

Reference: lis_precon_create_sainv (src/precon/lis_precon_sainv.c:59,
factorisation :~100-700) and lis_psolve_sainv (:735): M⁻¹ = Z D⁻¹ Wᴴ from
A-biconjugation with post-dropping (drop tolerance -sainv_drop, 0.05).

The apply is two sparse SpMVs + a diagonal scale (an approximate inverse
needs no triangular solves at all).  The biconjugation
runs on host at create, SPARSE and right-looking like the reference's: at
step i only the columns j>i where (A·Z_i)_j or (W_iᵀ·A)_j is nonzero are
touched, and update-term entries below -sainv_drop are discarded — O(nnz)
memory, usable at production sizes.  Native C++ engine
(_native.sainv_factor) with a pure-Python fallback.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.csr import CSRMatrix
from lis_tpu.precon.base import precon_pytree, register_precon


@precon_pytree
class SAINVPrecon:
    W: CSRMatrix              # biconjugation left factor (unit diag)
    Z: CSRMatrix              # right factor (unit diag)
    dinv: jax.Array

    def psolve(self, r):
        t = self.W.matvech(r)          # Wᴴ r
        return self.Z.matvec(self.dinv * t)

    def psolveh(self, r):
        t = self.Z.matvech(r)
        d = jnp.conj(self.dinv) if jnp.iscomplexobj(self.dinv) else self.dinv
        return self.W.matvec(d * t)


def _factor_sainv_py(ptr, index, value, n, tol):
    """Sparse right-looking biconjugation, pure-Python fallback: mirrors
    the reference loop (l = A·Z_i, u = W_iᵀ·A, update only the columns j>i
    where l_j/u_j is nonzero, drop update-term entries below tol).  Same
    output convention as _native.sainv_factor (Z/W row-wise CSR, dinv)."""
    import scipy.sparse as sp
    Acsr = sp.csr_matrix((value, index, ptr), shape=(n, n))
    Acsc = Acsr.tocsc()

    Zc = [dict([(i, 1.0)]) for i in range(n)]
    Wc = [dict([(i, 1.0)]) for i in range(n)]
    dinv = np.ones(n, dtype=value.dtype)

    def update_col(C, j, i, coef):
        cj = C[j]
        for r, v in C[i].items():
            t = coef * v
            if abs(t) < tol:
                continue
            nv = cj.get(r, 0.0) - t
            if nv == 0.0 and r != j:
                cj.pop(r, None)
            else:
                cj[r] = nv

    for i in range(n):
        l = {}
        for r, zv in Zc[i].items():
            for p in range(Acsc.indptr[r], Acsc.indptr[r + 1]):
                l[Acsc.indices[p]] = l.get(Acsc.indices[p], 0.0) \
                    + Acsc.data[p] * zv
        u = {}
        for r, wv in Wc[i].items():
            for p in range(Acsr.indptr[r], Acsr.indptr[r + 1]):
                u[Acsr.indices[p]] = u.get(Acsr.indices[p], 0.0) \
                    + wv * Acsr.data[p]
        dd = sum(u.get(r, 0.0) * zv for r, zv in Zc[i].items())
        if dd == 0.0:
            dinv[i] = 1.0
            continue
        dinv[i] = 1.0 / dd
        for j, lj in l.items():
            if j > i and lj != 0.0:
                update_col(Wc, j, i, lj / dd)
        for j, uj in u.items():
            if j > i and uj != 0.0:
                update_col(Zc, j, i, uj / dd)

    def emit(C):
        r_, c_, v_ = [], [], []
        for j in range(n):
            for r, v in C[j].items():
                r_.append(r)
                c_.append(j)
                v_.append(v)
        m = sp.coo_matrix((v_, (r_, c_)), shape=(n, n)).tocsr()
        m.sort_indices()
        return m.indptr.astype(np.int32), m.indices.astype(np.int32), m.data

    return emit(Zc), emit(Wc), dinv


@register_precon("sainv")
def create_sainv(A, opts):
    """M⁻¹ = Z D⁻¹ Wᴴ by SPARSE stabilised biconjugation — O(nnz) memory,
    usable at production sizes (the factorisation cost is governed by the
    drop tolerance, like the reference's)."""
    drop = getattr(opts, "sainv_drop", 0.05)
    n = A.nrows
    ptr, index, value = A.to_csr_arrays()
    ptr = np.asarray(ptr)
    index = np.asarray(index)
    value = np.asarray(value)
    out = None
    if not np.iscomplexobj(value):
        from lis_tpu import _native
        out = _native.sainv_factor(ptr, index, value, drop)
    if out is None:
        out = _factor_sainv_py(ptr, index, value, n, drop)
    (zp, zi, zv), (wp, wi, wv), dinv = out
    return SAINVPrecon(W=CSRMatrix.from_csr_arrays(wp, wi, wv, (n, n)),
                       Z=CSRMatrix.from_csr_arrays(zp, zi, zv, (n, n)),
                       dinv=jnp.asarray(dinv))
