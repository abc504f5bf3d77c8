"""Small dense-matrix kernels (analogue of src/array/lis_array.c).

The reference keeps a private mini-BLAS/LAPACK for the small dense problems
that appear inside GMRES (Hessenberg solves), eigensolvers (tridiagonal /
Hessenberg QR iteration, lis_array_qr src/array/lis_array.c:1136) and the
VBR/BSR block kernels (lis_array_ge / lis_array_solve :960, cgs/mgs
:1029,1084).  These dense problems are tiny (restart×restart), so we
express them directly in jnp and keep them jit-traceable so they can live
inside lax loops of the solvers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 products keep full f32 accuracy: a GPU may otherwise run them in TF32
_HI = "highest"


def matvec(a, x):
    """Dense y = A x (lis_array_matvec)."""
    return jnp.matmul(a, x, precision=_HI)


def matvech(a, x):
    """Dense y = Aᴴ x."""
    return jnp.matmul(jnp.conj(a).T, x, precision=_HI)


def matmat(a, b):
    """Dense C = A B (lis_array_matmat)."""
    return jnp.matmul(a, b, precision=_HI)


def solve(a, b):
    """Dense solve via LU (lis_array_solve / lis_array_ge)."""
    return jnp.linalg.solve(a, b)


def invert(a):
    """Dense inverse (lis_array_ge computes the explicit inverse)."""
    return jnp.linalg.inv(a)


def cgs(a):
    """Classical Gram-Schmidt QR (lis_array_cgs, src/array/lis_array.c:1029).

    Returns (Q, R) with A = Q R.  Classical (not modified) to match the
    reference routine; use ``mgs`` for the better-conditioned variant.
    """
    n = a.shape[1]
    q = jnp.zeros_like(a)
    r = jnp.zeros((n, n), dtype=a.dtype)
    for j in range(n):
        v = a[:, j]
        # projections against all previous q's
        rj = jnp.matmul(q.T.conj(), v, precision=_HI)
        rj = jnp.where(jnp.arange(n) < j, rj, 0.0)
        v = v - jnp.matmul(q, rj, precision=_HI)
        nrm = jnp.linalg.norm(v)
        q = q.at[:, j].set(v / nrm)
        r = r.at[:, j].set(rj)
        r = r.at[j, j].set(nrm)
    return q, r


def mgs(a):
    """Modified Gram-Schmidt QR (lis_array_mgs, src/array/lis_array.c:1084)."""
    m, n = a.shape
    q = jnp.array(a)
    r = jnp.zeros((n, n), dtype=a.dtype)
    for j in range(n):
        nrm = jnp.linalg.norm(q[:, j])
        r = r.at[j, j].set(nrm)
        qj = q[:, j] / nrm
        q = q.at[:, j].set(qj)
        proj = jnp.matmul(qj.conj(), q, precision=_HI)   # projections
        mask = jnp.arange(n) > j
        r = r.at[j, :].set(jnp.where(mask, proj, r[j, :]))
        q = q - jnp.outer(qj, jnp.where(mask, proj, 0.0))
    return q, r


def qr_eigen(a, maxiter: int = 200, tol: float = 1e-12):
    """Unshifted QR iteration for eigenvalues of a small dense matrix.

    Analogue of lis_array_qr (src/array/lis_array.c:1136), which runs plain
    QR steps until the subdiagonal decays; used by the Lanczos/Arnoldi/SI
    eigensolvers on their projected matrices.  Implemented as a lax loop so
    it can run jitted on device.  Returns (eigenvalue vector, iterations).

    Like the reference, complex pairs are not split — for real symmetric /
    tridiagonal inputs (Lanczos) the diagonal converges to the spectrum.
    """
    n = a.shape[0]

    def body(state):
        t, it, _ = state
        q, r = jnp.linalg.qr(t)
        t2 = jnp.matmul(r, q, precision=_HI)
        off = jnp.sqrt(jnp.sum(jnp.tril(t2, -1) ** 2))
        return t2, it + 1, off

    def cond(state):
        t, it, off = state
        return jnp.logical_and(it < maxiter, off > tol)

    t0 = jnp.asarray(a)
    init = (t0, jnp.array(0), jnp.array(jnp.inf, dtype=t0.dtype))
    t, it, _ = jax.lax.while_loop(cond, body, init)
    return jnp.diagonal(t), it
