"""Subspace eigensolvers: SI (subspace iteration), LI (Lanczos), AI (Arnoldi),
plus the CG/CR eigensolvers.

Reference: lis_esi (src/esolver/lis_esolver_si.c:137), lis_eli (Lanczos,
lis_esolver_li.c:149: tridiagonalise then dense QR via lis_array_qr :253,
then refine each Ritz pair with the inner esolver), lis_eai (Arnoldi,
lis_esolver_ai.c:151), lis_ecg/lis_ecr (lis_esolver_cg.c:126,780).

Design: the Krylov factorisations (Lanczos three-term recurrence /
Arnoldi MGS) run as device matvecs + dots; the small (ss+1)² projected
eigenproblem is solved on host with numpy — identical role to the
reference's lis_array_qr dense QR iteration.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from lis_tpu import config as C
from lis_tpu.core import vector as v
from lis_tpu.esolvers.base import register_esolver


def _multi_result(evalues, evectors, iters, resids, status, rh):
    from lis_tpu.esolvers.driver import EsolveResult
    evalues = np.asarray(evalues)
    return EsolveResult(evalue=float(np.real(evalues[0])),
                        evector=jnp.asarray(evectors[0]),
                        iters=int(iters[0]), resid=float(resids[0]),
                        status=status,
                        evalues=np.real(evalues),
                        evectors=np.asarray(evectors),
                        iters_all=np.asarray(iters),
                        resids_all=np.asarray(resids),
                        rhistory=np.asarray(rh))


def _gen_op(A, B, opts):
    """Operator x -> B⁻¹A x for the generalized problem (B=None -> A)."""
    if B is None:
        return A.matvec
    if not hasattr(B, "to_csr_arrays"):
        # operator-only B (distributed GlobalView): registry-solve path
        from lis_tpu.esolvers.power import _bsolve

        def op_gv(x):
            return _bsolve(B, A.matvec(x), opts)
        return op_gv
    from lis_tpu.solvers.driver import solve

    from lis_tpu.esolvers.power import _inner_precision

    def op(x):
        z = A.matvec(x)
        return solve(B, z, solver=opts.inner.solver, precon=opts.inner.precon,
                     maxiter=opts.inner.maxiter, tol=1e-13,
                     precision=_inner_precision(opts)).x
    return op


def _pair_resid(A, B, lam, x):
    bx = x if B is None else B.matvec(x)
    den = abs(lam) if lam != 0 else 1.0
    return float(v.nrm2(A.matvec(x) - lam * bx) / den)


def _refine_pair(A, B, lam, x, opts):
    """Polish a Ritz pair with FIXED-shift inverse iteration (the
    reference's per-pair refinement by the inner esolver,
    lis_esolver_li.c:576).  The shift stays at the Ritz value: updating it
    to the converging eigenvalue makes the inner system exactly singular
    and stalls the inner Krylov solve.

    Standard problem: runs as the cached compiled II loop (one XLA
    program per pair instead of a host dispatch per inner solve)."""
    from lis_tpu.esolvers.power import _shift_solve
    resid = _pair_resid(A, B, lam, x)
    if resid <= opts.tol:
        return lam, x, resid
    if B is None:
        import jax.numpy as _jnp
        from lis_tpu.esolvers.power import _eii_runner, _jit_inner_name
        name = _jit_inner_name(opts)
        run = _eii_runner(name, opts.inner.tol, opts.inner.maxiter)
        As = A.shift_diagonal(lam)
        iters, xr, ev, res, rh = run(As, A, _jnp.asarray(x),
                                     _jnp.asarray(float(lam)), 50, opts.tol)
        res = float(res)
        if np.isfinite(res) and res < resid:
            return complex(ev).real, xr, res
        return lam, x, resid
    sigma = lam
    for _ in range(min(max(opts.maxiter, 10), 50)):
        if resid <= opts.tol:
            break
        try:
            y = _shift_solve(A, B, sigma, x if B is None else B.matvec(x),
                             opts)
        except Exception:
            break
        nrm = float(v.nrm2(y))
        if not np.isfinite(nrm) or nrm == 0.0:
            break
        x = y / nrm
        bx = x if B is None else B.matvec(x)
        lam = complex(v.dot(x, A.matvec(x)) / v.dot(x, bx)).real
        resid = _pair_resid(A, B, lam, x)
    return lam, x, resid


@register_esolver("li")
def eli(A, B, x0, opts):
    """Lanczos (lis_eli): tridiagonalisation with full
    reorthogonalisation, host dense eig on T, fixed-shift II refinement
    of each Ritz pair (lis_esolver_li.c:253,576).

    Deliberate divergence from the reference: lis_eli runs only ss-1
    Lanczos steps (a size-ss Krylov space — with the default ss=1 it
    degenerates entirely) and reports refined Ritz values in QR order;
    here the Krylov dimension is max(2*ss, ss+8) and the ss pairs are
    the DOMINANT Ritz values, which gives strictly better-converged
    pairs for the same ss."""
    n = A.nrows
    ss = min(max(opts.ss, 1), n)
    m = min(max(2 * ss, ss + 8), n)       # Krylov dimension ≥ requested pairs
    op = _gen_op(A, B, opts)

    q = x0 / v.nrm2(x0)
    Q = [q]
    alphas, betas = [], []
    beta = 0.0
    qm1 = jnp.zeros_like(q)
    for j in range(m):
        w = op(Q[-1])
        alpha = complex(v.dot(Q[-1], w)).real
        w = w - alpha * Q[-1] - beta * qm1
        # full reorthogonalisation (keeps parity with small-tol reference runs)
        for qq in Q:
            w = w - v.dot(qq, w) * qq
        beta = float(v.nrm2(w))
        alphas.append(alpha)
        if j + 1 < m:
            betas.append(beta)
            if beta == 0.0:
                break
            qm1 = Q[-1]
            Q.append(w / beta)

    k = len(alphas)
    T = np.diag(np.asarray(alphas))
    if k > 1:
        off = np.asarray(betas[: k - 1])
        T += np.diag(off, 1) + np.diag(off, -1)
    w_eig, s_eig = np.linalg.eigh(T)
    # largest-magnitude first (reference returns the dominant pairs)
    order = np.argsort(-np.abs(w_eig))[:ss]
    evalues = w_eig[order]
    Qm = jnp.stack(Q[:k], axis=1)
    evectors, resids = [], []
    evalues = np.array(evalues, dtype=float)
    for idx in range(ss):
        xi = Qm @ jnp.asarray(s_eig[:, order[idx]])
        xi = xi / v.nrm2(xi)
        if getattr(opts, "ritz_only", False):
            # -rval true: report the raw Ritz pairs, no inner refinement
            # (lis_esolver_li.c's `if (rval) return LIS_SUCCESS` branch)
            res = _pair_resid(A, B, float(evalues[idx]), xi)
        else:
            lam, xi, res = _refine_pair(A, B, float(evalues[idx]), xi, opts)
            evalues[idx] = lam
        evectors.append(np.asarray(xi))
        resids.append(res)
    status = (C.LIS_SUCCESS if getattr(opts, "ritz_only", False)
              or max(resids) <= max(opts.tol * 10, 1e-10)
              else C.LIS_MAXITER)
    return _multi_result(evalues, evectors, [k] * ss, resids,
                         status, resids)


@register_esolver("ai")
def eai(A, B, x0, opts):
    """Arnoldi (lis_eai): MGS Hessenberg factorisation, host dense eig."""
    n = A.nrows
    ss = min(max(opts.ss, 1), n)
    m = min(max(2 * ss, ss + 8), n)
    op = _gen_op(A, B, opts)

    q = x0 / v.nrm2(x0)
    Q = [q]
    H = np.zeros((m + 1, m), dtype=np.asarray(x0).dtype)
    k = m
    for j in range(m):
        w = op(Q[j])
        for i in range(j + 1):
            H[i, j] = complex(v.dot(Q[i], w)) \
                if np.iscomplexobj(H) else float(v.dot(Q[i], w))
            w = w - H[i, j] * Q[i]
        hn = float(v.nrm2(w))
        H[j + 1, j] = hn
        if hn == 0.0:
            k = j + 1
            break
        if j + 1 < m:
            Q.append(w / hn)

    Hk = H[:k, :k]
    w_eig, s_eig = np.linalg.eig(Hk)
    order = np.argsort(-np.abs(w_eig))[:ss]
    evalues = w_eig[order]
    Qm = jnp.stack(Q[:k], axis=1)
    evectors, resids = [], []
    evalues = np.real(np.array(evalues))
    for idx in range(ss):
        vec = s_eig[:, order[idx]]
        if np.iscomplexobj(vec) and np.abs(vec.imag).max() < 1e-13:
            vec = vec.real
        xi = Qm @ jnp.asarray(np.real(vec))
        nrm = v.nrm2(xi)
        xi = xi / jnp.where(nrm == 0, 1.0, nrm)
        if getattr(opts, "ritz_only", False):
            # -rval true (lis_esolver_ai.c:313): raw Ritz pairs only
            res = _pair_resid(A, B, float(evalues[idx]), xi)
        else:
            lam, xi, res = _refine_pair(A, B, float(evalues[idx]), xi, opts)
            evalues[idx] = lam
        evectors.append(np.asarray(xi))
        resids.append(res)
    status = (C.LIS_SUCCESS if getattr(opts, "ritz_only", False)
              or max(resids) <= max(opts.tol * 10, 1e-10)
              else C.LIS_MAXITER)
    return _multi_result(evalues, evectors, [k] * ss, resids,
                         status, resids)


@register_esolver("si")
def esi(A, B, x0, opts):
    """Subspace iteration (lis_esi, src/esolver/lis_esolver_si.c:230-330):
    SEQUENTIAL deflated iteration — pair j orthogonalises against the
    already-converged v_1..v_{j-1} each sweep, the kernel is the inner
    esolver's map (-ie ii, the default: an inverse solve per sweep, so
    the SMALLEST pairs come out first; -ie pi: a matvec, largest pairs),
    and the final r carries over as the next pair's start vector."""
    from lis_tpu.esolvers.power import _shift_solve, _bsolve
    n = A.nrows
    ss = min(max(opts.ss, 1), n)
    inner = getattr(opts, "inner_esolver", "ii")
    sigma = opts.rval

    r = x0 / v.nrm2(x0)
    vs = []
    evalues, resids, iters_all, rh = [], [], [], []
    status = C.LIS_SUCCESS
    for j in range(ss):
        vj = r
        resid = np.inf
        theta = 0.0
        it = opts.maxiter
        for k in range(1, opts.maxiter + 1):
            for vk in vs:
                # project OUT vk: coefficient is <vk, vj> (conjugate on
                # vk's side — dot(vj, vk) is its conjugate and deflates
                # the wrong component for complex operands)
                vj = vj - v.dot(vk, vj) * vk
            if inner == "pi":
                rnew = A.matvec(vj) if B is None else _bsolve(
                    B, A.matvec(vj), opts)
            else:
                rhs = vj if B is None else B.matvec(vj)
                rnew = _shift_solve(A, B, sigma, rhs, opts)
            nrm = float(v.nrm2(rnew))
            if not np.isfinite(nrm) or nrm == 0.0:
                break
            theta = complex(v.dot(vj, rnew)).real
            resid = float(v.nrm2(rnew - theta * vj) /
                          (abs(theta) if theta != 0 else 1.0))
            vj = rnew / nrm
            if j == 0:
                rh.append(resid)
            if resid < opts.tol:
                it = k
                break
        if inner == "pi":
            lam = theta + sigma
        else:
            lam = (1.0 / theta if theta != 0 else 0.0) + sigma
        evalues.append(lam)
        resids.append(resid)
        iters_all.append(it)
        vs.append(vj)
        r = vj
        if resid > opts.tol:
            status = C.LIS_MAXITER
    evectors = [np.asarray(vk) for vk in vs]
    return _multi_result(np.asarray(evalues), evectors, iters_all, resids,
                         status, rh)
