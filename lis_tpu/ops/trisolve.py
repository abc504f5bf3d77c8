"""Sparse triangular solves via level scheduling.

Reference: lis_matrix_solve / lis_matrix_solveh dispatch
(src/matrix/lis_matrix_ops.c:1118,1168), CSR implementation
lis_matrix_solve_csr (src/matrix/lis_matrix_csr.c:1525) with LOWER /
UPPER / SSOR flags, where x[i] = (b[i] - Σ L[i,j]x[j]) · WD[i].

A sequential row loop cannot run data-parallel, but the dependency DAG of a
triangular matrix decomposes into *levels* — rows whose in-level
dependencies are empty — which is exactly the wavefront the reference's
vector-machine heritage wants.  The plan is computed once on host at
factor/split time (static per matrix); the device solve is a lax.scan over
levels, each level one padded gather + multiply + scatter.  For stencil
matrices the level count is O(n^(1/d)) with wide levels, so each level
is wide data-parallel work.

The reference's own OpenMP path *relaxes* the dependencies across threads
(lis_matrix_csr.c:1577-1605 skips out-of-block columns — block-Jacobi
within shared memory); `relaxed_sweeps` reproduces that behavior for the
distributed / performance path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class TriSolvePlan:
    rows: jax.Array       # (nlev, max_rows) int32, padded with n
    cols: jax.Array       # (nlev, max_rows, max_nnz) int32, padded n
    vals: jax.Array       # (nlev, max_rows, max_nnz), padded 0
    dinv: jax.Array       # (n,) per-row multiplier (the reference's WD)
    n: int                # static

jax.tree_util.register_pytree_node(
    TriSolvePlan,
    lambda p: ((p.rows, p.cols, p.vals, p.dinv), (p.n,)),
    lambda aux, c: TriSolvePlan(*c, n=aux[0]))


def make_plan(ptr, index, value, dinv, lower: bool = True) -> TriSolvePlan:
    """Build a level-scheduled plan from strictly-triangular CSR arrays.

    ``dinv`` is the per-row multiplier applied after the subtraction —
    D⁻¹ for GS, (D/ω)⁻¹ for SOR, U[ii]⁻¹ for ILU factors.
    """
    ptr = np.asarray(ptr)
    index = np.asarray(index)
    value = np.asarray(value)
    n = len(ptr) - 1

    from lis_tpu import _native
    sched = _native.level_schedule(ptr, index, lower)
    if sched is not None:
        nlev, lev = sched
        lev = lev.astype(np.int64)
    else:
        lev = np.zeros(n, dtype=np.int64)
        order = range(n) if lower else range(n - 1, -1, -1)
        for i in order:
            deps = index[ptr[i]:ptr[i + 1]]
            if len(deps):
                lev[i] = lev[deps].max() + 1
        nlev = int(lev.max()) + 1 if n else 1

    rows_by_level = [np.nonzero(lev == l)[0] for l in range(nlev)]
    max_rows = max((len(r) for r in rows_by_level), default=1) or 1
    row_nnz = np.diff(ptr)
    max_nnz = int(row_nnz.max()) if n else 0
    max_nnz = max(max_nnz, 1)

    rows = np.full((nlev, max_rows), n, dtype=np.int32)
    cols = np.full((nlev, max_rows, max_nnz), n, dtype=np.int32)
    vals = np.zeros((nlev, max_rows, max_nnz), dtype=value.dtype)
    for l, rl in enumerate(rows_by_level):
        rows[l, :len(rl)] = rl
        for k, i in enumerate(rl):
            s, e = ptr[i], ptr[i + 1]
            cols[l, k, :e - s] = index[s:e]
            vals[l, k, :e - s] = value[s:e]

    return TriSolvePlan(rows=jnp.asarray(rows), cols=jnp.asarray(cols),
                        vals=jnp.asarray(vals), dinv=jnp.asarray(dinv),
                        n=n)


def trisolve(plan: TriSolvePlan, b):
    """x such that (D̃ + T) x = b with D̃ = 1/dinv, T the planned triangle."""
    n = plan.n
    b_ext = jnp.concatenate([b, jnp.zeros(1, dtype=b.dtype)])
    dinv_ext = jnp.concatenate([plan.dinv,
                                jnp.zeros(1, dtype=plan.dinv.dtype)])
    x0 = jnp.zeros(n + 1, dtype=jnp.result_type(b.dtype, plan.vals.dtype))

    def body(x_ext, level):
        rows, cols, vals = level
        gath = jnp.sum(vals * x_ext[cols], axis=-1)
        xi = (b_ext[rows] - gath) * dinv_ext[rows]
        return x_ext.at[rows].set(xi), None

    x_ext, _ = jax.lax.scan(body, x0, (plan.rows, plan.cols, plan.vals))
    return x_ext[:n]


def relaxed_sweeps(L, U, dinv, b, nsweeps: int = 2, lower: bool = True):
    """Jacobi-relaxed triangular solve: fixed-point sweeps
    x ← (b - T x)·dinv, the dependency-dropping scheme the reference itself
    uses across OpenMP threads (lis_matrix_csr.c:1577-1605).  T = L or U
    (format objects with .matvec)."""
    T = L if lower else U
    x = b * dinv
    for _ in range(nsweeps):
        x = (b - T.matvec(x)) * dinv
    return x
