"""Generated test problems, equivalents of the reference's test programs.

- tridiag(n): the 1-D Laplacian of spmvtest1 (test/spmvtest1.c:139-150)
- poisson2d(m, n): 2-D 5-point Poisson of test2 (test/test2.c:112-127)
- poisson3d(l, m, n): 3-D 7-point Poisson of test3
- poisson3d27(l, m, n): 27-point HPCG-style operator of test3b
  (diag 26.0, off-diag -1.0; test/test3b.c:127)
- gamma_matrix(n, gamma): the ill-conditioned bidiagonal quad-precision
  test matrix of test5 (rows [gamma, 1, 2]; test/test5.c:96-105)
- random_spd(n): dense-ish random SPD matrix for solver unit tests
- random_rows(n, k, band): k random entries per row, uniform over all
  columns (locality-free) or within +-band of the diagonal, made
  diagonally dominant
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from lis_tpu.matrix.csr import CSRMatrix


def _to_matrix(a) -> CSRMatrix:
    a = a.tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                     a.shape)


def tridiag(n: int, diag: float = 2.0, off: float = -1.0) -> CSRMatrix:
    return _to_matrix(sp.diags([off, diag, off], [-1, 0, 1], shape=(n, n)))


def poisson2d(m: int, n: int) -> CSRMatrix:
    ix = sp.identity(m)
    iy = sp.identity(n)
    tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
    ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    return _to_matrix(sp.kron(iy, tx) + sp.kron(ty, ix))


def poisson3d(l: int, m: int, n: int) -> CSRMatrix:
    def lap(k):
        return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    il, im, in_ = sp.identity(l), sp.identity(m), sp.identity(n)
    a = (sp.kron(sp.kron(in_, im), lap(l))
         + sp.kron(sp.kron(in_, lap(m)), il)
         + sp.kron(sp.kron(lap(n), im), il))
    return _to_matrix(a)


def poisson3d27(l: int, m: int, n: int) -> CSRMatrix:
    """27-point stencil, diag 26, off-diag -1 (HPCG-style, test/test3b.c:127).

    Built straight into CSR: the 27 neighbours of a row, taken in
    (dz, dy, dx) order, have increasing column indices, so masking the
    out-of-grid ones leaves each row sorted — O(27 N) memory, no COO sort
    (216^3 = 10M rows builds in seconds)."""
    N = l * m * n
    itype = np.int32 if N < 2**31 // 27 else np.int64
    i = np.arange(N, dtype=itype)
    x, y, z = i % l, (i // l) % m, i // (l * m)
    cols, valid, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                valid.append((0 <= x + dx) & (x + dx < l)
                             & (0 <= y + dy) & (y + dy < m)
                             & (0 <= z + dz) & (z + dz < n))
                cols.append(i + itype(dx + dy * l + dz * l * m))
                vals.append(26.0 if (dx, dy, dz) == (0, 0, 0) else -1.0)
    valid = np.stack(valid, axis=1)
    index = np.stack(cols, axis=1)[valid]
    value = np.broadcast_to(np.asarray(vals), valid.shape)[valid]
    ptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=ptr[1:])
    return CSRMatrix.from_csr_arrays(ptr, index, value, (N, N))


def poisson3d_jump(l: int, m: int, n: int, jump: float = 1e4,
                   seed: int = 0, pattern: str = "cube") -> CSRMatrix:
    """7-point variable-coefficient Poisson with a discontinuous
    coefficient field (face values by harmonic mean) — the classic
    ill-conditioned AMG showcase: the condition number scales with the
    jump ratio, so one-level preconditioners (SSOR/ILU) degrade while
    multigrid stays (near) mesh- and jump-independent.  ``pattern`` is
    "cube" (a high-coefficient center cube) or "checker" (3-D 2^3-block
    checkerboard)."""
    N = l * m * n
    i = np.arange(N, dtype=np.int64)
    x, y, z = i % l, (i // l) % m, i // (l * m)
    if pattern == "checker":
        blk = max(2, min(l, m, n) // 8)
        hi = ((x // blk + y // blk + z // blk) % 2).astype(bool)
    else:
        hi = ((l // 4 <= x) & (x < 3 * l // 4)
              & (m // 4 <= y) & (y < 3 * m // 4)
              & (n // 4 <= z) & (z < 3 * n // 4))
    k = np.where(hi, jump, 1.0)

    rows, cols, vals = [], [], []
    diag = np.zeros(N)
    for d, lim, coord in ((1, l, x), (l, m, y), (l * m, n, z)):
        mask = coord < lim - 1          # face between i and i+d
        a = k[i[mask]]
        b = k[i[mask] + d]
        w = 2.0 * a * b / (a + b)       # harmonic mean
        rows += [i[mask], i[mask] + d]
        cols += [i[mask] + d, i[mask]]
        vals += [-w, -w]
        np.add.at(diag, i[mask], w)
        np.add.at(diag, i[mask] + d, w)
        # homogeneous Dirichlet boundary faces (keeps A nonsingular SPD)
        diag[coord == 0] += k[coord == 0]
        diag[coord == lim - 1] += k[coord == lim - 1]
    rows.append(i)
    cols.append(i)
    vals.append(diag)
    a = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N))
    return _to_matrix(a)


def gamma_matrix(n: int, gamma: float = 2.0) -> CSRMatrix:
    """The test5 quad-precision demo matrix (test/test5.c:96-105):
    A[i,i-2] = γ, A[i,i] = 2, A[i,i+1] = 1 — ill-conditioned for γ ≈ 2,
    where double BiCG stalls and quad converges."""
    a = sp.diags([np.full(n - 2, gamma), np.full(n, 2.0), np.ones(n - 1)],
                 [-2, 0, 1])
    return _to_matrix(a.tocsr())


def random_sparse(n: int, density: float = 0.05, seed: int = 0,
                  spd: bool = False) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, random_state=rng, format="csr")
    if spd:
        a = a @ a.T + n * sp.identity(n)
    else:
        a = a + n * sp.identity(n)     # diagonally dominant, nonsymmetric
    return _to_matrix(a.tocsr())


def random_rows(n: int, k: int, band: int | None = None, seed: int = 0,
                dtype=np.float64) -> CSRMatrix:
    """k uniformly random off-diagonal entries per row (standard normal
    values) plus a dominant diagonal (row sum of |values| + 1), so every
    Krylov solver converges.  ``band=None`` draws columns from all of
    [0, n) — locality-free sparsity; otherwise from [i - band, i + band]
    clipped to the matrix.  Duplicate columns are summed."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    if band is None:
        cols = rng.integers(0, n, size=n * k)
    else:
        cols = np.clip(rows + rng.integers(-band, band + 1, size=n * k),
                       0, n - 1)
    cols = np.sort(cols.reshape(n, k), axis=1).reshape(-1)
    vals = rng.standard_normal(n * k)
    a = sp.csr_matrix((vals, cols, np.arange(0, n * k + 1, k)),
                      shape=(n, n))
    a.sum_duplicates()
    d = np.asarray(abs(a).sum(axis=1)).ravel() + 1.0
    a = (a + sp.diags(d)).tocsr()
    a.sort_indices()
    return CSRMatrix.from_csr_arrays(a.indptr, a.indices,
                                     a.data.astype(dtype), a.shape)


def poisson3d27_dia(l, m, n, dtype=np.float64):
    """27-point 3-D Poisson operator built DIRECTLY in DIA form — O(27·N)
    memory instead of the COO/CSR assembly path (which peaks at ~50 bytes
    per nnz and cannot build 192³+ problems on modest hosts).  Same
    operator as poisson3d27 (diag 26, off-diag -1; test/spmvtest3b.c)."""
    import jax.numpy as jnp
    from lis_tpu.matrix.dia import DIAMatrix
    N = l * m * n
    i = np.arange(N, dtype=np.int64)
    x = i % l
    y = (i // l) % m
    z = i // (l * m)
    offsets, vals = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                off = dx + dy * l + dz * l * m
                valid = ((0 <= x + dx) & (x + dx < l)
                         & (0 <= y + dy) & (y + dy < m)
                         & (0 <= z + dz) & (z + dz < n))
                v = np.where(valid,
                             26.0 if (dx, dy, dz) == (0, 0, 0) else -1.0,
                             0.0).astype(dtype)
                offsets.append(int(off))
                vals.append(v)
    # tiny grids (l<=2 or m<=2) make different stencil legs collide on the
    # same flat offset — merge duplicates by summation
    merged = {}
    for off, val in zip(offsets, vals):
        merged[off] = merged[off] + val if off in merged else val
    offs = sorted(merged)
    nnz = sum(int(np.count_nonzero(merged[o])) for o in offs)
    return DIAMatrix(value=tuple(jnp.asarray(merged[o]) for o in offs),
                     nrows=N, ncols=N, nnz=nnz, offsets=tuple(offs))
