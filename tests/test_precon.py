"""Preconditioner coverage: all 11 reference types + additive Schwarz."""

import numpy as np
import pytest

import lis_tpu
from lis_tpu import solve
from lis_tpu.precon.base import PRECON_REGISTRY
from lis_tpu.runtime.options import PRECON_NAMES
from tests.problems import poisson2d, random_sparse

ALL_PRECONS = ["none", "jacobi", "ssor", "ilu", "ilut", "iluc",
               "hybrid", "is", "sainv", "bjacobi", "saamg"]


def _resid(a, b, x):
    return (np.linalg.norm(np.asarray(b) - a.to_dense() @ np.asarray(x))
            / np.linalg.norm(np.asarray(b)))


def test_registry_complete():
    assert set(PRECON_NAMES) - {"none"} == set(PRECON_REGISTRY)


@pytest.mark.parametrize("p", ALL_PRECONS)
def test_precon_bicgstab(p):
    a = poisson2d(9, 9)
    b = np.ones(81)
    res = solve(a, b, options=f"-i bicgstab -p {p} -tol 1e-10 -maxiter 2000")
    assert res.status == lis_tpu.LIS_SUCCESS, (p, res)
    assert _resid(a, b, res.x) < 1e-8


@pytest.mark.parametrize("p", ["jacobi", "ssor", "ilu", "saamg"])
def test_precon_accelerates_cg(p):
    a = poisson2d(12, 12)
    b = np.ones(144)
    base = solve(a, b, options="-i cg -tol 1e-10")
    pre = solve(a, b, options=f"-i cg -p {p} -tol 1e-10")
    assert pre.status == lis_tpu.LIS_SUCCESS
    assert pre.iters <= base.iters + 1, (p, pre.iters, base.iters)


@pytest.mark.parametrize("p", ["jacobi", "ssor", "ilu", "ilut", "sainv"])
def test_precon_with_bicg_needs_psolveh(p):
    """BiCG exercises psolveh (Mᴴ solve) — the transpose plans must be
    consistent with psolve."""
    a = random_sparse(60, density=0.08, seed=21)
    b = np.ones(60)
    res = solve(a, b, options=f"-i bicg -p {p} -tol 1e-10 -maxiter 2000")
    assert res.status == lis_tpu.LIS_SUCCESS, (p, res)
    assert _resid(a, b, res.x) < 1e-8


def test_ilu_fill_levels():
    a = poisson2d(10, 10)
    b = np.ones(100)
    iters = {}
    for k in (0, 1, 2):
        res = solve(a, b, options=f"-i cg -p ilu -ilu_fill {k} -tol 1e-10")
        assert res.status == lis_tpu.LIS_SUCCESS
        iters[k] = res.iters
    assert iters[2] <= iters[0]    # more fill, better preconditioner


def test_sainv_sparse_and_scales():
    """SAINV is sparse biconjugation (lis_precon_sainv.c:59): O(nnz)
    factors, native/Python engines agree, and creation at n>=10^5 runs in
    seconds (the round-1 dense version needed O(n^2) memory)."""
    import time
    from lis_tpu import _native
    from lis_tpu.precon.sainv import _factor_sainv_py
    a = poisson2d(12, 12)
    ptr, idx, val = [np.asarray(x) for x in a.to_csr_arrays()]
    n = a.nrows
    outp = _factor_sainv_py(ptr, idx, val, n, 0.05)
    assert len(outp[0][1]) < 0.1 * n * n          # sparse, not dense
    outn = _native.sainv_factor(ptr, idx, val, 0.05)
    if outn is not None:
        for an, bn in zip(outn[:2], outp[:2]):
            assert np.array_equal(an[0], bn[0])
            assert np.array_equal(an[1], bn[1])
            np.testing.assert_allclose(an[2], bn[2], rtol=1e-12)
        np.testing.assert_allclose(outn[2], outp[2], rtol=1e-12)

    if _native.sainv_factor(np.array([0, 0], np.int32),
                            np.array([], np.int32), np.array([]),
                            0.1) is not None:
        from lis_tpu.utils.testmat import poisson3d27
        A = poisson3d27(48, 48, 48)               # 110,592 rows
        ptr, idx, val = [np.asarray(x) for x in A.to_csr_arrays()]
        t0 = time.time()
        out = _native.sainv_factor(ptr, idx, val, 0.02)
        dt = time.time() - t0
        assert out is not None and dt < 60, dt
        assert len(out[0][1]) < 30 * A.nrows      # bounded fill


def test_sainv_accelerates_cg():
    a = poisson2d(40, 40)
    b = np.ones(1600)
    base = solve(a, b, options="-i cg -tol 1e-10")
    pre = solve(a, b, options="-i cg -p sainv -sainv_drop 0.02 -tol 1e-10")
    assert pre.status == lis_tpu.LIS_SUCCESS
    assert pre.iters < base.iters


def test_iluc_is_crout_not_ilut():
    """-p iluc runs a true Crout factorisation (lis_precon_iluc.c:67):
    distinct factors from ILUT on an asymmetric matrix once dropping is
    active, native and Python engines agree, and with dropping disabled the
    factors reproduce the complete LU (Crout = Doolittle without drops)."""
    import scipy.sparse as sp
    from lis_tpu import _native
    from lis_tpu.precon.ilu import _factor_iluc, _factor_ilut
    rng = np.random.default_rng(5)
    n = 80
    a = sp.random(n, n, density=0.07, random_state=11,
                  data_rvs=lambda k: rng.standard_normal(k))
    a = (a + sp.diags(np.abs(a).sum(axis=1).A1 + 1.0)).tocsr()
    a.sort_indices()
    ptr, idx, val = a.indptr, a.indices, a.data

    rows_c = _factor_iluc(ptr, idx, val, n, 0.05, 5.0)
    rows_t = _factor_ilut(ptr, idx, val, n, 0.05, 5.0)
    assert any(rows_c[i].keys() != rows_t[i].keys()
               or any(abs(rows_c[i][j] - rows_t[i][j]) > 1e-12
                      for j in rows_c[i]) for i in range(n))

    out = _native.iluc_factor(ptr, idx, val, 0.05, 5.0)
    if out is not None:
        fp, fi, fv = out
        pi, pv, pp = [], [], [0]
        for i in range(n):
            for j in sorted(rows_c[i]):
                pi.append(j)
                pv.append(rows_c[i][j])
            pp.append(len(pi))
        assert np.array_equal(fp, np.asarray(pp))
        assert np.array_equal(fi, np.asarray(pi))
        np.testing.assert_allclose(fv, np.asarray(pv), rtol=1e-12)

    # no dropping => complete LU: (unit L)(U) == A
    rows_f = _factor_iluc(ptr, idx, val, n, 0.0, float(n))
    L = np.eye(n)
    U = np.zeros((n, n))
    for i in range(n):
        for j, v in rows_f[i].items():
            (L if j < i else U)[i, j] = v
    np.testing.assert_allclose(L @ U, a.toarray(), atol=1e-8)


def test_iluc_converges():
    a = random_sparse(90, density=0.07, seed=3)
    b = np.ones(90)
    res = solve(a, b, options="-i bicgstab -p iluc -tol 1e-10 -maxiter 2000")
    assert res.status == lis_tpu.LIS_SUCCESS
    assert _resid(a, b, res.x) < 1e-8


def test_saamg_coarsens():
    from lis_tpu.precon.saamg import build_hierarchy
    import scipy.sparse as sp
    a = poisson2d(20, 20)
    ptr, idx, val = a.to_csr_arrays()
    levels, coarse = build_hierarchy(sp.csr_matrix((val, idx, ptr)))
    assert len(levels) >= 2
    assert coarse.shape[0] < 400 / 4


def test_additive_schwarz_wrapper():
    a = poisson2d(9, 9)
    b = np.ones(81)
    plain = solve(a, b, options="-i cg -p ssor -tol 1e-10")
    adds = solve(a, b, options="-i cg -p ssor -adds true -adds_iter 1 -tol 1e-10")
    assert adds.status == lis_tpu.LIS_SUCCESS
    assert adds.iters <= plain.iters


def test_hybrid_inner_options():
    a = poisson2d(8, 8)
    b = np.ones(64)
    res = solve(a, b, options="-i gmres -p hybrid -hybrid_i gmres "
                              "-hybrid_maxiter 10 -tol 1e-10")
    assert res.status == lis_tpu.LIS_SUCCESS


def test_saamg_hpcg_operator_coarsens():
    """The 27-pt HPCG stencil's off-diagonal strength (1/26 ~ 0.038) sits
    below the default -saamg_theta 0.05: the builder must relax theta
    until aggregation coarsens instead of degenerating to a dense coarse
    inverse of the whole matrix.  Native aggregation matches the Python
    fallback."""
    import scipy.sparse as sp
    from lis_tpu.precon.saamg import build_hierarchy, _strength, _aggregate
    from lis_tpu.utils.testmat import poisson3d27
    from lis_tpu import _native
    A = poisson3d27(16, 16, 16)
    pp, ii, vv = [np.asarray(x) for x in A.to_csr_arrays()]
    levels, coarse = build_hierarchy(sp.csr_matrix((vv, ii, pp)))
    assert len(levels) >= 2
    assert coarse.shape[0] < 4096 / 4
    b = np.asarray(A.matvec(np.ones(A.nrows)))
    r = solve(A, b, options="-i cg -p saamg -tol 1e-10")
    assert r.status == lis_tpu.LIS_SUCCESS
    assert r.iters < 20
    # native vs python aggregation parity
    S = _strength(sp.csr_matrix((vv, ii, pp)), 0.0125)
    out = _native.amg_aggregate(S.indptr, S.indices)
    if out is not None:
        import lis_tpu._native as nat
        orig = nat.amg_aggregate
        nat.amg_aggregate = lambda *a: None
        try:
            agg_py = _aggregate(S)
        finally:
            nat.amg_aggregate = orig
        assert np.array_equal(out[1], agg_py)


def test_saamg_jacobi_smoother():
    """-saamg_smoother jacobi: weighted-Jacobi V-cycle smoothing (pure
    streams — the stream alternative to level-scheduled SGS at scale);
    slightly more iterations, same convergence class."""
    from lis_tpu.utils.testmat import poisson3d27
    A = poisson3d27(12, 12, 12)
    b = np.asarray(A.matvec(np.ones(A.nrows)))
    r_sgs = solve(A, b, options="-i cg -p saamg -tol 1e-10")
    r_jac = solve(A, b, options="-i cg -p saamg -saamg_smoother jacobi "
                                "-tol 1e-10")
    assert r_jac.status == lis_tpu.LIS_SUCCESS
    assert r_jac.iters <= 2 * max(r_sgs.iters, 1)


def test_saamg_lattice_detection():
    """detect_lattice recovers tensor dims from band offsets and rejects
    unstructured sparsity."""
    import scipy.sparse as sp
    from lis_tpu.precon.saamg import detect_lattice
    from lis_tpu.utils.testmat import poisson2d, poisson3d, tridiag

    def tosp(A):
        p, i, v = A.to_csr_arrays()
        return sp.csr_matrix((np.asarray(v), np.asarray(i), np.asarray(p)),
                             shape=A.shape)

    assert detect_lattice(tosp(poisson3d(20, 12, 16))) == (16, 12, 20)
    assert detect_lattice(tosp(poisson2d(30, 40))) == (40, 30)
    assert detect_lattice(tosp(tridiag(100))) == (100,)
    rnd = (sp.random(500, 500, density=0.01, random_state=0)
           + sp.eye(500)).tocsr()
    assert detect_lattice(rnd) is None


def test_saamg_lattice_matches_graph_path():
    """The lattice (streamed box-decimation) hierarchy converges in the
    same class as the graph-aggregation hierarchy and solves exactly."""
    from lis_tpu.utils.testmat import poisson3d27
    A = poisson3d27(16, 16, 16)
    b = np.asarray(A.matvec(np.ones(A.nrows)))
    rl = solve(A, b, options="-i cg -p saamg -tol 1e-10")
    rg = solve(A, b, options="-i cg -p saamg -tol 1e-10 "
                             "-saamg_lattice false")
    assert rl.status == lis_tpu.LIS_SUCCESS
    assert rl.true_resid < 1e-8
    assert rl.iters <= rg.iters + 4


def test_saamg_lattice_implicit_prolongator_exact():
    """ImplicitP (tent-broadcast + one fine matvec) applies exactly the
    host-assembled smoothed prolongator P = (I - 2/3 D^-1 A) Pt."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from lis_tpu.precon.saamg import (build_hierarchy_lattice,
                                      detect_lattice, _lattice_levels)
    from lis_tpu.utils.testmat import poisson3d_jump

    A = poisson3d_jump(9, 9, 9, jump=100.0)
    p, i, v = A.to_csr_arrays()
    As = sp.csr_matrix((np.asarray(v), np.asarray(i), np.asarray(p)),
                       shape=A.shape)
    fd = detect_lattice(As)
    raw, _ = build_hierarchy_lattice(As, fd)
    levels = _lattice_levels(raw, "sgs")
    rng = np.random.default_rng(0)
    for (Al, Pl, *_), lev in zip(raw, levels):
        xc = rng.standard_normal(Pl.shape[1])
        np.testing.assert_allclose(np.asarray(lev.P.matvec(jnp.asarray(xc))),
                                   Pl @ xc, atol=1e-11)
        r = rng.standard_normal(Pl.shape[0])
        np.testing.assert_allclose(np.asarray(lev.P.matvech(jnp.asarray(r))),
                                   Pl.T @ r, atol=1e-11)


def test_saamg_jump_coefficient_mesh_independence():
    """Jump-coefficient Poisson (kappa ~ jump ratio): CG+SSOR iterations
    grow with the mesh while CG+SAAMG stays flat — the AMG win the
    reference's SAAMG exists for (lis_m_solver_AMGCG.F90)."""
    from lis_tpu.utils.testmat import poisson3d_jump
    iters = {}
    for dim in (16, 32):
        A = poisson3d_jump(dim, dim, dim, jump=1e4)
        b = np.ones(A.nrows)
        r = solve(A, b, options="-i cg -p saamg -tol 1e-9")
        assert r.status == lis_tpu.LIS_SUCCESS, dim
        iters[dim] = r.iters
    assert iters[32] <= iters[16] + 8          # near-mesh-independent
    r_ssor = solve(poisson3d_jump(32, 32, 32, jump=1e4),
                   np.ones(32 ** 3), options="-i cg -p ssor -tol 1e-9")
    assert iters[32] < r_ssor.iters / 2        # AMG wins the iteration count


def test_saamg_unsym_petrov_galerkin():
    """-saamg_unsym builds the Petrov-Galerkin hierarchy (restriction
    smoothed with A^T, coarse = R A P — reference
    data_creation_unsym_ssi_amg, lis_m_data_creation_AMGCG.F90:158):
    distinct R on every level, mesh-quality convergence on a genuinely
    nonsymmetric convection-diffusion operator, and at least matching the
    symmetric-Galerkin variant."""
    import scipy.sparse as sp
    from lis_tpu.matrix.csr import CSRMatrix

    def convdiff2d(nx, ny, beta):
        n, h = nx * ny, 1.0 / (nx + 1)
        A = sp.lil_matrix((n, n))
        for j in range(ny):
            for i in range(nx):
                k = j * nx + i
                A[k, k] = 4.0 + beta * h
                if i > 0:
                    A[k, k - 1] = -1.0 - beta * h   # upwind convection
                if i < nx - 1:
                    A[k, k + 1] = -1.0
                if j > 0:
                    A[k, k - nx] = -1.0
                if j < ny - 1:
                    A[k, k + nx] = -1.0
        return A.tocsr()

    a = convdiff2d(32, 32, 20.0)
    a.sort_indices()
    m = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    b = np.ones(a.shape[0])
    ru = lis_tpu.solve(m, b, options="-i bicgstab -p saamg -tol 1e-10 "
                                     "-saamg_unsym true")
    rs = lis_tpu.solve(m, b, options="-i bicgstab -p saamg -tol 1e-10 "
                                     "-saamg_lattice false")
    assert ru.status == lis_tpu.LIS_SUCCESS
    assert ru.iters <= rs.iters
    x = np.asarray(ru.x)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-9

    # the hierarchy really is Petrov-Galerkin: every level carries R != P^T
    from lis_tpu.precon.saamg import build_hierarchy
    raw, _ = build_hierarchy(a, unsym=True)
    assert raw and all(R is not None for (_, _, R) in raw)
    A0, P0, R0 = raw[0]
    assert abs(R0 - P0.T.tocsr()).max() > 1e-8
    # and the coarse operator is R A P, not P^T A P
    np.testing.assert_allclose((R0 @ A0 @ P0).toarray(),
                               raw[1][0].toarray() if len(raw) > 1
                               else (R0 @ A0 @ P0).toarray(), rtol=1e-12)


def test_vbr_auto_partition_runs_dont_cross():
    """The automatic VBR partition (lis_matrix_get_vbr_rowcol,
    lis_matrix_vbr.c:262) must place boundaries so no row's contiguous
    column run crosses a block edge, and must recover the exact block
    structure of a block-tridiagonal matrix with mixed block sizes."""
    import scipy.sparse as sp
    from lis_tpu.matrix.vbr import auto_rowcol

    sizes = [2, 3, 1, 4, 2]
    part = np.cumsum([0] + sizes)
    n = part[-1]
    rng = np.random.default_rng(5)
    blocks = {}
    for bi in range(len(sizes)):
        for bj in (bi - 1, bi, bi + 1):
            if 0 <= bj < len(sizes):
                blocks[(bi, bj)] = rng.standard_normal(
                    (sizes[bi], sizes[bj])) + (4.0 * np.eye(
                        sizes[bi], sizes[bj]) if bi == bj else 0.0)
    a = sp.lil_matrix((n, n))
    for (bi, bj), blk in blocks.items():
        a[part[bi]:part[bi + 1], part[bj]:part[bj + 1]] = blk
    a = a.tocsr()
    got = auto_rowcol(a.indptr, a.indices, n)
    assert got == tuple(int(t) for t in part)
    # exact characterization on an irregular pattern: the interior
    # boundaries are precisely the union over rows of every contiguous
    # run's start column and (end column + 1) — no more, no fewer
    # (lis_matrix_vbr.c:280-299; note a long run CAN be split by another
    # row's marks, which VBR tolerates: the run's entries just land in
    # several dense blocks)
    r = random_sparse(40, density=0.12, seed=11)
    p, i, v = (np.asarray(t) for t in r.to_csr_arrays())
    bounds = auto_rowcol(p, i, 40)
    marks = set()
    for row in range(40):
        cols = np.sort(i[p[row]:p[row + 1]])
        for s in np.split(cols, np.flatnonzero(np.diff(cols) != 1) + 1):
            if len(s):
                marks.add(int(s[0]))
                marks.add(int(s[-1]) + 1)
    marks.discard(0)
    assert set(bounds) - {0, 40} == marks - {40}, (bounds, sorted(marks))


def test_vbr_block_ilu_exact_at_full_fill():
    """With enough fill the variable-block ILU is an exact block LDU:
    M⁻¹r == A⁻¹r, and the transposed apply equals M⁻ᴴ."""
    import jax.numpy as jnp
    from lis_tpu.matrix.convert import convert_matrix
    from lis_tpu.precon.ilu import create_iluk
    from lis_tpu.runtime.options import SolverOptions

    a = random_sparse(24, density=0.25, seed=9)
    dense = a.to_dense() + 8.0 * np.eye(24)
    import scipy.sparse as sp
    s = sp.csr_matrix(dense)
    from lis_tpu.matrix.vbr import VBRMatrix
    m = VBRMatrix.from_csr_arrays(s.indptr, s.indices, s.data, s.shape,
                                  block=3)
    pc = create_iluk(m, SolverOptions(ilu_fill=24))
    r = np.random.default_rng(1).standard_normal(24)
    np.testing.assert_allclose(np.asarray(pc.psolve(jnp.asarray(r))),
                               np.linalg.solve(dense, r), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(pc.psolveh(jnp.asarray(r))),
                               np.linalg.solve(dense.T, r), rtol=1e-9,
                               atol=1e-9)


def test_vbr_block_ilu_psolveh_is_adjoint_of_psolve():
    """At any fill level: materialise M⁻¹ column-by-column via psolve and
    check psolveh applies its (conjugate) transpose."""
    import jax.numpy as jnp
    from lis_tpu.precon.ilu import create_iluk
    from lis_tpu.runtime.options import SolverOptions
    import scipy.sparse as sp
    from lis_tpu.matrix.vbr import VBRMatrix

    a = random_sparse(18, density=0.3, seed=2)
    dense = a.to_dense() + 6.0 * np.eye(18)
    s = sp.csr_matrix(dense)
    m = VBRMatrix.from_csr_arrays(s.indptr, s.indices, s.data, s.shape,
                                  row_part=(0, 2, 5, 9, 10, 14, 18),
                                  col_part=(0, 2, 5, 9, 10, 14, 18))
    pc = create_iluk(m, SolverOptions(ilu_fill=0))
    minv = np.stack([np.asarray(pc.psolve(jnp.asarray(e)))
                     for e in np.eye(18)], axis=1)
    r = np.random.default_rng(3).standard_normal(18)
    np.testing.assert_allclose(np.asarray(pc.psolveh(jnp.asarray(r))),
                               minv.T @ r, rtol=1e-10, atol=1e-10)


def test_user_block_format_not_rerouted():
    """A user-assembled BSR/VBR matrix keeps its block semantics through
    solve(): auto_storage must not silently reroute it to a scalar format
    (which would swap block ILU for scalar ILU — the reference never
    converts without -storage).  Iteration counts must match the explicit
    -storage path exactly."""
    from lis_tpu.matrix.convert import convert_matrix
    a = poisson2d(12, 12)
    b = np.ones(a.nrows)
    for fmt, opt in (("vbr", "-storage vbr"),
                     ("bsr", "-storage bsr -storage_block 2")):
        pre = solve(convert_matrix(a, fmt) if fmt == "vbr"
                    else convert_matrix(a, fmt, bnr=2), b,
                    options="-i bicgstab -p ilu -tol 1e-11")
        exp = solve(a, b, options=f"-i bicgstab -p ilu {opt} -tol 1e-11")
        assert pre.iters == exp.iters, (fmt, pre.iters, exp.iters)


def test_saamg_unsym_psolveh_is_adjoint():
    """The Petrov-Galerkin hierarchy (R != P^T) makes M nonsymmetric;
    psolveh must still apply M^-T exactly (BiCG's dual recursion needs
    it).  Adjoint identity: <M^-1 u, v> == <u, M^-H v>."""
    import scipy.sparse as sp
    import jax.numpy as jnp
    from lis_tpu.precon.saamg import create_saamg
    from lis_tpu.runtime.options import SolverOptions
    from lis_tpu.matrix.csr import CSRMatrix

    nx = 16
    n, h = nx * nx, 1.0 / (nx + 1)
    A = sp.lil_matrix((n, n))
    for j in range(nx):
        for i in range(nx):
            k = j * nx + i
            A[k, k] = 4.0 + 20.0 * h
            if i > 0:
                A[k, k - 1] = -1.0 - 20.0 * h
            if i < nx - 1:
                A[k, k + 1] = -1.0
            if j > 0:
                A[k, k - nx] = -1.0
            if j < nx - 1:
                A[k, k + nx] = -1.0
    a = A.tocsr()
    m = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    pc = create_saamg(m, SolverOptions(saamg_unsym=True))
    assert any(l.R is not None for l in pc.levels)
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(n), rng.standard_normal(n)
    lhs = float(np.dot(np.asarray(pc.psolve(jnp.asarray(u))), v))
    rhs = float(np.dot(u, np.asarray(pc.psolveh(jnp.asarray(v)))))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0), (lhs, rhs)
    # and BiCG converges with the unsym hierarchy
    res = solve(m, np.ones(n), options="-i bicg -p saamg "
                                       "-saamg_unsym true -tol 1e-10")
    assert res.status == lis_tpu.LIS_SUCCESS
    assert float(res.true_resid) < 1e-9


def test_block_structure_survives_scale_and_shift():
    """scale_rows/scale_symm/shift_diagonal rebuild in the same format —
    they must preserve a user-chosen BSR block size and VBR partition
    instead of silently reverting to defaults (which would change the
    block ILU that factors them)."""
    from lis_tpu.matrix.convert import convert_matrix
    from lis_tpu.matrix.vbr import VBRMatrix
    import scipy.sparse as sp
    import jax.numpy as jnp

    a = poisson2d(6, 6)
    bsr = convert_matrix(a, "bsr", bnr=3)
    d = jnp.arange(1.0, 37.0)
    for m2 in (bsr.scale_rows(d), bsr.scale_symm(d),
               bsr.shift_diagonal(0.5)):
        assert m2.bnr == 3, m2.bnr

    p, i, v = (np.asarray(t) for t in a.to_csr_arrays())
    part = (0, 4, 9, 17, 20, 30, 36)
    vbr = VBRMatrix.from_csr_arrays(p, i, v, a.shape,
                                    row_part=part, col_part=part)
    for m2 in (vbr.scale_rows(d), vbr.scale_symm(d),
               vbr.shift_diagonal(0.5)):
        assert tuple(m2.row_part) == part, m2.row_part


def test_bscale_singular_diagonal_block():
    """-scale 1 -storage bsr on a matrix whose diagonal block is singular
    (but the matrix itself is not) must solve, not crash: the block
    inversion falls back to the pseudo-inverse like the block-ILU paths."""
    import scipy.sparse as sp
    from lis_tpu.matrix.csr import CSRMatrix
    dense = np.array([[1.0, 1.0, 0.0, 2.0],
                      [1.0, 1.0, 3.0, 0.0],
                      [0.0, 2.0, 5.0, 1.0],
                      [1.0, 0.0, 1.0, 4.0]])   # top-left 2x2 singular
    assert abs(np.linalg.det(dense)) > 1e-9
    a = CSRMatrix.from_dense(dense)
    b = dense @ np.array([1.0, -2.0, 3.0, 0.5])
    res = solve(a, b, options="-i gmres -scale 1 -storage bsr "
                              "-storage_block 2 -tol 1e-12")
    assert res.status == lis_tpu.LIS_SUCCESS
    np.testing.assert_allclose(np.asarray(res.x),
                               [1.0, -2.0, 3.0, 0.5], atol=1e-8)


def test_compat_set_vbr_partition_honored():
    """lis_matrix_set_vbr declares the partition; assemble must keep it
    (the reference's block factorizations run on the declared blocks)."""
    import lis_tpu.compat as lis
    import scipy.sparse as sp
    a = poisson2d(4, 4)
    p, i, v = (np.asarray(t) for t in a.to_csr_arrays())
    s = sp.csr_matrix((v, i, p), shape=a.shape)
    part = np.array([0, 3, 7, 12, 16], dtype=np.int64)
    nr = len(part) - 1
    # build VBR arrays for set_vbr (column-major blocks)
    bptr, bindex, vptr, vals = [0], [], [0], []
    for bi in range(nr):
        for bj in range(nr):
            blk = s[part[bi]:part[bi + 1], part[bj]:part[bj + 1]].toarray()
            if np.any(blk):
                bindex.append(bj)
                vals.append(blk.T.ravel())     # column-major
                vptr.append(vptr[-1] + blk.size)
        bptr.append(len(bindex))
    value = np.concatenate(vals)
    A = lis.lis_matrix_create()
    lis.lis_matrix_set_size(A, 0, 16)
    lis.lis_matrix_set_vbr(s.nnz, nr, nr, len(bindex), part, part,
                           np.asarray(vptr), np.asarray(bptr),
                           np.asarray(bindex), value, A)
    lis.lis_matrix_set_type(A, lis.LIS_MATRIX_VBR)
    lis.lis_matrix_assemble(A)
    assert tuple(A.m.row_part) == tuple(int(t) for t in part)
    np.testing.assert_allclose(np.asarray(A.m.to_dense()), s.toarray(),
                               rtol=1e-14)


def test_vbr_block_ilu_large_block_padded_path():
    """A VBR partition with a block wider than 64 routes D^-1 through the
    padded gather/einsum apply instead of 2*mb-1 DIA streams; results
    must match the dense solve at full fill and stay adjoint-consistent."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from lis_tpu.matrix.vbr import VBRMatrix
    from lis_tpu.precon.ilu import create_iluk
    from lis_tpu.runtime.options import SolverOptions

    n = 100
    rng = np.random.default_rng(7)
    dense = np.where(rng.random((n, n)) < 0.05,
                     rng.standard_normal((n, n)), 0.0) + 20.0 * np.eye(n)
    s = sp.csr_matrix(dense)
    part = (0, 80, 90, 100)                   # one 80-wide block
    m = VBRMatrix.from_csr_arrays(s.indptr, s.indices, s.data, s.shape,
                                  row_part=part, col_part=part)
    pc = create_iluk(m, SolverOptions(ilu_fill=3))
    assert pc.pbinv is not None               # padded path engaged
    r = rng.standard_normal(n)
    x = np.asarray(pc.psolve(jnp.asarray(r)))
    np.testing.assert_allclose(x, np.linalg.solve(dense, r), rtol=1e-8,
                               atol=1e-8)
    u, v = rng.standard_normal(n), rng.standard_normal(n)
    lhs = float(np.asarray(pc.psolve(jnp.asarray(u))) @ v)
    rhs = float(u @ np.asarray(pc.psolveh(jnp.asarray(v))))
    assert abs(lhs - rhs) < 1e-9 * max(abs(lhs), 1.0)


def test_is_with_stationary_solvers_converges():
    """-p is with the stationary solvers: the reference's I+S-stationary
    branch SEGFAULTS in its own build (lsolve testmat.mtx 1 -i jacobi -p
    is crashes in lis_precon_create_is_csr); here the combination
    converges to the true solution."""
    import lis_tpu
    a = lis_tpu.read_matrix_market("/root/reference/test/testmat.mtx")
    b = np.ones(a.nrows)
    for s, cap in (("jacobi", 600), ("gs", 400), ("sor", 2000)):
        r = solve(a, b, options=f"-i {s} -p is -tol 1e-10 -maxiter 3000")
        assert r.status == lis_tpu.LIS_SUCCESS, (s, r)
        assert float(r.true_resid) < 1e-9
        assert r.iters <= cap, (s, r.iters)


def test_hybrid_inner_preconditioner():
    """-hybrid_p passes a preconditioner to the INNER solve
    (lis_precon_hybrid.c:89 forwards LIS_OPTIONS_PPRECON): the
    preconditioned inner iteration converges in no more outer
    iterations, and BiCG exercises the adjoint inner apply."""
    a = poisson2d(14, 14)
    b = np.ones(a.nrows)
    base = solve(a, b, options="-i gmres -p hybrid -hybrid_i gmres "
                               "-hybrid_maxiter 6 -tol 1e-10")
    pre = solve(a, b, options="-i gmres -p hybrid -hybrid_i gmres "
                              "-hybrid_maxiter 6 -hybrid_p ssor -tol 1e-10")
    assert pre.status == lis_tpu.LIS_SUCCESS
    assert pre.iters <= base.iters, (pre.iters, base.iters)
    rb = solve(a, b, options="-i bicg -p hybrid -hybrid_i cg "
                             "-hybrid_maxiter 6 -hybrid_p jacobi -tol 1e-10")
    assert rb.status == lis_tpu.LIS_SUCCESS
    assert _resid(a, b, rb.x) < 1e-8


def test_is_level_zero_disables_apply():
    """-is_level 0 turns the I+S apply off (reference routes psolve to
    none, lis_precon_is.c:100 — its build segfaults there, ours runs):
    iteration counts equal plain Jacobi-scaled BiCGSTAB."""
    import lis_tpu
    a = lis_tpu.read_matrix_market("/root/reference/test/testmat.mtx")
    b = np.ones(a.nrows)
    off = solve(a, b, options="-i bicgstab -p is -is_level 0 -tol 1e-12")
    plain = solve(a, b, options="-i bicgstab -scale 1 -tol 1e-12")
    assert off.status == lis_tpu.LIS_SUCCESS
    assert off.iters == plain.iters, (off.iters, plain.iters)
