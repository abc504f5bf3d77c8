"""Distributed (8-virtual-device mesh) solver tests.

The parity model mirrors the reference's test.sh multi-rank runs
(mpirun -np 2, SURVEY.md §4): the distributed path must reproduce the
single-device convergence behavior — same iteration counts, same residual
levels — because the math is identical and only the reductions are
communicated.
"""

import numpy as np
import pytest
import jax

import lis_tpu
from lis_tpu import solve
from lis_tpu.parallel.mesh import make_mesh
from lis_tpu.parallel.dist import distribute_csr, dist_solve, distribute_vector
from tests.problems import poisson2d, tridiag


_TEST_COUNT = [0]


@pytest.fixture(autouse=True)
def _bound_compile_accumulation():
    """This module alone compiles ~60 shard_map programs; past ~50 live
    executables in one process the XLA CPU backend segfaults inside
    backend_compile_and_load (same failure the session-wide per-module
    clear in conftest.py bounds).  Clear the jit caches every 12 tests
    so the live-executable count stays well under the crash threshold —
    costs recompiles, buys a suite that finishes."""
    yield
    _TEST_COUNT[0] += 1
    if _TEST_COUNT[0] % 12 == 0:
        jax.clear_caches()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh()


@pytest.fixture(scope="module")
def prob():
    a = poisson2d(20, 20)
    b = np.ones(400)
    return a, b, a.to_dense()


def _tr(ad, b, x):
    x = np.asarray(x)[: ad.shape[0]]
    return np.linalg.norm(b - ad @ x) / np.linalg.norm(b)


def test_dist_matvec_matches_single(mesh, prob):
    a, b, ad = prob
    Ad = distribute_csr(a, mesh)
    x = np.random.default_rng(0).standard_normal(400)
    xd = distribute_vector(x, mesh, Ad.gn_pad)
    from lis_tpu.parallel.dist import _shard_map
    from jax.sharding import PartitionSpec as P
    from lis_tpu.parallel.mesh import AXIS
    f = _shard_map(lambda A, xv: A.matvec(xv), mesh,
                   (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    y = np.asarray(jax.jit(f)(Ad, xd))[:400]
    np.testing.assert_allclose(y, ad @ x, rtol=1e-12, atol=1e-12)
    # transpose path (lis_reduce analogue)
    fh = _shard_map(lambda A, xv: A.matvech(xv), mesh,
                    (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    yh = np.asarray(jax.jit(fh)(Ad, xd))[:400]
    np.testing.assert_allclose(yh, ad.T @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("solver", ["cg", "bicg", "bicgstab", "gmres",
                                    "idrs", "minres"])
def test_dist_solver_matches_single_device_iters(mesh, prob, solver):
    a, b, ad = prob
    single = solve(a, b, options=f"-i {solver} -tol 1e-10")
    Ad = distribute_csr(a, mesh)
    dist = dist_solve(Ad, b, mesh, options=f"-i {solver} -tol 1e-10")
    assert dist.status == lis_tpu.LIS_SUCCESS
    assert _tr(ad, b, dist.x) < 1e-8
    assert abs(dist.iters - single.iters) <= 2, (solver, dist.iters,
                                                 single.iters)
    # true residual computed on-mesh (lis_solver.c:910-924 analogue):
    # finite, matches the host-side recomputation, within 10x single-chip
    assert np.isfinite(dist.true_resid)
    np.testing.assert_allclose(dist.true_resid, _tr(ad, b, dist.x),
                               rtol=1e-6, atol=1e-14)
    assert dist.true_resid <= max(10 * single.true_resid, 1e-9)


def test_dist_halo_modes_agree(mesh, prob):
    a, b, ad = prob
    for halo in ("gather", "neighbor"):
        Ad = distribute_csr(a, mesh, halo=halo)
        res = dist_solve(Ad, b, mesh, options="-i cg -tol 1e-10")
        assert res.status == lis_tpu.LIS_SUCCESS, halo
        assert _tr(ad, b, res.x) < 1e-8, halo


def test_dist_jacobi_precon(mesh):
    a = tridiag(100, diag=3.0)
    b = np.arange(1.0, 101.0)
    Ad = distribute_csr(a, mesh)
    res = dist_solve(Ad, b, mesh, options="-i cg -p jacobi -tol 1e-10")
    assert res.status == lis_tpu.LIS_SUCCESS
    assert _tr(a.to_dense(), b, res.x) < 1e-8


def test_dist_nondivisible_size(mesh):
    # 173 rows over 8 shards: padding path
    a = tridiag(173)
    b = np.ones(173)
    Ad = distribute_csr(a, mesh)
    assert Ad.gn_pad == 8 * Ad.nlocal and Ad.gn == 173
    res = dist_solve(Ad, b, mesh, options="-i cg -tol 1e-10")
    assert res.status == lis_tpu.LIS_SUCCESS
    assert _tr(a.to_dense(), b, res.x) < 1e-8


@pytest.mark.parametrize("precon", ["ilu", "ssor"])
def test_dist_block_precon(mesh, prob, precon):
    """Block-Jacobi ILU/SSOR (the reference's MPI semantics): converges to
    the same solution, possibly in more iterations than single-chip."""
    a, b, ad = prob
    Ad = distribute_csr(a, mesh)
    res = dist_solve(Ad, b, mesh, options=f"-i cg -p {precon} -tol 1e-10")
    assert res.status == lis_tpu.LIS_SUCCESS
    assert _tr(ad, b, res.x) < 1e-9
    r0 = solve(a, b, options=f"-i cg -p {precon} -tol 1e-10")
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(r0.x),
                               rtol=0, atol=1e-7)


def test_dist_x_truncated_to_global_size(mesh):
    a = poisson2d(13, 7)           # 91 rows: not divisible by 8
    b = np.ones(91)
    Ad = distribute_csr(a, mesh)
    res = dist_solve(Ad, b, mesh, options="-i cg -tol 1e-10")
    assert res.x.shape == (91,)


def test_redistribute_roundtrip(mesh):
    from lis_tpu.parallel.dist import redistribute_csr, undistribute_csr
    a = poisson2d(11, 9)
    Ad = distribute_csr(a, mesh)
    a2 = undistribute_csr(Ad)
    pa, ia, va = a.to_csr_arrays()
    pb, ib, vb = a2.to_csr_arrays()
    assert np.array_equal(np.asarray(pa), np.asarray(pb))
    assert np.array_equal(np.asarray(ia), np.asarray(ib))
    np.testing.assert_allclose(np.asarray(va), np.asarray(vb))
    Ad2 = redistribute_csr(Ad, mesh, halo="gather")
    res = dist_solve(Ad2, np.ones(99), mesh, options="-i cg -tol 1e-10")
    assert res.status == lis_tpu.LIS_SUCCESS


def test_dist_dia_matvec_and_solve(mesh):
    """Sharded DIA (stream SpMV over ring halos — the stencil path):
    matvec/matvech match dense, solves match single-device."""
    from lis_tpu.parallel.dist import distribute_matrix, DistDIAMatrix
    from jax.sharding import PartitionSpec as P
    from lis_tpu.parallel.mesh import AXIS
    from lis_tpu.parallel.dist import _shard_map, distribute_vector
    a = poisson2d(13, 11)
    n = a.nrows
    ad = a.to_dense()
    Ad = distribute_matrix(a, mesh)
    assert isinstance(Ad, DistDIAMatrix)
    x = np.random.default_rng(1).standard_normal(n)
    xd = distribute_vector(x, mesh, Ad.gn_pad)
    f = _shard_map(lambda M, xv: M.matvec(xv), mesh,
                   (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    np.testing.assert_allclose(np.asarray(jax.jit(f)(Ad, xd))[:n], ad @ x,
                               atol=1e-12)
    fh = _shard_map(lambda M, xv: M.matvech(xv), mesh,
                    (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    np.testing.assert_allclose(np.asarray(jax.jit(fh)(Ad, xd))[:n], ad.T @ x,
                               atol=1e-12)
    b = np.ones(n)
    r = dist_solve(Ad, b, mesh, options="-i bicg -p ilu -tol 1e-10")
    assert r.status == lis_tpu.LIS_SUCCESS
    assert _tr(ad, b, r.x) < 1e-9


@pytest.mark.parametrize("prec,bound", [("single", 1e-5), ("df", 1e-9),
                                        ("switch_df", 1e-12)])
def test_dist_precision_modes(mesh, prec, bound):
    """Distributed -f single / df / switch_df over sharded DIA: limb pairs
    ride the ring halos, DD reductions psum through the compensated tree."""
    from lis_tpu.parallel.dist import distribute_matrix
    a = poisson2d(20, 20)
    xs = np.linspace(1, 2, 400)
    b = np.asarray(a.to_dense() @ xs)
    Ad = distribute_matrix(a, mesh)
    r = dist_solve(Ad, b, mesh, options=f"-i cg -p jacobi -tol 1e-10 -f {prec}")
    assert r.status == lis_tpu.LIS_SUCCESS
    assert np.abs(np.asarray(r.x) - xs).max() < bound
    assert np.isfinite(r.true_resid) and r.true_resid < 10 * bound


@pytest.mark.parametrize("sopt", ["-i gs", "-i sor -omega 1.5"])
def test_dist_stationary(mesh, prob, sopt):
    """Block-local GS/SOR sweeps per shard (more iterations than exact,
    same solution)."""
    a, b, ad = prob
    from lis_tpu.parallel.dist import distribute_matrix
    Ad = distribute_matrix(a, mesh)
    r = dist_solve(Ad, b, mesh, options=f"{sopt} -tol 1e-8 -maxiter 5000")
    assert r.status == lis_tpu.LIS_SUCCESS
    assert _tr(ad, b, r.x) < 1e-7


def test_dist_hybrid(mesh):
    """Quasi-banded operators distribute as HDI: DIA streams + gather-halo
    remainder; block-local precons work through the merged view."""
    import scipy.sparse as sp
    from lis_tpu.parallel.dist import distribute_matrix, DistHybridMatrix
    n = 400
    a = sp.csr_matrix(np.asarray(poisson2d(20, 20).to_dense())) \
        + sp.random(n, n, density=0.001, random_state=7)
    a = a.tocsr(); a.sort_indices()
    from lis_tpu.matrix.csr import CSRMatrix
    A = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    Ad = distribute_matrix(A, mesh)
    assert isinstance(Ad, DistHybridMatrix)
    b = np.asarray(a @ np.ones(n))
    r = dist_solve(Ad, b, mesh, options="-i bicgstab -p ilu -tol 1e-10")
    assert r.status == lis_tpu.LIS_SUCCESS
    assert np.abs(np.asarray(r.x) - 1).max() < 1e-7


@pytest.mark.parametrize("es", ["pi", "ii", "cg", "cr"])
def test_dist_esolve_matches_single_device(mesh, prob, es):
    """Distributed eigensolvers (lis_esolver.c:263 under MPI): same
    iteration counts and eigenvalues as single-device — the same compiled
    loops run inside shard_map with psum reductions."""
    from lis_tpu import esolve
    from lis_tpu.parallel import distribute_matrix, dist_esolve
    a, b, ad = prob
    Ad = distribute_matrix(a, mesh)
    s = esolve(a, options=f"-e {es} -etol 1e-8 -emaxiter 2000")
    d = dist_esolve(Ad, mesh, options=f"-e {es} -etol 1e-8 -emaxiter 2000")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert abs(d.evalue - s.evalue) < 1e-6 * max(abs(s.evalue), 1)
    assert abs(d.iters - s.iters) <= 2, (es, d.iters, s.iters)
    # eigenpair residual against the dense operator
    x = np.asarray(d.evector)
    x = x / np.linalg.norm(x)
    assert np.linalg.norm(ad @ x - d.evalue * x) < 1e-6


def test_dist_esolve_rqi_converges(mesh, prob):
    """RQI's moving near-singular shift amplifies reduction-order rounding,
    so iteration counts may differ across meshes (the reference accepts the
    same across serial/OMP/MPI); the eigenpair itself must still be tight."""
    from lis_tpu.parallel import distribute_matrix, dist_esolve
    a, b, ad = prob
    Ad = distribute_matrix(a, mesh)
    d = dist_esolve(Ad, mesh, options="-e rqi -etol 1e-8 -emaxiter 200")
    assert d.status == lis_tpu.LIS_SUCCESS
    x = np.asarray(d.evector)
    x = x / np.linalg.norm(x)
    assert np.linalg.norm(ad @ x - d.evalue * x) < 1e-6


def test_dist_esolve_shift_and_dia(mesh):
    """-shift on the sharded DIA fast path: II targets the eigenvalue
    nearest sigma."""
    from lis_tpu.parallel import distribute_matrix, dist_esolve, \
        DistDIAMatrix
    a = poisson2d(16, 16)
    ad = np.asarray(a.to_dense())
    evs = np.linalg.eigvalsh(ad)
    target = float(evs[0])                 # well-separated extreme pair
    Ad = distribute_matrix(a, mesh)
    assert isinstance(Ad, DistDIAMatrix)
    d = dist_esolve(Ad, mesh,
                    options=f"-e ii -shift {target - 0.01} -etol 1e-8")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert abs(d.evalue - target) < 1e-6


def test_dist_saamg_matches_single(mesh):
    """Distributed SA-AMG (vs lis_m_solver_AMGCG.F90's MPI hierarchy):
    sharded level 0 with block-local SGS + replicated coarse levels.
    Bar: within 2x single-chip iterations; it matches exactly on
    the Poisson family."""
    a = poisson2d(24, 24)
    b = np.ones(576)
    from lis_tpu.parallel.dist import distribute_matrix
    s = solve(a, b, options="-i cg -p saamg -tol 1e-10")
    Ad = distribute_matrix(a, mesh)
    d = dist_solve(Ad, b, mesh, options="-i cg -p saamg -tol 1e-10")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert d.iters <= 2 * s.iters, (d.iters, s.iters)
    assert _tr(a.to_dense(), b, d.x) < 1e-8
    assert np.isfinite(d.true_resid) and d.true_resid < 1e-8


def test_dist_saamg_sharded_hierarchy(mesh):
    """Coarse levels above the -saamg_shard_rows × ndev threshold are
    mesh-sharded row slabs (lis_m_data_structure_for_AMG.F90:36's
    distributed per-level data), not full per-device replicas: the mid
    level's operator slab holds ~nnz/ndev entries per device, and the
    solve still converges to the true solution."""
    from lis_tpu.parallel.dist import distribute_matrix
    from lis_tpu.parallel.dist_precon import make_dist_saamg
    from lis_tpu.runtime.options import SolverOptions
    a = poisson2d(48, 48)
    n = 48 * 48
    b = np.ones(n)
    Ad = distribute_matrix(a, mesh)
    opts = SolverOptions.from_string("-saamg_shard_rows 8")
    M = make_dist_saamg(Ad, mesh, opts)
    assert len(M.mids) >= 1                       # level 1 is sharded
    mid = M.mids[0]
    # per-device slab ≈ level nnz / ndev (padded to the max shard)
    ndev = mesh.shape["p"]
    total = mid.a_val.shape[0]
    assert mid.n > 8 * ndev
    assert total < 2 * mid.n * 12                 # sanity: bounded storage
    per_dev = total // ndev
    assert per_dev <= -(-total // ndev)           # evenly split leading axis
    s = solve(a, b, options="-i cg -p saamg -tol 1e-10")
    d = dist_solve(Ad, b, mesh,
                   options="-i cg -p saamg -tol 1e-10 -saamg_shard_rows 8")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert d.iters <= 2 * s.iters, (d.iters, s.iters)
    assert _tr(a.to_dense(), b, d.x) < 1e-8


@pytest.mark.parametrize("opt,maxfac", [
    ("-i bicgstab -p hybrid -hybrid_maxiter 10", 3),
    ("-i cg -p sainv -sainv_drop 0.02", 3),
    ("-i cg -p bjacobi", 2),
    ("-i cg -p ssor -adds true -adds_iter 1", 2),
])
def test_dist_precon_families(mesh, prob, opt, maxfac):
    """hybrid (global inner solve over the mesh), block-Jacobi SAINV,
    bjacobi, and additive Schwarz with the distributed residual matvec."""
    a, b, ad = prob
    from lis_tpu.parallel.dist import distribute_matrix
    s = solve(a, b, options=f"{opt} -tol 1e-10")
    Ad = distribute_matrix(a, mesh)
    d = dist_solve(Ad, b, mesh, options=f"{opt} -tol 1e-10")
    assert d.status == lis_tpu.LIS_SUCCESS, (opt, d)
    assert _tr(ad, b, d.x) < 1e-8
    assert d.iters <= maxfac * max(s.iters, 1), (opt, d.iters, s.iters)


def test_dist_is_precon(mesh):
    """Block-Jacobi I+S on a diagonally dominant operator (its intended
    regime): bit-exact block apply, converging solve."""
    a = tridiag(120, diag=4.0)
    b = np.arange(1.0, 121.0)
    from lis_tpu.parallel.dist import distribute_matrix
    Ad = distribute_matrix(a, mesh)
    d = dist_solve(Ad, b, mesh, options="-i bicgstab -p is -tol 1e-10")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert _tr(a.to_dense(), b, d.x) < 1e-8


@pytest.mark.parametrize("es", ["li", "ai", "si"])
def test_dist_esolve_subspace(mesh, prob, es):
    """Distributed subspace eigensolvers (SI/LI/AI): the host-loop
    implementations run unchanged over GSPMD-sharded global vectors with
    the shard_map matvec — eigenvalues match single-device exactly."""
    from lis_tpu import esolve
    from lis_tpu.parallel import distribute_matrix, dist_esolve
    a, b, ad = prob
    Ad = distribute_matrix(a, mesh)
    s = esolve(a, options=f"-e {es} -ss 3 -etol 1e-8 -emaxiter 60")
    d = dist_esolve(Ad, mesh, options=f"-e {es} -ss 3 -etol 1e-8 -emaxiter 60")
    np.testing.assert_allclose(np.asarray(d.evalues), np.asarray(s.evalues),
                               rtol=1e-8)
    assert d.evectors.shape == (3, 400)
    assert d.status == s.status


def test_dist_bes_general_sparsity(mesh):
    """General (non-banded) matrices shard as BES slabs with ring window
    halos on request (distribute_slabs): exact matvec/matvech,
    block-precon solves, and the lis_reduce-style boundary return in
    matvech."""
    import scipy.sparse as sp
    from jax.sharding import PartitionSpec as P
    from lis_tpu.parallel.mesh import AXIS
    from lis_tpu.parallel.dist import (distribute_slabs, DistBESMatrix,
                                       _shard_map)
    from lis_tpu.matrix.csr import CSRMatrix
    rng = np.random.default_rng(3)
    n, K, bw = 1024, 10, 40
    rows = np.repeat(np.arange(n), K)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=n * K), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(n * K), (rows, cols)),
                      shape=(n, n)).tocsr()
    m = (m + sp.diags(np.abs(m).sum(axis=1).A1 + 1)).tocsr()
    m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape)
    Ad = distribute_slabs(A, mesh)
    assert isinstance(Ad, DistBESMatrix)
    x = rng.standard_normal(n)
    xd = distribute_vector(x, mesh, Ad.gn_pad)
    f = _shard_map(lambda M, xv: M.matvec(xv), mesh,
                   (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    np.testing.assert_allclose(np.asarray(jax.jit(f)(Ad, xd))[:n], m @ x,
                               atol=1e-10)
    fh = _shard_map(lambda M, xv: M.matvech(xv), mesh,
                    (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    np.testing.assert_allclose(np.asarray(jax.jit(fh)(Ad, xd))[:n], m.T @ x,
                               atol=1e-10)
    b = m @ np.ones(n)
    for opt in ("-i bicgstab -p jacobi", "-i bicgstab -p ilu"):
        r = dist_solve(Ad, b, mesh, options=f"{opt} -tol 1e-10")
        assert r.status == lis_tpu.LIS_SUCCESS, opt
        assert np.abs(np.asarray(r.x) - 1).max() < 1e-7


def test_dist_gesolve_pencil(mesh):
    """Distributed generalized eigensolve (Ax = λBx): pencil power
    iteration with nested distributed B-solves matches single-device
    iteration counts exactly."""
    from lis_tpu import gesolve
    from lis_tpu.parallel import distribute_matrix
    from lis_tpu.parallel.dist_esolve import dist_esolve
    a = poisson2d(16, 16)
    bm = tridiag(256, diag=4.0)
    s = gesolve(a, bm, options="-e gpi -etol 1e-8 -emaxiter 2000")
    Ad = distribute_matrix(a, mesh)
    Bd = distribute_matrix(bm, mesh)
    d = dist_esolve(Ad, mesh, options="-e gpi -etol 1e-8 -emaxiter 2000",
                    B=Bd)
    assert d.status == lis_tpu.LIS_SUCCESS
    assert abs(d.evalue - s.evalue) < 1e-6
    assert abs(d.iters - s.iters) <= 2


def test_dist_gesolve_all_compiled_families(mesh):
    """gii/grqi/gcg/gcr on the mesh (nested distributed B-solves /
    pencil Rayleigh-Ritz): iteration-identical to single-device
    (reference runs every G* family under MPI, lis_esolver.c:285)."""
    from lis_tpu import gesolve
    from lis_tpu.parallel import distribute_matrix
    from lis_tpu.parallel.dist_esolve import dist_esolve
    a = poisson2d(16, 16)
    bm = tridiag(256, diag=4.0)
    Ad = distribute_matrix(a, mesh)
    Bd = distribute_matrix(bm, mesh)
    for e in ("gii", "grqi", "gcg", "gcr"):
        s = gesolve(a, bm, options=f"-e {e} -etol 1e-8 -emaxiter 2000")
        d = dist_esolve(Ad, mesh,
                        options=f"-e {e} -etol 1e-8 -emaxiter 2000", B=Bd)
        assert d.status == lis_tpu.LIS_SUCCESS, e
        assert d.iters == s.iters, (e, d.iters, s.iters)
        assert abs(d.evalue - s.evalue) < 1e-8, e


def test_dist_gesolve_subspace_families(mesh):
    """Generalized subspace families (gli/gai/gsi) through the
    GlobalView adapter with operator-only pencil B-solves."""
    from lis_tpu import gesolve
    from lis_tpu.parallel import distribute_matrix
    from lis_tpu.parallel.dist_esolve import dist_esolve
    a = poisson2d(16, 16)
    bm = tridiag(256, diag=4.0)
    Ad = distribute_matrix(a, mesh)
    Bd = distribute_matrix(bm, mesh)
    for e in ("gli", "gai"):
        s = gesolve(a, bm, options=f"-e {e} -etol 1e-8 -emaxiter 300 -ss 2")
        d = dist_esolve(Ad, mesh, B=Bd,
                        options=f"-e {e} -etol 1e-8 -emaxiter 300 -ss 2")
        assert d.status == lis_tpu.LIS_SUCCESS, e
        assert d.iters == s.iters, e
        np.testing.assert_allclose(d.evalues, s.evalues, rtol=1e-7)
    s = gesolve(a, bm, options="-e gsi -etol 1e-8 -emaxiter 300")
    d = dist_esolve(Ad, mesh, B=Bd,
                    options="-e gsi -etol 1e-8 -emaxiter 300")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert d.iters == s.iters
    assert abs(d.evalue - s.evalue) < 1e-8


def test_dist_bes_extended_precision(mesh):
    """-f df / switch_df over a BES-sharded general matrix: the slab
    product accumulates in emulated f64 and splits back to the limb pair
    (DistBESDDOperator); switch_df reaches beyond-f32 true residuals."""
    import scipy.sparse as sp
    from lis_tpu.parallel.dist import distribute_slabs, DistBESMatrix
    from lis_tpu.matrix.csr import CSRMatrix
    rng = np.random.default_rng(3)
    n, K, bw = 1024, 10, 40
    rows = np.repeat(np.arange(n), K)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=n * K), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(n * K), (rows, cols)),
                      shape=(n, n)).tocsr()
    m = (m + sp.diags(np.abs(m).sum(axis=1).A1 + 1)).tocsr()
    m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape)
    Ad = distribute_slabs(A, mesh)
    assert isinstance(Ad, DistBESMatrix)
    xs = np.linspace(1, 2, n)
    b = m @ xs
    for f, bound in (("df", 1e-5), ("switch_df", 1e-10)):
        r = dist_solve(Ad, b, mesh,
                       options=f"-i bicgstab -p jacobi -tol 1e-12 -f {f} "
                               "-maxiter 3000")
        assert r.status == lis_tpu.LIS_SUCCESS, f
        assert np.abs(np.asarray(r.x) - xs).max() < bound, f


def test_dist_esolve_over_bes(mesh):
    """dist_esolve runs unchanged over BES-sharded general matrices (the
    slab leaves shard on axis 0): power iteration matches single-device
    exactly."""
    import scipy.sparse as sp
    from lis_tpu import esolve
    from lis_tpu.parallel.dist import distribute_slabs
    from lis_tpu.parallel.dist import DistBESMatrix
    from lis_tpu.parallel.dist_esolve import dist_esolve
    from lis_tpu.matrix.csr import CSRMatrix
    rng = np.random.default_rng(3)
    n, K, bw = 1024, 10, 40
    rows = np.repeat(np.arange(n), K)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=n * K), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(n * K), (rows, cols)),
                      shape=(n, n)).tocsr()
    m = (m + m.T + sp.diags(np.abs(m).sum(axis=1).A1 * 2 + 1)).tocsr()
    m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape)
    Ad = distribute_slabs(A, mesh)
    assert isinstance(Ad, DistBESMatrix)
    s = esolve(A, options="-e pi -etol 1e-7 -emaxiter 500")
    d = dist_esolve(Ad, mesh, options="-e pi -etol 1e-7 -emaxiter 500")
    assert abs(d.evalue - s.evalue) < 1e-6
    assert d.iters == s.iters


@pytest.mark.parametrize("opt", ["-i bicgstab -scale 1", "-i cg -scale 2",
                                 "-i cg -p jacobi -scale 1",
                                 "-i bicgstab -p is"])
def test_dist_scaling_modes(mesh, opt):
    """-scale 1/2 under dist_solve (lis_solve_kernel :613-721 under MPI):
    same iteration counts as single-chip, true residual on the UNSCALED
    system, x unscaled on return; includes the CG+jacobi symm upgrade
    and the forced Jacobi scaling for -p is."""
    from lis_tpu.parallel.dist import distribute_matrix
    a = poisson2d(20, 20)
    n = 400
    xs = np.linspace(1, 2, n)
    b = np.asarray(a.to_dense()) @ xs
    s = solve(a, b, options=f"{opt} -tol 1e-10")
    Ad = distribute_matrix(a, mesh)
    d = dist_solve(Ad, b, mesh, options=f"{opt} -tol 1e-10")
    assert d.status == lis_tpu.LIS_SUCCESS
    # -p is applies block-Jacobi truncated-U distributed (the reference's
    # MPI semantics) so its counts drift a little; pure scaling rows match
    band = 8 if "-p is" in opt else 2
    assert abs(d.iters - s.iters) <= band, (opt, d.iters, s.iters)
    assert np.abs(np.asarray(d.x) - xs).max() < 1e-7
    assert np.isfinite(d.true_resid) and d.true_resid < 1e-8


def test_dist_multibes_two_bands(mesh):
    """Multi-band general matrices shard as DistMultiBESMatrix: one
    sharded slab per affine band with SHIFTED ring window fetches (a band
    at +5000 reads 5 shards away), remainder on the gather path; exact
    matvec/matvech and preconditioned solves."""
    import scipy.sparse as sp
    from jax.sharding import PartitionSpec as P
    from lis_tpu.parallel.mesh import AXIS
    from lis_tpu.parallel.dist import (distribute_slabs,
                                       DistMultiBESMatrix, _shard_map)
    from lis_tpu.matrix.csr import CSRMatrix
    rng = np.random.default_rng(7)
    n = 8000
    rows = np.repeat(np.arange(n), 8)
    off = np.where(rng.random(n * 8) < 0.5,
                   rng.integers(-40, 41, size=n * 8),
                   5000 + rng.integers(-40, 41, size=n * 8))
    cols = np.clip(rows + off, 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(n * 8), (rows, cols)),
                      shape=(n, n)).tocsr()
    m = (m + sp.diags(np.abs(m).sum(axis=1).A1 + 1)).tocsr()
    m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape)
    Ad = distribute_slabs(A, mesh)
    assert isinstance(Ad, DistMultiBESMatrix)
    x = rng.standard_normal(n)
    xd = distribute_vector(x, mesh, Ad.gn_pad)
    f = _shard_map(lambda M, xv: M.matvec(xv), mesh,
                   (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    np.testing.assert_allclose(np.asarray(jax.jit(f)(Ad, xd))[:n], m @ x,
                               atol=1e-9)
    fh = _shard_map(lambda M, xv: M.matvech(xv), mesh,
                    (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    np.testing.assert_allclose(np.asarray(jax.jit(fh)(Ad, xd))[:n],
                               m.T @ x, atol=1e-9)
    xs = np.linspace(1, 2, n)
    for opt in ("-i bicgstab -p jacobi", "-i bicgstab -p ilu"):
        r = dist_solve(Ad, m @ xs, mesh, options=f"{opt} -tol 1e-10")
        assert r.status == lis_tpu.LIS_SUCCESS, opt
        assert np.abs(np.asarray(r.x) - xs).max() < 1e-7


def test_dist_multibes_extended_precision(mesh):
    """switch_df over a multi-band-sharded matrix: the whole sharded
    pytree lifts to emulated f64 and the formats' own matvecs run inside
    the DD solver (beyond-double true residuals on 8 devices)."""
    import scipy.sparse as sp
    from lis_tpu.parallel.dist import distribute_slabs, DistMultiBESMatrix
    from lis_tpu.matrix.csr import CSRMatrix
    rng = np.random.default_rng(7)
    n = 8000
    rows = np.repeat(np.arange(n), 8)
    off = np.where(rng.random(n * 8) < 0.5,
                   rng.integers(-40, 41, size=n * 8),
                   5000 + rng.integers(-40, 41, size=n * 8))
    cols = np.clip(rows + off, 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(n * 8), (rows, cols)),
                      shape=(n, n)).tocsr()
    m = (m + sp.diags(np.abs(m).sum(axis=1).A1 + 1)).tocsr()
    m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape)
    Ad = distribute_slabs(A, mesh)
    assert isinstance(Ad, DistMultiBESMatrix)
    xs = np.linspace(1, 2, n)
    r = dist_solve(Ad, m @ xs, mesh,
                   options="-i bicgstab -p jacobi -tol 1e-12 -f switch_df "
                           "-maxiter 4000")
    assert r.status == lis_tpu.LIS_SUCCESS
    assert np.abs(np.asarray(r.x) - xs).max() < 1e-10


def test_dist_table_halo(mesh):
    """Comm-table halo plan (lis_commtable_create/lis_send_recv analogue,
    src/matrix/lis_matrix_mpi.c:594-955): general sparsity distributes
    with per-device comm volume proportional to boundary nnz, not gn;
    matvec/matvech/diagonal exact, solves converge."""
    import scipy.sparse as sp
    from jax.sharding import PartitionSpec as P
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.parallel.mesh import AXIS
    from lis_tpu.parallel.dist import (DistTableCSRMatrix, distribute_csr,
                                       distribute_vector, undistribute_csr,
                                       _shard_map)
    rng = np.random.default_rng(3)
    n = 1200
    m = (sp.random(n, n, density=0.008, random_state=rng)
         + 20 * sp.eye(n)).tocsr()
    m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape)
    Ad = distribute_csr(A, mesh)          # auto -> table for non-banded
    assert isinstance(Ad, DistTableCSRMatrix)
    assert Ad.comm_elems < Ad.gn_pad      # boundary < whole vector
    x = np.linspace(0.0, 1.0, n)          # catches permutation bugs
    xd = distribute_vector(x, mesh, Ad.gn_pad)
    f = _shard_map(lambda M, xv: M.matvec(xv), mesh,
                   (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    np.testing.assert_allclose(np.asarray(jax.jit(f)(Ad, xd))[:n], m @ x,
                               atol=1e-11)
    fh = _shard_map(lambda M, xv: M.matvech(xv), mesh,
                    (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS)), P(AXIS))
    np.testing.assert_allclose(np.asarray(jax.jit(fh)(Ad, xd))[:n], m.T @ x,
                               atol=1e-11)
    g = undistribute_csr(Ad)
    gp, gi, gv = g.to_csr_arrays()
    g2 = sp.csr_matrix((np.asarray(gv), np.asarray(gi), np.asarray(gp)),
                       shape=m.shape)
    assert abs(g2 - m).max() < 1e-14
    b = m @ np.ones(n)
    r = dist_solve(Ad, b, mesh, options="-i bicgstab -p ilu -tol 1e-10")
    assert r.status == lis_tpu.LIS_SUCCESS
    assert np.abs(np.asarray(r.x) - 1).max() < 1e-7


def test_dist_table_comm_proportional_to_boundary(mesh):
    """A mostly-local matrix with a few long-range couplings: the comm
    table moves a small fraction of gn per device (the gather fallback
    would move all of it)."""
    import scipy.sparse as sp
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.parallel.dist import DistTableCSRMatrix, distribute_csr
    rng = np.random.default_rng(5)
    a0 = poisson2d(40, 40)
    p0, i0, v0 = a0.to_csr_arrays()
    m = sp.csr_matrix((np.asarray(v0), np.asarray(i0), np.asarray(p0)),
                      shape=a0.shape)
    r, c = rng.integers(0, 1600, 50), rng.integers(0, 1600, 50)
    m = (m + sp.coo_matrix((np.full(50, 0.01), (r, c)), shape=m.shape)
         + sp.coo_matrix((np.full(50, 0.01), (c, r)), shape=m.shape)).tocsr()
    m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape)
    Ad = distribute_csr(A, mesh)
    assert isinstance(Ad, DistTableCSRMatrix)
    assert Ad.comm_elems < 0.15 * Ad.gn_pad, (Ad.comm_elems, Ad.gn_pad)
    b = m @ np.ones(1600)
    r2 = dist_solve(Ad, b, mesh, options="-i bicgstab -tol 1e-10")
    assert r2.status == lis_tpu.LIS_SUCCESS
    assert np.abs(np.asarray(r2.x) - 1).max() < 1e-6


def test_dist_complex_solve_matches_single(mesh):
    """Complex operands ride the same sharded machinery (the distributed
    analogue of the reference's --enable-complex + MPI build):
    iteration-identical to single-device, complex dtype preserved."""
    import scipy.sparse as sp
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.parallel.dist import distribute_matrix
    n = 512
    a = sp.diags([-(1 + 0.5j), 4 + 1j, -(1 - 0.25j)], [-1, 0, 1],
                 shape=(n, n), format="csr")
    m = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    rng = np.random.RandomState(1)
    b = rng.randn(n) + 1j * rng.randn(n)
    r1 = solve(m, b, options="-i bicgstab -p jacobi -tol 1e-10")
    dm = distribute_matrix(m, mesh)
    r8 = dist_solve(dm, b, mesh, options="-i bicgstab -p jacobi -tol 1e-10")
    assert r8.status == lis_tpu.LIS_SUCCESS
    assert r8.iters == r1.iters
    x8 = np.asarray(r8.x)[:n]
    assert np.iscomplexobj(x8)
    assert np.linalg.norm(a @ x8 - b) / np.linalg.norm(b) < 1e-9


def test_dist_block_ilu_storage_bsr(mesh, prob):
    """'-p ilu -storage bsr' under dist_solve runs the per-shard BLOCK
    factorization (the reference's per-rank BSR conversion +
    lis_precon_iluk.c:1289 under MPI): it must converge to the true
    solution, engage a BlockILUPrecon, and differ from the scalar local
    ILU only in iteration count, not in the answer."""
    import warnings
    from lis_tpu.parallel.dist import distribute_matrix, dist_solve
    from lis_tpu.parallel.dist_precon import make_dist_block_precon
    from lis_tpu.precon.ilu import BlockILUPrecon
    from lis_tpu.runtime.options import SolverOptions
    a, b, ad = prob
    Ad = distribute_matrix(a, mesh)
    M = make_dist_block_precon(Ad, mesh,
                               SolverOptions(precon="ilu", storage=7,
                                             storage_block=2))
    assert isinstance(M, BlockILUPrecon)
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # must NOT warn for this combo
        d = dist_solve(Ad, b, mesh,
                       options="-i bicgstab -p ilu -storage bsr "
                               "-storage_block 2 -tol 1e-10")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert _tr(ad, b, d.x) < 1e-8
    ds = dist_solve(Ad, b, mesh, options="-i bicgstab -p ilu -tol 1e-10")
    assert abs(d.iters - ds.iters) <= max(3, ds.iters // 2)


def test_dist_block_scale_storage_bsr(mesh, prob):
    """'-scale 1 -storage bsr' under dist_solve runs the reference's MPI
    block-Jacobi scaling branch (lis_solve_kernel :659-691): same
    iteration counts as the single-device block-scale path, no -storage
    warning, true solution recovered."""
    import warnings
    from lis_tpu.parallel.dist import distribute_matrix, dist_solve
    a, b, ad = prob
    Ad = distribute_matrix(a, mesh)
    s = solve(a, b, options="-i bicgstab -scale 1 -storage bsr "
                            "-storage_block 2 -tol 1e-10")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d = dist_solve(Ad, b, mesh,
                       options="-i bicgstab -scale 1 -storage bsr "
                               "-storage_block 2 -tol 1e-10")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert abs(d.iters - s.iters) <= 2, (d.iters, s.iters)
    assert _tr(ad, b, d.x) < 1e-8


def test_dist_scale2_padded_global_size(mesh):
    """-scale 2 when gn doesn't divide the mesh (padded shards): the
    symmetric-scale unscale vector must treat padding rows as identity —
    a zero pad made x0/dscale produce 0/0 = nan and poisoned every psum
    (gn=324 on 8 devices)."""
    from lis_tpu.parallel.dist import distribute_matrix, dist_solve
    a = poisson2d(18, 18)
    n = a.nrows
    assert n % 8 != 0                      # the padded case by construction
    xtrue = np.linspace(1, 2, n)
    b = np.asarray(a.to_dense()) @ xtrue
    Ad = distribute_matrix(a, mesh)
    d = dist_solve(Ad, b, mesh, options="-i cg -scale 2 -tol 1e-10")
    assert d.status == lis_tpu.LIS_SUCCESS
    assert np.abs(np.asarray(d.x)[:n] - xtrue).max() < 1e-7
    assert np.isfinite(d.true_resid) and d.true_resid < 1e-8


def test_dist_cst_locality_free(mesh):
    """DistCSTMatrix: comm-table halo + per-shard CST (gather- and
    scatter-free lane-shuffle SpMV, matrix/cst.py) — matvec/matvech match
    the dense product exactly, and dist_solve converges with the same
    iteration count as the single-device solve."""
    import scipy.sparse as sp
    from jax.sharding import PartitionSpec as P
    from lis_tpu.parallel.mesh import AXIS
    from lis_tpu.parallel.dist import (_shard_map, distribute_csr_cst,
                                       dist_solve, undistribute_csr)
    from lis_tpu.matrix.csr import CSRMatrix

    rng = np.random.default_rng(11)
    n, k = 960, 8
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + a.T + sp.eye(n) * (4 * k)).tocsr()    # SPD-ish, well posed
    a.sort_indices()
    A1 = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    Ad = distribute_csr_cst(A1, mesh)
    x = rng.standard_normal(n)
    xd = distribute_vector(x, mesh, Ad.gn_pad)
    spec = (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS))
    f = _shard_map(lambda A, xv: A.matvec(xv), mesh, spec, P(AXIS))
    y = np.asarray(jax.jit(f)(Ad, xd))[:n]
    np.testing.assert_allclose(y, a @ x, rtol=1e-11, atol=1e-11)
    fh = _shard_map(lambda A, xv: A.matvech(xv), mesh, spec, P(AXIS))
    yh = np.asarray(jax.jit(fh)(Ad, xd))[:n]
    np.testing.assert_allclose(yh, a.T @ x, rtol=1e-11, atol=1e-11)
    # round-trip through the host reconstruction
    g = undistribute_csr(Ad)
    gp, gi, gv = g.to_csr_arrays()
    back = sp.csr_matrix((np.asarray(gv), np.asarray(gi), np.asarray(gp)),
                         shape=a.shape)
    assert abs(back - a).max() < 1e-12
    # solve parity vs single device
    b = np.ones(n)
    r1 = lis_tpu.solve(A1, b, options="-i bicgstab -tol 1e-10 "
                                      "-auto_storage false")
    rd = dist_solve(Ad, b, mesh, options="-i bicgstab -tol 1e-10")
    assert rd.status == lis_tpu.LIS_SUCCESS
    assert abs(rd.iters - r1.iters) <= 1, (rd.iters, r1.iters)
    assert rd.true_resid < 1e-9


def test_dist_switch_df_table_general_sparsity(mesh):
    """-f switch_df over a table-sharded GENERAL matrix: hi+lo pairs ride
    the comm-table halo (the reference's _mp exchange variants,
    include/lis_mpi.h:45-46) — true residual below 1e-12 where plain
    double stalls near its roundoff."""
    import scipy.sparse as sp
    from lis_tpu.parallel.dist import distribute_csr, dist_solve

    rng = np.random.default_rng(3)
    n, k = 480, 6
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + a.T + sp.eye(n) * (4 * k)).tocsr()
    a.sort_indices()
    from lis_tpu.matrix.csr import CSRMatrix
    A1 = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    Ad = distribute_csr(A1, mesh, halo="table")
    assert Ad.halo == "table" and Ad.G > 0
    b = np.ones(n)
    r = dist_solve(Ad, b, mesh,
                   options="-i bicgstab -f switch_df -tol 1e-13 "
                           "-maxiter 500")
    assert r.status == lis_tpu.LIS_SUCCESS
    assert r.true_resid < 1e-12, r.true_resid
    # BiCG exercises matvech (the DD lis_reduce ghost-partial return)
    r2 = dist_solve(Ad, b, mesh,
                    options="-i bicg -f switch_df -tol 1e-13 -maxiter 500")
    assert r2.status == lis_tpu.LIS_SUCCESS
    assert r2.true_resid < 1e-12, r2.true_resid
