"""Format construction, conversion round-trips, and SpMV correctness.

The reference has no per-kernel unit tests; SURVEY.md §4 prescribes adding
them: every format's matvec/matvech is checked against the dense product,
and every conversion must round-trip through CSR.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from lis_tpu.matrix.convert import convert_matrix
from lis_tpu.matrix.base import _MATRIX_REGISTRY
from tests.problems import poisson2d, random_sparse, tridiag

FORMATS = ["csr", "csc", "msr", "dia", "ell", "jad", "bsr", "bsc", "vbr",
           "coo", "dns", "bes", "css", "cst"]


@pytest.fixture(scope="module")
def prob():
    a = random_sparse(37, density=0.15, seed=3)
    dense = a.to_dense()
    x = np.random.default_rng(7).standard_normal(37)
    return a, dense, x


@pytest.mark.parametrize("fmt", FORMATS)
def test_matvec_matches_dense(prob, fmt):
    a, dense, x = prob
    m = convert_matrix(a, fmt)
    y = np.asarray(m.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fmt", FORMATS)
def test_matvech_matches_dense(prob, fmt):
    a, dense, x = prob
    m = convert_matrix(a, fmt)
    y = np.asarray(m.matvech(jnp.asarray(x)))
    np.testing.assert_allclose(y, dense.T @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fmt", FORMATS)
def test_conversion_roundtrip(prob, fmt):
    a, dense, x = prob
    m = convert_matrix(a, fmt)
    back = convert_matrix(m, "csr")
    np.testing.assert_allclose(back.to_dense(), dense, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("fmt", FORMATS)
def test_stencil_matrix(fmt):
    a = poisson2d(6, 5)
    dense = a.to_dense()
    x = np.arange(30, dtype=float)
    m = convert_matrix(a, fmt)
    np.testing.assert_allclose(np.asarray(m.matvec(jnp.asarray(x))),
                               dense @ x, rtol=1e-13, atol=1e-13)


def test_nonsquare_matvec():
    rng = np.random.default_rng(0)
    dense = np.where(rng.random((9, 13)) < 0.3, rng.standard_normal((9, 13)), 0.0)
    from lis_tpu.matrix.csr import CSRMatrix
    a = CSRMatrix.from_dense(dense)
    x = rng.standard_normal(13)
    y = rng.standard_normal(9)
    np.testing.assert_allclose(np.asarray(a.matvec(jnp.asarray(x))), dense @ x,
                               rtol=1e-13)
    np.testing.assert_allclose(np.asarray(a.matvech(jnp.asarray(y))),
                               dense.T @ y, rtol=1e-13)


def test_get_diagonal_and_split():
    a = tridiag(11)
    d = np.asarray(a.get_diagonal())
    np.testing.assert_allclose(d, np.full(11, 2.0))
    from lis_tpu.matrix.split import split_matrix
    s = split_matrix(a)
    dense = a.to_dense()
    np.testing.assert_allclose(s.L.to_dense(), np.tril(dense, -1))
    np.testing.assert_allclose(s.U.to_dense(), np.triu(dense, 1))
    np.testing.assert_allclose(np.asarray(s.D), np.diag(dense))


def test_assembler_set_value():
    from lis_tpu.matrix.assembly import MatrixAssembler, LIS_ADD_VALUE, LIS_INS_VALUE
    asm = MatrixAssembler((4, 4))
    for i in range(4):
        asm.set_value(LIS_INS_VALUE, i, i, 2.0)
    asm.set_value(LIS_ADD_VALUE, 0, 0, 1.0)     # accumulate
    asm.set_value(LIS_INS_VALUE, 1, 1, 5.0)     # overwrite
    asm.set_value(LIS_INS_VALUE, 2, 3, -1.0)
    a = asm.assemble("csr")
    dense = a.to_dense()
    assert dense[0, 0] == 3.0
    assert dense[1, 1] == 5.0
    assert dense[2, 3] == -1.0


def test_registry_covers_all_lis_formats():
    for fmt in FORMATS:
        assert fmt in _MATRIX_REGISTRY


def test_hybrid_hdi_format():
    """HDI (dominant diagonals + CSR remainder — an extension): exact
    matvec/matvech, auto-routing for quasi-banded operators."""
    import scipy.sparse as sp
    from lis_tpu.matrix.hybrid import HybridMatrix
    from lis_tpu.solvers.driver import auto_storage
    from tests.problems import poisson2d
    n = 400
    a = sp.csr_matrix(np.asarray(poisson2d(20, 20).to_dense())) \
        + sp.random(n, n, density=0.0015, random_state=7)
    a = a.tocsr(); a.sort_indices()
    H = HybridMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    assert H is not None and len(H.rem.value) < 0.25 * a.nnz
    x = np.random.default_rng(2).standard_normal(n)
    np.testing.assert_allclose(np.asarray(H.matvec(x)), a @ x, atol=1e-12)
    np.testing.assert_allclose(np.asarray(H.matvech(x)), a.T @ x, atol=1e-12)
    # csr round trip preserves the matrix
    p2, i2, v2 = H.to_csr_arrays()
    a2 = sp.csr_matrix((np.asarray(v2), np.asarray(i2), np.asarray(p2)),
                       shape=a.shape)
    assert abs(a2 - a).max() < 1e-14
    # general sparsity goes to CSS when its chunk grid is dense enough
    # to beat CSR at the measured rates (driver._css_wins): a fully
    # random matrix packs its single column chunk at fill ~1
    from lis_tpu.matrix.csr import CSRMatrix
    r = sp.random(100, 100, density=0.2, random_state=1).tocsr()
    r.sort_indices()
    R = CSRMatrix.from_csr_arrays(r.indptr, r.indices, r.data, r.shape)
    assert auto_storage(R).format_name == "css"
    big = sp.random(3000, 3000, density=0.001, random_state=2).tocsr()
    big = big + sp.eye(3000, format="csr")
    big = big.tocsr(); big.sort_indices()
    Rb = CSRMatrix.from_csr_arrays(big.indptr, big.indices, big.data,
                                   big.shape)
    # locality-free sparsity (no band): CSS, measured faster than CSR
    assert auto_storage(Rb).format_name == "css"


def test_poisson3d27_dia_generator():
    """Direct-DIA stencil construction matches the COO/CSR path."""
    from lis_tpu.utils.testmat import poisson3d27, poisson3d27_dia
    A = poisson3d27(5, 4, 3)
    D = poisson3d27_dia(5, 4, 3)
    np.testing.assert_allclose(np.asarray(D.to_dense()),
                               np.asarray(A.to_dense()))


def test_bes_general_sparsity_and_rcm():
    """BES dense sliding slabs (the general-sparsity fast path): exact
    matvec/matvech on a scrambled (unstructured) operator, RCM recovers
    the bandwidth, and the -reorder rcm solve matches the plain solve."""
    import scipy.sparse as sp
    import lis_tpu
    from lis_tpu import solve
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.matrix.reorder import (rcm_permutation, permute_symmetric,
                                        bandwidth)
    a = poisson2d(20, 20)
    n = 400
    ad = np.asarray(a.to_dense())
    rng = np.random.default_rng(5)
    perm = rng.permutation(n)
    ap = sp.csr_matrix(ad)[perm][:, perm].tocsr()
    Ap = CSRMatrix.from_csr_arrays(ap.indptr, ap.indices, ap.data, (n, n))

    pr = rcm_permutation(Ap)
    Ar = permute_symmetric(Ap, pr)
    assert bandwidth(Ar) < bandwidth(Ap) / 3

    B = convert_matrix(Ar, "bes")
    x = rng.standard_normal(n)
    adr = np.asarray(Ar.to_dense())
    np.testing.assert_allclose(np.asarray(B.matvec(jnp.asarray(x))),
                               adr @ x, atol=1e-12)
    np.testing.assert_allclose(np.asarray(B.matvech(jnp.asarray(x))),
                               adr.T @ x, atol=1e-12)

    b = ap @ np.ones(n)
    r0 = solve(Ap, b, options="-i bicgstab -tol 1e-10")
    r1 = solve(Ap, b, options="-i bicgstab -tol 1e-10 -reorder rcm")
    assert r1.status == lis_tpu.LIS_SUCCESS
    assert np.abs(np.asarray(r1.x) - 1.0).max() < 1e-7
    # solution comes back in the ORIGINAL ordering
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x), atol=1e-6)


def test_bes_auto_storage_routing():
    """auto_storage falls through DIA/HDI for a banded-ish matrix with
    many distinct offsets.  BES can hold it, but BES never beat CSS on
    the card, so the router picks CSS (or CSR) — never BES."""
    import scipy.sparse as sp
    from lis_tpu.solvers.driver import auto_storage
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.matrix.bes import BESMatrix
    rng = np.random.default_rng(9)
    n = 600
    # banded-ish random structure with many distinct offsets (not DIA-able)
    rows, cols = [], []
    for i in range(n):
        cs = np.unique(np.clip(i + rng.integers(-40, 41, size=12), 0, n - 1))
        rows.extend([i] * len(cs))
        cols.extend(cs)
    vals = rng.standard_normal(len(rows))
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    m = m + sp.diags(np.abs(m).sum(axis=1).A1 + 1)
    m = m.tocsr(); m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, (n, n))
    B = convert_matrix(A, "bes")
    assert isinstance(B, BESMatrix)
    routed = auto_storage(A)
    assert routed.format_name == "css", routed.format_name
    x = rng.standard_normal(n)
    for M in (B, routed):
        np.testing.assert_allclose(np.asarray(M.matvec(jnp.asarray(x))),
                                   m @ x, atol=1e-10)


def test_multibes_auto_routing_two_bands():
    """A general matrix with TWO affine column bands is representable as
    a multi-window BES (mbes), but the router keeps it on CSR (its CSS
    grid is too uneven to win); it solves end-to-end in every precision
    mode, including through the scale paths."""
    import scipy.sparse as sp
    import lis_tpu
    from lis_tpu import solve
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.solvers.driver import auto_storage
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
    from lis_tpu.matrix.bes import multi_bes_from_csr
    mb = multi_bes_from_csr(m.indptr, m.indices, m.data, m.shape)
    assert mb.format_name == "mbes" and len(mb.parts) >= 2
    routed = auto_storage(A)
    assert routed.format_name == "csr", routed.format_name
    x = rng.standard_normal(n)
    for M in (mb, routed):
        np.testing.assert_allclose(np.asarray(M.matvec(jnp.asarray(x))),
                                   m @ x, atol=1e-10)
    xs = np.linspace(1, 2, n)
    b = m @ xs
    for f, bound in (("double", 1e-7), ("switch_df", 1e-11)):
        r = solve(A, b, options=f"-i bicgstab -p jacobi -tol 1e-10 -f {f} "
                                "-maxiter 4000")
        assert r.status == lis_tpu.LIS_SUCCESS, f
        assert np.abs(np.asarray(r.x) - xs).max() < bound, f
    r = solve(A, b, options="-i bicgstab -p jacobi -tol 1e-10 -scale 1")
    assert r.status == lis_tpu.LIS_SUCCESS


def test_css_profile_matches_built_matrix():
    """CSSMatrix.profile predicts from one bincount exactly the
    fill_blowup / rem_frac the full construction produces (auto_storage
    rejects on the cheap numbers, so they must agree)."""
    from lis_tpu.matrix.css import CSSMatrix
    a = random_sparse(300, density=0.02, seed=8)
    ptr, idx, val = (np.asarray(t) for t in a.to_csr_arrays())
    blowup, rem_frac = CSSMatrix.profile(idx, 300)
    m = CSSMatrix.from_csr_arrays(ptr, idx, val, a.shape)
    got_rem = m.rem.nnz / max(m.nnz, 1) if m.rem is not None else 0.0
    assert abs(blowup - m.fill_blowup) < 1e-12, (blowup, m.fill_blowup)
    assert abs(rem_frac - got_rem) < 1e-12, (rem_frac, got_rem)


def test_vbr_uniform_partition_bsr_delegate():
    """A uniform square VBR partition is exactly a BSR: matvec/matvech
    route through the BSR windowed slabs (einsum path) with identical
    results; non-uniform partitions keep the scalar view (fast=None)."""
    from lis_tpu.matrix.vbr import VBRMatrix
    import scipy.sparse as sp
    a = poisson2d(6, 6)
    p, i, v = (np.asarray(t) for t in a.to_csr_arrays())
    m = VBRMatrix.from_csr_arrays(p, i, v, a.shape, block=3)
    assert m.fast is not None and m.fast.format_name == "bsr"
    x = np.random.default_rng(0).standard_normal(36)
    dense = a.to_dense()
    np.testing.assert_allclose(np.asarray(m.matvec(jnp.asarray(x))),
                               dense @ x, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(np.asarray(m.matvech(jnp.asarray(x))),
                               dense.T @ x, rtol=1e-13, atol=1e-13)
    mv = VBRMatrix.from_csr_arrays(p, i, v, a.shape,
                                   row_part=(0, 2, 5, 9, 36),
                                   col_part=(0, 2, 5, 9, 36))
    assert mv.fast is None


def test_cst_locality_free_exact():
    """CST (chunk-sorted transpose-routed, matrix/cst.py): gather- and
    scatter-free SpMV on uniformly random sparsity — products are routed
    to ELL row order by the Benes shuffle plan (ops/shuffle.py).  Exact
    vs scipy, including the transpose apply and scaling."""
    import scipy.sparse as sp
    from lis_tpu.matrix.cst import CSTMatrix
    rng = np.random.default_rng(5)
    n, k = 3000, 9
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    A = CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(A.matvec(jnp.asarray(x))),
                               a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(A.matvech(jnp.asarray(x))),
                               a.T @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(A.get_diagonal()), a.diagonal(),
                               rtol=1e-13, atol=0)
    d = rng.random(n) + 0.5
    As = A.scale_symm(jnp.asarray(d))
    want = sp.diags(d) @ a @ sp.diags(d)
    np.testing.assert_allclose(np.asarray(As.matvec(jnp.asarray(x))),
                               want @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(As.matvech(jnp.asarray(x))),
                               want.T @ x, rtol=1e-12, atol=1e-12)
    # roundtrip
    p2, i2, v2 = As.to_csr_arrays()
    b = sp.csr_matrix((np.asarray(v2), np.asarray(i2), np.asarray(p2)),
                      shape=a.shape)
    assert abs(b - want).max() < 1e-12


@pytest.mark.parametrize("Kp", [2, 4, 32, 128])
def test_plan_apply_rowsum(Kp):
    """ShufflePlan.apply and apply_rowsum on an exact-holes plan vs the
    numpy oracle apply_host, across ELL widths Kp (ops/shuffle.py)."""
    import jax
    from lis_tpu.ops import shuffle as sh
    rng = np.random.default_rng(5)
    M = 1 << 16
    nreal = M // 2
    src = rng.choice(M, size=nreal, replace=False).astype(np.int64)
    dst = rng.choice(M, size=nreal, replace=False).astype(np.int64)
    perm = np.full(M, -1, dtype=np.int64)
    perm[src] = dst
    plan = sh.plan_shuffle(perm, exact_holes=True, validate=False)
    assert plan.small is None and len(plan.meta) > 1
    passes = [(d, s, np.asarray(i).astype(np.int64))
              for (d, s), i in zip(plan.meta, plan.idxs)]
    v = np.zeros(M)
    v[src] = rng.standard_normal(nreal)
    want = sh.apply_host(passes, v, M)
    np.testing.assert_array_equal(want[dst], v[src])
    got = np.asarray(jax.jit(plan.apply)(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    gotr = np.asarray(jax.jit(lambda t: plan.apply_rowsum(t, Kp))(
        jnp.asarray(v)))
    np.testing.assert_allclose(gotr, want.reshape(-1, Kp).sum(axis=1),
                               rtol=1e-13, atol=1e-13)


def test_auto_storage_prefers_cst_over_slow_bes():
    """Throughput-aware routing: a wide scattered band is representable
    as BES (at a high fill) and as CST, but neither beat CSR on the card;
    auto_storage picks CSS, whose estimated rate does (driver._css_wins),
    not the first format that merely fits."""
    import scipy.sparse as sp
    from lis_tpu.solvers.driver import auto_storage
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.matrix.cst import CSTMatrix
    rng = np.random.default_rng(3)
    n, k = 1 << 15, 16
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-1000, 1001, size=n * k), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    A = CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape)
    # a CST grid fits once its ELL width coarsens the bucket grid
    assert any(b <= 6.0 and sp_ <= 0.02 for b, sp_ in (
        CSTMatrix.profile(m.indptr, m.indices, m.shape, Kp=kp)
        for kp in (32, 64, 128, 256)))
    routed = auto_storage(A)
    assert routed.format_name == "css", routed.format_name
    x = rng.standard_normal(n)
    got = np.asarray(routed.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, m @ x, rtol=1e-10, atol=1e-8)


def test_cst_lazy_transpose_routing():
    """A CST built without its transpose grid applies A^H through the
    exact scatter fallback.  auto_storage builds the routed CSS's
    transpose grid only for solvers that apply A^H every iteration
    (bicg/bicr) — CG-class solves skip it (half the build), its scatter
    matvech stays exact, and a later bicg solve on the same matrix
    upgrades the cached grid."""
    import scipy.sparse as sp
    import lis_tpu
    from lis_tpu.solvers.driver import auto_storage
    from lis_tpu.matrix.csr import CSRMatrix
    from lis_tpu.matrix.cst import CSTMatrix
    from lis_tpu.matrix.css import CSSMatrix
    rng = np.random.default_rng(5)
    n, k = 1 << 15, 10
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + a.T + sp.eye(n) * (4 * k)).tocsr()
    a.sort_indices()
    A = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    x = np.random.default_rng(1).standard_normal(n)
    C = CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                  transpose=False)
    assert C.at is None
    np.testing.assert_allclose(np.asarray(C.matvech(x)), a.T @ x,
                               rtol=1e-12, atol=1e-10)
    routed = auto_storage(A, need_at=False)
    assert isinstance(routed, CSSMatrix) and routed.at is None
    np.testing.assert_allclose(np.asarray(routed.matvech(x)), a.T @ x,
                               rtol=1e-12, atol=1e-10)
    r = lis_tpu.solve(A, np.ones(n), options="-i bicgstab -tol 1e-10")
    assert r.status == lis_tpu.LIS_SUCCESS
    up = auto_storage(A, need_at=True)      # cache upgrade
    assert isinstance(up, CSSMatrix) and up.at is not None
    assert A._auto_dia.at is not None
