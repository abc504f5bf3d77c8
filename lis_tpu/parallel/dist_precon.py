"""Distributed (block-local) preconditioners.

The reference's MPI behavior for ILU/SSOR is block-Jacobi: each rank
factors and sweeps only its owned diagonal block (lis_precon_iluk.c — the
fact loops run over local rows; the OpenMP tri-solve drops out-of-block
columns, src/matrix/lis_matrix_csr.c:1577-1605).  The mesh equivalent:
extract each shard's diagonal block on host, factor it with the standard
(single-chip) create functions, and stack the resulting level-scheduled
plans with a leading shard axis so a P("p") in_spec hands every shard its
own local plan inside shard_map.  The apply is then the UNCHANGED psolve of
the single-chip preconditioner class, run per-shard.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lis_tpu.matrix.base import host
from lis_tpu.matrix.csr import CSRMatrix
from lis_tpu.ops.trisolve import TriSolvePlan
from lis_tpu.parallel.mesh import AXIS


def local_diag_blocks(A) -> list:
    """Per-shard diagonal blocks of a distributed matrix (CSR or DIA
    sharding) as host CSRMatrix objects of uniform size (nlocal × nlocal).
    Padding rows (beyond the true global size) get an explicit unit
    diagonal so factors act as identity there."""
    from lis_tpu.parallel.dist import undistribute_csr
    g = undistribute_csr(A)
    gp, gi, gv = g.to_csr_arrays()
    gs = sp.csr_matrix((np.asarray(gv), np.asarray(gi), np.asarray(gp)),
                       shape=(A.gn, A.gn))
    p, nl, gn = A.nprocs, A.nlocal, A.gn
    blocks = []
    for k in range(p):
        lo, hi = min(k * nl, gn), min((k + 1) * nl, gn)
        m = gs[lo:hi, lo:hi].tocoo()
        r, c, v = m.row, m.col, m.data
        npad = nl - (hi - lo)
        if npad > 0:
            r = np.concatenate([r, np.arange(hi - lo, nl)])
            c = np.concatenate([c, np.arange(hi - lo, nl)])
            v = np.concatenate([v, np.ones(npad, dtype=v.dtype)])
        m = sp.coo_matrix((v, (r, c)), shape=(nl, nl)).tocsr()
        m.sort_indices()
        blocks.append(CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data,
                                                (nl, nl)))
    return blocks


def _stack_plans(plans: list[TriSolvePlan], mesh: Mesh) -> TriSolvePlan:
    """Pad per-shard plans to common (nlev, max_rows, max_nnz) and stack
    with the shard axis leading-and-flattened, so P("p") splits cleanly."""
    n = plans[0].n
    nlev = max(p.rows.shape[0] for p in plans)
    mr = max(p.rows.shape[1] for p in plans)
    mn = max(p.cols.shape[2] for p in plans)
    sh = NamedSharding(mesh, P(AXIS))

    def pad(a, shape, fill):
        out = np.full(shape, fill, dtype=host(a).dtype)
        s = a.shape
        out[tuple(slice(0, d) for d in s)] = host(a)
        return out

    rows = np.stack([pad(p.rows, (nlev, mr), n) for p in plans])
    cols = np.stack([pad(p.cols, (nlev, mr, mn), n) for p in plans])
    vals = np.stack([pad(p.vals, (nlev, mr, mn), 0) for p in plans])
    dinv = np.stack([host(p.dinv) for p in plans])
    put = lambda a: jax.device_put(jnp.asarray(a.reshape((-1,) + a.shape[2:])), sh)
    return TriSolvePlan(rows=put(rows), cols=put(cols), vals=put(vals),
                        dinv=put(dinv), n=n)


def stack_precons(precons: list, mesh: Mesh):
    """Stack a list of identical-structure single-chip preconditioners into
    one whose leaves carry a flattened leading shard axis.  TriSolvePlan
    sub-trees are padded to a common level/row/nnz geometry; plain array
    leaves are stacked directly."""
    import dataclasses
    cls = type(precons[0])
    fields = {}
    for f in dataclasses.fields(precons[0]):
        vs = [getattr(p, f.name) for p in precons]
        if isinstance(vs[0], TriSolvePlan):
            fields[f.name] = _stack_plans(vs, mesh)
        else:
            a = np.stack([host(v) for v in vs])
            fields[f.name] = jax.device_put(
                jnp.asarray(a.reshape((-1,) + a.shape[2:])),
                NamedSharding(mesh, P(AXIS)))
    return cls(**fields)


def make_dist_block_precon(A, mesh: Mesh, opts, name=None):
    """Block-Jacobi version of any local preconditioner (the reference's
    MPI semantics for ILU/SSOR/SAINV/I+S): factor each shard's diagonal
    block with the standard registry create function and stack.

    ``-p ilu -storage bsr`` selects the BLOCK factorization for the
    local blocks, like the reference's per-rank BSR conversion before
    lis_precon_create (lis_solver.c:741 + lis_precon_iluk.c:1289); the
    sharded *operator* layout is still chosen by distribute_matrix."""
    from lis_tpu.precon.base import PRECON_REGISTRY
    create = PRECON_REGISTRY[name or opts.precon]
    blocks = local_diag_blocks(A)
    if (name or opts.precon) == "ilu" and getattr(opts, "storage", 0) == 7:
        from lis_tpu.matrix.convert import convert_matrix
        bnr = getattr(opts, "storage_block", 2) or 2
        blocks = [convert_matrix(b, "bsr", bnr=bnr) for b in blocks]
    return stack_precons_nested([create(b, opts) for b in blocks], mesh)


def _pad_stack_csr(mats, mesh: Mesh):
    """Stack per-shard local CSRMatrix blocks (possibly different nnz) into
    one whose leaves carry the flattened shard axis: entries padded with
    value 0 pointing at the last local row/col (harmless under the
    segment-sum matvec)."""
    nl = mats[0].nrows
    nc = mats[0].ncols
    mx = max(m.nnz for m in mats) or 1
    val = np.zeros((len(mats), mx))
    idx = np.full((len(mats), mx), nc - 1, dtype=np.int32)
    rid = np.full((len(mats), mx), nl - 1, dtype=np.int32)
    ptr = np.zeros((len(mats), nl + 1), dtype=np.int32)
    for k, m in enumerate(mats):
        p_, i_, v_ = m.to_csr_arrays()
        val[k, :m.nnz] = v_
        idx[k, :m.nnz] = i_
        rid[k, :m.nnz] = np.repeat(np.arange(nl, dtype=np.int32),
                                   np.diff(p_))
        ptr[k] = p_
        ptr[k, -1] = mx                     # pad entries live on last row
    sh = NamedSharding(mesh, P(AXIS))
    put = lambda a: jax.device_put(jnp.asarray(a.reshape(-1)), sh)
    return CSRMatrix(ptr=put(ptr), index=put(idx), value=put(val),
                     row_ids=put(rid), nrows=nl, ncols=nc, nnz=mx)


def stack_precons_nested(precons: list, mesh: Mesh):
    """stack_precons generalised to preconditioners whose fields are
    sparse-matrix pytrees (SAINV's W/Z) or static values (IS's alpha):
    matrices pad-stack, statics keep the first value, arrays stack."""
    import dataclasses
    from lis_tpu.matrix.base import SparseMatrix
    cls = type(precons[0])
    statics = set(getattr(precons[0], "_static", ()))
    fields = {}
    for f in dataclasses.fields(precons[0]):
        if f.name == "_static":
            continue
        vs = [getattr(p, f.name) for p in precons]
        if f.name in statics or vs[0] is None:
            fields[f.name] = vs[0]
        elif isinstance(vs[0], TriSolvePlan):
            fields[f.name] = _stack_plans(vs, mesh)
        elif isinstance(vs[0], SparseMatrix):
            csr = [v if isinstance(v, CSRMatrix)
                   else CSRMatrix.from_csr_arrays(*v.to_csr_arrays(),
                                                  v.shape) for v in vs]
            fields[f.name] = _pad_stack_csr(csr, mesh)
        else:
            a = np.stack([host(v) for v in vs])
            fields[f.name] = jax.device_put(
                jnp.asarray(a.reshape((-1,) + a.shape[2:])),
                NamedSharding(mesh, P(AXIS)))
    return cls(**fields)


class _TransposedOp:
    """Aᴴ as an operator view (matvec <-> matvech swapped) — lets the
    distributed hybrid run its psolveh inner solve without materialising a
    transposed sharded matrix."""

    def __init__(self, A):
        self.A = A

    def matvec(self, x):
        return self.A.matvech(x)

    def matvech(self, x):
        return self.A.matvec(x)

    def get_diagonal(self):
        d = self.A.get_diagonal()
        return jnp.conj(d) if jnp.iscomplexobj(d) else d


jax.tree_util.register_pytree_node(
    _TransposedOp, lambda m: ((m.A,), ()), lambda aux, c: _TransposedOp(*c))


def make_dist_hybrid(A, mesh: Mesh, opts):
    """Distributed hybrid preconditioner: the inner iterative solver runs
    on the GLOBAL sharded system (matching the reference, whose inner
    lis_solve under MPI is fully distributed — lis_precon_hybrid.c:165);
    axis_name threads psum into the inner reductions."""
    from lis_tpu.precon.hybrid import HybridPrecon
    from lis_tpu.solvers.base import SolverSpec
    inner_name = getattr(opts, "hybrid_i", "sor")
    if inner_name in ("sor", "gs"):
        # stationary inner solvers need block-local sweep plans; default
        # to the always-distributable Jacobi-like CG smoother instead
        inner_name = "cg"
    spec = SolverSpec(solver=inner_name,
                      tol=getattr(opts, "hybrid_tol", 1e-3),
                      maxiter=getattr(opts, "hybrid_maxiter", 25),
                      restart=getattr(opts, "hybrid_restart", 40),
                      ell=getattr(opts, "hybrid_ell", 2),
                      omega=getattr(opts, "hybrid_omega", 1.5),
                      conv_cond=0, axis_name=AXIS)
    return HybridPrecon(A=A, At=_TransposedOp(A), aux=None, aux_t=None,
                        spec=spec)


@jax.tree_util.register_pytree_node_class
class DistAMGMidLevel:
    """One mesh-sharded coarse level of the distributed SA-AMG hierarchy.

    The analogue of the reference's per-level distributed AMG data
    (src/fortran/amg/lis_m_data_structure_for_AMG.F90:36): each shard owns
    a contiguous row slab of this level's operator A_l and prolongator
    P_l plus block-local SGS plans of its diagonal block.  Vectors at
    these levels are small, so they stay REPLICATED — a slab matvec is a
    local segment-sum followed by one tiled all_gather; only the MATRIX
    memory (the part that scales) is divided by the mesh width.
    """

    def __init__(self, a_val, a_col, a_row, p_val, p_col, p_row, fwd, bwd,
                 n, nc, nloc, p):
        self.a_val = a_val        # (mnnzA,) local operator slab entries
        self.a_col = a_col        # (mnnzA,) int32 GLOBAL columns
        self.a_row = a_row        # (mnnzA,) int32 local slab rows (sorted)
        self.p_val = p_val        # (mnnzP,) local prolongator slab
        self.p_col = p_col        # (mnnzP,) int32 global coarse columns
        self.p_row = p_row        # (mnnzP,) int32 local slab rows (sorted)
        self.fwd = fwd            # block-local SGS plans (stacked)
        self.bwd = bwd
        self.n = n                # static: global rows at this level
        self.nc = nc              # static: global rows at the next level
        self.nloc = nloc          # static: slab rows per shard
        self.p = p                # static: mesh width

    def tree_flatten(self):
        return ((self.a_val, self.a_col, self.a_row, self.p_val, self.p_col,
                 self.p_row, self.fwd, self.bwd),
                (self.n, self.nc, self.nloc, self.p))

    @classmethod
    def tree_unflatten(cls, aux, c):
        return cls(*c, *aux)

    # ---- inside-shard_map ops (x, b replicated length-n vectors) --------
    def local(self, x):
        k = jax.lax.axis_index(AXIS)
        return jax.lax.dynamic_slice_in_dim(
            jnp.pad(x, (0, self.nloc * self.p - self.n)), k * self.nloc,
            self.nloc)

    def gather(self, x_loc):
        return jax.lax.all_gather(x_loc, AXIS, tiled=True)[:self.n]

    def matvec(self, x):
        y_loc = jax.ops.segment_sum(
            self.a_val * jnp.take(x, self.a_col, axis=0), self.a_row,
            num_segments=self.nloc, indices_are_sorted=True)
        return self.gather(y_loc)

    def gs(self, b, lower):
        """Block-local SGS half sweep on the owned diagonal block (the
        reference's rank-local hybrid Gauss-Seidel)."""
        from lis_tpu.ops.trisolve import trisolve
        return trisolve(self.fwd if lower else self.bwd, self.local(b))

    def restrict(self, r):
        r_loc = self.local(r)
        contrib = jnp.zeros(self.nc, dtype=r.dtype).at[self.p_col].add(
            self.p_val * jnp.take(r_loc, self.p_row, axis=0))
        return jax.lax.psum(contrib, AXIS)

    def prolong_local(self, ec):
        return jax.ops.segment_sum(
            self.p_val * jnp.take(ec, self.p_col, axis=0), self.p_row,
            num_segments=self.nloc, indices_are_sorted=True)


@jax.tree_util.register_pytree_node_class
class DistSAAMGPrecon:
    """Distributed smoothed-aggregation AMG.

    Design (vs the reference's per-level MPI comm tables,
    src/fortran/amg/lis_m_solver_AMGCG.F90:50, lis_m_solver_SR2.F90:43):
    level 0 is mesh-sharded: block-local SGS smoothing (the relaxed-sweep
    precedent of dist ssor) with the residual matvec going through the
    DISTRIBUTED operator, and the smoothed prolongator stored as local
    row slabs; restriction is one psum of the coarse-length vector.
    Coarse levels that still exceed ``saamg_shard_rows × ndev`` rows are
    sharded as :class:`DistAMGMidLevel` row slabs (matrix memory ∝ 1/p,
    vectors replicated), so the hierarchy no longer keeps a full replica
    per device; only the truly small tail is replicated — the
    idiomatic choice: don't shard tiny work.
    """

    def __init__(self, A0, p_value, p_col, p_row, fwd, bwd, mids, coarse,
                 n1, nlocal):
        self.A0 = A0              # distributed operator (local view)
        self.p_value = p_value    # (mnnz,) local prolongator entries
        self.p_col = p_col        # (mnnz,) int32 global coarse columns
        self.p_row = p_row        # (mnnz,) int32 local fine rows (sorted)
        self.fwd = fwd            # block-local SGS plans (stacked)
        self.bwd = bwd
        self.mids = mids          # tuple[DistAMGMidLevel] — sharded slabs
        self.coarse = coarse      # replicated single-chip SAAMGPrecon tail
        self.n1 = n1              # static: coarse size
        self.nlocal = nlocal      # static

    def tree_flatten(self):
        return ((self.A0, self.p_value, self.p_col, self.p_row, self.fwd,
                 self.bwd, self.mids, self.coarse), (self.n1, self.nlocal))

    @classmethod
    def tree_unflatten(cls, aux, c):
        return cls(*c, *aux)

    def partition_specs(self):
        """Mixed in_specs: level-0 + mid-level leaves sharded, coarse
        replicated."""
        sharded = jax.tree.map(
            lambda _: P(AXIS),
            (self.A0, self.p_value, self.p_col, self.p_row, self.fwd,
             self.bwd, self.mids))
        repl = jax.tree.map(lambda _: P(), self.coarse)
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(self),
            jax.tree.leaves((sharded, repl),
                            is_leaf=lambda x: isinstance(x, P)))

    # ---- local (inside-shard_map) apply ---------------------------------
    def _smooth(self, x, b):
        from lis_tpu.ops.trisolve import trisolve
        x = x + trisolve(self.fwd, b - self.A0.matvec(x))
        return x + trisolve(self.bwd, b - self.A0.matvec(x))

    def _mid_cycle(self, i, b):
        """V-cycle over the sharded coarse levels; ``b`` is a replicated
        global vector at mid level ``i``.  Mirrors SAAMGPrecon._cycle with
        block-local SGS smoothing and slab matvecs."""
        if i == len(self.mids):
            return self.coarse.psolve(b)
        m = self.mids[i]
        # pre-smooth from x = 0
        x_loc = m.gs(b, lower=True)
        x = m.gather(x_loc)
        x_loc = x_loc + m.gs(b - m.matvec(x), lower=False)
        x = m.gather(x_loc)
        # coarse-grid correction
        rc = m.restrict(b - m.matvec(x))
        ec = self._mid_cycle(i + 1, rc)
        x_loc = x_loc + m.prolong_local(ec)
        x = m.gather(x_loc)
        # post-smooth
        x_loc = x_loc + m.gs(b - m.matvec(x), lower=True)
        x = m.gather(x_loc)
        x_loc = x_loc + m.gs(b - m.matvec(x), lower=False)
        return m.gather(x_loc)

    def psolve(self, r):
        from lis_tpu.ops.trisolve import trisolve
        # pre-smooth from x = 0 (one SGS sweep)
        x = trisolve(self.fwd, r)
        x = x + trisolve(self.bwd, r - self.A0.matvec(x))
        # restrict the residual: rc = psum(P_locᵀ r_loc) — replicated
        rr = r - self.A0.matvec(x)
        contrib = jnp.zeros(self.n1, dtype=rr.dtype).at[self.p_col].add(
            self.p_value * jnp.take(rr, self.p_row, axis=0))
        rc = jax.lax.psum(contrib, AXIS)
        ec = self._mid_cycle(0, rc)         # sharded slabs, then the tail
        # prolongate the correction into the local rows
        x = x + jax.ops.segment_sum(
            self.p_value * jnp.take(ec, self.p_col, axis=0), self.p_row,
            num_segments=self.nlocal, indices_are_sorted=True)
        # post-smooth
        return self._smooth(x, r)

    def psolveh(self, r):
        return self.psolve(r)               # symmetric hierarchy


def _slab_triplets(M, p, nloc):
    """Row-slab triplets of a scipy matrix, padded per shard to a common
    nnz: (p, mnnz) value / GLOBAL column / local-row arrays, rows sorted
    within each shard so segment_sum can assume sorted indices.  Padding
    entries carry value 0 at local row nloc-1."""
    Mc = M.tocoo()
    shard_of = Mc.row // nloc
    counts = np.bincount(shard_of, minlength=p)
    mnnz = max(int(counts.max()), 1)
    val = np.zeros((p, mnnz))
    col = np.zeros((p, mnnz), dtype=np.int32)
    row = np.full((p, mnnz), nloc - 1, dtype=np.int32)
    lrow = Mc.row - shard_of * nloc
    srt = np.lexsort((Mc.col, lrow, shard_of))
    pos = np.concatenate([[0], np.cumsum(counts)])
    for k in range(p):
        sel = srt[pos[k]:pos[k + 1]]
        cnt = len(sel)
        val[k, :cnt] = Mc.data[sel]
        col[k, :cnt] = Mc.col[sel]
        row[k, :cnt] = lrow[sel]
    return val, col, row


def _slab_sgs_plans(gs, p, nloc, mesh):
    """Stacked block-local SGS plans of the nloc-sized diagonal blocks of
    a scipy matrix (identity on padding rows past the true size)."""
    from lis_tpu.precon.saamg import _sgs_plans
    gn = gs.shape[0]
    fwds, bwds = [], []
    for k in range(p):
        lo, hi = min(k * nloc, gn), min((k + 1) * nloc, gn)
        m = gs[lo:hi, lo:hi].tocoo()
        r, c, v = m.row, m.col, m.data
        npad = nloc - (hi - lo)
        if npad > 0:
            r = np.concatenate([r, np.arange(hi - lo, nloc)])
            c = np.concatenate([c, np.arange(hi - lo, nloc)])
            v = np.concatenate([v, np.ones(npad, dtype=v.dtype)])
        f, b = _sgs_plans(sp.coo_matrix((v, (r, c)),
                                        shape=(nloc, nloc)).tocsr())
        fwds.append(f)
        bwds.append(b)
    return _stack_plans(fwds, mesh), _stack_plans(bwds, mesh)


def make_dist_saamg(A, mesh: Mesh, opts):
    from lis_tpu.parallel.dist import undistribute_csr
    from lis_tpu.precon.saamg import (build_hierarchy, _sgs_plans,
                                      AMGLevel, SAAMGPrecon)

    g = undistribute_csr(A)
    gp, gi, gv = g.to_csr_arrays()
    gs = sp.csr_matrix((np.asarray(gv), np.asarray(gi), np.asarray(gp)),
                       shape=(A.gn, A.gn))
    theta = getattr(opts, "saamg_theta", 0.05)
    raw, A_coarse = build_hierarchy(gs, theta=theta)
    p, nl = A.nprocs, A.nlocal
    sh = NamedSharding(mesh, P(AXIS))

    if not raw:
        raise ValueError("saamg: operator too small to build a hierarchy; "
                         "use -p jacobi or a direct solve")

    A0, P0, _ = raw[0]      # dist SAAMG runs the symmetric variant
    n1 = P0.shape[1]

    # block-local SGS plans of the level-0 diagonal blocks
    from lis_tpu.matrix.csr import CSRMatrix as _CSR
    blocks = local_diag_blocks(A)
    fwds, bwds = [], []
    for blk in blocks:
        bp, bi, bv = blk.to_csr_arrays()
        f, b = _sgs_plans(sp.csr_matrix(
            (np.asarray(bv), np.asarray(bi), np.asarray(bp)),
            shape=(nl, nl)))
        fwds.append(f)
        bwds.append(b)
    fwd = _stack_plans(fwds, mesh)
    bwd = _stack_plans(bwds, mesh)

    # local row slabs of the smoothed prolongator, padded per shard
    val, col, row = _slab_triplets(P0, p, nl)
    put = lambda a: jax.device_put(jnp.asarray(a.reshape(-1)), sh)

    # coarse hierarchy: shard levels while they still hold real memory
    # (rows > saamg_shard_rows × ndev), replicate only the small tail —
    # the reference distributes every level with per-level comm tables
    # (lis_m_data_structure_for_AMG.F90:36)
    shard_rows = int(getattr(opts, "saamg_shard_rows", 256))
    lvl = 1
    mids = []
    while lvl < len(raw) and raw[lvl][0].shape[0] > shard_rows * p:
        Al, Pl, _Rl = raw[lvl]
        n_l = Al.shape[0]
        nloc_l = -(-n_l // p)
        av, ac, ar = _slab_triplets(Al, p, nloc_l)
        pv, pc, pr = _slab_triplets(Pl, p, nloc_l)
        f_l, b_l = _slab_sgs_plans(Al.tocsr(), p, nloc_l, mesh)
        mids.append(DistAMGMidLevel(
            a_val=put(av), a_col=put(ac), a_row=put(ar),
            p_val=put(pv), p_col=put(pc), p_row=put(pr),
            fwd=f_l, bwd=b_l, n=n_l, nc=Pl.shape[1], nloc=nloc_l, p=p))
        lvl += 1

    clevels = []
    for (Al, Pl, _Rl) in raw[lvl:]:
        f, b = _sgs_plans(Al)
        Al.sort_indices()
        Pl.sort_indices()
        clevels.append(AMGLevel(
            A=_CSR.from_csr_arrays(Al.indptr, Al.indices, Al.data, Al.shape),
            P=_CSR.from_csr_arrays(Pl.indptr, Pl.indices, Pl.data, Pl.shape),
            fwd=f, bwd=b))
    coarse = SAAMGPrecon(levels=tuple(clevels),
                         coarse_inv=jnp.asarray(
                             np.linalg.inv(A_coarse.toarray())))

    return DistSAAMGPrecon(A0=A, p_value=put(val), p_col=put(col),
                           p_row=put(row), fwd=fwd, bwd=bwd,
                           mids=tuple(mids), coarse=coarse,
                           n1=n1, nlocal=nl)
