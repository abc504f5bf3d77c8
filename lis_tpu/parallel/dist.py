"""Distributed (mesh-sharded) matrices, vectors, and solver execution.

The reference distributes by 1-D block-row partition with a comm table for
halo exchange (lis_matrix_g2l_csr src/matrix/lis_matrix_mpi.c:222,
lis_commtable_create :594-828, lis_send_recv :834-955, transpose-reduce
lis_reduce :959) and MPI_Allreduce in every dot/norm.

Mesh mapping (SURVEY.md §2.10):
- rows block-partitioned over mesh axis "p", padded so every shard owns the
  same ``nlocal`` rows (static shapes for XLA);
- SpMV: remote x segments arrive by one of three plans:
  * ``halo='neighbor'``— banded matrices exchange fixed-width boundary
    slabs with the two ring neighbors via ppermute, overlapping interior
    compute — the analogue of the reference's USE_OVERLAP JAD path;
  * ``halo='table'``   — general sparsity uses a static export/import
    comm table built at distribute time (lis_commtable_create analogue):
    per-device traffic proportional to boundary nnz, not gn (the
    default for non-banded matrices);
  * ``halo='gather'``  — all_gather(x) then gather at global column
    indices (explicit opt-in; O(gn) traffic per matvec);
- transpose SpMV: local scatter contributions then psum_scatter — the
  analogue of lis_reduce;
- dot/norm: lax.psum via the vector ops' axis_name.

Solvers are reused UNCHANGED: the same jitted functions run inside
shard_map with spec.axis_name="p" — exactly the reference's property that
solvers are written as if serial with SPMD-ness encapsulated in L2/L3.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lis_tpu.utils.trace import traced
from lis_tpu.parallel.mesh import AXIS
from lis_tpu.matrix.base import SparseMatrix, host


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


@dataclasses.dataclass(frozen=True)
class DistCSRMatrix(SparseMatrix):
    """Block-row sharded CSR.  Array leaves are laid out flat with the
    shard axis leading-and-flattened ((p·m,) arrays) so that a P("p")
    in_spec hands each shard its clean local slice.  Methods are written
    for the LOCAL view (inside shard_map); the global object is a
    container + sharding descriptor."""
    value: jax.Array          # (p·mnnz,) zero-padded
    index: jax.Array          # (p·mnnz,) int32 GLOBAL column indices
    row_ids: jax.Array        # (p·mnnz,) int32 LOCAL row ids (sorted/shard)
    nlocal: int               # static: padded rows per shard
    gn: int                   # static: true global size
    gn_pad: int               # static: p·nlocal
    nprocs: int               # static
    halo: str = "gather"      # static: 'gather' | 'neighbor'
    hw: int = 0               # static: halo width for 'neighbor'

    # ---- local (inside-shard_map) compute --------------------------------
    def _gather_x(self, x_local):
        if self.halo == "neighbor":
            # ring exchange of fixed-width boundary slabs
            p = self.nprocs
            perm_up = [(i, (i + 1) % p) for i in range(p)]
            perm_dn = [(i, (i - 1) % p) for i in range(p)]
            hw = self.hw
            from_left = jax.lax.ppermute(x_local[-hw:], AXIS, perm_up)
            from_right = jax.lax.ppermute(x_local[:hw], AXIS, perm_dn)
            k = jax.lax.axis_index(AXIS)
            base = k * self.nlocal
            # extended local vector: [left slab | x | right slab]
            xe = jnp.concatenate([from_left, x_local, from_right])
            return xe, base - hw
        xg = jax.lax.all_gather(x_local, AXIS, tiled=True)
        return xg, 0

    def matvec(self, x_local):
        if self.halo == "neighbor":
            # Interior/boundary split — the analogue of the reference's
            # USE_OVERLAP path (lis_matvec.c:119-124): the interior product
            # needs only x_local, so XLA's async collectives can overlap
            # the two ppermutes with it; the boundary product touches only
            # the exchanged slabs.
            p, hw = self.nprocs, self.hw
            perm_up = [(i, (i + 1) % p) for i in range(p)]
            perm_dn = [(i, (i - 1) % p) for i in range(p)]
            from_left = jax.lax.ppermute(x_local[-hw:], AXIS, perm_up)
            from_right = jax.lax.ppermute(x_local[:hw], AXIS, perm_dn)

            k = jax.lax.axis_index(AXIS)
            lidx = self.index - k * self.nlocal      # local column offsets
            interior = (lidx >= 0) & (lidx < self.nlocal)
            prod_int = jnp.where(interior, self.value, 0) * jnp.take(
                x_local, jnp.clip(lidx, 0, self.nlocal - 1), axis=0)
            y = jax.ops.segment_sum(prod_int, self.row_ids,
                                    num_segments=self.nlocal,
                                    indices_are_sorted=True)

            slabs = jnp.concatenate([from_left, from_right])
            # left slab covers lidx in [-hw, 0), right slab [nlocal, nlocal+hw)
            sidx = jnp.where(lidx < 0, lidx + hw, lidx - self.nlocal + hw)
            prod_b = jnp.where(interior, 0, self.value) * jnp.take(
                slabs, jnp.clip(sidx, 0, 2 * hw - 1), axis=0, mode="clip")
            return y + jax.ops.segment_sum(prod_b, self.row_ids,
                                           num_segments=self.nlocal,
                                           indices_are_sorted=True)
        xe, offset = self._gather_x(x_local)
        prod = self.value * jnp.take(xe, self.index, axis=0, mode="clip")
        return jax.ops.segment_sum(prod, self.row_ids,
                                   num_segments=self.nlocal,
                                   indices_are_sorted=True)

    def matvech(self, x_local):
        v = jnp.conj(self.value) if jnp.iscomplexobj(self.value) else self.value
        prod = v * jnp.take(x_local, self.row_ids, axis=0)
        contrib = jnp.zeros(self.gn_pad, dtype=prod.dtype)
        contrib = contrib.at[self.index].add(prod)
        return jax.lax.psum_scatter(contrib, AXIS, scatter_dimension=0,
                                    tiled=True)

    # container metadata
    @property
    def nrows(self):
        return self.gn

    @property
    def ncols(self):
        return self.gn

    def get_diagonal(self):
        """LOCAL diagonal slice (inside shard_map)."""
        k = jax.lax.axis_index(AXIS)
        gcol = self.row_ids.astype(jnp.int64) + k * self.nlocal
        isdiag = self.index == gcol.astype(self.index.dtype)
        contrib = jnp.where(isdiag, self.value, 0)
        return jax.ops.segment_sum(contrib, self.row_ids,
                                   num_segments=self.nlocal,
                                   indices_are_sorted=True)


jax.tree_util.register_pytree_node(
    DistCSRMatrix,
    lambda m: ((m.value, m.index, m.row_ids),
               (m.nlocal, m.gn, m.gn_pad, m.nprocs, m.halo, m.hw)),
    lambda aux, c: DistCSRMatrix(*c, *aux))


@dataclasses.dataclass(frozen=True)
class DistTableCSRMatrix(SparseMatrix):
    """Block-row sharded CSR with a COMM-TABLE halo plan — the
    analogue of the reference's lis_commtable_create / lis_send_recv
    (src/matrix/lis_matrix_mpi.c:594-828, :834-955): at distribute time
    the host computes, per shard and per shard-distance d, exactly which
    owned x entries each neighbor needs (export lists) and where the
    received ghosts land (import layout = the ghost tail, concatenated
    per distance).  Every matvec then moves ONLY boundary data — one
    ppermute of the packed export slab per active distance — instead of
    all-gathering the whole vector: per-device comm volume is
    proportional to boundary nnz, not gn.  Column indices are renumbered
    g2l (ghosts occupy [nlocal, nlocal+G), mirroring lis_matrix_g2l_csr
    :222); the transpose apply routes ghost partials back through the
    reversed permutes and adds into the owners (lis_reduce :959).

    Entries are SPLIT at distribute time into interior (all columns
    owned) and boundary (ghost columns) segments so the interior product
    has no data dependency on the exchanges: the matvec issues every
    per-distance ppermute first, computes the interior product while the
    async collective-permutes fly, and only then touches the ghost tail
    — the reference's USE_OVERLAP (src/matvec/lis_matvec.c:119-124)
    carried to the comm-table plan."""
    value: jax.Array          # (p*mi,) interior values, zero-padded
    lidx: jax.Array           # (p*mi,) int32 local col ids (< nlocal)
    row_ids: jax.Array        # (p*mi,) int32 local row ids (sorted)
    value_b: jax.Array        # (p*mb,) boundary values, zero-padded
    lidx_b: jax.Array         # (p*mb,) int32 ghost-tail ids (< G)
    row_ids_b: jax.Array      # (p*mb,) int32 local row ids (sorted)
    ghost_gids: jax.Array     # (p*G,) int32 global id per ghost slot
    exports: tuple            # per distance: (p*Ed,) int32 local x ids
    nlocal: int               # static
    gn: int                   # static
    gn_pad: int               # static
    nprocs: int               # static
    dists: tuple = ()         # static: active shard distances
    exp_lens: tuple = ()      # static: Ed per distance
    G: int = 0                # static: ghost tail length

    halo = "table"

    # ---- local (inside-shard_map) compute -------------------------------
    def _start_exchange(self, x_local):
        """Per-distance export pack + ppermute (the lis_send_recv
        analogue); returns the ghost slabs WITHOUT concatenating so the
        caller can compute before consuming them."""
        p = self.nprocs
        ghosts = []
        for d, eidx in zip(self.dists, self.exports):
            packed = jnp.take(x_local, eidx, axis=0, mode="clip")
            perm = [(i, (i - d) % p) for i in range(p)]
            ghosts.append(jax.lax.ppermute(packed, AXIS, perm))
        return ghosts

    def _exchange(self, x_local):
        """Full ghost-extended vector (halo-mode parity tests)."""
        ghosts = self._start_exchange(x_local)
        if not ghosts:
            return x_local
        return jnp.concatenate([x_local] + ghosts)

    def matvec(self, x_local):
        # comm first, interior compute while it flies (USE_OVERLAP)
        ghosts = self._start_exchange(x_local)
        prod = self.value * jnp.take(x_local, self.lidx, axis=0,
                                     mode="clip")
        y = jax.ops.segment_sum(prod, self.row_ids,
                                num_segments=self.nlocal,
                                indices_are_sorted=True)
        if ghosts:
            gh = jnp.concatenate(ghosts)
            prod_b = self.value_b * jnp.take(gh, self.lidx_b, axis=0,
                                             mode="clip")
            y = y + jax.ops.segment_sum(prod_b, self.row_ids_b,
                                        num_segments=self.nlocal,
                                        indices_are_sorted=True)
        return y

    def matvech(self, x_local):
        conj = (jnp.conj if jnp.iscomplexobj(self.value) else
                (lambda a: a))
        prod = conj(self.value) * jnp.take(x_local, self.row_ids, axis=0)
        y = jnp.zeros(self.nlocal + 1, dtype=prod.dtype)
        y = y.at[jnp.minimum(self.lidx, self.nlocal)].add(prod)
        if not self.dists:
            return y[: self.nlocal]
        prod_b = conj(self.value_b) * jnp.take(x_local, self.row_ids_b,
                                               axis=0)
        tail = jnp.zeros(self.G, dtype=prod_b.dtype)
        tail = tail.at[self.lidx_b].add(prod_b)
        p = self.nprocs
        off = 0
        # lis_reduce: route ghost partials back to their owners and add
        for d, Ed, eidx in zip(self.dists, self.exp_lens, self.exports):
            part = jax.lax.dynamic_slice(tail, (off,), (Ed,))
            off += Ed
            perm = [(i, (i + d) % p) for i in range(p)]
            back = jax.lax.ppermute(part, AXIS, perm)
            y = y.at[jnp.minimum(eidx, self.nlocal)].add(back)
        return y[: self.nlocal]

    @property
    def nrows(self):
        return self.gn

    @property
    def ncols(self):
        return self.gn

    @property
    def comm_elems(self) -> int:
        """Per-device vector elements moved per matvec (the measured comm
        volume cli/scaling.py reports; all-gather moves gn_pad)."""
        return int(sum(self.exp_lens))

    def get_diagonal(self):
        isdiag = self.lidx == self.row_ids
        contrib = jnp.where(isdiag, self.value, 0)
        return jax.ops.segment_sum(contrib, self.row_ids,
                                   num_segments=self.nlocal,
                                   indices_are_sorted=True)


jax.tree_util.register_pytree_node(
    DistTableCSRMatrix,
    lambda m: ((m.value, m.lidx, m.row_ids, m.value_b, m.lidx_b,
                m.row_ids_b, m.ghost_gids, m.exports),
               (m.nlocal, m.gn, m.gn_pad, m.nprocs, m.dists, m.exp_lens,
                m.G)),
    lambda aux, c: DistTableCSRMatrix(*c, *aux))


def _table_plan(ptr, index, gn, p, nlocal):
    """Comm-table plan + g2l renumbering (lis_commtable_create analogue,
    host-side): returns (rows, shard_of, lidx_np, exports, dists,
    exp_lens, ghost_gids, G) — shared by the table-CSR and CST sharded
    layouts."""
    ptr = np.asarray(ptr)
    index = np.asarray(index).astype(np.int64)
    rows = np.repeat(np.arange(gn, dtype=np.int64), np.diff(ptr))
    shard_of = rows // nlocal
    owner = np.minimum(index // nlocal, p - 1)

    # need[k][j]: sorted unique global ids shard k imports from owner j
    need = [dict() for _ in range(p)]
    for k in range(p):
        sel = shard_of == k
        cols = index[sel]
        own = owner[sel]
        gh = own != k
        if gh.any():
            for j in np.unique(own[gh]):
                need[k][int(j)] = np.unique(cols[gh & (own == j)])

    dists = sorted({(j - k) % p for k in range(p) for j in need[k]})
    exp_lens = []
    exports = []
    ghost_base = [dict() for _ in range(p)]   # (k, d) -> tail offset
    G = 0
    for d in dists:
        Ed = max((len(need[(i - d) % p].get(i, ()))
                  for i in range(p)), default=0)
        Ed = max(Ed, 1)
        exp = np.full((p, Ed), nlocal, dtype=np.int32)   # pad -> dump slot
        for i in range(p):                                # i = owner/sender
            k = (i - d) % p                               # receiver
            gids = need[k].get(i)
            if gids is not None:
                exp[i, : len(gids)] = (gids - i * nlocal).astype(np.int32)
            ghost_base[k][d] = nlocal + G
        exports.append(exp)
        exp_lens.append(Ed)
        G += Ed

    # g2l renumbering: ghost slot = base(k, d) + position in import list
    lidx_np = np.empty(len(index), dtype=np.int32)
    for k in range(p):
        sel = np.nonzero(shard_of == k)[0]
        cols = index[sel]
        own = owner[sel]
        loc = (cols - k * nlocal).astype(np.int32)
        for j, gids in need[k].items():
            d = (j - k) % p
            m = own == j
            pos = np.searchsorted(gids, cols[m])
            loc[m] = (ghost_base[k][d] + pos).astype(np.int32)
        lidx_np[sel] = loc

    ghost_gids = np.full((p, G), gn, dtype=np.int32)
    for k in range(p):
        for d in dists:
            j = (k + d) % p
            gids = need[k].get(j)
            if gids is not None:
                b = ghost_base[k][d] - nlocal
                ghost_gids[k, b: b + len(gids)] = gids
    return (rows, shard_of, lidx_np, exports, dists, exp_lens,
            ghost_gids, G)


def distribute_csr_table(A, mesh: Mesh,
                         nlocal: int | None = None) -> DistTableCSRMatrix:
    """Build the comm-table sharded layout (the assemble step: g2l
    renumbering + export/import plan, host-side — the trace-time
    lis_commtable_create)."""
    ptr, index, value = A.to_csr_arrays()
    gn = A.nrows
    p = mesh.shape[AXIS]
    if nlocal is None:
        nlocal = -(-gn // p)
    gn_pad = p * nlocal
    value = np.asarray(value)
    (rows, shard_of, lidx_np, exports, dists, exp_lens, ghost_gids,
     G) = _table_plan(ptr, index, gn, p, nlocal)

    # interior/boundary split: the matvec computes the interior product
    # while the halo ppermutes fly (USE_OVERLAP); boundary entries index
    # the ghost tail directly
    lrow = rows - shard_of * nlocal
    is_int = lidx_np < nlocal
    cnt_i = np.bincount(shard_of[is_int], minlength=p)
    cnt_b = np.bincount(shard_of[~is_int], minlength=p)
    mi = max(int(cnt_i.max()) if p else 1, 1)
    mb = max(int(cnt_b.max()) if p else 1, 1)
    val = np.zeros((p, mi), dtype=value.dtype)
    li = np.zeros((p, mi), dtype=np.int32)
    rid = np.full((p, mi), nlocal - 1, dtype=np.int32)
    val_b = np.zeros((p, mb), dtype=value.dtype)
    li_b = np.zeros((p, mb), dtype=np.int32)
    rid_b = np.full((p, mb), nlocal - 1, dtype=np.int32)
    for k in range(p):
        for seg, (v_a, l_a, r_a, off) in (
                (np.nonzero((shard_of == k) & is_int)[0],
                 (val, li, rid, 0)),
                (np.nonzero((shard_of == k) & ~is_int)[0],
                 (val_b, li_b, rid_b, nlocal))):
            cnt = len(seg)
            v_a[k, :cnt] = value[seg]
            l_a[k, :cnt] = lidx_np[seg] - off
            r_a[k, :cnt] = lrow[seg]

    sh = NamedSharding(mesh, P(AXIS))
    put = lambda a: jax.device_put(jnp.asarray(a.reshape(-1)), sh)
    return DistTableCSRMatrix(
        value=put(val), lidx=put(li), row_ids=put(rid),
        value_b=put(val_b), lidx_b=put(li_b), row_ids_b=put(rid_b),
        ghost_gids=put(ghost_gids),
        exports=tuple(put(e) for e in exports),
        nlocal=nlocal, gn=gn, gn_pad=gn_pad, nprocs=p,
        dists=tuple(int(d) for d in dists),
        exp_lens=tuple(int(e) for e in exp_lens), G=G)


@dataclasses.dataclass(frozen=True)
class DistCSTMatrix(SparseMatrix):
    """Block-row sharded LOCALITY-FREE matrix: the comm-table halo plan
    (export/import ppermutes, boundary-proportional traffic) married to
    the per-shard CST compute kernel (matrix/cst.py) — each shard's local
    block runs the gather- and scatter-free shuffle-plan SpMV over its
    ghost-extended vector instead of a jnp.take gather.
    The reference analogue is lis_matvec_csr under MPI
    (src/matvec/lis_matvec_csr.c:53 per rank + lis_send_recv halo).

    All CST static parameters (n_pad, Kp, Benes pass list) are forced
    identical across shards so the per-shard pytrees stack into sharded
    leaves and run unchanged inside shard_map.  Per-shard bucket/row
    overflow spills to a padded gather-path remainder.

    Entries are SPLIT at distribute time into interior (all columns
    owned — the CST grid covers ONLY these, over the nlocal column
    space) and boundary (ghost columns — a padded gather segment over
    the ghost tail, O(boundary nnz)).  The matvec issues every
    per-distance ppermute first, runs the interior CST product while the
    collective-permutes fly, and only then consumes the ghost tail — the
    reference's USE_OVERLAP (src/matvec/lis_matvec.c:119-124) carried to
    the locality-free layout, matching the sibling table-CSR class."""
    cst: object               # CSTMatrix of the INTERIOR block (nlocal^2)
    at_cst: object            # CSTMatrix of the interior-block transpose
    rem_val: jax.Array        # (p*mrem,) spill values (zero-padded)
    rem_lidx: jax.Array       # (p*mrem,) int32 local col ids (< nlocal)
    rem_rows: jax.Array       # (p*mrem,) int32 local row ids (sorted)
    art_val: jax.Array        # (p*mrem2,) transpose-block spill values
    art_lidx: jax.Array       # (p*mrem2,) int32 col ids (< nlocal)
    art_rows: jax.Array       # (p*mrem2,) int32 row ids (< nlocal)
    bnd_val: jax.Array        # (p*mbnd,) boundary values (zero-padded)
    bnd_lidx: jax.Array       # (p*mbnd,) int32 ghost-tail ids (< G)
    bnd_rows: jax.Array       # (p*mbnd,) int32 local row ids (sorted)
    ghost_gids: jax.Array     # (p*G,) int32 global id per ghost slot
    exports: tuple            # per distance: (p*Ed,) int32 local x ids
    nlocal: int               # static
    gn: int
    gn_pad: int
    nprocs: int
    dists: tuple = ()
    exp_lens: tuple = ()
    G: int = 0
    mrem: int = 0
    mrem2: int = 0
    mbnd: int = 0

    halo = "table"

    # ---- local (inside-shard_map) compute -------------------------------
    def _start_exchange(self, x_local):
        """Per-distance export pack + ppermute, slabs returned without
        concatenating so the interior product can run first."""
        p = self.nprocs
        ghosts = []
        for d, eidx in zip(self.dists, self.exports):
            packed = jnp.take(x_local, eidx, axis=0, mode="clip")
            perm = [(i, (i - d) % p) for i in range(p)]
            ghosts.append(jax.lax.ppermute(packed, AXIS, perm))
        return ghosts

    def _exchange(self, x_local):
        ghosts = self._start_exchange(x_local)
        if not ghosts:
            return x_local
        return jnp.concatenate([x_local] + ghosts)

    def matvec(self, x_local):
        # comm first, interior CST compute while it flies (USE_OVERLAP)
        ghosts = self._start_exchange(x_local)
        y = self.cst.matvec(x_local)
        if self.mrem:
            prod = self.rem_val * jnp.take(x_local, self.rem_lidx, axis=0,
                                           mode="clip")
            y = y + jax.ops.segment_sum(prod, self.rem_rows,
                                        num_segments=self.nlocal,
                                        indices_are_sorted=True)
        if ghosts:
            gh = jnp.concatenate(ghosts)
            prod_b = self.bnd_val * jnp.take(gh, self.bnd_lidx, axis=0,
                                             mode="clip")
            y = y + jax.ops.segment_sum(prod_b, self.bnd_rows,
                                        num_segments=self.nlocal,
                                        indices_are_sorted=True)
        return y

    def matvech(self, x_local):
        conj = (jnp.conj if jnp.iscomplexobj(self.cst.val) else
                (lambda a: a))
        xin = jnp.conj(x_local) if jnp.iscomplexobj(self.cst.val) \
            else x_local
        z = self.at_cst.matvec(xin)[: self.nlocal]   # interior partials
        z = conj(z)
        if self.mrem2:
            prod = conj(self.art_val) * jnp.take(
                x_local, jnp.minimum(self.art_lidx, self.nlocal - 1),
                axis=0)
            z = jnp.concatenate([z, jnp.zeros(1, z.dtype)])
            z = z.at[jnp.minimum(self.art_rows, self.nlocal)].add(prod)
            z = z[: self.nlocal]
        y = jnp.concatenate([z, jnp.zeros(1, z.dtype)])
        if not self.dists:
            return y[: self.nlocal]
        # ghost partials come from the boundary segment alone
        prod_b = conj(self.bnd_val) * jnp.take(
            x_local, jnp.minimum(self.bnd_rows, self.nlocal - 1), axis=0)
        tail = jnp.zeros(self.G, dtype=prod_b.dtype)
        tail = tail.at[self.bnd_lidx].add(prod_b)
        p = self.nprocs
        off = 0
        # lis_reduce: route ghost partials back to their owners and add
        for d, Ed, eidx in zip(self.dists, self.exp_lens, self.exports):
            part = jax.lax.dynamic_slice(tail, (off,), (Ed,))
            off += Ed
            perm = [(i, (i + d) % p) for i in range(p)]
            back = jax.lax.ppermute(part, AXIS, perm)
            y = y.at[jnp.minimum(eidx, self.nlocal)].add(back)
        return y[: self.nlocal]

    @property
    def nrows(self):
        return self.gn

    @property
    def ncols(self):
        return self.gn

    @property
    def comm_elems(self) -> int:
        return int(sum(self.exp_lens))

    def get_diagonal(self):
        d = self.cst.diag[: self.nlocal]
        if self.mrem:
            isdiag = self.rem_lidx == self.rem_rows
            d = d + jax.ops.segment_sum(
                jnp.where(isdiag, self.rem_val, 0), self.rem_rows,
                num_segments=self.nlocal, indices_are_sorted=True)
        return d


jax.tree_util.register_pytree_node(
    DistCSTMatrix,
    lambda m: ((m.cst, m.at_cst, m.rem_val, m.rem_lidx, m.rem_rows,
                m.art_val, m.art_lidx, m.art_rows, m.bnd_val, m.bnd_lidx,
                m.bnd_rows, m.ghost_gids, m.exports),
               (m.nlocal, m.gn, m.gn_pad, m.nprocs, m.dists, m.exp_lens,
                m.G, m.mrem, m.mrem2, m.mbnd)),
    lambda aux, c: DistCSTMatrix(*c, *aux))


def distribute_csr_cst(A, mesh: Mesh,
                       nlocal: int | None = None) -> DistCSTMatrix:
    """Comm-table halo + per-shard CST compute (see DistCSTMatrix)."""
    import scipy.sparse as sp
    from lis_tpu.matrix.cst import CSTMatrix, _next_pow2
    ptr, index, value = A.to_csr_arrays()
    gn = A.nrows
    p = mesh.shape[AXIS]
    if nlocal is None:
        nlocal = -(-gn // p)
    gn_pad = p * nlocal
    value = np.asarray(value)
    (rows, shard_of, lidx_np, exports, dists, exp_lens, ghost_gids,
     G) = _table_plan(ptr, index, gn, p, nlocal)
    lrow = rows - shard_of * nlocal
    # interior/boundary split (USE_OVERLAP): only interior entries enter
    # the CST grid, so it spans the LOCAL column space and has no data
    # dependency on the halo exchanges
    is_int = lidx_np < nlocal
    n_pad = _next_pow2(max(nlocal, 128 * 128))
    Kp = CSTMatrix._pick_kp(len(value) / max(gn, 1))

    csts, ats, spills, spills_at = [], [], [], []
    for k in range(p):
        sel = np.nonzero((shard_of == k) & is_int)[0]   # row-major order
        lp = np.zeros(nlocal + 1, dtype=np.int64)
        np.add.at(lp, lrow[sel] + 1, 1)
        lp = np.cumsum(lp)
        blk, sp_k = CSTMatrix.from_csr_arrays(
            lp, lidx_np[sel], value[sel], (nlocal, nlocal),
            transpose=False, Kp=Kp, n_pad=n_pad, return_spill=True,
            consistent_passes=True)
        csts.append(blk)
        spills.append(sp_k)
        at_sp = sp.coo_matrix(
            (value[sel], (lidx_np[sel], lrow[sel])),
            shape=(nlocal, nlocal)).tocsr()
        at_sp.sort_indices()
        atk, sp2 = CSTMatrix.from_csr_arrays(
            at_sp.indptr, at_sp.indices, at_sp.data, (nlocal, nlocal),
            transpose=False, Kp=Kp, n_pad=n_pad, return_spill=True,
            consistent_passes=True)
        ats.append(atk)
        spills_at.append(sp2)

    metas = {tuple(c.plan.meta) for c in csts} \
        | {tuple(c.plan.meta) for c in ats}
    if len(metas) != 1:
        raise RuntimeError(
            "per-shard Benes plans disagree in pass structure — "
            "degenerate shard layout; use halo='table' instead")
    # statics must match exactly for the leaves to stack: nnz is
    # metadata-only, normalize it to the per-shard maximum
    nz = max(c.nnz for c in csts)
    csts = [dataclasses.replace(c, nnz=nz) for c in csts]
    nz = max(c.nnz for c in ats)
    ats = [dataclasses.replace(c, nnz=nz) for c in ats]

    sh = NamedSharding(mesh, P(AXIS))

    def stack(*leaves):
        a = np.stack([np.asarray(x) for x in leaves])
        return jax.device_put(jnp.asarray(a.reshape((-1,) + a.shape[2:])),
                              sh)

    cst_s = jax.tree.map(stack, *csts)
    at_s = jax.tree.map(stack, *ats)

    def pad_spill(sps, n_rows_dim):
        mr = max(max((len(s[0]) for s in sps), default=0), 1)
        v = np.zeros((p, mr), dtype=value.dtype)
        li = np.zeros((p, mr), dtype=np.int32)
        ri = np.full((p, mr), n_rows_dim - 1, dtype=np.int32)
        any_real = False
        for k, (r_, c_, v_) in enumerate(sps):
            cnt = len(r_)
            any_real = any_real or cnt > 0
            v[k, :cnt] = v_
            ri[k, :cnt] = r_.astype(np.int32)
            li[k, :cnt] = c_.astype(np.int32)
        put = lambda a: jax.device_put(jnp.asarray(a.reshape(-1)), sh)
        return put(v), put(li), put(ri), (mr if any_real else 0), mr

    rv, rl, rr, mrem, _ = pad_spill(spills, nlocal)
    av, al, ar, mrem2, _ = pad_spill(spills_at, nlocal)

    # boundary segment: ghost-column entries, row-major-sorted per shard,
    # consumed AFTER the ppermutes (padded like the table-CSR class)
    cnt_b = np.bincount(shard_of[~is_int], minlength=p)
    mbnd = max(int(cnt_b.max()) if p else 1, 1)
    bval = np.zeros((p, mbnd), dtype=value.dtype)
    bli = np.zeros((p, mbnd), dtype=np.int32)
    brow = np.full((p, mbnd), nlocal - 1, dtype=np.int32)
    any_b = False
    for k in range(p):
        seg = np.nonzero((shard_of == k) & ~is_int)[0]
        cnt = len(seg)
        any_b = any_b or cnt > 0
        bval[k, :cnt] = value[seg]
        bli[k, :cnt] = lidx_np[seg] - nlocal
        brow[k, :cnt] = lrow[seg]

    put = lambda a: jax.device_put(jnp.asarray(a.reshape(-1)), sh)
    return DistCSTMatrix(
        cst=cst_s, at_cst=at_s,
        rem_val=rv, rem_lidx=rl, rem_rows=rr,
        art_val=av, art_lidx=al, art_rows=ar,
        bnd_val=put(bval), bnd_lidx=put(bli), bnd_rows=put(brow),
        ghost_gids=put(ghost_gids),
        exports=tuple(put(e) for e in exports),
        nlocal=nlocal, gn=gn, gn_pad=gn_pad, nprocs=p,
        dists=tuple(int(d) for d in dists),
        exp_lens=tuple(int(e) for e in exp_lens), G=G,
        mrem=int(mrem), mrem2=int(mrem2),
        mbnd=int(mbnd if any_b else 0))



def distribute_csr(A, mesh: Mesh, halo: str = "auto",
                   nlocal: int | None = None) -> DistCSRMatrix:
    """Partition a CSR matrix into the sharded layout (the assemble step:
    g2l renumbering + comm plan, all host-side like the reference's
    lis_matrix_assemble).  ``nlocal`` overrides the rows-per-shard (used
    to match another sharded object's geometry, e.g. a BES remainder)."""
    ptr, index, value = A.to_csr_arrays()
    gn = A.nrows
    p = mesh.shape[AXIS]
    if nlocal is None:
        nlocal = -(-gn // p)
    gn_pad = p * nlocal

    rows = np.repeat(np.arange(gn, dtype=np.int64), np.diff(ptr))
    shard_of = rows // nlocal
    lrow = rows - shard_of * nlocal

    # bandwidth check for the neighbor-halo fast path; non-banded
    # sparsity gets the comm-table plan (boundary-proportional traffic —
    # lis_commtable semantics); the O(gn) all-gather is explicit opt-in
    bw = int(np.abs(index.astype(np.int64) - rows).max()) if len(rows) else 0
    if halo == "auto":
        halo = "neighbor" if 0 < bw <= nlocal else "table"
    if halo == "table":
        return distribute_csr_table(A, mesh, nlocal=nlocal)
    hw = min(max(bw, 1), nlocal) if halo == "neighbor" else 0

    counts = np.bincount(shard_of, minlength=p)
    mnnz = int(counts.max()) if p else 1
    mnnz = max(mnnz, 1)
    val = np.zeros((p, mnnz), dtype=value.dtype)
    idx = np.zeros((p, mnnz), dtype=np.int64)
    rid = np.zeros((p, mnnz), dtype=np.int32)
    # padding rows point at row nlocal-1 with value 0 to stay sorted
    rid[:] = nlocal - 1
    order = np.argsort(shard_of, kind="stable")
    pos = np.concatenate([[0], np.cumsum(counts)])
    for k in range(p):
        sel = order[pos[k]:pos[k + 1]]
        cnt = len(sel)
        val[k, :cnt] = value[sel]
        idx[k, :cnt] = index[sel]
        rid[k, :cnt] = lrow[sel]
        if cnt < mnnz:
            rid[k, cnt:] = nlocal - 1
            idx[k, cnt:] = min(k * nlocal, gn - 1)

    dist = DistCSRMatrix(
        value=jnp.asarray(val.reshape(-1)),
        index=jnp.asarray(idx.reshape(-1).astype(np.int32)),
        row_ids=jnp.asarray(rid.reshape(-1)),
        nlocal=nlocal, gn=gn, gn_pad=gn_pad, nprocs=p, halo=halo, hw=hw)
    # place the leaves with the sharding they will be consumed with
    sh = NamedSharding(mesh, P(AXIS))
    return jax.tree.map(lambda a: jax.device_put(a, sh), dist)


def undistribute_csr(A):
    """Collect a sharded matrix back into a host CSRMatrix (inverse of
    distribute_csr/dia; the reference's lis_matrix_merge direction)."""
    import scipy.sparse as sp
    from lis_tpu.matrix.csr import CSRMatrix
    if isinstance(A, DistHybridMatrix):
        import scipy.sparse as _sp
        d = undistribute_csr(A.dia)
        r = undistribute_csr(A.rem)
        dp, di, dv = d.to_csr_arrays()
        rp, ri, rv = r.to_csr_arrays()
        m = (_sp.csr_matrix((np.asarray(dv), np.asarray(di), np.asarray(dp)),
                            shape=(A.gn, A.gn))
             + _sp.csr_matrix((np.asarray(rv), np.asarray(ri),
                               np.asarray(rp)), shape=(A.gn, A.gn))).tocsr()
        m.sort_indices()
        return CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data,
                                         (A.gn, A.gn))
    if isinstance(A, DistMultiBESMatrix):
        from lis_tpu.matrix.csr import CSRMatrix as _CSR
        acc = None
        for part in list(A.parts) + ([A.rem] if A.rem is not None else []):
            g = undistribute_csr(part)
            gp, gi, gv = g.to_csr_arrays()
            mm = sp.csr_matrix((np.asarray(gv), np.asarray(gi),
                                np.asarray(gp)), shape=(A.gn, A.gn))
            acc = mm if acc is None else (acc + mm).tocsr()
        acc.sort_indices()
        return _CSR.from_csr_arrays(acc.indptr, acc.indices, acc.data,
                                    (A.gn, A.gn))
    if isinstance(A, DistBESMatrix):
        from lis_tpu.matrix.bes import BESMatrix
        from lis_tpu.matrix.csr import CSRMatrix as _CSR
        s = host(A.slab)
        T, W, R = s.shape
        t, w, r = np.nonzero(s)
        grow = t * R + r
        gcol = t * R + A.c0 + w
        keep = (grow < A.gn) & (gcol >= 0) & (gcol < A.gn)
        m = sp.coo_matrix((s[t, w, r][keep], (grow[keep], gcol[keep])),
                          shape=(A.gn, A.gn)).tocsr()
        if A.rem is not None:
            r2 = undistribute_csr(A.rem)
            rp, ri, rv = r2.to_csr_arrays()
            m = (m + sp.csr_matrix((np.asarray(rv), np.asarray(ri),
                                    np.asarray(rp)),
                                   shape=(A.gn, A.gn))).tocsr()
        m.sort_indices()
        return _CSR.from_csr_arrays(m.indptr, m.indices, m.data,
                                    (A.gn, A.gn))
    if isinstance(A, DistDIAMatrix):
        from lis_tpu.matrix.dia import DIAMatrix
        from lis_tpu.matrix.convert import convert_matrix
        vals = tuple(jnp.asarray(host(v)[: A.gn]) for v in A.value)
        nnz = sum(int(np.count_nonzero(host(v))) for v in vals)
        D = DIAMatrix(value=vals, nrows=A.gn, ncols=A.gn,
                      nnz=nnz, offsets=A.offsets)
        return convert_matrix(D, "csr")
    if isinstance(A, DistCSTMatrix):
        # per-shard local blocks back to global coordinates via the g2l
        # ghost ids, plus the padded spill remainders
        import dataclasses as _dc
        gg = (host(A.ghost_gids).reshape(A.nprocs, A.G) if A.G
              else np.zeros((A.nprocs, 0), np.int64))

        def _g2l_to_global(k, lrows, lcols, vals):
            grow = lrows + k * A.nlocal
            ghost = lcols >= A.nlocal
            gcol = np.where(
                ghost,
                gg[k, np.clip(lcols - A.nlocal, 0, max(A.G - 1, 0))]
                if A.G else lcols,
                lcols + k * A.nlocal)
            keep = (vals != 0) & (grow < A.gn) & (gcol < A.gn) \
                & (lrows < A.nlocal)
            return vals[keep], grow[keep], gcol[keep]

        vv, rr_, cc_ = [], [], []
        leaves, treedef = jax.tree_util.tree_flatten(A.cst)
        for k in range(A.nprocs):
            sl = [host(x).reshape((A.nprocs, -1) + x.shape[1:])[k]
                  for x in leaves]
            blk = jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(x) for x in sl])
            bp, bi, bv = blk.to_csr_arrays()
            lr = np.repeat(np.arange(A.nlocal, dtype=np.int64),
                           np.diff(np.asarray(bp)))
            v, g, c = _g2l_to_global(k, lr, np.asarray(bi, np.int64),
                                     np.asarray(bv))
            vv.append(v); rr_.append(g); cc_.append(c)
        if A.mrem:
            rvv = host(A.rem_val).reshape(A.nprocs, -1)
            rll = host(A.rem_lidx).reshape(A.nprocs, -1).astype(np.int64)
            rrr = host(A.rem_rows).reshape(A.nprocs, -1).astype(np.int64)
            for k in range(A.nprocs):
                v, g, c = _g2l_to_global(k, rrr[k], rll[k], rvv[k])
                vv.append(v); rr_.append(g); cc_.append(c)
        if A.mbnd:
            bvv = host(A.bnd_val).reshape(A.nprocs, -1)
            bll = host(A.bnd_lidx).reshape(A.nprocs, -1).astype(np.int64)
            brr = host(A.bnd_rows).reshape(A.nprocs, -1).astype(np.int64)
            for k in range(A.nprocs):
                # boundary lidx indexes the ghost tail: shift into the
                # ghost-extended range _g2l_to_global resolves via gg
                v, g, c = _g2l_to_global(k, brr[k], bll[k] + A.nlocal,
                                         bvv[k])
                vv.append(v); rr_.append(g); cc_.append(c)
        coo = sp.coo_matrix((np.concatenate(vv),
                             (np.concatenate(rr_), np.concatenate(cc_))),
                            shape=(A.gn, A.gn)).tocsr()
        coo.sum_duplicates()
        coo.sort_indices()
        return CSRMatrix.from_csr_arrays(coo.indptr, coo.indices, coo.data,
                                         (A.gn, A.gn))
    if isinstance(A, DistTableCSRMatrix):
        # rebuild global columns from the g2l renumbering + ghost ids;
        # interior and boundary segments are stored split (USE_OVERLAP)
        val = host(A.value)
        li = host(A.lidx).astype(np.int64)
        rid = host(A.row_ids).astype(np.int64)
        shard = np.repeat(np.arange(A.nprocs), len(val) // A.nprocs)
        grow = shard * A.nlocal + rid
        gcol = li + shard * A.nlocal
        if A.G:
            gg = host(A.ghost_gids).reshape(A.nprocs, A.G)
            val_b = host(A.value_b)
            li_b = host(A.lidx_b).astype(np.int64)
            rid_b = host(A.row_ids_b).astype(np.int64)
            shard_b = np.repeat(np.arange(A.nprocs),
                                len(val_b) // A.nprocs)
            val = np.concatenate([val, val_b])
            grow = np.concatenate([grow, shard_b * A.nlocal + rid_b])
            gcol = np.concatenate(
                [gcol, gg[shard_b, np.clip(li_b, 0, A.G - 1)]])
        keep = (val != 0) & (grow < A.gn) & (gcol < A.gn)
        coo = sp.coo_matrix((val[keep], (grow[keep], gcol[keep])),
                            shape=(A.gn, A.gn)).tocsr()
        coo.sort_indices()
        return CSRMatrix.from_csr_arrays(coo.indptr, coo.indices, coo.data,
                                         (A.gn, A.gn))
    val = host(A.value)
    idx = host(A.index).astype(np.int64)
    rid = host(A.row_ids).astype(np.int64)
    shard = np.repeat(np.arange(A.nprocs), len(val) // A.nprocs)
    grow = shard * A.nlocal + rid
    keep = (val != 0) & (grow < A.gn)
    coo = sp.coo_matrix((val[keep], (grow[keep], idx[keep])),
                        shape=(A.gn, A.gn)).tocsr()
    coo.sort_indices()
    return CSRMatrix.from_csr_arrays(coo.indptr, coo.indices, coo.data,
                                     (A.gn, A.gn))


def redistribute_csr(A: DistCSRMatrix, mesh: Mesh,
                     halo: str = "auto") -> DistCSRMatrix:
    """Re-partition a distributed matrix onto a (different) mesh — the
    analogue of lis_matrix_redistribute_csr (src/matrix/lis_matrix_mpi.c:1007).

    The reference shuffles rows rank-to-rank with MPI_Alltoallv; here the
    partition plan is recomputed on host and the leaves re-placed with the
    new mesh's sharding (XLA handles the device-to-device movement)."""
    return distribute_csr(undistribute_csr(A), mesh, halo=halo)


def distribute_vector(v, mesh: Mesh, gn_pad: int):
    """Zero-pad v to gn_pad and shard it into equal block rows over the
    mesh (the lis_vector block-row partition, ranges.py rule)."""
    v = jnp.asarray(v)
    if v.shape[0] < gn_pad:
        v = jnp.pad(v, (0, gn_pad - v.shape[0]))
    return jax.device_put(v, NamedSharding(mesh, P(AXIS)))


@traced
def dist_solve(A: DistCSRMatrix, b, mesh: Mesh, options=None, M=None,
               x0=None, **overrides):
    """Distributed lis_solve: runs the standard solver registry inside
    shard_map over the mesh.  Returns a SolveResult with a sharded x."""
    from lis_tpu.runtime.options import SolverOptions
    from lis_tpu.solvers.base import SOLVER_FNS, SolverSpec
    from lis_tpu.solvers.driver import SolveResult, _make_spec
    from lis_tpu.precon.base import NonePrecon
    from lis_tpu import config as C
    from lis_tpu.core import vector as vec

    if isinstance(options, SolverOptions):
        opts = options
    else:
        opts = SolverOptions.from_string(options, **overrides)
    spec = _make_spec(opts, axis_name=AXIS)

    # ---- block-Jacobi scaling (-scale 1 -storage bsr) -----------------------
    # the reference's BSR block branch (lis_solve_kernel :659-691) under
    # MPI; done host-side on the global operator and b BEFORE
    # distribution (setup-only cost, like the scalar dist scaling below)
    bscale = (opts.scale == 1 and opts.storage == 7
              and opts.precon != "is")
    if bscale:
        from lis_tpu.solvers.driver import _bscale_operator, _block_matvec
        g = undistribute_csr(A)
        gs, binv = _bscale_operator(g, opts.storage_block or 2)
        b = np.asarray(_block_matvec(binv, jnp.asarray(
            np.asarray(b)[: A.gn])))
        A = distribute_matrix(gs, mesh) if not isinstance(A, DistCSRMatrix) \
            else distribute_csr(gs, mesh, halo=A.halo)

    b = distribute_vector(b, mesh, A.gn_pad)
    x0 = jnp.zeros_like(b) if x0 is None else distribute_vector(
        x0, mesh, A.gn_pad)
    A_orig, b_orig = A, b      # uncast originals for the true residual

    if getattr(opts, "reorder", "none") != "none":
        import warnings
        warnings.warn(
            "-reorder is a pre-distribution transform: apply "
            "matrix.reorder.rcm_permutation/permute_symmetric BEFORE "
            "distribute_matrix (ignored here)", RuntimeWarning,
            stacklevel=2)
    if opts.storage and not (opts.storage == 7
                             and (opts.precon == "ilu" or bscale)):
        import warnings
        warnings.warn(
            "-storage is ignored under dist_solve: the sharded layout is "
            "chosen by distribute_matrix (exceptions: '-storage bsr -p "
            "ilu' selects the per-shard BLOCK ILU factorization, "
            "'-storage bsr -scale 1' the block-Jacobi scaling, like "
            "the reference's per-rank BSR conversion)",
            RuntimeWarning, stacklevel=2)

    # ---- scaling (lis_solve_kernel :613-721, distributed) ------------------
    # host-roundtrip scaling: correct for every sharded type (setup-only
    # cost); mirrors the single-chip driver incl. the CG+jacobi upgrade
    # and the forced Jacobi scaling for -p is
    scale = 0 if bscale else opts.scale
    if scale == 1 and opts.solver == "cg" and opts.precon == "jacobi":
        scale = 2
    if opts.precon == "is" and scale == 0 and not bscale:
        scale = 1
    dscale = None
    if scale:
        g = undistribute_csr(A)
        d = np.zeros(A.gn_pad, dtype=np.float64)
        d[: A.gn] = np.asarray(g.get_diagonal())
        if scale == 1:
            with np.errstate(divide="ignore"):
                dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)
            gs = g.scale_rows(jnp.asarray(dinv[: A.gn]))
            fac = dinv
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                ds = np.where(d != 0,
                              1.0 / np.sqrt(np.abs(np.where(d != 0, d, 1))),
                              1.0)
            gs = g.scale_symm(jnp.asarray(ds[: A.gn]))
            fac = ds
            # pad with 1, not 0: x0 divides by dscale and the padding
            # tail would otherwise produce 0/0 = nan, poisoning every
            # psum (found at gn=324 on an 8-device mesh, gn_pad=328)
            dscale = jnp.asarray(
                np.pad(ds[: A.gn], (0, A.gn_pad - A.gn),
                       constant_values=1.0))
        A = distribute_matrix(gs, mesh) if not isinstance(A, DistCSRMatrix) \
            else distribute_csr(gs, mesh, halo=A.halo)
        b = b * distribute_vector(fac, mesh, A.gn_pad).astype(b.dtype)
        if dscale is not None and x0 is not None:
            x0 = x0 / dscale.astype(x0.dtype)

    if M is None:
        if opts.precon == "none":
            M = NonePrecon()
        elif opts.precon == "jacobi":
            M = make_dist_jacobi(A, mesh)
        elif opts.precon in ("ilu", "ilut", "iluc", "ssor", "sainv", "is",
                             "bjacobi"):
            # block-Jacobi application of the local preconditioners —
            # the reference's own MPI semantics (local-rows ILU/SSOR/...)
            from lis_tpu.parallel.dist_precon import make_dist_block_precon
            M = make_dist_block_precon(
                A, mesh, opts,
                name="jacobi" if opts.precon == "bjacobi" else None)
        elif opts.precon == "hybrid":
            from lis_tpu.parallel.dist_precon import make_dist_hybrid
            M = make_dist_hybrid(A, mesh, opts)
        elif opts.precon == "saamg":
            from lis_tpu.parallel.dist_precon import make_dist_saamg
            M = make_dist_saamg(A, mesh, opts)
        else:
            raise NotImplementedError(
                f"distributed preconditioner {opts.precon!r} "
                "(supported: none, jacobi, bjacobi, ilu, ilut, iluc, ssor, "
                "sainv, is, hybrid, saamg, or pass a precon pytree whose "
                "leaves are sharded local views)")
        if opts.adds:
            # additive-Schwarz refinement with the DISTRIBUTED residual
            # matvec (the reference's lis_psolve_adds uses the global
            # lis_matvec under MPI, lis_precon_ads.c:116)
            from lis_tpu.precon.ads import AdditiveSchwarzPrecon
            M = AdditiveSchwarzPrecon(A=A, inner=M,
                                      iters=getattr(opts, "adds_iter", 1))

    # host-side prepare (solver aux): shadow space for IDR(s), sharded over
    # the vector axis; trisolve-plan solvers (gs/sor) need block-local
    # plans and are not distributed yet
    aux = None
    aux_spec = None
    if opts.solver in ("idrs", "idr1"):
        from lis_tpu.solvers.idrs import _shadow_space
        s = opts.irestart if opts.solver == "idrs" else 1
        shadow = _shadow_space(s, A.gn, np.float64)
        shadow = np.pad(shadow, ((0, 0), (0, A.gn_pad - A.gn)))
        aux = jax.device_put(jnp.asarray(shadow),
                             NamedSharding(mesh, P(None, AXIS)))
        aux_spec = P(None, AXIS)
    elif opts.solver in ("gs", "sor"):
        # block-local (D+L)⁻¹ sweeps per shard — the reference's OpenMP
        # tri-solve relaxation applied at shard granularity.  NOTE: the
        # block variant has a tighter SOR stability bound than the exact
        # sweep; the single-chip default -omega 1.9 can diverge across
        # many shards (omega <= ~1.5 is safe on the Poisson family)
        from lis_tpu.parallel.dist_precon import (local_diag_blocks,
                                                  _stack_plans)
        from lis_tpu.solvers.stationary import _lower_plan
        w = 1.0 if opts.solver == "gs" else opts.omega
        if opts.solver == "sor" and w > 1.5 and A.nprocs > 1:
            # Block-local sweeps have a tighter SOR stability bound than
            # the exact sweep the single-chip default -omega 1.9 assumes;
            # across shards omega > ~1.5 can diverge on the Poisson family.
            import warnings
            warnings.warn(
                f"distributed SOR with -omega {w:g} over {A.nprocs} shards "
                "uses block-local sweeps and can diverge; clamping to 1.5 "
                "(pass -omega <= 1.5 explicitly to silence)",
                RuntimeWarning, stacklevel=2)
            w = 1.5
        aux = _stack_plans([_lower_plan(blk, w)
                            for blk in local_diag_blocks(A)], mesh)
        aux_spec = P(AXIS)

    cast32 = lambda t: jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, t)
    if opts.precision == "single":
        # f32 distributed solve (true residual plateaus ~1e-7)
        A, b, x0, M, aux = cast32((A, b, x0, M, aux))
    elif opts.precision in ("df", "switch_df", "quad", "switch"):
        from lis_tpu.core.ddreal import DD
        from lis_tpu.solvers.base import SOLVER_FNS as _FNS
        qname = opts.solver + "_quad"
        if qname not in _FNS:
            raise NotImplementedError(f"no quad variant of {opts.solver!r}")
        limb = jnp.float32 if opts.precision in ("df", "switch_df") else None
        if isinstance(A, (DistBESMatrix, DistMultiBESMatrix)):
            A_dd = DistBESDDOperator.from_matrix(A)
        elif isinstance(A, DistDIAMatrix):
            A_dd = make_dist_dd_operator(A, mesh, limb=limb)
        elif isinstance(A, (DistTableCSRMatrix, DistCSTMatrix)):
            # general sparsity: hi+lo pairs over the comm-table halo —
            # the reference's _mp exchange (include/lis_mpi.h:45-46)
            A_dd = DistTableDDOperator.from_matrix(A, mesh, limb=limb)
        else:
            raise NotImplementedError(
                "distributed DD precision needs a DIA-, BES-, table- or "
                "cst-sharded matrix (distribute_matrix picks one)")
        b64 = b
        if limb is not None:
            A, b, x0, M, aux = cast32((A, b, x0, M, aux))
            b_dd = DD(b, (b64 - b.astype(b64.dtype)).astype(jnp.float32))
        else:
            b_dd = b
        extra_iters = 0
        if opts.precision in ("switch", "switch_df"):
            sw_tol = (opts.switch_tol if opts.precision == "switch"
                      else max(opts.switch_tol, 1.0e-6))
            sw_maxiter = (opts.switch_maxiter if opts.switch_maxiter > 0
                          else opts.maxiter)
            dspec = spec._replace(tol=sw_tol, maxiter=sw_maxiter)
            out1 = _dist_execute(A, b, x0, M, aux, aux_spec, mesh, dspec)
            x0 = out1.x
            extra_iters = int(out1.iters)
        t0 = C.wtime()
        out = _dist_execute(A_dd, b_dd, x0, M, aux, aux_spec, mesh,
                            spec._replace(solver=qname))
        x = out.x.block_until_ready()
        if dscale is not None:
            x = x * dscale.astype(x.dtype)
        elapsed = C.wtime() - t0
        iters = int(out.iters) + extra_iters
        import numpy as _np
        tr = float(_dist_true_resid(A_orig, b_orig, x, mesh))
        return SolveResult(x=x[: A_dd.gn] if A_dd.gn_pad != A_dd.gn else x,
                           status=int(out.status), iters=iters,
                           resid=float(out.resid), true_resid=tr,
                           rhistory=_np.asarray(out.rhistory)[: iters + 1],
                           time=elapsed, itime=elapsed, ptime=0.0,
                           options=opts)
    elif opts.precision != "double":
        raise NotImplementedError(
            f"distributed -f {opts.precision}: supported are double, "
            "single, df, switch_df, quad, switch")

    t0 = C.wtime()
    out = _dist_execute(A, b, x0, M, aux, aux_spec, mesh, spec)
    x = out.x.block_until_ready()
    if dscale is not None:
        x = x * dscale.astype(x.dtype)
    elapsed = C.wtime() - t0

    iters = int(out.iters)
    import numpy as _np
    tr = float(_dist_true_resid(A_orig, b_orig, x, mesh))
    return SolveResult(x=x[: A.gn] if A.gn_pad != A.gn else x,
                       status=int(out.status), iters=iters,
                       resid=float(out.resid),
                       true_resid=tr,
                       rhistory=_np.asarray(out.rhistory)[: iters + 1],
                       time=elapsed, itime=elapsed, ptime=0.0, options=opts)


@partial(jax.jit, static_argnums=(3,))
def _dist_true_resid(A, b, x, mesh):
    """‖b−Ax‖₂/‖b‖₂ on the sharded system — one sharded matvec + psum,
    the distributed analogue of the reference's true-residual check after
    the solve (src/solver/lis_solver.c:910-924)."""
    def body(A_loc, b_loc, x_loc):
        r = b_loc - A_loc.matvec(x_loc.astype(b_loc.dtype))
        nr = jax.lax.psum(jnp.sum(jnp.abs(r) ** 2), AXIS)
        nb = jax.lax.psum(jnp.sum(jnp.abs(b_loc) ** 2), AXIS)
        return jnp.sqrt(nr) / jnp.sqrt(jnp.where(nb == 0, 1.0, nb))

    in_specs = (jax.tree.map(lambda _: P(AXIS), A), P(AXIS), P(AXIS))
    return _shard_map(body, mesh, in_specs, P())(A, b, x)


def _precon_specs(M):
    """in_specs for a preconditioner pytree: P(AXIS) everywhere, except
    that any sub-object defining ``partition_specs()`` (e.g. the dist
    SA-AMG with its replicated coarse hierarchy) chooses its own."""
    if hasattr(M, "partition_specs"):
        return M.partition_specs()
    return jax.tree.map(
        lambda sub: (sub.partition_specs()
                     if hasattr(sub, "partition_specs") else
                     jax.tree.map(lambda _: P(AXIS), sub)),
        M, is_leaf=lambda x: hasattr(x, "partition_specs"))


@partial(jax.jit, static_argnums=(6, 7, 8))
def _dist_execute_dyn(A, b, x0, M, aux, dyn, aux_spec, mesh, spec_key):
    from lis_tpu.solvers.base import SOLVER_FNS, SolverOutput

    def body(A_loc, b_loc, x0_loc, M_loc, aux_loc, dyn_loc):
        spec = spec_key._replace(tol=dyn_loc["tol"], tol_w=dyn_loc["tol_w"],
                                 maxiter=dyn_loc["maxiter"])
        return SOLVER_FNS[spec_key.solver](A_loc, b_loc, x0_loc, M_loc,
                                           spec, aux=aux_loc)

    in_specs = (jax.tree.map(lambda _: P(AXIS), A),
                jax.tree.map(lambda _: P(AXIS), b),
                jax.tree.map(lambda _: P(AXIS), x0),
                _precon_specs(M),
                jax.tree.map(lambda _: aux_spec, aux),
                jax.tree.map(lambda _: P(), dyn))
    out_specs = SolverOutput(x=P(AXIS), status=P(), iters=P(),
                             resid=P(), rhistory=P())
    return _shard_map(body, mesh, in_specs, out_specs)(A, b, x0, M, aux,
                                                       dyn)


def _dist_execute(A, b, x0, M, aux, aux_spec, mesh, spec):
    """Distributed solver run with tol/tol_w/maxiter dynamic (shared
    compile cache across tolerance/budget changes — see driver._execute)."""
    from lis_tpu.solvers.driver import _bucket
    spec_key = spec._replace(tol=0.0, tol_w=0.0, maxiter=0,
                             rh_cap=_bucket(spec.maxiter))
    dyn = {"tol": jnp.asarray(spec.tol),
           "tol_w": jnp.asarray(spec.tol_w),
           "maxiter": jnp.asarray(spec.maxiter, jnp.int32)}
    return _dist_execute_dyn(A, b, x0, M, aux, dyn, aux_spec, mesh,
                             spec_key)


def make_dist_jacobi(A, mesh: Mesh):
    """Jacobi preconditioner with a sharded dinv (computed on host)."""
    from lis_tpu.precon.jacobi import JacobiPrecon
    g = undistribute_csr(A)
    d = np.zeros(A.gn_pad, dtype=np.asarray(g.value).dtype)
    d[: A.gn] = np.asarray(g.get_diagonal())
    with np.errstate(divide="ignore"):
        dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)
    return JacobiPrecon(dinv=jax.device_put(
        jnp.asarray(dinv), NamedSharding(mesh, P(AXIS))))


@dataclasses.dataclass(frozen=True)
class DistDIAMatrix(SparseMatrix):
    """Block-row sharded DIA — the distributed stencil operator.

    Per shard the local view is (nnd, nlocal) diagonal streams; the halo is
    the two ring-neighbor slabs of width hw = max|offset| exchanged with
    ppermute, and each diagonal contributes by a dynamic slice of the
    extended local x — no gathers anywhere.  Out-of-range
    positions carry zero values (the DIA convention), so wrapped ring slabs
    at the global edges are harmlessly multiplied away."""
    value: tuple              # per-diagonal (p·nlocal,) arrays sharded P("p")
    offsets: tuple            # static: global diagonal offsets
    nlocal: int
    gn: int
    gn_pad: int
    nprocs: int
    hw: int                   # halo width = max(|off|) (≤ nlocal)

    def _exchange(self, x_local):
        p, hw = self.nprocs, self.hw
        perm_up = [(i, (i + 1) % p) for i in range(p)]
        perm_dn = [(i, (i - 1) % p) for i in range(p)]
        from_left = jax.lax.ppermute(x_local[-hw:], AXIS, perm_up)
        from_right = jax.lax.ppermute(x_local[:hw], AXIS, perm_dn)
        return jnp.concatenate([from_left, x_local, from_right])

    def matvec(self, x_local):
        # comm/compute overlap (the reference's USE_OVERLAP analogue): the
        # BULK result needs only x_local (zero-padded), so XLA can overlap
        # the two ring ppermutes with it; only the first/last hw outputs
        # get slab corrections afterwards.
        p, hw, nl = self.nprocs, self.hw, self.nlocal
        perm_up = [(i, (i + 1) % p) for i in range(p)]
        perm_dn = [(i, (i - 1) % p) for i in range(p)]
        left = jax.lax.ppermute(x_local[-hw:], AXIS, perm_up)
        right = jax.lax.ppermute(x_local[:hw], AXIS, perm_dn)

        dt = jnp.result_type(self.value[0].dtype, x_local.dtype) \
            if self.value else x_local.dtype
        xp = jnp.pad(x_local, (hw, hw))
        y = jnp.zeros(nl, dtype=dt)
        for k, off in enumerate(self.offsets):
            y = y + self.value[k] * jax.lax.dynamic_slice(
                xp, (hw + off,), (nl,))
        # edge corrections from the exchanged slabs
        for k, off in enumerate(self.offsets):
            if off < 0:
                m = -off            # output rows [0, m) read left slab
                y = y.at[:m].add(self.value[k][:m] * left[hw + off:])
            elif off > 0:
                m = off             # output rows [nl-m, nl) read right slab
                y = y.at[nl - m:].add(self.value[k][nl - m:] * right[:m])
        return y

    def matvech(self, x_local):
        # Aᵀ[i, i-o] = A[i-o, i] = value[k][i-o]: exchanged value slabs
        # realign the diagonal streams across the shard boundary.  All
        # diagonals' edge slabs ride ONE batched ppermute pair (a
        # per-diagonal exchange would issue 2·nnd collectives per apply).
        xe = self._exchange(x_local)
        p, hw, nl = self.nprocs, self.hw, self.nlocal
        vs_ = [jnp.conj(vk) if jnp.iscomplexobj(vk) else vk
               for vk in self.value]
        perm_up = [(i, (i + 1) % p) for i in range(p)]
        perm_dn = [(i, (i - 1) % p) for i in range(p)]
        left = jax.lax.ppermute(jnp.stack([vk[-hw:] for vk in vs_]),
                                AXIS, perm_up)
        right = jax.lax.ppermute(jnp.stack([vk[:hw] for vk in vs_]),
                                 AXIS, perm_dn)
        dt = jnp.result_type(vs_[0].dtype, x_local.dtype) if vs_ \
            else x_local.dtype
        y = jnp.zeros(nl, dtype=dt)
        for k, off in enumerate(self.offsets):
            ve = jnp.concatenate([left[k], vs_[k], right[k]])
            vv = jax.lax.dynamic_slice(ve, (hw - off,), (nl,))
            xs = jax.lax.dynamic_slice(xe, (hw - off,), (nl,))
            y = y + vv * xs
        return y

    @property
    def nrows(self):
        return self.gn

    @property
    def ncols(self):
        return self.gn

    def get_diagonal(self):
        """LOCAL diagonal slice (inside shard_map)."""
        k0 = self.offsets.index(0) if 0 in self.offsets else None
        if k0 is None:
            return jnp.zeros(self.nlocal, self.value[0].dtype
                             if self.value else jnp.float64)
        return self.value[k0]


jax.tree_util.register_pytree_node(
    DistDIAMatrix,
    lambda m: ((m.value,),
               (m.offsets, m.nlocal, m.gn, m.gn_pad, m.nprocs, m.hw)),
    lambda aux, c: DistDIAMatrix(c[0], *aux))


def distribute_dia(A, mesh: Mesh) -> DistDIAMatrix:
    """Partition a matrix into sharded DIA (the distributed fast path for
    banded operators)."""
    from lis_tpu.matrix.convert import convert_matrix
    D = A if getattr(A, "format_name", None) == "dia" \
        else convert_matrix(A, "dia")
    gn = D.nrows
    p = mesh.shape[AXIS]
    nlocal = -(-gn // p)
    gn_pad = p * nlocal
    offsets = tuple(int(o) for o in D.offsets)
    hw = max((abs(o) for o in offsets), default=1) or 1
    if hw > nlocal:
        raise ValueError(f"bandwidth {hw} exceeds shard size {nlocal}; "
                         "use distribute_csr with halo='gather'")
    v2d = D.value_2d
    val = np.zeros((len(offsets), gn_pad), dtype=v2d.dtype)
    val[:, :gn] = v2d
    dist = DistDIAMatrix(value=tuple(jnp.asarray(val[k])
                                     for k in range(len(offsets))),
                         offsets=offsets, nlocal=nlocal, gn=gn,
                         gn_pad=gn_pad, nprocs=p, hw=hw)
    sh = NamedSharding(mesh, P(AXIS))
    return jax.tree.map(lambda a: jax.device_put(a, sh), dist)


def distribute_matrix(A, mesh: Mesh, halo: str = "auto"):
    """Distributed layout choice, by the same measured rates as the
    single-device router (solvers/driver.auto_storage): banded operators
    become sharded DIA (stream SpMV over ring halos), quasi-banded ones
    DIA plus a comm-table CSR remainder, everything else block-row CSR.
    The sharded slab (distribute_slabs) and CST (distribute_csr_cst)
    layouts stay available by explicit choice: neither beat CSR on the
    card."""
    from lis_tpu.matrix.convert import diag_profile, is_banded
    nlocal = -(-A.nrows // mesh.shape[AXIS])
    offs, _ = diag_profile(A)
    bw = int(np.abs(offs).max()) if offs is not None and len(offs) else 0
    if is_banded(A) and 0 < bw <= nlocal:
        return distribute_dia(A, mesh)
    # quasi-banded: dominant diagonals stream, small remainder gathers
    from lis_tpu.matrix.hybrid import HybridMatrix
    try:
        H = HybridMatrix.try_split(*A.to_csr_arrays(), A.shape)
    except NotImplementedError:
        H = None
    if H is not None:
        hbw = max((abs(o) for o in H.dia.offsets), default=0)
        if 0 < hbw <= nlocal:
            return DistHybridMatrix(
                dia=distribute_dia(H.dia, mesh),
                rem=distribute_csr(H.rem, mesh, halo="table"))
    return distribute_csr(A, mesh, halo=halo)


def distribute_slabs(A, mesh: Mesh):
    """Shard a general matrix as dense sliding slabs with ring window
    halos: one DistBESMatrix, or a DistMultiBESMatrix with one sharded
    slab per affine band plus a comm-table CSR remainder."""
    from lis_tpu.matrix.bes import multi_bes_from_csr, BESMatrix
    bes = multi_bes_from_csr(*A.to_csr_arrays(), A.shape,
                             max_bytes=4 << 30)
    if isinstance(bes, BESMatrix):
        return distribute_bes(bes, mesh)
    parts = [distribute_bes(p, mesh) for p in bes.parts]
    rem = (None if bes.rem is None
           else distribute_csr(bes.rem, mesh, halo="table",
                               nlocal=parts[0].nlocal))
    return DistMultiBESMatrix(tuple(parts), rem, bes.nrows,
                              parts[0].gn_pad, parts[0].nlocal,
                              parts[0].nprocs)


@dataclasses.dataclass(frozen=True)
class DistTableDDOperator:
    """DD (limb-pair) matvec over the comm-table halo — the reference's
    quad-under-MPI capability for ANY sparsity (the _mp send/recv halo
    variants exchange hi+lo pairs, include/lis_mpi.h:45-46): each
    distance's export slab carries BOTH limbs stacked in one ppermute,
    and the per-shard compute runs the exact ELL double-double
    accumulation (core/ddreal.matvec_dd_ell) over the ghost-extended
    vector.  The transpose apply routes ghost-column DD partials back
    through the reversed permutes and adds them with two_sum."""
    index: jax.Array          # (p*nlocal, maxk) int32 into ghost-ext x
    value: jax.Array          # (p*nlocal, maxk) hi limbs
    value_lo: object          # lo limbs or None (full-f64 mode)
    index_t: jax.Array        # (p*(nlocal+G), maxk_t) int32 into x
    value_t: jax.Array
    value_t_lo: object
    exports: tuple            # per distance: (p*Ed,) int32 local x ids
    nlocal: int
    gn: int
    gn_pad: int
    nprocs: int
    dists: tuple = ()
    exp_lens: tuple = ()
    G: int = 0

    def _exchange_dd(self, x):
        """Ghost-extend both limbs; ONE ppermute per distance carries
        the packed (2, Ed) hi/lo slab (the _mp exchange)."""
        from lis_tpu.core.ddreal import DD
        p = self.nprocs
        hs, ls = [x.hi], [x.lo]
        for d, eidx in zip(self.dists, self.exports):
            packed = jnp.stack([
                jnp.take(x.hi, eidx, axis=0, mode="clip"),
                jnp.take(x.lo, eidx, axis=0, mode="clip")])
            perm = [(i, (i - d) % p) for i in range(p)]
            got = jax.lax.ppermute(packed, AXIS, perm)
            hs.append(got[0])
            ls.append(got[1])
        return DD(jnp.concatenate(hs), jnp.concatenate(ls))

    def matvec(self, x):
        from lis_tpu.core.ddreal import matvec_dd_ell
        xe = self._exchange_dd(x)
        return matvec_dd_ell(self.index, self.value, xe, self.value_lo)

    def matvech(self, x):
        from lis_tpu.core.ddreal import (DD, matvec_dd_ell, two_sum)
        z = matvec_dd_ell(self.index_t, self.value_t, x, self.value_t_lo)
        yh, yl = z.hi[: self.nlocal], z.lo[: self.nlocal]
        p = self.nprocs
        off = self.nlocal
        for d, Ed, eidx in zip(self.dists, self.exp_lens, self.exports):
            part = jnp.stack([
                jax.lax.dynamic_slice(z.hi, (off,), (Ed,)),
                jax.lax.dynamic_slice(z.lo, (off,), (Ed,))])
            off += Ed
            perm = [(i, (i + d) % p) for i in range(p)]
            back = jax.lax.ppermute(part, AXIS, perm)
            # export ids are unique within a distance: densify and add
            # with an error-free transform (exact DD accumulation)
            safe = jnp.minimum(eidx, self.nlocal - 1)
            live = (eidx < self.nlocal).astype(back.dtype)
            bh = jnp.zeros(self.nlocal, back.dtype).at[safe].set(
                back[0] * live)
            bl = jnp.zeros(self.nlocal, back.dtype).at[safe].set(
                back[1] * live)
            sh_, se = two_sum(yh, bh)
            yl = yl + bl + se
            yh = sh_
        from lis_tpu.core.ddreal import quick_two_sum
        yh, yl = quick_two_sum(yh, yl)
        return DD(yh, yl)

    @property
    def nrows(self):
        return self.gn

    @property
    def ncols(self):
        return self.gn

    @classmethod
    def from_matrix(cls, A, mesh: Mesh, limb=None):
        """Build from any table-planned sharded matrix (DistTableCSR or
        DistCST) by re-deriving the per-shard local blocks in g2l
        numbering from the global operator + the same comm-table plan."""
        import scipy.sparse as sp
        from lis_tpu.core.ddreal import _split_limbs
        g = undistribute_csr(A)
        ptr, index, value = g.to_csr_arrays()
        value = np.asarray(value)
        gn, p, nlocal = A.gn, A.nprocs, A.nlocal
        (rows, shard_of, lidx_np, exports, dists, exp_lens, _gg,
         G) = _table_plan(ptr, index, gn, p, nlocal)
        lrow = rows - shard_of * nlocal
        ncl = nlocal + G
        # per-shard ELL over the ghost-extended columns, common maxk
        cnt = np.zeros((p, nlocal), dtype=np.int64)
        np.add.at(cnt, (shard_of, lrow), 1)
        maxk = max(int(cnt.max()), 1)
        cnt_t = np.zeros((p, ncl), dtype=np.int64)
        np.add.at(cnt_t, (shard_of, lidx_np.astype(np.int64)), 1)
        maxk_t = max(int(cnt_t.max()), 1)
        idx = np.zeros((p, nlocal, maxk), dtype=np.int32)
        val = np.zeros((p, nlocal, maxk), dtype=value.dtype)
        idx_t = np.zeros((p, ncl, maxk_t), dtype=np.int32)
        val_t = np.zeros((p, ncl, maxk_t), dtype=value.dtype)
        for k in range(p):
            sel = np.nonzero(shard_of == k)[0]
            a = sp.coo_matrix((value[sel], (lrow[sel], lidx_np[sel])),
                              shape=(nlocal, ncl)).tocsr()
            a.sort_indices()
            for r in range(nlocal):
                s0, s1 = a.indptr[r], a.indptr[r + 1]
                idx[k, r, : s1 - s0] = a.indices[s0:s1]
                val[k, r, : s1 - s0] = a.data[s0:s1]
            at = a.T.tocsr()
            at.sort_indices()
            for r in range(ncl):
                s0, s1 = at.indptr[r], at.indptr[r + 1]
                idx_t[k, r, : s1 - s0] = at.indices[s0:s1]
                val_t[k, r, : s1 - s0] = at.data[s0:s1]
        v, vlo = _split_limbs(jnp.asarray(val), limb)
        vt, vtlo = _split_limbs(jnp.asarray(val_t), limb)
        sh = NamedSharding(mesh, P(AXIS))
        put = lambda a: jax.device_put(
            jnp.asarray(a).reshape((-1,) + a.shape[2:]), sh)
        return cls(
            index=put(idx), value=put(np.asarray(v)),
            value_lo=None if vlo is None else put(np.asarray(vlo)),
            index_t=put(idx_t), value_t=put(np.asarray(vt)),
            value_t_lo=None if vtlo is None else put(np.asarray(vtlo)),
            exports=tuple(jax.device_put(jnp.asarray(e.reshape(-1)), sh)
                          for e in exports),
            nlocal=nlocal, gn=gn, gn_pad=A.gn_pad, nprocs=p,
            dists=tuple(int(d) for d in dists),
            exp_lens=tuple(int(e) for e in exp_lens), G=G)


jax.tree_util.register_pytree_node(
    DistTableDDOperator,
    lambda m: ((m.index, m.value, m.value_lo, m.index_t, m.value_t,
                m.value_t_lo, m.exports),
               (m.nlocal, m.gn, m.gn_pad, m.nprocs, m.dists, m.exp_lens,
                m.G)),
    lambda aux, c: DistTableDDOperator(*c, *aux))



@dataclasses.dataclass(frozen=True)
class DistDIADDOperator:
    """DD (limb-pair) matvec over a block-row sharded DIA operator — the
    distributed double-float path: x's hi and lo limbs ride the same ring
    halos, matrix values are f32 pairs, and products accumulate through
    two_prod error-free transforms.  Reductions inside the DD solvers go
    through ddreal._dd_sum's axis_name branch (the analogue of the
    reference's custom quad MPI_Op, lis_precision_vec.c:778)."""
    value: tuple              # per-diagonal (p·nlocal,) hi limbs
    value_lo: tuple           # per-diagonal (p·nlocal,) lo limbs
    offsets: tuple
    nlocal: int
    gn: int
    gn_pad: int
    nprocs: int
    hw: int

    def _exchange(self, v):
        p, hw = self.nprocs, self.hw
        perm_up = [(i, (i + 1) % p) for i in range(p)]
        perm_dn = [(i, (i - 1) % p) for i in range(p)]
        left = jax.lax.ppermute(v[-hw:], AXIS, perm_up)
        right = jax.lax.ppermute(v[:hw], AXIS, perm_dn)
        return jnp.concatenate([left, v, right])

    def matvec(self, x):
        from lis_tpu.core import ddreal as q
        xh = self._exchange(x.hi)
        xl = self._exchange(x.lo)
        nl, hw = self.nlocal, self.hw
        acc = q.DD(jnp.zeros(nl, x.hi.dtype), jnp.zeros(nl, x.hi.dtype))
        for k, off in enumerate(self.offsets):
            sh = jax.lax.dynamic_slice(xh, (hw + off,), (nl,))
            sl = jax.lax.dynamic_slice(xl, (hw + off,), (nl,))
            ph, pe = q.two_prod(self.value[k], sh)
            pe = pe + self.value[k] * sl + self.value_lo[k] * sh
            acc = q.add(acc, q.DD(ph, pe))
        return acc

    def matvech(self, x):
        from lis_tpu.core import ddreal as q
        xh = self._exchange(x.hi)
        xl = self._exchange(x.lo)
        p, nl, hw = self.nprocs, self.nlocal, self.hw
        perm_up = [(i, (i + 1) % p) for i in range(p)]
        perm_dn = [(i, (i - 1) % p) for i in range(p)]
        # one batched ppermute pair per limb for all diagonals' edge slabs
        lh = jax.lax.ppermute(jnp.stack([v[-hw:] for v in self.value]),
                              AXIS, perm_up)
        rh = jax.lax.ppermute(jnp.stack([v[:hw] for v in self.value]),
                              AXIS, perm_dn)
        ll = jax.lax.ppermute(jnp.stack([v[-hw:] for v in self.value_lo]),
                              AXIS, perm_up)
        rl = jax.lax.ppermute(jnp.stack([v[:hw] for v in self.value_lo]),
                              AXIS, perm_dn)
        acc = q.DD(jnp.zeros(nl, x.hi.dtype), jnp.zeros(nl, x.hi.dtype))
        for k, off in enumerate(self.offsets):
            vhe = jnp.concatenate([lh[k], self.value[k], rh[k]])
            vle = jnp.concatenate([ll[k], self.value_lo[k], rl[k]])
            vs = jax.lax.dynamic_slice(vhe, (hw - off,), (nl,))
            vls = jax.lax.dynamic_slice(vle, (hw - off,), (nl,))
            xs = jax.lax.dynamic_slice(xh, (hw - off,), (nl,))
            xls = jax.lax.dynamic_slice(xl, (hw - off,), (nl,))
            ph, pe = q.two_prod(vs, xs)
            pe = pe + vs * xls + vls * xs
            acc = q.add(acc, q.DD(ph, pe))
        return acc


jax.tree_util.register_pytree_node(
    DistDIADDOperator,
    lambda m: ((m.value, m.value_lo),
               (m.offsets, m.nlocal, m.gn, m.gn_pad, m.nprocs, m.hw)),
    lambda aux, c: DistDIADDOperator(c[0], c[1], *aux))


def make_dist_dd_operator(A: DistDIAMatrix, mesh: Mesh,
                          limb=None) -> DistDIADDOperator:
    sh = NamedSharding(mesh, P(AXIS))
    vhi, vlo = [], []
    for vk in A.value:
        v64 = host(vk)
        if limb is not None:
            h = v64.astype(np.float32)
            l = (v64 - h.astype(v64.dtype)).astype(np.float32)
        else:
            h, l = v64, np.zeros_like(v64)
        vhi.append(jax.device_put(jnp.asarray(h), sh))
        vlo.append(jax.device_put(jnp.asarray(l), sh))
    return DistDIADDOperator(
        value=tuple(vhi), value_lo=tuple(vlo),
        offsets=A.offsets, nlocal=A.nlocal, gn=A.gn, gn_pad=A.gn_pad,
        nprocs=A.nprocs, hw=A.hw)


@dataclasses.dataclass(frozen=True)
class DistHybridMatrix(SparseMatrix):
    """Sharded HDI: dominant diagonals as a DistDIAMatrix + remainder as a
    gather-halo DistCSRMatrix — the distributed form of the hybrid layout
    (matrix/hybrid.py)."""
    dia: object
    rem: object

    def matvec(self, x_local):
        return self.dia.matvec(x_local) + self.rem.matvec(x_local)

    def matvech(self, x_local):
        return self.dia.matvech(x_local) + self.rem.matvech(x_local)

    def get_diagonal(self):
        return self.dia.get_diagonal() + self.rem.get_diagonal()

    @property
    def nrows(self):
        return self.dia.gn

    @property
    def ncols(self):
        return self.dia.gn

    @property
    def gn(self):
        return self.dia.gn

    @property
    def gn_pad(self):
        return self.dia.gn_pad

    @property
    def nlocal(self):
        return self.dia.nlocal

    @property
    def nprocs(self):
        return self.dia.nprocs


jax.tree_util.register_pytree_node(
    DistHybridMatrix,
    lambda m: ((m.dia, m.rem), ()),
    lambda aux, c: DistHybridMatrix(*c))


@dataclasses.dataclass(frozen=True)
class DistBESMatrix(SparseMatrix):
    """Block-row sharded BES (dense sliding slabs — matrix/bes.py).

    Shard k's tiles need the x window [k*nlocal + c0, k*nlocal + c0 +
    nlocal + W - R): a contiguous run of length L = nlocal + W - R at
    offset c0 from the shard's own start.  Decomposing c0 = shift*nlocal
    + c0r (c0r in [0, nlocal)), the run lives inside shards k+shift and
    k+shift+1, fetched with TWO shifted ring ppermutes — so windows may
    sit at ARBITRARY offsets (far off-diagonal bands of a multi-window
    build), not just the +-1-neighbor band.  Requires W - R <= nlocal.
    The remainder (out-of-window entries) rides a gather-mode
    DistCSRMatrix."""
    slab: jax.Array           # (p·tlocal, W, R) sharded on axis 0
    rem: object               # DistCSRMatrix or None
    nlocal: int               # rows per shard = tlocal·R
    gn: int
    gn_pad: int
    nprocs: int
    R: int
    W: int
    c0: int

    def _fetch(self, x_local, shift):
        """x of shard (k + shift) for every k (identity when shift==0)."""
        p = self.nprocs
        s = shift % p
        if s == 0:
            return x_local
        perm = [(i, (i - s) % p) for i in range(p)]
        return jax.lax.ppermute(x_local, AXIS, perm)

    def _window_run(self, x_local):
        """(L,) run [k*nlocal + c0, ... + L) for the local shard.  Three
        consecutive source shards always cover it: c0r < nlocal and
        L <= 2*nlocal by the W - R <= nlocal guard."""
        L = self.nlocal + self.W - self.R
        shift, c0r = divmod(self.c0, self.nlocal)
        xe = jnp.concatenate([self._fetch(x_local, shift + j)
                              for j in range(3)])
        return jax.lax.dynamic_slice(xe, (c0r,), (L,))

    def matvec(self, x_local):
        R, W = self.R, self.W
        tl = self.nlocal // R
        run = self._window_run(x_local)           # (nlocal + W - R,)
        xw = jnp.concatenate(
            [jax.lax.dynamic_slice(run, (c * R,), (tl * R,))
             .reshape(tl, R) for c in range(W // R)], axis=1)
        y = jnp.sum(self.slab * xw[:, :, None], axis=1).reshape(-1)
        if self.rem is not None:
            y = y + self.rem.matvec(x_local)
        return y

    def matvech(self, x_local):
        s = jnp.conj(self.slab) if jnp.iscomplexobj(self.slab) else self.slab
        R, W = self.R, self.W
        tl = self.nlocal // R
        p = self.nprocs
        xr = x_local.reshape(tl, R)
        win = jnp.sum(s * xr[:, None, :], axis=2)          # (tl, W)
        # overlap-add into the local window run, then return the two
        # segments to their owner shards (the lis_reduce analogue)
        L = self.nlocal + W - R
        shift, c0r = divmod(self.c0, self.nlocal)
        ye = jnp.zeros(3 * self.nlocal, dtype=win.dtype)
        run = jnp.zeros(L, dtype=win.dtype)
        for c in range(W // R):
            seg = win[:, c * R:(c + 1) * R].reshape(-1)
            cur = jax.lax.dynamic_slice(run, (c * R,), (tl * R,))
            run = jax.lax.dynamic_update_slice(run, cur + seg, (c * R,))
        ye = jax.lax.dynamic_update_slice(ye, run, (c0r,))
        # partials for shards k+shift+j, j=0,1,2: send each back
        y = None
        for j in range(3):
            yj = ye[j * self.nlocal:(j + 1) * self.nlocal]
            sj = (shift + j) % p
            if sj:
                yj = jax.lax.ppermute(
                    yj, AXIS, [(i, (i + sj) % p) for i in range(p)])
            y = yj if y is None else y + yj
        if self.rem is not None:
            y = y + self.rem.matvech(x_local)
        return y

    def get_diagonal(self):
        R, W = self.R, self.W
        r = jnp.arange(R)
        w = r - self.c0
        ok = (w >= 0) & (w < W)
        d = jnp.where(ok, self.slab[:, jnp.clip(w, 0, W - 1), r],
                      0.0).reshape(-1)
        if self.rem is not None:
            d = d + self.rem.get_diagonal()
        return d

    @property
    def nrows(self):
        return self.gn

    @property
    def ncols(self):
        return self.gn


jax.tree_util.register_pytree_node(
    DistBESMatrix,
    lambda m: ((m.slab, m.rem),
               (m.nlocal, m.gn, m.gn_pad, m.nprocs, m.R, m.W, m.c0)),
    lambda aux, c: DistBESMatrix(c[0], c[1], *aux))


def distribute_bes(A, mesh: Mesh):
    """Shard a BESMatrix (or build one from A) block-row over the mesh.
    Requires the window overhang (hl/hr) to fit within one shard."""
    from lis_tpu.matrix.bes import BESMatrix
    from lis_tpu.matrix.convert import convert_matrix
    B = A if getattr(A, "format_name", None) == "bes" \
        else convert_matrix(A, "bes")
    p = mesh.shape[AXIS]
    T, W, R = B.slab.shape
    tlocal = -(-T // p)
    nlocal = tlocal * R
    gn_pad = p * nlocal
    if W - R > nlocal:
        raise ValueError(f"bes window width {W} exceeds shard rows "
                         f"{nlocal}+R; use distribute_csr")
    slab = np.zeros((p * tlocal, W, R), dtype=host(B.slab).dtype)
    slab[:T] = host(B.slab)
    rem = None
    if B.rem is not None:
        rem = distribute_csr(B.rem, mesh, halo="table", nlocal=nlocal)
    shslab = NamedSharding(mesh, P(AXIS, None, None))
    return DistBESMatrix(
        slab=jax.device_put(jnp.asarray(slab), shslab), rem=rem,
        nlocal=nlocal, gn=B.nrows, gn_pad=gn_pad, nprocs=p, R=R, W=W,
        c0=B.c0)


@dataclasses.dataclass(frozen=True)
class DistBESDDOperator:
    """DD matvec over a sharded BES slab: accumulate in f64 (tighter
    than the f32-pair 2^-48) and
    split back to the limb pair — the distributed twin of
    core.ddreal.DDBesOperator."""
    bes: object               # DistBESMatrix, slab cast to f64
    gn: int
    gn_pad: int
    nlocal: int
    nprocs: int

    def _lift(self, x):
        return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)

    def matvec(self, x):
        from lis_tpu.core.ddreal import DD
        y = self.bes.matvec(self._lift(x))
        h = y.astype(x.hi.dtype)
        return DD(h, (y - h.astype(jnp.float64)).astype(x.hi.dtype))

    def matvech(self, x):
        from lis_tpu.core.ddreal import DD
        y = self.bes.matvech(self._lift(x))
        h = y.astype(x.hi.dtype)
        return DD(h, (y - h.astype(jnp.float64)).astype(x.hi.dtype))

    @classmethod
    def from_matrix(cls, A) -> "DistBESDDOperator":
        b64 = jax.tree.map(
            lambda a: a.astype(jnp.float64)
            if hasattr(a, "dtype") and jnp.issubdtype(a.dtype,
                                                      jnp.floating)
            else a, A)
        return cls(bes=b64, gn=A.gn, gn_pad=A.gn_pad, nlocal=A.nlocal,
                   nprocs=A.nprocs)


jax.tree_util.register_pytree_node(
    DistBESDDOperator,
    lambda m: ((m.bes,), (m.gn, m.gn_pad, m.nlocal, m.nprocs)),
    lambda aux, c: DistBESDDOperator(c[0], *aux))


@dataclasses.dataclass(frozen=True)
class DistMultiBESMatrix(SparseMatrix):
    """Sharded multi-window BES: one DistBESMatrix per affine band plus a
    gather-mode CSR remainder — the distributed form of MultiBESMatrix."""
    parts: tuple
    rem: object
    gn: int
    gn_pad: int
    nlocal: int
    nprocs: int

    def matvec(self, x_local):
        y = self.parts[0].matvec(x_local)
        for p in self.parts[1:]:
            y = y + p.matvec(x_local)
        if self.rem is not None:
            y = y + self.rem.matvec(x_local)
        return y

    def matvech(self, x_local):
        y = self.parts[0].matvech(x_local)
        for p in self.parts[1:]:
            y = y + p.matvech(x_local)
        if self.rem is not None:
            y = y + self.rem.matvech(x_local)
        return y

    def get_diagonal(self):
        d = self.parts[0].get_diagonal()
        for p in self.parts[1:]:
            d = d + p.get_diagonal()
        if self.rem is not None:
            d = d + self.rem.get_diagonal()
        return d

    @property
    def nrows(self):
        return self.gn

    @property
    def ncols(self):
        return self.gn


jax.tree_util.register_pytree_node(
    DistMultiBESMatrix,
    lambda m: ((m.parts, m.rem),
               (m.gn, m.gn_pad, m.nlocal, m.nprocs)),
    lambda aux, c: DistMultiBESMatrix(c[0], c[1], *aux))
