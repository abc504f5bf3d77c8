"""Fixed-permutation shuffle engine: an arbitrary permutation as passes
of within-row gathers.

The engine realises an ARBITRARY (build-time-fixed) permutation of
M = 2^t elements as a mixed-radix Benes network whose every stage
permutes elements only WITHIN each 128-wide row of an (M/128, 128) view:

- factor M into digits d_1 ... d_k (powers of two, <= 128);
- a Benes network permutes digit 1, digit 2, ..., digit k, ..., digit 2,
  digit 1 (2k-1 passes); each pass permutes elements only within groups
  that share all other digits;
- routing (which group position each element takes in each pass) is the
  classic recursive edge coloring of d-regular bipartite multigraphs,
  computed at build time by log2(d) Euler-circuit splits per level
  (native C++ ``euler_split``; lis_native.cpp);
- each pass is applied as reshape/transpose plus one row-local
  ``take_along_axis`` over the (M/128, 128) view.

It was built for a device without a fast general gather: every pass is
regular data movement.  On an H100 the general gather is a hardware load
and CST, the engine's user, loses to CSR (CHANGES.md), so the storage
router (solvers/driver.py) does not pick it.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

_XLA_TAKE_MAX = 1 << 14       # below this, one XLA take beats the passes


# ---------------------------------------------------------------------------
# Routing (host, build time)
# ---------------------------------------------------------------------------

def _euler_split_py(u, v, nu, nv):
    """Pure-Python Hierholzer fallback (slow; tests/production use the
    native engine)."""
    m = len(u)
    n = nu + nv
    deg = np.zeros(n + 1, dtype=np.int64)
    np.add.at(deg, u + 1, 1)
    np.add.at(deg, nu + v + 1, 1)
    deg = np.cumsum(deg)
    pos = deg[:-1].copy()
    adj = np.empty(2 * m, dtype=np.int64)
    for i in range(m):
        adj[pos[u[i]]] = i
        pos[u[i]] += 1
        adj[pos[nu + v[i]]] = i
        pos[nu + v[i]] += 1
    cursor = deg[:-1].copy()
    used = np.zeros(m, dtype=bool)
    bit = np.zeros(m, dtype=np.uint8)
    for s in range(n):
        while True:
            while cursor[s] < deg[s + 1] and used[adj[cursor[s]]]:
                cursor[s] += 1
            if cursor[s] == deg[s + 1]:
                break
            node = s
            while True:
                while cursor[node] < deg[node + 1] \
                        and used[adj[cursor[node]]]:
                    cursor[node] += 1
                if cursor[node] == deg[node + 1]:
                    break
                e = adj[cursor[node]]
                used[e] = True
                if node < nu:
                    bit[e] = 1
                    node = nu + v[e]
                else:
                    bit[e] = 0
                    node = u[e]
    return bit


def _euler_split(u, v, nu, nv):
    from lis_tpu import _native
    out = _native.euler_split(u, v, nu, nv)
    if out is None:
        out = _euler_split_py(np.asarray(u, np.int64),
                              np.asarray(v, np.int64), nu, nv)
    return out


def _edge_color_euler(left, right, d):
    """Color edges of a d-regular bipartite multigraph (d = 2^p) with d
    colors so each color class is a perfect matching (Birkhoff/Euler).
    Exact; used when the slot grid has no slack."""
    color = np.zeros(len(left), dtype=np.int64)
    nl = int(left.max()) + 1 if len(left) else 1
    nr = int(right.max()) + 1 if len(right) else 1
    deg = d
    while deg > 1:
        # prefix current colors into node ids: each class splits
        # independently (disjoint components of one multigraph)
        u = color * nl + left
        v = color * nr + right
        ncls = int(color.max()) + 1 if len(color) else 1
        bit = _euler_split(u, v, ncls * nl, ncls * nr)
        color = color * 2 + bit
        deg //= 2
    return color


def _edge_color_greedy(left, right, d, n_nodes, seed=0):
    """Partial edge coloring by randomized rounds (vectorized): an
    uncolored edge samples a color and sticks when the (node, color)
    slot is free on BOTH endpoints and no same-round rival claimed it.
    Three phases trade vector width for hit rate as the free-slot pool
    drains: uniform sampling -> sampling among the left node's free
    colors -> sequential first-free walk.  Returns None if edges remain
    (the caller falls back to the exact Euler decomposition)."""
    rng = np.random.default_rng(seed)
    m = len(left)
    left = left.astype(np.int64)
    right = right.astype(np.int64)
    free_l = np.ones((n_nodes, d), dtype=bool)
    free_r = np.ones((n_nodes, d), dtype=bool)
    color = np.full(m, -1, dtype=np.int64)
    todo = np.arange(m)
    # same-round rival detection by claim-stamping (no O(n*d) bincounts):
    # a slot's last writer survives iff it reads its own unique stamp back
    claim = np.zeros(n_nodes * d, dtype=np.int64)
    stamp = np.int64(1)

    def accept(c):
        nonlocal todo, stamp
        kl = left[todo] * d + c
        kr = right[todo] * d + c
        ok = free_l.reshape(-1)[kl] & free_r.reshape(-1)[kr]
        i = np.flatnonzero(ok)
        claim[kl[i]] = stamp + i
        i = i[claim[kl[i]] == stamp + i]
        claim[kr[i]] = stamp + i
        i = i[claim[kr[i]] == stamp + i]
        stamp += m
        color[todo[i]] = c[i]
        free_l.reshape(-1)[kl[i]] = False
        free_r.reshape(-1)[kr[i]] = False
        keep = np.ones(len(todo), dtype=bool)
        keep[i] = False
        todo = todo[keep]

    # phase 1: uniform colors — cheap rounds while slots are plentiful
    for _ in range(24):
        if len(todo) <= (1 << 18):
            break
        before = len(todo)
        accept(rng.integers(0, d, size=len(todo)))
        if len(todo) > 0.9 * before:
            break                      # occupancy too high for blind luck
    # phase 2: sample among the LEFT node's free colors (d-wide rows)
    for _ in range(96):
        if not len(todo) or len(todo) <= (1 << 13):
            break
        fl = free_l[left[todo]]
        cnt = fl.sum(axis=1, dtype=np.uint8)
        if (cnt == 0).any():
            return None
        r = (rng.random(len(todo)) * cnt).astype(np.uint8)
        c = (fl.cumsum(axis=1, dtype=np.uint8)
             > r[:, None]).argmax(axis=1)
        accept(c)
    # phase 3: sequential first-free walk over the stragglers
    if len(todo) > (1 << 15):
        return None
    for e in todo:
        both = free_l[left[e]] & free_r[right[e]]
        c = int(both.argmax())
        if not both[c]:
            return None
        color[e] = c
        free_l[left[e], c] = False
        free_r[right[e], c] = False
    return color


def factor_digits(M: int):
    """Digits (powers of two <= 128) with the fastest digit 128 so the
    center pass is a plain stride-1 lane shuffle."""
    t = int(M).bit_length() - 1
    assert (1 << t) == M, "shuffle plan needs a power-of-two slot count"
    k = -(-t // 7)
    first = t - 7 * (k - 1)
    return [1 << first] + [128] * (k - 1)


def block_digits(M: int, L: int):
    """Digits whose trailing product is the block length L: a
    block-local permutation (every element stays within its L-aligned
    block) then leaves all leading digits untouched, and _route skips
    those levels entirely — the cheap way to buy Benes depth with data
    layout instead of routing.  L must be a power of 128 so every
    colored level has d = 128 (wide color budgets keep the randomized
    greedy coloring reliable; small digits like 8 starve it)."""
    q = 0
    ll = L
    while ll > 1:
        assert ll % 128 == 0, "block length must be a power of 128"
        ll //= 128
        q += 1
    lead = factor_digits(M // L) if M > L else []
    return lead + [128] * q


def _edge_color(left, right, d, n_nodes):
    """Proper partial edge coloring (distinct colors per node on both
    sides): randomized greedy first (fast, exploits empty-slot slack),
    exact Euler decomposition as fallback (graph completed to d-regular
    with dummy edges)."""
    from lis_tpu import _native
    out = _native.greedy_color(left, right, n_nodes, d)
    if out is not None and out[0] == 0:
        return out[1].astype(np.int64)
    if out is None:
        c = _edge_color_greedy(left, right, d, n_nodes)
        if c is not None:
            return c
    deg_l = np.bincount(left, minlength=n_nodes)
    deg_r = np.bincount(right, minlength=n_nodes)
    dum_l = np.repeat(np.arange(n_nodes, dtype=np.int64), d - deg_l)
    dum_r = np.repeat(np.arange(n_nodes, dtype=np.int64), d - deg_r)
    full = _edge_color_euler(np.concatenate([left, dum_l]),
                             np.concatenate([right, dum_r]), d)
    return full[: len(left)]


def _pass_idx(pos_before, pos_after, d, s, M, exact_holes=False):
    """Lane-shuffle gather indices for one Benes pass.

    The pass permutes digit j (size d, stride s): group
    g = (pos // (d*s)) * s + pos % s is invariant.  Physically the array
    is viewed as (M/(d*s), d, s) -> transposed to (.., s, d) -> rows of
    128 lanes holding 128/d consecutive groups; idx is the within-row
    gather of the pass.

    Slots not occupied by real elements default to reading their own
    lane (may duplicate a real value): cheap, but the plan's output is
    then only meaningful at real destinations — callers mask or ignore
    the rest (ShufflePlan.apply_masked zeroes them).  ``exact_holes``
    instead routes unread source lanes into unwritten output lanes so
    every row stays a true permutation (exact value-preserving
    shuffle)."""
    from lis_tpu import _native
    out = _native.pass_idx(pos_before, pos_after, int(d), int(s), int(M),
                           exact_holes)
    if out is not None:
        return out
    ls = s.bit_length() - 1                  # all sizes are powers of two:
    ld = d.bit_length() - 1                  # shifts/masks beat int64 //,%
    g = ((pos_after >> (ld + ls)) << ls) + (pos_after & (s - 1))
    a_before = ((pos_before >> ls) & (d - 1)).astype(np.int32)
    a_after = ((pos_after >> ls) & (d - 1)).astype(np.int32)
    gpr = 128 // d
    lg = gpr.bit_length() - 1
    rows = g >> lg
    base = ((g & (gpr - 1)) << ld).astype(np.int32)
    if exact_holes:
        idx = np.full((M // 128, 128), -1, dtype=np.int32)
        idx[rows, base + a_after] = base + a_before
        read = np.zeros((M // 128, 128), dtype=bool)
        read[rows, base + a_before] = True
        # pair the j-th unwritten output with the j-th unread lane PER
        # ROW, all vectorized (two global np.nonzero scans cost ~40% of
        # the whole routing at 4M nnz): stable argsort of the read flag
        # lists unread lanes first in lane order; a row-wise cumsum
        # ranks the holes
        unread = np.argsort(read, axis=1, kind="stable").astype(np.int32)
        hole = idx < 0
        jrank = np.cumsum(hole, axis=1, dtype=np.int32) - 1
        np.copyto(idx, np.take_along_axis(unread, jrank, axis=1),
                  where=hole)
        return idx
    idx = np.broadcast_to(np.arange(128, dtype=np.int32),
                          (M // 128, 128)).copy()
    idx.reshape(-1)[rows * 128 + base + a_after] = base + a_before
    return idx


def _route(src: np.ndarray, dst: np.ndarray, M: int, digits=None,
           exact_holes=False, skip_identity=True):
    """Benes routing: list of (d, s, idx) passes moving the element at
    slot src[i] to slot dst[i] (injective; free slots hole-filled).
    Levels whose digit is already final for every element (e.g. the
    block id of a block-local permutation) are skipped — no coloring,
    no pass."""
    digits = digits or factor_digits(M)
    assert int(np.prod(digits)) == M
    k = len(digits)
    strides = np.cumprod([1] + digits[:0:-1])[::-1]  # s_j = prod d_{>j}
    dst = dst.astype(np.int64)
    cur = src.astype(np.int64)
    passes = []
    # forward half: level-j coloring pins digit j to the sub-network id;
    # batch (= digits 1..j-1, already colors) is part of both node ids
    mirrored = []
    for j in range(k - 1):
        d, s = digits[j], int(strides[j])
        ls, ld = s.bit_length() - 1, d.bit_length() - 1
        if skip_identity and np.array_equal((cur >> ls) & (d - 1),
                                            (dst >> ls) & (d - 1)):
            # digit already final for every element: color = own value,
            # both this pass and its mirror are identities
            continue
        prefix = ((cur >> (ld + ls)) << ls)
        left = (cur & (s - 1)) + prefix            # (colors, suffix_src)
        right = (dst & (s - 1)) + prefix           # (colors, suffix_dst)
        c = _edge_color(left, right, d, M // d)
        nxt = ((cur >> (ld + ls)) << (ld + ls)) + (c << ls) + (cur & (s - 1))
        passes.append((d, s, _pass_idx(cur, nxt, d, s, M, exact_holes)))
        cur = nxt
        mirrored.append(j)
    # center pass: digit k goes to its final value
    d = digits[-1]
    ld = d.bit_length() - 1
    nxt = ((cur >> ld) << ld) + (dst & (d - 1))
    if not (skip_identity and np.array_equal(nxt, cur)):
        passes.append((d, 1, _pass_idx(cur, nxt, d, 1, M, exact_holes)))
    cur = nxt
    # mirrored half: colored digits from color to final, innermost first
    for j in reversed(mirrored):
        d, s = digits[j], int(strides[j])
        ls, ld = s.bit_length() - 1, d.bit_length() - 1
        nxt = (((cur >> (ld + ls)) << ld) + ((dst >> ls) & (d - 1))) * s \
            + (cur & (s - 1))
        if not (skip_identity and np.array_equal(nxt, cur)):
            passes.append((d, s, _pass_idx(cur, nxt, d, s, M, exact_holes)))
        cur = nxt
    assert (cur == dst).all(), "Benes routing failed to realise the perm"
    return passes


# ---------------------------------------------------------------------------
# Device application
# ---------------------------------------------------------------------------

def _lane_shuffle(x, idx):
    """Permute within each 128-wide row: out[r, l] = x[r, idx[r, l]].
    One XLA gather; exact for every dtype."""
    return jnp.take_along_axis(x, idx.astype(jnp.int32), axis=1)


def _apply_pass(v, idx, d, s, M):
    """Apply one Benes pass to the flat (M,) vector ``v``."""
    pre = M // (d * s)
    x = v.reshape(pre, d, s)
    x = jnp.swapaxes(x, 1, 2).reshape(-1, 128)
    x = _lane_shuffle(x, idx)
    return jnp.swapaxes(x.reshape(pre, s, d), 1, 2).reshape(-1)


@dataclass(frozen=True)
class ShufflePlan:
    """A fixed permutation compiled to Benes lane-shuffle passes.

    apply(v) returns w with w[perm[i]] = v[i]."""
    idxs: tuple               # device (M/128, 128) uint8 per pass
    meta: tuple = ()          # ((d, s), ...) static
    M: int = 0
    small: object = None      # tiny fallback: device scatter-order take

    def apply(self, v):
        if self.small is not None:
            return jnp.take(v, self.small, axis=0)
        out = v
        for (d, s), idx in zip(self.meta, self.idxs):
            out = _apply_pass(out, idx, d, s, self.M)
        return out

    def apply_rowsum(self, v, Kp: int):
        """apply(v).reshape(M // Kp, Kp).sum(axis=1).  Only meaningful
        for exact-holes plans, where every hole slot provably carries a
        zero."""
        return self.apply(v).reshape(-1, Kp).sum(axis=1)

jax.tree_util.register_pytree_node(
    ShufflePlan,
    lambda p: ((p.idxs, p.small), (p.meta, p.M)),
    lambda aux, c: ShufflePlan(idxs=c[0], small=c[1], meta=aux[0],
                               M=aux[1]))


def apply_host(passes, v, M):
    """Numpy reference application of a pass list (build-time validation
    and the test oracle)."""
    out = np.asarray(v)
    for d, s, idx in passes:
        pre = M // (d * s)
        x = np.swapaxes(out.reshape(pre, d, s), 1, 2).reshape(-1, 128)
        x = np.take_along_axis(x, idx, axis=1)
        out = np.swapaxes(x.reshape(pre, s, d), 1, 2).reshape(-1)
    return out


_PLAN_CACHE: "dict[bytes, ShufflePlan]" = {}
_PLAN_CACHE_MAX = 16


def plan_shuffle(perm: np.ndarray, M: int | None = None,
                 validate: bool = True, digits=None,
                 exact_holes: bool = False,
                 skip_identity: bool = True) -> ShufflePlan:
    """Compile a permutation into a ShufflePlan.

    ``perm`` maps src slot -> dst slot; -1 entries are free (unfilled src
    slots), and dst slots not hit are free — both are completed into a
    full bijection internally.  ``M`` (power of two >= len(perm)) pads
    the slot count.

    Plans are memoised on a content hash of (perm, M, digits, flags):
    re-assembling a matrix with an unchanged sparsity pattern (new
    values, same structure — the dominant production pattern, e.g.
    time-stepping re-solves) skips the whole host routing phase, the
    analogue of the reference reusing its commtable across solves
    (src/matrix/lis_matrix_mpi.c:594: built once at assemble)."""
    import hashlib
    perm = np.asarray(perm, dtype=np.int64)
    h = hashlib.blake2b(perm.tobytes(), digest_size=16)
    h.update(repr((M, tuple(digits) if digits else None, exact_holes,
                   skip_identity)).encode())
    key = h.digest()
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    M = M or len(perm)
    assert M >= len(perm)
    real = np.flatnonzero(perm >= 0)
    src = real.astype(np.int64)
    dst = perm[real]
    if len(np.unique(dst)) != len(dst):
        raise ValueError("perm has duplicate destinations")
    if M <= _XLA_TAKE_MAX:
        # tiny: one XLA take; unfilled outputs read unread (empty) slots
        inv = np.full(M, -1, dtype=np.int64)
        inv[dst] = src
        unread = np.setdiff1d(np.arange(M, dtype=np.int64), src,
                              assume_unique=False)
        inv[inv < 0] = unread[: int((inv < 0).sum())]
        return _plan_cache_put(key, ShufflePlan(
            idxs=(), meta=(), M=M,
            small=jnp.asarray(inv.astype(np.int32))))
    passes = _route(src, dst, M, digits=digits,
                    exact_holes=exact_holes, skip_identity=skip_identity)
    if validate:
        got = apply_host(passes, np.arange(M, dtype=np.int64), M)
        if not np.array_equal(got[dst], src):
            raise AssertionError("shuffle routing produced a wrong plan")
    return _plan_cache_put(key, ShufflePlan(
        # lane indices are < 128: uint8 storage quarters the index
        # traffic of every pass
        idxs=tuple(jnp.asarray(idx.astype(np.uint8)) for (_, _, idx)
                   in passes),
        meta=tuple((d, s) for (d, s, _) in passes), M=M))


def _plan_cache_put(key: bytes, plan: ShufflePlan) -> ShufflePlan:
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))    # FIFO eviction
    _PLAN_CACHE[key] = plan
    return plan


def clear_plan_cache() -> None:
    """Drop every memoised plan (and the device index arrays it holds)."""
    _PLAN_CACHE.clear()
