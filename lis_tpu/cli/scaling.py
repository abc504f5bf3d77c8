"""Weak/strong-scaling harness for the distributed SpMV and solves.

The reference measures multi-rank behavior by re-running spmvtest/test2
under ``mpirun -np N`` (test/test.sh); here the mesh width takes the place
of the rank count.  On a multi-GPU host this reports device numbers; with
``JAX_PLATFORMS=cpu`` the CPU backend is re-initialised with as many
virtual devices as asked for, to validate the sharding and collective plan
(timings then reflect host CPUs).  Any other backend with too few devices
is an error.

Usage:
  python -m lis_tpu.cli.scaling weak  m n iter   [ndev ...] [-problem P]
  python -m lis_tpu.cli.scaling strong m n iter  [ndev ...] [-problem P]

weak:   problem with m·n rows PER DEVICE (global grows with the mesh);
        reports MFLOPS and efficiency vs 1 device.
strong: fixed global m·n rows split over the mesh.

-problem poisson (default): 2-D 5-pt Poisson — banded, rides the
        sharded-DIA ring halo.
-problem random: uniformly random sparsity (8 nnz/row) — locality-free.
        distribute_matrix picks the comm-table layout (DistCST above its
        nnz threshold); pass ``-layout cst`` to force DistCSTMatrix
        (comm-table halo + per-shard CST compute with interior/boundary
        overlap) at any size.  The comm column shows the
        boundary-proportional export volume vs the gather alternative.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _bench_dist_matvec(A, mesh, iters):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from lis_tpu.parallel.dist import _shard_map, distribute_vector
    from lis_tpu.parallel.mesh import AXIS

    x = distribute_vector(jnp.ones(A.gn), mesh, A.gn_pad)

    def loop(k):
        def body(Ad, xv):
            def it(_, v):
                return Ad.matvec(v) * 0.25
            return jax.lax.fori_loop(0, k, it, xv)
        return jax.jit(_shard_map(body, mesh,
                                  (jax.tree.map(lambda _: P(AXIS), A),
                                   P(AXIS)), P(AXIS)))

    la, lb = max(1, iters // 10), iters + max(1, iters // 10)
    fa, fb = loop(la), loop(lb)
    float(fa(A, x)[0]); float(fb(A, x)[0])

    def best(f):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(f(A, x)[0])
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t = (best(fb) - best(fa)) / (lb - la)
    return max(t, 1e-12)


def main(argv=None):
    import jax
    import lis_tpu
    from lis_tpu.parallel.mesh import make_mesh
    from lis_tpu.parallel.dist import distribute_matrix
    from lis_tpu.utils.testmat import poisson2d

    argv = list(sys.argv[1:] if argv is None else argv)
    problem, layout = "poisson", None
    if "-problem" in argv:
        i = argv.index("-problem")
        problem = argv[i + 1]
        del argv[i: i + 2]
    if "-layout" in argv:
        i = argv.index("-layout")
        layout = argv[i + 1]
        del argv[i: i + 2]
    if len(argv) < 4:
        print(__doc__)
        return 1
    mode, m, n, iters = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    ndevs = [int(a) for a in argv[4:]] or None
    total = len(jax.devices())
    need = max(ndevs) if ndevs else min(total, 8) or 8
    if total < need:
        # a CPU backend self-provisions a virtual mesh (validates
        # sharding; timings then reflect host CPUs); others raise
        from lis_tpu.parallel.mesh import ensure_devices
        try:
            total = ensure_devices(need)
            print(f"(re-initialized on {total} virtual CPU devices)")
        except RuntimeError as e:
            print(e)
            return 1
    if ndevs is None:
        ndevs = [d for d in (1, 2, 4, 8, 16, 32) if d <= total]

    def make_problem(rows_m, rows_n):
        if problem == "random":
            import scipy.sparse as sp
            from lis_tpu.matrix.csr import CSRMatrix
            rng = np.random.default_rng(0)
            nn, k = rows_m * rows_n, 8
            rr = np.repeat(np.arange(nn), k)
            cc = rng.integers(0, nn, size=nn * k)
            a = sp.coo_matrix((rng.standard_normal(nn * k), (rr, cc)),
                              shape=(nn, nn)).tocsr()
            a.sum_duplicates(); a.sort_indices()
            return CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                             a.shape)
        return poisson2d(rows_m, rows_n)

    lis_tpu.initialize(argv)
    lis_tpu.config.enable_compile_cache()
    base = None
    pname = ("uniformly random 8 nnz/row (locality-free)"
             if problem == "random" else "2-D 5-pt Poisson")
    print(f"{mode} scaling, {pname}, base grid {m}x{n}, "
          f"{iters} iterations")
    for nd in ndevs:
        mesh = make_mesh(nd)
        if mode == "weak":
            A0 = make_problem(m, n * nd)
        else:
            A0 = make_problem(m, n)
        if layout == "cst":
            from lis_tpu.parallel.dist import distribute_csr_cst
            Ad = distribute_csr_cst(A0, mesh)
        else:
            Ad = distribute_matrix(A0, mesh)
        t = _bench_dist_matvec(Ad, mesh, iters)
        mflops = 2.0 * A0.nnz / t / 1e6
        if base is None:
            base = (mflops, nd)
        # ideal throughput scales linearly with mesh width in both modes
        eff = mflops / (base[0] * nd / base[1])
        # per-device comm volume for the matvec actually timed above
        # (elements moved over the mesh): two neighbor x slabs for ring
        # halos (matrix slabs are exchanged once at distribute time, and
        # the timed op is matvec, not matvech), the export table for
        # comm-table halos, the whole padded vector for all-gather
        import jax as _jax
        dts = [l.dtype for l in _jax.tree.leaves(Ad)
               if hasattr(l, "dtype") and np.issubdtype(l.dtype,
                                                        np.inexact)]
        esz = max((np.dtype(d).itemsize for d in dts), default=8)
        if getattr(Ad, "hw", 0):
            comm = 2 * Ad.hw                           # two x slabs
        elif hasattr(Ad, "comm_elems"):
            comm = Ad.comm_elems
        elif getattr(Ad, "halo", "") == "gather":
            comm = Ad.gn_pad
        else:
            comm = 0
        print(f"  ndev={nd:3d}  n={A0.nrows:9d}  {t*1e6:10.1f} us/matvec  "
              f"{mflops:10.1f} MFLOPS  efficiency {eff:5.2f}  "
              f"comm {comm * esz / 1e3:.1f} KB/dev/mv  "
              f"[{type(Ad).__name__}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
