"""Distributed (mesh-sharded) layer — SURVEY.md §2.10's device mapping."""

from lis_tpu.parallel.mesh import make_mesh, nprocs, ensure_devices, AXIS
from lis_tpu.parallel.dist import (distribute_matrix, distribute_csr,
                                   distribute_dia, distribute_slabs,
                                   distribute_vector,
                                   dist_solve, redistribute_csr,
                                   undistribute_csr, DistCSRMatrix,
                                   DistDIAMatrix, DistHybridMatrix)
from lis_tpu.parallel.dist_esolve import dist_esolve

__all__ = ["make_mesh", "nprocs", "ensure_devices", "AXIS",
           "distribute_matrix", "distribute_csr", "distribute_dia",
           "distribute_slabs",
           "distribute_vector", "dist_solve", "redistribute_csr",
           "undistribute_csr", "DistCSRMatrix", "DistDIAMatrix",
           "DistHybridMatrix", "dist_esolve"]
