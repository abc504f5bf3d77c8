"""lis_tpu — a JAX sparse iterative-solver framework.

A from-scratch JAX/XLA framework with the capabilities of the Lis
library (reference: anishida/lis, "Library of Iterative Solvers"): sparse
storage formats with conversions, SpMV / transpose-SpMV kernels, Krylov and
stationary linear solvers, preconditioners, eigensolvers, double-double
("quad") precision paths, Matrix Market / Harwell-Boeing I/O, and distributed
execution over a ``jax.sharding.Mesh`` (halo-exchange SpMV + psum reductions)
instead of MPI.

The reference's public surface is a single header (``include/lis.h``); here
the public surface is this package's top level.
"""

from lis_tpu.config import (
    LIS_SUCCESS,
    LIS_FAILS,
    LIS_ILL_OPTION,
    LIS_BREAKDOWN,
    LIS_OUT_OF_MEMORY,
    LIS_MAXITER,
    LIS_ERR_NOT_IMPLEMENTED,
    LIS_ERR_FILE_IO,
    initialize,
    finalize,
    wtime,
)
from lis_tpu.runtime.options import SolverOptions, EsolverOptions
from lis_tpu.matrix.base import SparseMatrix
from lis_tpu.matrix.coo import COOMatrix
from lis_tpu.matrix.csr import CSRMatrix
from lis_tpu.matrix.csc import CSCMatrix
from lis_tpu.matrix.msr import MSRMatrix
from lis_tpu.matrix.dia import DIAMatrix
from lis_tpu.matrix.ell import ELLMatrix
from lis_tpu.matrix.jad import JADMatrix
from lis_tpu.matrix.bsr import BSRMatrix
from lis_tpu.matrix.bsc import BSCMatrix
from lis_tpu.matrix.vbr import VBRMatrix
from lis_tpu.matrix.dns import DNSMatrix
from lis_tpu.matrix.convert import convert_matrix
from lis_tpu.matrix.assembly import (MatrixAssembler, LIS_INS_VALUE,
                                     LIS_ADD_VALUE)
from lis_tpu.ops.spmv import matvec, matvech
from lis_tpu.solvers.driver import solve, SolveResult, SOLVER_REGISTRY
from lis_tpu.esolvers.driver import esolve, gesolve, EsolveResult
from lis_tpu.io.mm import read_matrix_market, write_matrix_market, read_vector_mm
from lis_tpu.io.hb import read_harwell_boeing, write_harwell_boeing
from lis_tpu.io.lisio import read_lis_file, write_lis_file
from lis_tpu.io import (lis_input, lis_input_vector, lis_output,
                        lis_output_vector)
from lis_tpu.utils.trace import set_debug_trace, debug_trace_enabled

__version__ = "0.1.0"

__all__ = [
    "LIS_SUCCESS", "LIS_FAILS", "LIS_ILL_OPTION", "LIS_BREAKDOWN",
    "LIS_OUT_OF_MEMORY", "LIS_MAXITER", "LIS_ERR_NOT_IMPLEMENTED",
    "LIS_ERR_FILE_IO",
    "initialize", "finalize", "wtime",
    "LIS_INS_VALUE", "LIS_ADD_VALUE",
    "lis_input", "lis_input_vector", "lis_output", "lis_output_vector",
    "SolverOptions", "EsolverOptions",
    "SparseMatrix", "COOMatrix", "CSRMatrix", "CSCMatrix", "MSRMatrix",
    "DIAMatrix", "ELLMatrix", "JADMatrix", "BSRMatrix", "BSCMatrix",
    "VBRMatrix", "DNSMatrix",
    "convert_matrix", "MatrixAssembler",
    "matvec", "matvech",
    "solve", "SolveResult", "SOLVER_REGISTRY",
    "esolve", "gesolve", "EsolveResult",
    "read_matrix_market", "write_matrix_market", "read_vector_mm",
    "read_harwell_boeing", "write_harwell_boeing",
    "read_lis_file", "write_lis_file",
    "set_debug_trace", "debug_trace_enabled",
]
