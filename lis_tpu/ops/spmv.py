"""SpMV dispatch — the L3←L4 interface.

The reference dispatches on A->matrix_type (src/matvec/lis_matvec.c:55-345);
here dispatch is a method call on the format object.  These wrappers exist
so solver code reads like the reference's three-call interface
(lis_matvec / lis_matvech) and so format fast paths can be swapped in
centrally.  There is no hand-written SpMV kernel: XLA's DIA SpMV streams
the 27-point 216^3 operator at 3000 GB/s csr-equivalent on an H100, at
the bandwidth of a plain copy in the same run (CHANGES.md).
"""

from __future__ import annotations

from lis_tpu.matrix.base import SparseMatrix


def matvec(a: SparseMatrix, x):
    """y = A x."""
    return a.matvec(x)


def matvech(a: SparseMatrix, x):
    """y = Aᴴ x."""
    return a.matvech(x)
