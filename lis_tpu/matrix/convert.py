"""Format conversion with CSR as the hub.

Mirrors lis_matrix_convert (src/matrix/lis_matrix_ops.c:128-326): any-to-any
conversion routes through canonical CSR arrays on the host.  Conversions are
assembly-time operations (the reference also converts on host before the
solve), so host numpy/scipy is the right tool; the result's arrays land on
device as jnp leaves.
"""

from __future__ import annotations

from lis_tpu.matrix.base import SparseMatrix, get_format


from lis_tpu.matrix import hybrid as _hybrid    # noqa: F401 (registers 'hdi')
from lis_tpu.matrix import bes as _bes          # noqa: F401 (registers 'bes')
from lis_tpu.matrix import css as _css          # noqa: F401 (registers 'css')
from lis_tpu.matrix import cst as _cst          # noqa: F401 (registers 'cst')


def convert_matrix(matrix: SparseMatrix, target: str, **kw) -> SparseMatrix:
    """Convert ``matrix`` to the ``target`` format name (csr, ell, dia, ...)."""
    target = target.lower()
    if matrix.format_name == target and not kw:
        return matrix
    cls = get_format(target)
    ptr, index, value = matrix.to_csr_arrays()
    if target in ("bsr", "bsc"):
        kw.setdefault("bnr", getattr(matrix, "bnr", 2))
        kw.setdefault("bnc", getattr(matrix, "bnc", None))
    return cls.from_csr_arrays(ptr, index, value, matrix.shape, **kw)


def diag_profile(A):
    """(offsets, nnz) of the matrix's diagonal structure — host-side.
    Shared by the single-chip and distributed DIA-routing policies."""
    import numpy as np
    ptr, index, value = A.to_csr_arrays()
    nnz = len(value)
    if nnz == 0 or A.nrows != A.ncols:
        return None, nnz
    n = A.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(np.asarray(ptr)))
    # entries per offset as counts[off + n]: one O(nnz) bincount, no sort
    counts = np.bincount(np.asarray(index).astype(np.int64) - rows + n,
                         minlength=2 * n)
    return np.flatnonzero(counts) - n, nnz


def is_banded(A, max_nnd: int = 512, max_fill: float = 4.0):
    """True when A's nonzeros lie on few enough diagonals for DIA storage
    (nnd <= max_nnd and padding <= max_fill x nnz)."""
    offs, nnz = diag_profile(A)
    return (offs is not None and len(offs) <= max_nnd
            and len(offs) * A.nrows <= max_fill * nnz)
