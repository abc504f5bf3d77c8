"""Bandwidth-reducing reordering (reverse Cuthill-McKee) + the reordered
operator wrapper.

The reference leaves ordering to the user; here ordering feeds the
storage router — the stream formats (DIA, HDI, BES slabs) all
exploit locality of ``col - row``, and RCM is the standard way to expose
it on unstructured (SuiteSparse-class) matrices.  ``-reorder rcm`` makes
the solver driver solve the symmetrically permuted system
``(P A Pᵀ)(P x) = P b`` — b is permuted once at entry and x unpermuted
once at exit, so the iteration itself never gathers.
"""

from __future__ import annotations

import numpy as np


def rcm_permutation(A) -> np.ndarray:
    """Reverse-Cuthill-McKee permutation of A's symmetrised graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    ptr, index, value = A.to_csr_arrays()
    g = sp.csr_matrix((np.ones(len(np.asarray(value))),
                       np.asarray(index), np.asarray(ptr)), shape=A.shape)
    g = g + g.T
    return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True))


def permute_symmetric(A, perm: np.ndarray):
    """P A Pᵀ in A's format class (rows and columns reordered by perm)."""
    import scipy.sparse as sp
    ptr, index, value = A.to_csr_arrays()
    a = sp.csr_matrix((np.asarray(value), np.asarray(index),
                       np.asarray(ptr)), shape=A.shape)
    a = a[perm][:, perm].tocsr()
    a.sort_indices()
    return type(A).from_csr_arrays(a.indptr, a.indices, a.data, A.shape)


def bandwidth(A) -> int:
    """max |col - row| over the nonzeros (host-side)."""
    ptr, index, _ = A.to_csr_arrays()
    ptr = np.asarray(ptr)
    index = np.asarray(index).astype(np.int64)
    if len(index) == 0:
        return 0
    rows = np.repeat(np.arange(A.nrows, dtype=np.int64), np.diff(ptr))
    return int(np.abs(index - rows).max())
