"""Explicit-transpose operator (-use_at).

Reference: the BiCG family optionally materialises Aᵀ so the transpose
matvec runs the fast row-oriented kernel instead of the scatter direction
(LIS_USE_AT_TYPE, src/solver/lis_solver.c:163-166,836-843).  Here the
scatter-add matvech is likewise slower than the sorted segment-sum, so the
same trade applies: memory for speed.
"""

from __future__ import annotations

import dataclasses

import jax

from lis_tpu.matrix.base import SparseMatrix


@dataclasses.dataclass(frozen=True)
class WithTranspose(SparseMatrix):
    A: object           # primary operator
    At: object          # explicit Aᴴ in a row-oriented format

    @property
    def nrows(self):
        return self.A.nrows

    @property
    def ncols(self):
        return self.A.ncols

    @property
    def nnz(self):
        return self.A.nnz

    format_name = "use_at"

    def matvec(self, x):
        return self.A.matvec(x)

    def matvech(self, x):
        return self.At.matvec(x)        # fast direction on Aᴴ

    def to_csr_arrays(self):
        return self.A.to_csr_arrays()

    def get_diagonal(self):
        return self.A.get_diagonal()


jax.tree_util.register_pytree_node(
    WithTranspose,
    lambda m: ((m.A, m.At), None),
    lambda aux, c: WithTranspose(*c))


def with_explicit_transpose(A) -> WithTranspose:
    from lis_tpu.matrix.convert import convert_matrix
    At = convert_matrix(A, "csr").transpose()
    return WithTranspose(A=A, At=At)
