"""DNS — dense storage (reference: src/matrix/lis_matrix_dns.c).

SpMV is one dense matvec (precision="highest": f32 never drops to TF32).
Stored row-major (n, m); the reference stores column-major,
an irrelevant distinction behind the L3 interface.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host


@matrix_format("dns")
class DNSMatrix(SparseMatrix):
    value: jax.Array          # (n, m) dense
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape) -> "DNSMatrix":
        import scipy.sparse as sp
        a = sp.csr_matrix((host(value), host(index), host(ptr)), shape=shape)
        return cls(value=jnp.asarray(a.toarray()),
                   nrows=int(shape[0]), ncols=int(shape[1]),
                   nnz=int(len(host(value))))

    @classmethod
    def from_dense(cls, dense) -> "DNSMatrix":
        d = np.asarray(dense)
        return cls(value=jnp.asarray(d), nrows=d.shape[0], ncols=d.shape[1],
                   nnz=int((d != 0).sum()))

    def to_csr_arrays(self):
        import scipy.sparse as sp
        a = sp.csr_matrix(host(self.value))
        a.sort_indices()
        return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data

    def to_dense(self):
        return host(self.value)

    # precision="highest": an f32 product must not drop to TF32
    def matvec(self, x):
        return jnp.matmul(self.value, x, precision="highest")

    def matvech(self, x):
        a = jnp.conj(self.value) if jnp.iscomplexobj(self.value) \
            else self.value
        return jnp.matmul(a.T, x, precision="highest")

    def get_diagonal(self):
        return jnp.diagonal(self.value)
