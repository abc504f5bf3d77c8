"""DIA (diagonal / CDS) format — the speed-of-light format for stencils.

Reference: src/matrix/lis_matrix_dia.c, kernel src/matvec/lis_matvec_dia.c:50.
For banded/stencil matrices (all of the reference's spmvtest problems) the
matrix is a handful of dense diagonals; SpMV needs NO gather at all: each
diagonal contributes ``value[k] * shift(x, off_k)``, a multiply-add over
contiguous memory.  The diagonal offsets are static aux data, so the
shifts are compile-time slices — this is the flagship stream format
(XLA-fused; 3000 GB/s csr-equivalent on an H100 at 216^3, CHANGES.md).

Out-of-range positions hold zeros in ``value`` so no runtime masks needed.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host


@matrix_format("dia")
class DIAMatrix(SparseMatrix):
    # per-diagonal arrays: value[k][i] = A[i, i+off_k].  Stored as a TUPLE
    # of (n,) leaves, not one (nnd, n) array: separate buffers let XLA fuse
    # the whole shift-FMA chain when the matrix is a jit ARGUMENT, which
    # one (nnd, n) argument array defeats
    value: tuple
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    offsets: tuple = static()        # static diagonal offsets

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape) -> "DIAMatrix":
        ptr, index, value = host(ptr), host(index), host(value)
        n = shape[0]
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        shifted = index.astype(np.int64) - rows + n      # offset + n >= 0
        present = np.bincount(shifted, minlength=n + shape[1]) > 0
        uoffs = np.flatnonzero(present) - n
        slot = np.cumsum(present) - 1                    # offset -> row of dval
        dval = np.zeros((len(uoffs), n), dtype=value.dtype)
        dval[slot[shifted], rows] = value
        out = cls(value=tuple(jnp.asarray(dval[k])
                              for k in range(len(uoffs))),
                  nrows=int(n), ncols=int(shape[1]), nnz=int(len(value)),
                  offsets=tuple(int(o) for o in uoffs))
        # host CSR cache (see csr.py): avoids a device-to-host pull when
        # a preconditioner (SA-AMG, ILU) re-reads the converted operator
        object.__setattr__(out, "_host_csr",
                           (np.asarray(ptr, np.int32),
                            np.asarray(index, np.int32), value))
        return out

    @property
    def value_2d(self) -> np.ndarray:
        """Host (nnd, n) view of the diagonals (single batched device_get +
        preallocated copy — np.stack over jax arrays is ~15x slower)."""
        if not self.value:
            return np.zeros((0, self.nrows))
        g = jax.device_get(list(self.value))
        out = np.empty((len(g), self.nrows), dtype=np.asarray(g[0]).dtype)
        for k, v in enumerate(g):
            out[k] = v
        return out

    def to_csr_arrays(self):
        cached = getattr(self, "_host_csr", None)
        if cached is not None:
            return cached
        val = self.value_2d
        n, m = self.shape
        cols = np.arange(n)[None, :] + np.array(self.offsets)[:, None]
        valid = (cols >= 0) & (cols < m) & (val != 0)
        rows = np.broadcast_to(np.arange(n)[None, :], cols.shape)
        r, c, v = rows[valid], cols[valid], val[valid]
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        ptr = np.zeros(n + 1, dtype=np.int32)
        np.add.at(ptr, r + 1, 1)
        ptr = np.cumsum(ptr).astype(np.int32)
        return ptr, c.astype(np.int32), v

    def get_diagonal(self):
        if 0 in self.offsets:
            return self.value[self.offsets.index(0)]
        dt = self.value[0].dtype if self.value else jnp.float64
        return jnp.zeros(self.nrows, dt)

    def _padded(self, x):
        pad = max(max(abs(o) for o in self.offsets), 1) if self.offsets else 1
        return jnp.pad(x, (pad, pad)), pad

    def scale_rows(self, d):
        """Row scaling ON DEVICE: A[i, i+off] *= d[i] is elementwise on
        each diagonal stream (the base-class CSR round trip moves the
        whole matrix through the host — prohibitive at production sizes)."""
        d = jnp.asarray(d)
        vals = tuple(vk * d.astype(vk.dtype) for vk in self.value)
        return dataclasses.replace(self, value=vals)

    def scale_symm(self, dsqrt_inv):
        """D^-1/2 A D^-1/2 on device: value[k][i] *= d[i]·d[i+off]
        (the column factor is the d stream shifted by the offset)."""
        d = jnp.asarray(dsqrt_inv)
        pad = max(max(abs(o) for o in self.offsets), 1) if self.offsets else 1
        dp = jnp.pad(d, (pad, pad))
        n = self.nrows
        vals = []
        for k, off in enumerate(self.offsets):
            dshift = jax.lax.dynamic_slice(dp, (pad + off,), (n,))
            vals.append(self.value[k] * (d * dshift).astype(
                self.value[k].dtype))
        return dataclasses.replace(self, value=tuple(vals))

    def matvec(self, x):
        xp, pad = self._padded(x)
        n = self.nrows
        dt = jnp.result_type(self.value[0].dtype, x.dtype) if self.value \
            else x.dtype
        y = jnp.zeros(n, dtype=dt)
        for k, off in enumerate(self.offsets):
            y = y + self.value[k] * jax.lax.dynamic_slice(xp, (pad + off,), (n,))
        return y

    def matvech(self, x):
        v = [jnp.conj(vk) if jnp.iscomplexobj(vk) else vk
             for vk in self.value]
        n = self.nrows
        out_len = self.ncols
        pad = max(max(abs(o) for o in self.offsets), 1) if self.offsets else 1
        dt = jnp.result_type(v[0].dtype, x.dtype) if v else x.dtype
        if out_len == n:
            # (Aᴴx)[j] = Σ_k v[k][j-off_k]·x[j-off_k]: pure shifted streams
            # (the serialized update-slice chain below does not fuse)
            xp = jnp.pad(x, (pad, pad))
            y = jnp.zeros(n, dtype=dt)
            for k, off in enumerate(self.offsets):
                vp = jnp.pad(v[k], (pad, pad))
                vs = jax.lax.dynamic_slice(vp, (pad - off,), (n,))
                xs = jax.lax.dynamic_slice(xp, (pad - off,), (n,))
                y = y + vs * xs
            return y
        y = jnp.zeros(out_len + 2 * pad, dtype=dt)
        for k, off in enumerate(self.offsets):
            t = v[k] * x
            y = jax.lax.dynamic_update_slice(
                y, jax.lax.dynamic_slice(y, (pad + off,), (n,)) + t, (pad + off,))
        return y[pad:pad + out_len]
