"""Jacobi and block-Jacobi preconditioners.

Reference: lis_precon_create_jacobi / lis_psolve_jacobi
(src/precon/lis_precon_jacobi.c:61,89) — z = D⁻¹ r, with an
inverted-block-diagonal version for BSR (:221,255).  The point version
is one elementwise multiply; the block version is a batched small matvec
against the pre-inverted (nb, b, b) diagonal blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.precon.base import precon_pytree, register_precon


@precon_pytree
class JacobiPrecon:
    dinv: jax.Array

    def psolve(self, r):
        return self.dinv * r

    def psolveh(self, r):
        return jnp.conj(self.dinv) * r if jnp.iscomplexobj(self.dinv) \
            else self.dinv * r


@precon_pytree
class BlockJacobiPrecon:
    """Inverted block-diagonal (the reference's BSR jacobi / 'bjacobi')."""
    binv: jax.Array            # (nb, bs, bs) inverted diagonal blocks
    _static = ("n",)
    n: int = 0

    def psolve(self, r):
        nb, bs, _ = self.binv.shape
        pad = nb * bs - r.shape[0]
        rp = jnp.pad(r, (0, pad)) if pad else r
        z = jnp.einsum("kij,kj->ki", self.binv, rp.reshape(nb, bs),
                       precision="highest")
        return z.reshape(-1)[: r.shape[0]]

    def psolveh(self, r):
        nb, bs, _ = self.binv.shape
        pad = nb * bs - r.shape[0]
        rp = jnp.pad(r, (0, pad)) if pad else r
        b = jnp.conj(self.binv) if jnp.iscomplexobj(self.binv) else self.binv
        z = jnp.einsum("kji,kj->ki", b, rp.reshape(nb, bs),
                       precision="highest")
        return z.reshape(-1)[: r.shape[0]]


def inv_blocks(blocks, singular="pinv"):
    """Invert (nb, bs, bs) diagonal blocks without raising on a singular
    block, so a matrix that is nonsingular overall never crashes block
    scaling / block Jacobi on one bad diagonal block.  ``singular``
    picks the fallback: "pinv" for preconditioning (only convergence is
    affected) or "eye" for SCALING, where a pseudo-inverse would make
    the scaled system D⁺A singular and change the solution — identity
    leaves those rows unscaled instead."""
    try:
        return np.linalg.inv(blocks)
    except np.linalg.LinAlgError:
        out = np.empty_like(blocks)
        bs = blocks.shape[1]
        for k in range(blocks.shape[0]):
            try:
                out[k] = np.linalg.inv(blocks[k])
            except np.linalg.LinAlgError:
                out[k] = (np.linalg.pinv(blocks[k]) if singular == "pinv"
                          else np.eye(bs, dtype=blocks.dtype))
        return out


@register_precon("jacobi")
def create_jacobi(A, opts):
    d = A.get_diagonal()
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 1.0)
    return JacobiPrecon(dinv=dinv)


@register_precon("bjacobi")
def create_bjacobi(A, opts):
    """Block Jacobi: invert dense diagonal blocks of size opts.storage_block
    (for BSR matrices, the matrix's own block size)."""
    bs = getattr(A, "bnr", None) or getattr(opts, "storage_block", 2) or 2
    dense_blocks = _diag_blocks(A, bs)
    binv = jnp.asarray(inv_blocks(dense_blocks))
    return BlockJacobiPrecon(binv=binv, n=A.nrows)


def _diag_blocks(A, bs: int) -> np.ndarray:
    ptr, index, value = A.to_csr_arrays()
    n = A.nrows
    nb = -(-n // bs)
    blocks = np.zeros((nb, bs, bs), dtype=np.asarray(value).dtype)
    rows = np.repeat(np.arange(n), np.diff(ptr))
    same_block = rows // bs == index // bs
    r, c, v = rows[same_block], index[same_block], value[same_block]
    np.add.at(blocks, (r // bs, r % bs, c % bs), v)
    # empty rows (incl. padding beyond n) get 1 on the diagonal so the
    # block inverse is well posed
    row_abs = np.abs(blocks).sum(axis=2)            # (nb, bs)
    empty = row_abs == 0
    bi, ri = np.nonzero(empty)
    blocks[bi, ri, ri] = 1.0
    return blocks
