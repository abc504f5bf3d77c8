"""BLAS-1 vector operations.

The reference implements these as local loops followed by MPI_Allreduce for
the reductions (src/vector/lis_vector_ops.c:58-470).  Here vectors are plain
``jnp`` arrays; under ``shard_map`` the same functions are used with an
``axis_name`` so the reductions become ``lax.psum`` over the mesh — the
equivalent of Allreduce.  Everything is jit-traceable.

Vectors carrying double-double precision are handled by lis_tpu.core.ddreal;
solvers pick the arithmetic backend, these stay plain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _maybe_psum(val, axis_name):
    if axis_name is None:
        return val
    return jax.lax.psum(val, axis_name)


# ---- element-wise (no communication) -------------------------------------

def axpy(alpha, x, y):
    """y + alpha*x (lis_vector_axpy semantics, returned functionally)."""
    return y + alpha * x


def xpay(x, alpha, y):
    """x + alpha*y (lis_vector_xpay: y := x + alpha*y)."""
    return x + alpha * y


def axpyz(alpha, x, y):
    """z = alpha*x + y (lis_vector_axpyz)."""
    return alpha * x + y


def scale(alpha, x):
    return alpha * x


def pmul(x, y):
    """Element-wise product (lis_vector_pmul)."""
    return x * y


def pdiv(x, y):
    """Element-wise division (lis_vector_pdiv)."""
    return x / y


def set_all(alpha, like):
    return jnp.full_like(like, alpha)


def abs_(x):
    return jnp.abs(x)


def reciprocal(x):
    return 1.0 / x


def conjugate(x):
    return jnp.conj(x)


def shift(sigma, x):
    """x - sigma (lis_vector_shift subtracts the scalar)."""
    return x - sigma


# ---- reductions (one psum each under a mesh) ------------------------------

def dot(x, y, axis_name=None):
    """<x, y> with conjugation of x for complex (lis_vector_dot uses conj)."""
    local = jnp.sum(jnp.conj(x) * y) if jnp.iscomplexobj(x) else jnp.sum(x * y)
    return _maybe_psum(local, axis_name)


def nhdot(x, y, axis_name=None):
    """Non-Hermitian dot <x̄, y> without conjugation (lis_vector_nhdot)."""
    return _maybe_psum(jnp.sum(x * y), axis_name)


def nrm2(x, axis_name=None):
    local = jnp.sum(jnp.real(jnp.conj(x) * x))
    return jnp.sqrt(_maybe_psum(local, axis_name))


def nrm1(x, axis_name=None):
    return _maybe_psum(jnp.sum(jnp.abs(x)), axis_name)


def nrmi(x, axis_name=None):
    local = jnp.max(jnp.abs(x))
    if axis_name is None:
        return local
    return jax.lax.pmax(local, axis_name)


def vsum(x, axis_name=None):
    return _maybe_psum(jnp.sum(x), axis_name)


def gather(v):
    """Copy a (possibly device-resident) vector into a host numpy array
    (lis_vector_gather, src/vector/lis_vector.c)."""
    import numpy as np
    return np.asarray(v)


def scatter(arr, like=None):
    """Place a host array onto device as a solver-ready vector
    (lis_vector_scatter)."""
    return jnp.asarray(arr, dtype=None if like is None else like.dtype)
