"""Device-mesh helpers — the replacement for MPI communicators.

The reference's process model (ranks + MPI_COMM_WORLD, lis_initialize
src/system/lis_init.c) maps to a 1-D ``jax.sharding.Mesh`` over all chips:
the mesh axis "p" plays the role of the communicator, ``psum``/
``all_gather``/``psum_scatter`` over it replace MPI_Allreduce /
Isend-Irecv halo exchange / transpose-reduce.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

AXIS = "p"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh over the first n_devices (default all) jax devices;
    the axis name is AXIS ("p") — the MPI_Comm analogue."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"make_mesh({n_devices}) but only {len(devs)} JAX device(s) "
                "are visible; for a virtual CPU mesh set "
                "XLA_FLAGS=--xla_force_host_platform_device_count=N and "
                "JAX_PLATFORMS=cpu before JAX initializes its backends")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def nprocs(mesh: Mesh) -> int:
    """Device count along the distribution axis (MPI_Comm_size analogue)."""
    return mesh.shape[AXIS]


def ensure_devices(n: int) -> int:
    """Make sure at least n JAX devices are visible and return the count.

    On the CPU backend a short count is made up by re-initialising it
    with n virtual devices (a test mesh).  Any other backend has the
    devices it has: too few raises, and the backend is never switched."""
    have = len(jax.devices())
    if have >= n:
        return have
    if jax.devices()[0].platform != "cpu":
        raise RuntimeError(
            f"need {n} devices but the {jax.default_backend()} backend has "
            f"{have}")
    from jax._src import xla_bridge as _xb
    _xb._clear_backends()
    jax.clear_caches()
    jax.config.update("jax_num_cpu_devices", n)
    got = len(jax.devices())
    if got < n:
        raise RuntimeError(f"cannot provision {n} CPU devices (have {got})")
    return got
