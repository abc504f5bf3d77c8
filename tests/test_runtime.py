"""Runtime helpers: the persistent compile cache, device provisioning, and
the matmul precision of f32 products."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lis_tpu
from lis_tpu import config as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert C.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed(monkeypatch, restore_cache_dir):
    """Without the variable the cache sits at <checkout>/.jax_cache — the
    same path in every process, so a second run finds the first one's
    programs."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = C.enable_compile_cache()
    assert first == os.path.join(REPO, ".jax_cache")
    assert C.enable_compile_cache() == first
    assert jax.config.jax_compilation_cache_dir == first


def test_ensure_devices_raises_off_cpu(monkeypatch):
    """Too few devices on a non-CPU backend is an error; the backend is
    never swapped for virtual CPU devices."""
    from lis_tpu.parallel import mesh

    class _Gpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Gpu()])
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    platforms = jax.config.jax_platforms
    ncpu = jax.config.jax_num_cpu_devices
    with pytest.raises(RuntimeError, match="need 4 devices"):
        mesh.ensure_devices(4)
    assert jax.config.jax_platforms == platforms
    assert jax.config.jax_num_cpu_devices == ncpu
    assert mesh.ensure_devices(1) == 1


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a closed jaxpr, sub-jaxprs
    included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


def test_f32_block_and_dense_matvec_ask_for_highest_precision():
    """An f32 matmul may run in TF32 on a GPU (~3 digits); the BSR and
    DNS products must ask for full precision."""
    from lis_tpu.matrix.convert import convert_matrix
    from lis_tpu.utils.testmat import poisson2d
    a = poisson2d(6, 6)
    p, i, v = a.to_csr_arrays()
    a32 = lis_tpu.CSRMatrix.from_csr_arrays(p, i, np.asarray(v, np.float32),
                                            a.shape)
    x = jnp.ones(36, jnp.float32)
    for fmt in ("bsr", "dns"):
        M = convert_matrix(a32, fmt)
        for f in (M.matvec, M.matvech):
            precs = _dot_precisions(jax.make_jaxpr(f)(x).jaxpr)
            assert precs, fmt
            for prec in precs:
                assert prec is not None and all(
                    q == jax.lax.Precision.HIGHEST for q in prec), (fmt, prec)
