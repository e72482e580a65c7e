"""Platform routing (ops/route.py), backend selection and the compile
cache's home (utils/backend.py)."""

import os
from types import SimpleNamespace

import jax
import pytest

from dxrvoxelizer_tpu.ops import raymarch_warp, raystab_fast, raystab_pallas
from dxrvoxelizer_tpu.ops import route
from dxrvoxelizer_tpu.ops import voxelize_queue as vq
from dxrvoxelizer_tpu.utils import backend


@pytest.mark.parametrize("platform,parity,raystab", [
    ("gpu", vq.queue_fold_triton, raystab_pallas.stab_fold_extract),
    ("cpu", vq.queue_fold_xla, raystab_fast.fold_extract_xla),
])
def test_route_picks_per_platform(monkeypatch, platform, parity, raystab):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert route.platform() == platform
    assert route.parity_voxelize() is parity
    assert route.raystab_query() is raystab
    assert route.march() is raymarch_warp.march_xla
    assert route.resolve() is raymarch_warp.bilinear_take


@pytest.mark.parametrize("job", ["platform", "parity_voxelize",
                                 "raystab_query", "march", "resolve"])
def test_route_rejects_other_platforms(monkeypatch, job):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        getattr(route, job)()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = backend.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.startswith(os.path.join(repo, ".cache", "xla"))
    # the CPU keys its executables on the host's ISA
    assert os.path.basename(path) == "cpu-" + backend._host_cache_key()


def test_select_backend_cpu_on_request():
    assert backend.select_backend("cpu") == "cpu"


def test_select_backend_raises_without_accelerator():
    """The default selection finds only the CPU and the CPU was not asked
    for: an error, never a silent fallback."""
    jax.config.update("jax_platforms", "")
    try:
        with pytest.raises(RuntimeError, match="no accelerator"):
            backend.select_backend()
    finally:
        jax.config.update("jax_platforms", "cpu")
    # with the CPU chosen explicitly (JAX_PLATFORMS=cpu) it is accepted
    assert backend.select_backend() == "cpu"


def test_select_backend_returns_the_gpu(monkeypatch):
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [SimpleNamespace(platform="gpu")])
    assert backend.select_backend() == "gpu"
