"""Test configuration: run everything on an 8-device virtual CPU mesh.

Multi-card hardware is not available in CI; we exercise all pjit/shard_map
code paths on the CPU backend with XLA's forced host device count (SURVEY.md
section 4 "multi-chip without a real cluster").

Tests marked ``chip`` need an NVIDIA GPU: they skip on the CPU and run on
the card with ``DXRVOX_TEST_ON_CHIP=1 python -m pytest -m chip tests/``
(that variable leaves the platform to JAX's default).
"""

import os

ON_CHIP = os.environ.get("DXRVOX_TEST_ON_CHIP") == "1"
if not ON_CHIP:
    os.environ["JAX_PLATFORMS"] = "cpu"
# persistent compile cache across test processes, inside the checkout
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".cache", "xla-tests"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# pin the platform after import as well, so tests run on the local CPU
# backend with the 8 virtual devices whatever the environment selects
if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips elsewhere"
    )


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU (decided here, at test
    time, never while modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with DXRVOX_TEST_ON_CHIP=1)")
    return jax.devices()[0]


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Release live compiled executables between test modules.

    XLA:CPU's JIT segfaults sequence-dependently once enough distinct
    executables accumulate in one process (reproduced: test_raystab2.py's
    29 tests followed by test_accel_cache.py crash inside
    backend_compile_and_load on the 31st test; every module passes in
    isolation, 128 GB RAM free, serialized LLVM codegen does not help).
    Dropping the live-executable caches at module boundaries keeps the
    resident JIT state bounded; within a module jits still share."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def reference_assets_available():
    from dxrvoxelizer_tpu.utils.assets import find_asset

    try:
        find_asset("bunny.obj")
        return True
    except FileNotFoundError:
        pytest.skip("canonical OBJ assets not available")
