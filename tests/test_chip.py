"""Tests that need an NVIDIA GPU: the Triton-route kernels compiled for
the card against their plain versions (they skip on the CPU; run them on
the card with ``DXRVOX_TEST_ON_CHIP=1 python -m pytest -m chip tests/``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dxrvoxelizer_tpu.models.procedural import displaced_icosphere

pytestmark = pytest.mark.chip


@pytest.fixture(scope="module")
def mesh():
    v, nr, t = displaced_icosphere(5120, seed=4)
    return jnp.asarray(v), jnp.asarray(nr), jnp.asarray(t)


@pytest.mark.parametrize("n", [64, 96, 256])
def test_queue_kernel_on_gpu_matches_plain_fold(gpu, mesh, n):
    from dxrvoxelizer_tpu.ops import voxelize_queue as vq

    v, _, t = mesh
    coefs, row0, count, _ = vq.build_queue(v, t, n)
    a = vq.queue_fold_triton(coefs, row0, count, 0, n)
    b = vq.queue_fold_xla(coefs, row0, count, 0, n)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n", [32, 128])
def test_raystab_kernel_on_gpu_matches_plain_fold(gpu, mesh, n):
    """Same winners (occupancy and ids) on the card; normals within the
    FMA-contraction tolerance chip_smoke.py states."""
    from dxrvoxelizer_tpu.ops.raystab_fast import (
        build_raystab_accel2,
        fold_extract_xla,
        table_k,
    )
    from dxrvoxelizer_tpu.ops.raystab_pallas import stab_fold_extract

    v, nr, t = mesh
    accel = build_raystab_accel2(v, t, nr, n)
    for level in accel.levels:
        for rays, coefs, _sc, bounds, ntab in level:
            k = table_k(coefs)
            args = (rays, coefs, ntab, k, int(t.shape[0]), 0.12)
            ta, ia, na = stab_fold_extract(*args, bounds=bounds)
            tb, ib, nb = fold_extract_xla(*args, bounds=bounds)
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
            np.testing.assert_array_equal(
                np.asarray(na[:, 3]), np.asarray(nb[:, 3]))
            np.testing.assert_allclose(np.asarray(na), np.asarray(nb),
                                       rtol=0, atol=1e-6)
