"""Mip pyramid (SHOW_MIP) + float-grid (USE_MUTEX) texture emulation."""

import numpy as np
import jax.numpy as jnp

from dxrvoxelizer_tpu.core.pipeline import render, voxelize
from dxrvoxelizer_tpu.models.mesh import MeshBuffers
from dxrvoxelizer_tpu.ops.mips import downsample2, generate_mips, mip_level
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig
from meshes import tetrahedron_mesh


def _tet_buffers():
    v, nrm, t = tetrahedron_mesh()
    return MeshBuffers(
        positions=jnp.asarray(v),
        normals=jnp.asarray(nrm),
        tris=jnp.asarray(t, jnp.int32),
        positions_norm=jnp.asarray(v),
    )


def _consts(cfg):
    from dxrvoxelizer_tpu.models.camera import OrbitCamera
    from dxrvoxelizer_tpu.models.scene import FrameConstants
    from dxrvoxelizer_tpu.utils import dxmath as dxm

    cam = OrbitCamera(cfg.width, cfg.height)
    bound = np.array([0.0, 4.0, 0.0, 2.0], np.float32)
    world = dxm.world_matrix(bound, np.array([0, 0, 0, 1], np.float32))
    world_inv = dxm.inverse(world)
    return FrameConstants(
        local_space_light_pt=dxm.transform_coord(
            np.array(cfg.light_pt, np.float32), world_inv
        ),
        local_space_eye_pt=dxm.transform_coord(cam.eye, world_inv),
        screen_to_local=dxm.screen_to_local(
            world, cam.view_proj, cfg.width, cfg.height
        ),
    )


def test_downsample_box_average():
    d = jnp.arange(4**3, dtype=jnp.float32).reshape(4, 4, 4)
    m = downsample2(d)
    assert m.shape == (2, 2, 2)
    expect = np.asarray(d).reshape(2, 2, 2, 2, 2, 2).mean(axis=(1, 3, 5))
    np.testing.assert_allclose(np.asarray(m), expect)


def test_generate_mips_chain():
    d = jnp.ones((32, 32, 32), jnp.float32) * 0.5
    mips = generate_mips(d)
    assert [m.shape[0] for m in mips] == [32, 16, 8, 4, 2, 1]
    # constant field survives box filtering at every level
    for m in mips:
        np.testing.assert_allclose(np.asarray(m), 0.5)


def test_mip_alpha_quantization():
    """R10G10B10A2 emulation re-quantizes alpha to {0, 1/3, 2/3, 1}."""
    d = jnp.full((4, 4, 4), 0.5, jnp.float32)
    q = generate_mips(d, quantize_alpha=True)[0]
    # 0.5 rounds to 2/3 at 2-bit precision (round(0.5*3)=2)
    np.testing.assert_allclose(np.asarray(q), 2.0 / 3.0, rtol=1e-6)
    f = generate_mips(d, quantize_alpha=False)[0]
    np.testing.assert_allclose(np.asarray(f), 0.5)


def test_render_show_mip_runs():
    mesh = _tet_buffers()
    cfg = VoxelizerConfig(grid_size=32, width=64, height=64, show_mip=2)
    grid = voxelize(mesh, 32, impl="xla")
    fc = _consts(cfg)
    img = render(grid, fc, cfg, impl="gather")
    assert img.shape == (64, 64, 3)
    assert np.isfinite(np.asarray(img)).all()
    # a coarser mip blurs but must still produce non-clear pixels
    clear = np.asarray(cfg.clear_color, np.float32)
    assert (np.abs(np.asarray(img) - clear) > 0.05).any()


def test_mip_level_zero_is_identity():
    d = jnp.zeros((8, 8, 8), jnp.float32)
    assert mip_level(d, 0) is d
