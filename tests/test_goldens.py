"""Golden occupancy grids for the canonical scenes (bit-exactness CI).

The goldens are 64^3 parity-mode packed grids produced by the counting
oracle (CPU, f32); the work-queue voxelizer and the oracle must reproduce
them bit-for-bit on every backend (BASELINE.json "bit-exact occupancy grids").
Scene placements follow the reference launch scripts: bunny/dragon default,
TuringBowl posScale (0, 2.8, 0, 0.03) (Bin/TuringBowl.bat).
"""

from pathlib import Path

import numpy as np
import pytest

from dxrvoxelizer_tpu.models.scene import Scene
from dxrvoxelizer_tpu.ops.packing import pack_bits_z
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig

GOLDENS = Path(__file__).parent / "goldens"

SCENES = [
    ("bunny", (0.0, 0.0, 0.0, 1.0), 52356),
    ("dragon", (0.0, 0.0, 0.0, 1.0), 14529),
    ("TuringBowl", (0.0, 2.8, 0.0, 0.03), 11772),
]


@pytest.mark.parametrize("name,ps,occupied", SCENES)
def test_oracle_matches_golden(reference_assets_available, name, ps, occupied):
    golden = np.load(GOLDENS / f"{name}_64_parity.npy")
    scene = Scene.load(VoxelizerConfig(mesh=f"{name}.obj", pos_scale=ps))
    occ = voxelize_parity_ref(
        scene.buffers.positions_norm, scene.buffers.tris, n=64, tri_chunk=4096
    )
    assert int(np.asarray(occ).sum()) == occupied
    np.testing.assert_array_equal(np.asarray(pack_bits_z(occ)), golden)


def test_binned_kernel_matches_golden_bunny(reference_assets_available):
    golden = np.load(GOLDENS / "bunny_64_parity.npy")
    scene = Scene.load(VoxelizerConfig(mesh="bunny.obj"))
    from dxrvoxelizer_tpu.ops.voxelize_queue import voxelize_parity_queue

    words = voxelize_parity_queue(
        scene.buffers.positions_norm, scene.buffers.tris, n=64, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(words), golden)


def test_golden_render_tet():
    """Shear-warp render drift detector: fixed tet scene vs stored image.

    Tolerance absorbs cross-version fp noise (the golden is float16); any
    real renderer change shows up orders of magnitude above it.
    """
    import numpy as np

    from dxrvoxelizer_tpu.core.pipeline import render, voxelize
    from dxrvoxelizer_tpu.models.camera import OrbitCamera
    from dxrvoxelizer_tpu.models.scene import Scene
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu.utils.objloader import ObjMesh
    from meshes import tetrahedron_mesh

    v, nrm, t = tetrahedron_mesh()
    mesh = ObjMesh(
        positions=np.asarray(v, np.float32),
        normals=np.asarray(nrm, np.float32),
        indices=np.asarray(t, np.int32).reshape(-1),
        aabb_min=np.asarray(v, np.float32).min(axis=0),
        aabb_max=np.asarray(v, np.float32).max(axis=0),
    )
    # the stored image is the -fast mode's (ss=1 + recurrence light
    # sweep); pin that mode explicitly — the hq DEFAULT is pinned by
    # test_production_render_720p_vs_reference_golden's bounds instead
    cfg = VoxelizerConfig(grid_size=32, width=96, height=64, render_ss=1)
    scene = Scene(mesh)
    cam = OrbitCamera(cfg.width, cfg.height)
    fc = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    grid = voxelize(scene.buffers, cfg.grid_size, mode="parity", impl="xla")
    img = np.asarray(render(grid, fc, cfg, impl="warp"))
    gold = np.load(GOLDENS / "tet_32_render_96x64.npy").astype(np.float32)
    assert img.shape == gold.shape
    assert np.abs(img - gold).max() < 2e-3, float(np.abs(img - gold).max())


RENDER_BOUNDS = {
    # measured vs the shader-exact reference render at the default cap
    # (scripts/make_render_goldens.py, docs/RENDER_QUALITY.md), with margin:
    #            u8_mean  u8_p99  u8_max   (measured: 5.4/41/68, 5.7/39/61,
    "bunny": (8.0, 55.0, 150),           #            2.1/34/94)
    "dragon": (8.0, 55.0, 150),
    "TuringBowl": (4.0, 48.0, 150),
}

HQ_RENDER_BOUNDS = {
    # -hq mode (render_ss=2 + reference-step light sweep), measured
    # 0.61/9/55, 1.15/15/51, 0.64/11/51 (docs/RENDER_QUALITY.md) + margin
    "bunny": (1.5, 16.0, 80),
    "dragon": (2.5, 24.0, 80),
    "TuringBowl": (1.5, 18.0, 80),
}


@pytest.mark.parametrize("name,ps,_occ", SCENES)
def test_production_render_720p_vs_reference_golden(
    reference_assets_available, name, ps, _occ
):
    """Production-quality pin at production scale: the shear-warp renderer
    at 1280x720 vs the checked-in shader-exact reference render (generated
    by scripts/make_render_goldens.py). Bounds are u8 mean / p99 /
    max absolute error per channel."""
    from dxrvoxelizer_tpu.core.pipeline import VoxelGrid, render
    from dxrvoxelizer_tpu.models.camera import OrbitCamera
    from dxrvoxelizer_tpu.utils.image import read_png, to_u8

    golden_png = GOLDENS / f"render_{name.lower()}_720p.png"
    golden = read_png(golden_png).astype(np.int32)
    cfg = VoxelizerConfig(mesh=f"{name}.obj", pos_scale=ps,
                          grid_size=64, width=1280, height=720)
    scene = Scene.load(cfg)
    # the checked-in parity grid (bit-exact on every backend) is the input
    words = np.load(GOLDENS / f"{name}_64_parity.npy")
    import jax.numpy as jnp

    grid = VoxelGrid(words=jnp.asarray(words))
    cam = OrbitCamera(cfg.width, cfg.height)
    fc = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    # the DEFAULT config is the high-fidelity mode (render_ss=2 +
    # reference-step light sweep, the quality-default decision of round 4:
    # docs/RENDER_QUALITY.md) and must land ~4x closer to the shader-exact
    # reference than -fast
    assert cfg.render_ss == 2, "hq is the documented default"
    img_hq = to_u8(np.asarray(render(grid, fc, cfg, impl="warp"))).astype(
        np.int32
    )
    err_hq = np.abs(img_hq - golden)
    mean_b, p99_b, max_b = HQ_RENDER_BOUNDS[name]
    assert err_hq.mean() < mean_b, err_hq.mean()
    assert np.percentile(err_hq, 99) < p99_b, np.percentile(err_hq, 99)
    assert err_hq.max() < max_b, err_hq.max()

    # -fast speed mode (ss=1 + per-slab recurrence light sweep)
    img = to_u8(np.asarray(
        render(grid, fc, cfg.replace(render_ss=1), impl="warp")
    )).astype(np.int32)
    err = np.abs(img - golden)
    mean_b, p99_b, max_b = RENDER_BOUNDS[name]
    assert err.mean() < mean_b, err.mean()
    assert np.percentile(err, 99) < p99_b, np.percentile(err, 99)
    assert err.max() < max_b, err.max()
