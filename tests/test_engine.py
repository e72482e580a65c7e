"""Engine (EZ tier), core pipeline, CLI app, and image IO tests."""

import numpy as np
import pytest

from dxrvoxelizer_tpu.app.main import main
from dxrvoxelizer_tpu.core import FRAME_COUNT, FramePipeline, voxelize
from dxrvoxelizer_tpu.ez import Engine
from dxrvoxelizer_tpu.models.camera import OrbitCamera
from dxrvoxelizer_tpu.models.mesh import MeshBuffers
from dxrvoxelizer_tpu.models.scene import Scene
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig, parse_args
from dxrvoxelizer_tpu.utils.image import read_png, to_u8, write_png
from dxrvoxelizer_tpu.utils.objloader import ObjMesh
from meshes import tetrahedron_mesh


def _tet_scene():
    verts, norms, tris = tetrahedron_mesh()
    mesh = ObjMesh(
        positions=verts * 2.0 + np.array([0, 4, 0], np.float32),
        normals=norms,
        indices=tris.reshape(-1).astype(np.int32),
        aabb_min=(verts * 2.0 + [0, 4, 0]).min(0),
        aabb_max=(verts * 2.0 + [0, 4, 0]).max(0),
    )
    return Scene(mesh)


def test_engine_update_render_surface():
    cfg = VoxelizerConfig(grid_size=32, width=32, height=24, num_samples=16,
                          num_light_samples=4)
    eng = Engine(cfg, scene=_tet_scene(), vox_impl="xla")
    cam = OrbitCamera(cfg.width, cfg.height)
    for frame in range(4):
        eng.update_frame(frame % FRAME_COUNT, cam.eye, cam.view_proj)
        img = eng.render(frame % FRAME_COUNT)
    eng.sync()
    host = np.asarray(img)
    assert host.shape == (24, 32, 3)
    assert np.isfinite(host).all()


def test_render_before_update_raises():
    cfg = VoxelizerConfig(grid_size=32, width=16, height=16)
    eng = Engine(cfg, scene=_tet_scene(), vox_impl="xla")
    try:
        eng.render(0)
        raise AssertionError("expected RuntimeError")
    except RuntimeError:
        pass


def test_voxelize_mode_raystab_has_rgba():
    scene = _tet_scene()
    grid = voxelize(scene.buffers, 32, mode="raystab")
    assert grid.rgba is not None
    occ = np.asarray(grid.occupancy())
    rgba = np.asarray(grid.rgba)
    # alpha quantized to {0, 1} by R10G10B10A2 emulation, matches occupancy
    np.testing.assert_array_equal(rgba[..., 3] > 0.5, occ)


def test_frame_pipeline_inflight_bound():
    cfg = VoxelizerConfig(grid_size=32, width=16, height=16, num_samples=8,
                          num_light_samples=2)
    scene = _tet_scene()
    pipe = FramePipeline(cfg, scene.buffers, vox_impl="xla")
    cam = OrbitCamera(cfg.width, cfg.height)
    for i in range(6):
        consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
        pipe.frame(consts)
        assert len(pipe._inflight) <= FRAME_COUNT
    pipe.sync()
    assert not pipe._inflight


def test_frame_pipeline_static_builds_once(monkeypatch):
    """Static parity frames must NOT re-bin per frame: the queue is built
    once and every frame only dispatches the kernel — the reference's
    build-AS-once (Voxelizer.cpp:264-326) vs per-frame DispatchRays-only
    (:351-369) split. Round-3 verdict finding #2."""
    import dxrvoxelizer_tpu.ops.voxelize_queue as vq
    from dxrvoxelizer_tpu.ops.packing import pack_bits_z
    from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref

    builds = {"n": 0}
    real_build = vq.build_queue

    def counting_build(*a, **kw):
        builds["n"] += 1
        return real_build(*a, **kw)

    monkeypatch.setattr(vq, "build_queue", counting_build)
    # run the Triton-route fold interpreted (the CPU product fold is jnp)

    class InterpStatic(vq.StaticVoxelizer):
        def __init__(self, verts, tris, n, **kw):
            kw["interpret"] = True
            super().__init__(verts, tris, n, **kw)

    monkeypatch.setattr(vq, "StaticVoxelizer", InterpStatic)

    cfg = VoxelizerConfig(grid_size=32, width=32, height=24, num_samples=16,
                          num_light_samples=4)
    scene = _tet_scene()
    pipe = FramePipeline(cfg, scene.buffers, vox_impl="queue")
    cam = OrbitCamera(cfg.width, cfg.height)
    for frame in range(3):
        cam.orbit(10.0, 0.0)
        consts = scene.update_frame(cam.eye, cam.view_proj, 32, 24)
        img = pipe.frame(consts)
    pipe.sync()
    assert builds["n"] == 1, f"re-binned {builds['n']} times over 3 frames"
    assert np.isfinite(np.asarray(img)).all()
    # and the cached dispatch is still bit-exact vs the oracle
    want = pack_bits_z(
        voxelize_parity_ref(scene.buffers.positions_norm, scene.buffers.tris,
                            n=32)
    )
    np.testing.assert_array_equal(
        np.asarray(pipe._static_vox()), np.asarray(want)
    )


def test_cli_parse_reference_flags():
    cfg = parse_args(["-mesh", "Assets/dragon.obj", "0.0", "2.8", "0.0", "0.03"])
    assert cfg.mesh == "Assets/dragon.obj"
    assert cfg.pos_scale == (0.0, 2.8, 0.0, 0.03)
    cfg = parse_args(["/warp"])
    assert cfg.backend == "cpu"
    cfg = parse_args(["-grid", "128", "-width", "640", "-height", "360"])
    assert (cfg.grid_size, cfg.width, cfg.height) == (128, 640, 360)
    assert parse_args([]).accel_cache is True
    assert parse_args(["-noaccelcache"]).accel_cache is False


@pytest.mark.parametrize(
    "argv,mesh,pos_scale,backend",
    [
        (["-mesh", "/abs/x.obj"], "/abs/x.obj", (0.0, 0.0, 0.0, 1.0),
         "default"),
        (["-mesh", "/abs/x.obj", "0", "0", "0", "1"], "/abs/x.obj",
         (0.0, 0.0, 0.0, 1.0), "default"),
        (["-mesh", "/abs/x.obj", "1", "-2", "0.5", "0.25", "/warp"],
         "/abs/x.obj", (1.0, -2.0, 0.5, 0.25), "cpu"),
        (["/mesh", "/abs/x.obj", "/grid", "32"], "/abs/x.obj",
         (0.0, 0.0, 0.0, 1.0), "default"),
        (["-mesh", "/warp"], "bunny.obj", (0.0, 0.0, 0.0, 1.0), "cpu"),
    ],
)
def test_cli_absolute_mesh_path(argv, mesh, pos_scale, backend):
    """A '/'-prefixed argument is a value unless it names a known flag."""
    cfg = parse_args(argv)
    assert cfg.mesh == mesh
    assert cfg.pos_scale == pos_scale
    assert cfg.backend == backend


def test_app_main_end_to_end(tmp_path, reference_assets_available):
    out = tmp_path / "shot.png"
    rc = main([
        "-mesh", "bunny.obj", "-grid", "32", "-width", "48", "-height", "32",
        "-frames", "2", "-out", str(out), "-voximpl", "xla",
    ])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (32, 48, 3)
    # bunny visible: some pixels differ from the clear color
    clear = to_u8(np.array([0.0, 0.2, 0.4]))
    assert (np.abs(img.astype(int) - clear.astype(int)).max(axis=-1) > 12).mean() > 0.03


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    img = (rng.random((20, 31, 3)) * 255).astype(np.uint8)
    p = tmp_path / "rt.png"
    write_png(p, img)
    back = read_png(p)
    np.testing.assert_array_equal(back, img)


def test_mesh_buffers_normalization():
    scene = _tet_scene()
    pn = np.asarray(scene.buffers.positions_norm)
    assert np.abs(pn).max() <= 1.0 + 1e-5


def test_meshbuffers_pytree():
    import jax

    scene = _tet_scene()
    leaves = jax.tree.leaves(scene.buffers)
    assert len(leaves) == 4


def test_obj_mesh_roundtrip_to_buffers():
    verts, norms, tris = tetrahedron_mesh()
    m = ObjMesh(verts, norms, tris.reshape(-1).astype(np.int32),
                verts.min(0), verts.max(0))
    b = MeshBuffers.from_obj(m)
    assert b.num_triangles == 4


def test_app_loadgrid_roundtrip(tmp_path, monkeypatch):
    """Checkpoint/resume: -savegrid then -loadgrid renders the saved grid."""
    import numpy as np

    from dxrvoxelizer_tpu.app.main import main
    from dxrvoxelizer_tpu.utils.image import read_png
    from meshes import tetrahedron_mesh
    from dxrvoxelizer_tpu.utils import assets

    # point the asset loader at a temp OBJ of the tet
    v, _, t = tetrahedron_mesh()
    obj = tmp_path / "tet.obj"
    with open(obj, "w") as f:
        for p in v:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for a, b, c in t:
            f.write(f"f {a+1} {b+1} {c+1}\n")
    grid = tmp_path / "g.npy"
    png = tmp_path / "r.png"
    rc = main(["-mesh", str(obj), "-grid", "32", "-width", "64",
               "-height", "64", "-frames", "1", "-renderimpl", "gather",
               "-savegrid", str(grid), "-out", str(tmp_path / "first.png")])
    assert rc == 0 and grid.exists()
    rc = main(["-mesh", str(obj), "-grid", "32", "-width", "64",
               "-height", "64", "-renderimpl", "gather",
               "-loadgrid", str(grid), "-out", str(png)])
    assert rc == 0
    img = read_png(png)
    assert img.shape == (64, 64, 3)


def test_parity_with_normals_matches_raystab_rgb():
    """Parity-mode optional normal channel (the reference's
    float4(Normal,1.0) content, DXRVoxelizer.hlsl:83-84): radial first-hit
    normals gated by the parity bit. On voxels where both rules agree
    occupied, the rgb must equal the raystab grid's bit-for-bit (same
    winner machinery); alpha must equal the parity occupancy."""
    import jax.numpy as jnp

    from meshes import icosphere_mesh
    from dxrvoxelizer_tpu.models.mesh import MeshBuffers
    from dxrvoxelizer_tpu.utils.objloader import ObjMesh

    v, nrm, t = icosphere_mesh(2, radius=0.7)
    mesh = MeshBuffers.from_obj(ObjMesh(
        positions=np.asarray(v, np.float32),
        normals=np.asarray(nrm, np.float32),
        indices=np.asarray(t, np.int32).reshape(-1),
        aabb_min=np.asarray(v, np.float32).min(0),
        aabb_max=np.asarray(v, np.float32).max(0),
    ))
    n = 32
    grid_p = voxelize(mesh, n, mode="parity", with_normals=True)
    grid_s = voxelize(mesh, n, mode="raystab", impl="xla")
    occ_p = np.asarray(grid_p.occupancy())
    occ_s = np.asarray(grid_s.occupancy())
    rgba_p = np.asarray(grid_p.rgba)
    rgba_s = np.asarray(grid_s.rgba)
    # alpha channel is exactly the parity occupancy
    np.testing.assert_array_equal(rgba_p[..., 3] > 0.5, occ_p)
    # where both rules say inside, identical quantized normals
    both = occ_p & occ_s
    assert both.sum() > 100  # the fixture overlaps substantially
    np.testing.assert_array_equal(rgba_p[both][:, :3], rgba_s[both][:, :3])
    # most parity-occupied voxels carry a nonzero stored normal (UNORM
    # clamps all-negative normals to zero, faithfully to the reference's
    # R10G10B10A2 grid — so "all" would be wrong; an octant's worth may
    # legitimately clamp away)
    frac = (np.abs(rgba_p[occ_p][:, :3]).sum(-1) > 0).mean()
    assert frac > 0.8, frac
