"""DirectXMath-convention matrix tests: verify the row-vector transform chain
(SURVEY.md section 7 "Matching DX conventions" — tested with oriented
asymmetric fixtures)."""

import numpy as np

from dxrvoxelizer_tpu.models.camera import OrbitCamera
from dxrvoxelizer_tpu.utils import dxmath as dxm


def test_translation_row_vector():
    m = dxm.translation(1, 2, 3)
    v = dxm.transform_coord([0, 0, 0], m)
    np.testing.assert_allclose(v, [1, 2, 3])


def test_compose_order_scale_then_translate():
    # row-vector: A * B applies A first
    m = dxm.scaling(2.0) @ dxm.translation(1, 0, 0)
    v = dxm.transform_coord([1, 1, 1], m)
    np.testing.assert_allclose(v, [3, 2, 2])


def test_look_at_lh_basis():
    view = dxm.look_at_lh([0, 0, -5], [0, 0, 0])
    # eye maps to origin; a point ahead of the eye has +z in view space (LH)
    np.testing.assert_allclose(dxm.transform_coord([0, 0, -5], view), [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(dxm.transform_coord([0, 0, 0], view), [0, 0, 5], atol=1e-6)
    # +x world is +x view (right-vector = cross(up, z) = +x here)
    np.testing.assert_allclose(dxm.transform_coord([1, 0, -5], view), [1, 0, 0], atol=1e-6)


def test_perspective_fov_lh_depth_range():
    proj = dxm.perspective_fov_lh(np.pi / 2, 1.0, 1.0, 100.0)
    near = dxm.transform_coord([0, 0, 1], proj)
    far = dxm.transform_coord([0, 0, 100], proj)
    np.testing.assert_allclose(near[2], 0.0, atol=1e-6)
    np.testing.assert_allclose(far[2], 1.0, atol=1e-5)


def test_world_matrix_maps_normalized_to_local():
    bound = np.array([1.0, 2.0, 3.0, 4.0], dtype=np.float32)  # center, half-ext
    pos_scale = np.array([10.0, 0.0, 0.0, 0.5], dtype=np.float32)
    world = dxm.world_matrix(bound, pos_scale)
    # normalized-space origin -> bound center, then posScale: *0.5 + (10,0,0)
    v = dxm.transform_coord([0, 0, 0], world)
    np.testing.assert_allclose(v, [10.5, 1.0, 1.5])
    # normalized +1 along x -> center + half-ext along x, scaled/translated
    v = dxm.transform_coord([1, 0, 0], world)
    np.testing.assert_allclose(v, [12.5, 1.0, 1.5])


def test_screen_to_local_roundtrip():
    w, h = 640, 360
    cam = OrbitCamera(w, h)
    bound = np.array([0.0, 4.0, 0.0, 2.0], dtype=np.float32)
    world = dxm.world_matrix(bound, np.array([0, 0, 0, 1], dtype=np.float32))
    s2l = dxm.screen_to_local(world, cam.view_proj, w, h)
    # the center pixel on the near plane should map back to screen center
    local = dxm.transform_coord([w / 2, h / 2, 0.0], s2l)
    l2s = np.linalg.inv(s2l.astype(np.float64))
    back = dxm.transform_coord(local, l2s.astype(np.float32))
    np.testing.assert_allclose(back, [w / 2, h / 2, 0.0], atol=1e-2)


def test_orbit_preserves_focus_distance():
    cam = OrbitCamera(1280, 720)
    d0 = np.linalg.norm(cam.focus - cam.eye)
    cam.orbit(37.0, -12.0)
    d1 = np.linalg.norm(cam.focus - cam.eye)
    np.testing.assert_allclose(d0, d1, rtol=1e-4)
    # view matrix still maps eye to origin
    np.testing.assert_allclose(
        dxm.transform_coord(cam.eye, cam.view), [0, 0, 0], atol=1e-4
    )


def test_zoom_moves_eye_toward_focus():
    cam = OrbitCamera(1280, 720)
    d0 = np.linalg.norm(cam.focus - cam.eye)
    cam.zoom(2.0)
    d1 = np.linalg.norm(cam.focus - cam.eye)
    assert d1 < d0


def test_rotation_roll_pitch_yaw_matches_axis_composition():
    pitch, yaw, roll = 0.3, -0.7, 0.2
    m = dxm.rotation_roll_pitch_yaw(pitch, yaw, roll)
    v = np.array([0.2, -0.5, 0.9], dtype=np.float32)
    out = dxm.transform_coord(v, m)
    # roll about z, then pitch about x, then yaw about y (row-vector order)
    def rot_x(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]], dtype=np.float64)

    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=np.float64)

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=np.float64)

    expect = v @ rot_z(roll) @ rot_x(pitch) @ rot_y(yaw)
    np.testing.assert_allclose(out, expect, atol=1e-6)


def test_dispatch_2d_to_3d_reconstruction_identity():
    """The reference folds its 3D voxel dispatch into (N, N*N, 1) because
    the DXR fallback layer lacks a depth dimension, then reconstructs
    index.z = y // N; y %= N (DXRVoxelizer.hlsl:64-67, Voxelizer.cpp:367).
    This engine never folds (kernel grids are index math), but the
    identity the reference relies on must hold for every voxel."""
    n = 64
    x = np.arange(n)
    yz = np.arange(n * n)
    xx, yy = np.meshgrid(x, yz, indexing="ij")
    z = yy // n
    y = yy % n
    # forward fold: (x, y, z) -> dispatch (x, y + z*N)
    refold = y + z * n
    assert (refold == yy).all()
    assert ((0 <= z) & (z < n)).all() and ((0 <= y) & (y < n)).all()
    # every (x, y, z) voxel is hit exactly once
    flat = (xx * n * n + y * n + z).ravel()
    assert len(np.unique(flat)) == n * n * n
