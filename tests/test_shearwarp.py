"""Shear-warp renderer tests: warp primitives, light sweep, the bilinear
screen resolve, and image agreement with the exact reference renderer."""

import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops.raymarch_fast import precompute_light_volume
from dxrvoxelizer_tpu.ops.raymarch_ref import raymarch_ref
from dxrvoxelizer_tpu.ops.raymarch_warp import (
    bilinear_take,
    light_sweep_host,
    raymarch_shearwarp,
)
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref
from dxrvoxelizer_tpu.ops.warp import interp_matrix, scale_offset_coords, warp2d
from meshes import box_mesh, tetrahedron_mesh
from test_raymarch import _frame_consts

CLEAR = np.array([0.0, 0.2, 0.4], dtype=np.float32)


def test_interp_matrix_identity():
    w = np.asarray(interp_matrix(jnp.arange(8, dtype=jnp.float32), 8))
    np.testing.assert_allclose(w, np.eye(8), atol=1e-6)


def test_interp_matrix_half_shift():
    w = np.asarray(interp_matrix(jnp.arange(7, dtype=jnp.float32) + 0.5, 8))
    v = np.arange(8.0, dtype=np.float32)
    np.testing.assert_allclose(w @ v, v[:7] + 0.5, atol=1e-6)


def test_interp_matrix_zero_outside():
    w = np.asarray(interp_matrix(jnp.asarray([-2.0, 10.0]), 8))
    np.testing.assert_allclose(w, 0.0)


def test_warp2d_identity():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((3, 16, 16)), jnp.float32)
    coords = scale_offset_coords(16, jnp.ones(3), jnp.zeros(3) - 0.5)
    # coords = i + 0.5 - 0.5 = texel index i -> identity
    w = interp_matrix(coords, 16)
    out = warp2d(img, w, w)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-5)


def test_light_sweep_empty_is_one():
    density = jnp.zeros((16, 16, 16), jnp.float32)
    lv = light_sweep_host(density, np.array([-10.0, 45.0, -75.0], np.float32), 16)
    np.testing.assert_allclose(np.asarray(lv), 1.0, atol=1e-6)


def test_light_sweep_shadows_behind_solid():
    verts, _, tris = box_mesh([-0.4, -0.4, -0.4], [0.4, 0.4, 0.4])
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=16).astype(
        jnp.float32
    )
    light = np.array([0.0, 100.0, 0.0], np.float32)  # straight +y
    lv = np.asarray(light_sweep_host(density, light, 16))
    assert lv.shape == (16, 16, 16)
    assert (lv >= 0).all() and (lv <= 1.0 + 1e-6).all()
    # +y light, y texel axis points down (-y normalized): voxels below the
    # solid (larger y index) are shadowed vs voxels above it
    assert lv[8, 14, 8] < 0.3  # below the box (normalized y negative side)
    assert lv[8, 1, 8] > 0.9  # above the box, toward the light


def test_light_sweep_close_to_gather_reference():
    verts, _, tris = tetrahedron_mesh()
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=32).astype(
        jnp.float32
    )
    light = np.array([-10.0, 45.0, -75.0], np.float32)
    lv_sweep = np.asarray(light_sweep_host(density, light, 32))
    lv_ref = np.asarray(
        precompute_light_volume(density, jnp.asarray(light), n_light=32)
    )
    diff = np.abs(lv_sweep - lv_ref)
    assert diff.mean() < 0.03, diff.mean()


def _bilinear_reference(img, x, y):
    """Independent edge-clamped bilinear sampler (scipy, order 1)."""
    from scipy.ndimage import map_coordinates

    m = img.shape[0]
    xc = np.clip(np.asarray(x, np.float64), 0.0, m - 1.0)
    yc = np.clip(np.asarray(y, np.float64), 0.0, m - 1.0)
    return map_coordinates(
        np.asarray(img, np.float64), [xc, yc], order=1, mode="nearest"
    )


def test_bilinear_resolve_matches_xla(tmp_path):
    """The resolve's bilinear read vs an independent sampler, including
    points outside the intermediate (edge clamps on every side)."""
    rng = np.random.default_rng(1)
    sc = jnp.asarray(rng.random((128, 128)), jnp.float32)
    p = 3000
    gx = jnp.asarray(rng.random(p) * 140 - 6, jnp.float32)
    gy = jnp.asarray(rng.random(p) * 140 - 6, jnp.float32)
    got = np.asarray(bilinear_take(sc, gx, gy, 128))
    np.testing.assert_allclose(got, _bilinear_reference(sc, gx, gy),
                               atol=1e-5)
    # exact texel centers read the texel itself
    i = jnp.asarray([0.0, 5.0, 127.0], jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(bilinear_take(sc, i, i, 128)),
        np.asarray(sc)[[0, 5, 127], [0, 5, 127]],
    )


def _compare_vs_ref(density, w, h, n, atol_mean):
    s2l, eye_l, light_l = _frame_consts(w, h)
    ref = np.asarray(
        raymarch_ref(
            density, jnp.asarray(s2l), jnp.asarray(eye_l), jnp.asarray(light_l),
            jnp.asarray(CLEAR), w, h, n_samples=128, n_light=32,
        )
    )
    lv = light_sweep_host(density, light_l, n)
    img = np.asarray(
        raymarch_shearwarp(
            density, lv, s2l, eye_l, CLEAR, w, h,
        )
    )
    assert img.shape == ref.shape
    diff = np.abs(img - ref)
    assert diff.mean() < atol_mean, (diff.mean(), np.quantile(diff, 0.99))
    return ref, img


def test_shearwarp_empty_grid_is_clear():
    density = jnp.zeros((32, 32, 32), jnp.float32)
    w = h = 24
    s2l, eye_l, light_l = _frame_consts(w, h)
    lv = light_sweep_host(density, light_l, 32)
    img = np.asarray(
        raymarch_shearwarp(density, lv, s2l, eye_l, CLEAR, w, h)
    )
    np.testing.assert_allclose(img, np.broadcast_to(CLEAR, img.shape), atol=1e-4)


def test_shearwarp_box_close_to_reference():
    verts, _, tris = box_mesh([-0.7, -0.5, -0.6], [0.4, 0.66, 0.55])
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=32).astype(
        jnp.float32
    )
    _compare_vs_ref(density, 64, 48, 32, atol_mean=0.03)


def test_shearwarp_pallas_resolve_full_path():
    """The real screen mapping through the resolve on a wide screen
    (intermediate rows track screen-y after the swap) stays close to the
    exact renderer."""
    verts, _, tris = box_mesh([-0.7, -0.5, -0.6], [0.4, 0.66, 0.55])
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=32).astype(
        jnp.float32
    )
    _compare_vs_ref(density, 160, 96, 32, atol_mean=0.03)


def test_shearwarp_tet_close_to_reference():
    verts, _, tris = tetrahedron_mesh()
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=32).astype(
        jnp.float32
    )
    _compare_vs_ref(density, 48, 48, 32, atol_mean=0.03)


def test_resolver_wide_intermediates():
    """The bilinear resolve matches the independent sampler for m in
    {128, 256, 512} (the -quality cap)."""
    rng = np.random.default_rng(11)
    for m in (128, 256, 512):
        sc = jnp.asarray(rng.random((m, m)), jnp.float32)
        p = 4096
        gx = jnp.asarray(rng.uniform(-1, m, size=p), jnp.float32)
        gy = jnp.asarray(rng.uniform(-1, m, size=p), jnp.float32)
        got = np.asarray(bilinear_take(sc, gx, gy, m))
        np.testing.assert_allclose(got, _bilinear_reference(sc, gx, gy),
                                   atol=1e-5, err_msg=f"m={m}")


def test_point_light_sweep_close_to_exact_field():
    """Perspective point-light sweep vs the exact per-voxel point march."""
    from dxrvoxelizer_tpu.ops.raymarch_warp import light_sweep_point_host

    verts, _, tris = tetrahedron_mesh()
    density = voxelize_parity_ref(
        jnp.asarray(verts), jnp.asarray(tris), n=32
    ).astype(jnp.float32)
    light = np.array([-3.0, 8.0, -12.0], np.float32)  # outside, -z major
    lv_sweep = np.asarray(light_sweep_point_host(density, light, 32))
    lv_ref = np.asarray(precompute_light_volume(
        density, jnp.asarray(light), n_light=32, point_light=True
    ))
    assert (lv_sweep >= 0).all() and (lv_sweep <= 1.0 + 1e-5).all()
    diff = np.abs(lv_sweep - lv_ref)
    assert diff.mean() < 0.03, diff.mean()


def test_point_light_sweep_inside_falls_back_to_exact():
    """A light inside the volume cannot be swept; the host wrapper returns
    the exact per-voxel field."""
    from dxrvoxelizer_tpu.ops.raymarch_warp import light_sweep_point_host

    verts, _, tris = tetrahedron_mesh()
    density = voxelize_parity_ref(
        jnp.asarray(verts), jnp.asarray(tris), n=16
    ).astype(jnp.float32)
    light = np.array([0.1, 0.2, -0.1], np.float32)  # inside the box
    lv = np.asarray(light_sweep_point_host(density, light, 16))
    lv_ref = np.asarray(precompute_light_volume(
        density, jnp.asarray(light), n_light=32, point_light=True
    ))
    np.testing.assert_allclose(lv, lv_ref, atol=1e-6)


def _light_sweep_ref_scan(density, light_local, n, axis, flip, d0,
                          n_light=32):
    """Per-slab sliding-window form of the reference-step light
    recurrence — the pre-round-5 implementation, kept as the parity
    oracle for the blocked form (light_sweep_ref batches d0 slabs per
    scan step; it must be the same arithmetic op for op)."""
    from functools import partial as _p

    import jax

    from dxrvoxelizer_tpu.ops.raymarch_ref import MAX_DIST
    from dxrvoxelizer_tpu.ops.raymarch_warp import (
        ABSORPTION,
        TEX_SCALE,
        _perm_for_axis,
    )

    assert d0 >= 1
    ls = MAX_DIST / n_light
    ld = light_local / jnp.linalg.norm(light_local)
    s_full = jnp.asarray(TEX_SCALE) * ld * ls
    perm = _perm_for_axis(axis)
    dens = jnp.transpose(density, perm)
    s_t = s_full[jnp.asarray(perm)]
    if flip:
        dens = dens[:, :, ::-1]
        s_t = s_t * jnp.asarray([1.0, 1.0, -1.0])
    dvol = jnp.moveaxis(dens, -1, 0)
    delta = s_t[2] * n
    w = delta - d0
    sx = s_t[0] * n
    sy = s_t[1] * n
    i = jnp.arange(n, dtype=jnp.float32)
    coords_x = i + sx
    coords_y = i + sy
    wx_l = interp_matrix(coords_x, n)
    wy_l = interp_matrix(coords_y, n)
    corr_l = 1.0 - wx_l.sum(-1)[:, None] * wy_l.sum(-1)[None, :]
    wx_d = interp_matrix(jnp.clip(coords_x, 0.0, n - 1.0), n)
    wy_d = interp_matrix(jnp.clip(coords_y, 0.0, n - 1.0), n)
    px = (i + 0.5) / n + s_t[0]
    py = (i + 0.5) / n + s_t[1]
    in_xy = ((px >= 0.0) & (px <= 1.0))[:, None] & (
        (py >= 0.0) & (py <= 1.0)
    )[None, :]
    k = jnp.arange(n, dtype=jnp.float32)
    in_z = (k + 0.5) / n + s_t[2] <= 1.0
    ki = jnp.arange(n)
    z0 = jnp.clip(ki + d0, 0, n - 1)
    z1 = jnp.clip(ki + d0 + 1, 0, n - 1)
    dmix = dvol[z0] * (1.0 - w) + dvol[z1] * w
    dres = jnp.einsum("mn,kny->kmy", wx_d, dmix, precision="highest")
    dres = jnp.einsum("kmy,py->kmp", dres, wy_d, precision="highest")
    g = jnp.minimum(dres * 8.0, 16.0)
    att = jnp.clip(1.0 - ABSORPTION * ls * g, 0.0, 1.0)
    mask = in_xy[None] & in_z[:, None, None]

    def body(win, xs):
        att_k, mask_k = xs
        lmix = win[d0 - 1] * (1.0 - w) + win[d0] * w
        lres = wx_l @ lmix @ wy_l.T + corr_l
        l_k = jnp.where(mask_k, att_k * lres, 1.0)
        return jnp.concatenate([l_k[None], win[:-1]], axis=0), l_k

    init = jnp.ones((d0 + 1, n, n), jnp.float32)
    _, ls_stack = jax.lax.scan(body, init, (att[::-1], mask[::-1]))
    lvol = ls_stack[::-1]
    lvol = jnp.moveaxis(lvol, 0, -1)
    if flip:
        lvol = lvol[:, :, ::-1]
    inv = np.argsort(np.asarray(perm))
    del _p
    return jnp.transpose(lvol, tuple(inv))


def test_light_sweep_ref_blocked_matches_per_slab_scan():
    """The blocked (d0-slabs-per-step) reference-step light recurrence
    matches the per-slab sliding-window scan it replaced to f32 ulp
    noise (the batched matmul lowers with a different (but equally
    valid) contraction vectorization — measured max |diff| 1.8e-7 on
    this fixture; the recurrence is contractive (att <= 1) so the noise
    cannot amplify). Covers an n % d0 != 0 partial block. The -hq
    product contract itself is the golden-image bounds
    (tests/test_goldens.py)."""
    from dxrvoxelizer_tpu.ops.raymarch_warp import (
        light_ref_statics,
        light_sweep_ref,
    )

    rng = np.random.default_rng(3)
    for n, light in ((64, (8.0, 12.0, -14.0)), (64, (2.0, 15.0, 3.0)),
                     (32, (-9.0, 11.0, 13.0))):
        density = jnp.asarray(
            (rng.random((n, n, n)) < 0.12).astype(np.float32)
        )
        light_np = np.asarray(light, np.float32)
        axis, flip, d0 = light_ref_statics(light_np, n)
        if d0 < 1:
            continue
        a = light_sweep_ref(density, jnp.asarray(light_np), n, axis, flip,
                            d0)
        b = _light_sweep_ref_scan(density, jnp.asarray(light_np), n, axis,
                                  flip, d0)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0.0, atol=5e-6,
            err_msg=str((n, light, d0)),
        )
