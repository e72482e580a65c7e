"""Fast (loop-free) ray-marcher vs the shader-exact reference renderer.

The only approximation in the fast path is sampling a precomputed light
volume instead of re-marching light from every primary sample; images must
agree tightly everywhere else."""

import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops.raymarch_fast import (
    precompute_light_volume,
    raymarch_fast,
)
from dxrvoxelizer_tpu.ops.raymarch_ref import raymarch_ref
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref
from meshes import box_mesh, tetrahedron_mesh
from test_raymarch import _frame_consts

CLEAR = np.array([0.0, 0.2, 0.4], dtype=np.float32)


def _render_both(density, w, h, ns=64, nl=16):
    s2l, eye_l, light_l = _frame_consts(w, h)
    ref = np.asarray(
        raymarch_ref(
            density, jnp.asarray(s2l), jnp.asarray(eye_l), jnp.asarray(light_l),
            jnp.asarray(CLEAR), w, h, n_samples=ns, n_light=nl,
        )
    )
    lv = precompute_light_volume(density, jnp.asarray(light_l), n_light=nl)
    fast = np.asarray(
        raymarch_fast(
            density, lv, jnp.asarray(s2l), jnp.asarray(eye_l),
            jnp.asarray(CLEAR), w, h, n_samples=ns,
        )
    )
    return ref, fast


def test_empty_grid_identical():
    density = jnp.zeros((16, 16, 16), dtype=jnp.float32)
    ref, fast = _render_both(density, 24, 16)
    np.testing.assert_allclose(fast, ref, atol=1e-6)


def test_box_scene_close_to_reference():
    verts, _, tris = box_mesh([-0.7, -0.5, -0.6], [0.4, 0.66, 0.55])
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=16).astype(
        jnp.float32
    )
    ref, fast = _render_both(density, 64, 48)
    diff = np.abs(ref - fast)
    assert diff.mean() < 0.01, diff.mean()
    assert np.quantile(diff, 0.99) < 0.1, np.quantile(diff, 0.99)


def test_tet_scene_close_to_reference():
    verts, _, tris = tetrahedron_mesh()
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=16).astype(
        jnp.float32
    )
    ref, fast = _render_both(density, 48, 48)
    diff = np.abs(ref - fast)
    assert diff.mean() < 0.01, diff.mean()


def test_light_volume_range_and_shadowing():
    verts, _, tris = box_mesh([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=16).astype(
        jnp.float32
    )
    light = jnp.asarray([-10.0, 45.0, -75.0], jnp.float32)
    lv = np.asarray(precompute_light_volume(density, light, n_light=16))
    assert lv.shape == (16, 16, 16)
    assert (lv >= 0).all() and (lv <= 1).all()
    # voxels deep inside the solid are darker than voxels outside it
    assert lv[8, 8, 8] < 0.2
    assert lv[0, 0, 0] > 0.5


def test_pixel_chunking_invariant():
    verts, _, tris = tetrahedron_mesh()
    density = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=16).astype(
        jnp.float32
    )
    w, h = 40, 24
    s2l, eye_l, light_l = _frame_consts(w, h)
    lv = precompute_light_volume(density, jnp.asarray(light_l), n_light=8)
    args = (density, lv, jnp.asarray(s2l), jnp.asarray(eye_l), jnp.asarray(CLEAR), w, h)
    one = np.asarray(raymarch_fast(*args, n_samples=32, px_chunk=1 << 17))
    many = np.asarray(raymarch_fast(*args, n_samples=32, px_chunk=256))
    np.testing.assert_allclose(one, many, atol=1e-6)


def test_point_light_ref_differs_and_converges_to_directional():
    """_POINT_LIGHT_ branch: a nearby point light shades differently from
    the directional default; a very distant one converges to it."""
    verts, _, tris = box_mesh([-0.6, -0.6, -0.6], [0.5, 0.5, 0.5])
    density = voxelize_parity_ref(
        jnp.asarray(verts), jnp.asarray(tris), n=16
    ).astype(jnp.float32)
    w, h = 48, 32
    s2l, eye_l, _ = _frame_consts(w, h)

    def ref(light, point):
        return np.asarray(raymarch_ref(
            density, jnp.asarray(s2l), jnp.asarray(eye_l),
            jnp.asarray(np.asarray(light, np.float32)), jnp.asarray(CLEAR),
            w, h, n_samples=32, n_light=8, point_light=point,
        ))

    near = np.array([0.3, 1.1, -0.4], np.float32)  # just above the volume
    img_dir = ref(near, False)
    img_pt = ref(near, True)
    assert np.abs(img_dir - img_pt).max() > 0.01  # genuinely different

    far = np.array([0.3, 2.0, -0.4], np.float32) * 1e5
    img_dir_far = ref(far, False)
    img_pt_far = ref(far, True)
    np.testing.assert_allclose(img_pt_far, img_dir_far, atol=1e-4)


def test_point_light_gather_close_to_reference():
    """Gather renderer with the point-light volume tracks the point-light
    reference as tightly as the directional pairing does."""
    verts, _, tris = tetrahedron_mesh()
    density = voxelize_parity_ref(
        jnp.asarray(verts), jnp.asarray(tris), n=16
    ).astype(jnp.float32)
    w, h = 64, 48
    s2l, eye_l, _ = _frame_consts(w, h)
    light = jnp.asarray(np.array([0.4, 1.8, -0.6], np.float32))
    ref = np.asarray(raymarch_ref(
        density, jnp.asarray(s2l), jnp.asarray(eye_l), light,
        jnp.asarray(CLEAR), w, h, n_samples=64, n_light=16,
        point_light=True,
    ))
    lv = precompute_light_volume(density, light, n_light=16,
                                 point_light=True)
    fast = np.asarray(raymarch_fast(
        density, lv, jnp.asarray(s2l), jnp.asarray(eye_l),
        jnp.asarray(CLEAR), w, h, n_samples=64,
    ))
    diff = np.abs(ref - fast)
    assert diff.mean() < 0.01, diff.mean()
    assert np.quantile(diff, 0.99) < 0.12, np.quantile(diff, 0.99)
