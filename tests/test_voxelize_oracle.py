"""Oracle voxelizer tests vs independent float64 NumPy brute force
(SURVEY.md section 4: inside/outside classification on analytic shapes)."""

import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops.packing import voxel_centers_norm
from dxrvoxelizer_tpu.ops.voxelize_ref import (
    voxelize_parity_ref,
    voxelize_raystab_ref,
)
from meshes import (
    box_mesh,
    closest_hit_bruteforce,
    point_in_mesh_bruteforce,
    tetrahedron_mesh,
)

N = 16


def _grid_centers(n):
    cx, cy, cz = voxel_centers_norm(n)
    px, py, pz = np.meshgrid(cx, cy, cz, indexing="ij")
    return np.stack([px, py, pz], axis=-1).reshape(-1, 3)


def test_parity_box_matches_analytic():
    lo = np.array([-0.52, 0.07, -0.73])
    hi = np.array([0.31, 0.81, 0.22])
    verts, _, tris = box_mesh(lo, hi)
    occ = np.asarray(voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=N))
    centers = _grid_centers(N)
    expect = np.all((centers > lo) & (centers < hi), axis=1).reshape(N, N, N)
    np.testing.assert_array_equal(occ, expect)


def test_parity_tet_matches_bruteforce():
    verts, _, tris = tetrahedron_mesh()
    occ = np.asarray(voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=N))
    centers = _grid_centers(N)
    expect = point_in_mesh_bruteforce(centers, verts, tris).reshape(N, N, N)
    np.testing.assert_array_equal(occ, expect)
    assert occ.any()  # non-trivial


def test_parity_winding_invariant():
    verts, _, tris = tetrahedron_mesh()
    occ1 = np.asarray(voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=N))
    flipped = tris[:, [0, 2, 1]]
    occ2 = np.asarray(voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(flipped), n=N))
    np.testing.assert_array_equal(occ1, occ2)


def test_parity_empty_outside_grid():
    verts, _, tris = box_mesh([5.0, 5.0, 5.0], [6.0, 6.0, 6.0])
    occ = np.asarray(voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=N))
    assert not occ.any()


def test_raystab_tet_matches_bruteforce():
    verts, norms, tris = tetrahedron_mesh()
    occ, rgba = voxelize_raystab_ref(
        jnp.asarray(verts), jnp.asarray(norms), jnp.asarray(tris),
        n=N, ray_chunk=1024,
    )
    occ = np.asarray(occ)
    rgba = np.asarray(rgba)

    centers = _grid_centers(N)
    lens = np.linalg.norm(centers, axis=1, keepdims=True)
    dirs = centers / np.maximum(lens, 1e-20)
    t, idx, u, v = closest_hit_bruteforce(centers, dirs, verts, tris)
    hit = np.isfinite(t) & (idx >= 0)
    n0 = norms[tris[np.maximum(idx, 0), 0]]
    n1 = norms[tris[np.maximum(idx, 0), 1]]
    n2 = norms[tris[np.maximum(idx, 0), 2]]
    nr = n0 + u[:, None] * (n1 - n0) + v[:, None] * (n2 - n0)
    nr = nr / np.maximum(np.linalg.norm(nr, axis=1, keepdims=True), 1e-20)
    expect = hit & ((nr * dirs).sum(axis=1) > 0.12)
    expect = expect.reshape(N, N, N)

    # f32 vs f64 may disagree only on boundary-grazing voxels; require exact
    # match here (fixture is chosen off-grid) and verify it really is exact.
    np.testing.assert_array_equal(occ, expect)
    assert occ.any()

    # rgba: alpha == 1 and unit normal exactly where inside
    np.testing.assert_array_equal(rgba[..., 3] > 0, occ)
    inside_n = rgba[occ][:, :3]
    np.testing.assert_allclose(np.linalg.norm(inside_n, axis=1), 1.0, atol=1e-5)


def test_raystab_box_matches_bruteforce():
    # asymmetric off-center box (a symmetric box would put diagonal voxel rays
    # exactly through box edges, where f32/f64 legitimately disagree);
    # grazing exits (dot <= 0.12) are excluded by the reference's threshold.
    verts, norms, tris = box_mesh([-0.62, -0.55, -0.53], [0.57, 0.66, 0.49])
    occ, _ = voxelize_raystab_ref(
        jnp.asarray(verts), jnp.asarray(norms), jnp.asarray(tris),
        n=N, ray_chunk=1024,
    )
    occ = np.asarray(occ)
    centers = _grid_centers(N)
    lens = np.linalg.norm(centers, axis=1, keepdims=True)
    dirs = centers / np.maximum(lens, 1e-20)
    t, idx, u, v = closest_hit_bruteforce(centers, dirs, verts, tris)
    hit = np.isfinite(t) & (idx >= 0)
    fn = norms[tris[np.maximum(idx, 0), 0]]  # per-face normals (flat box faces)
    expect = (hit & ((fn * dirs).sum(axis=1) > 0.12)).reshape(N, N, N)
    np.testing.assert_array_equal(occ, expect)
    # no voxel outside the solid is ever classified inside
    inside_box = np.all(
        (centers > [-0.62, -0.55, -0.53]) & (centers < [0.57, 0.66, 0.49]), axis=1
    ).reshape(N, N, N)
    assert (occ & ~inside_box).sum() == 0
    assert occ.any()


def test_parity_and_raystab_agree_on_watertight_solid():
    # for a well-behaved closed solid the two rules agree away from grazing
    verts, norms, tris = box_mesh([-0.45, -0.35, -0.55], [0.5, 0.65, 0.4])
    par = np.asarray(voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=N))
    stab, _ = voxelize_raystab_ref(
        jnp.asarray(verts), jnp.asarray(norms), jnp.asarray(tris),
        n=N, ray_chunk=1024,
    )
    np.testing.assert_array_equal(par, np.asarray(stab))
