"""OBJ loader unit tests (SURVEY.md section 4: counts vs the shipped assets,
format coverage, DX conversion semantics)."""

import numpy as np
import pytest

from dxrvoxelizer_tpu.utils.assets import find_asset
from dxrvoxelizer_tpu.utils.objloader import load_obj


def _write(tmp_path, text, name="m.obj"):
    p = tmp_path / name
    p.write_text(text)
    return p


def test_plain_triangle(tmp_path):
    p = _write(
        tmp_path,
        """
v 0 0 0
v 1 0 0
v 0 1 0
f 1 2 3
""",
    )
    m = load_obj(p, for_dx=False)
    assert m.num_vertices == 3
    assert m.num_triangles == 1
    np.testing.assert_allclose(m.positions[1], [1, 0, 0])
    # recomputed normal for CCW triangle in z=0 plane -> +z
    np.testing.assert_allclose(m.normals[0], [0, 0, 1], atol=1e-6)


def test_dx_conversion_flips_z_and_reverses_indices(tmp_path):
    p = _write(
        tmp_path,
        """
v 0 0 1
v 1 0 1
v 0 1 1
f 1 2 3
""",
    )
    m = load_obj(p, for_dx=True)
    # z negated (XUSGObjLoader.cpp:198)
    assert np.all(m.positions[:, 2] == -1)
    # whole flat index stream reversed (XUSGObjLoader.cpp:227)
    np.testing.assert_array_equal(m.indices, [2, 1, 0])


def test_fan_triangulation(tmp_path):
    p = _write(
        tmp_path,
        """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
""",
    )
    m = load_obj(p, for_dx=False)
    assert m.num_triangles == 2
    np.testing.assert_array_equal(m.triangles, [[0, 1, 2], [0, 2, 3]])


def test_negative_indices(tmp_path):
    p = _write(
        tmp_path,
        """
v 0 0 0
v 1 0 0
v 0 1 0
f -3 -2 -1
""",
    )
    m = load_obj(p, for_dx=False)
    np.testing.assert_array_equal(m.triangles, [[0, 1, 2]])


def test_v_slash_vt_format(tmp_path):
    p = _write(
        tmp_path,
        """
v 0 0 0
v 1 0 0
v 0 1 0
vt 0 0
vt 1 0
vt 0 1
f 1/1 2/2 3/3
""",
    )
    m = load_obj(p, for_dx=False)
    assert m.num_triangles == 1
    np.testing.assert_array_equal(m.triangles, [[0, 1, 2]])


def test_vertex_split_on_normal_mismatch(tmp_path):
    # two triangles sharing vertices 1&3 but with different normal indices on
    # the shared corners -> the shared corners split (XUSGObjLoader.cpp:313-322)
    p = _write(
        tmp_path,
        """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vn 0 1 0
f 1//1 2//1 3//1
f 3//2 4//2 1//2
""",
    )
    m = load_obj(p, for_dx=False)
    # corners (3,//2) and (1,//2) mismatch their first normals -> 2 splits
    assert m.num_vertices == 6
    assert m.num_triangles == 2
    np.testing.assert_allclose(m.normals[0], [0, 0, 1])
    # split copies carry the second normal
    np.testing.assert_allclose(m.normals[4], [0, 1, 0])
    np.testing.assert_allclose(m.normals[5], [0, 1, 0])


def test_aabb(tmp_path):
    p = _write(
        tmp_path,
        """
v -1 2 0.5
v 3 -4 1.5
v 0 0 0
f 1 2 3
""",
    )
    m = load_obj(p, for_dx=False)
    np.testing.assert_allclose(m.aabb_min, [-1, -4, 0])
    np.testing.assert_allclose(m.aabb_max, [3, 2, 1.5])
    b = m.bound()
    np.testing.assert_allclose(b, [1.0, -1.0, 0.75, 3.0])


@pytest.mark.parametrize(
    "name,verts,tris",
    [
        ("bunny.obj", 34835, 69666),
        ("dragon.obj", 50000, 100000),
    ],
)
def test_canonical_assets_counts(reference_assets_available, name, verts, tris):
    m = load_obj(find_asset(name))
    assert m.num_vertices == verts
    assert m.num_triangles == tris
    # normals recomputed and unit-length
    lens = np.linalg.norm(m.normals, axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-3)


def test_turing_bowl_counts(reference_assets_available):
    m = load_obj(find_asset("TuringBowl.obj"))
    # 15,359 v-lines; file normals present (14,260) -> splitting may add verts
    assert m.num_triangles == 22744
    assert m.num_vertices >= 15359
    lens = np.linalg.norm(m.normals, axis=1)
    np.testing.assert_allclose(lens[lens > 0], 1.0, atol=1e-3)


def _generated_obj(tmp_path, n_tris=5120, seed=3):
    from dxrvoxelizer_tpu.models.procedural import (
        displaced_icosphere,
        write_obj,
    )

    v, nr, t = displaced_icosphere(n_tris, seed=seed)
    return load_obj(write_obj(tmp_path / f"ico_{n_tris}_{seed}.obj", v, nr, t))


class TestSubdivide:
    def test_counts_and_surface(self, tmp_path):
        from dxrvoxelizer_tpu.utils.objloader import subdivide

        m = _generated_obj(tmp_path)
        s = subdivide(m, 1)
        assert s.num_triangles == 4 * m.num_triangles
        # midpoints dedup: V' = V + E; for a closed triangle mesh E = 3T/2
        assert s.num_vertices <= m.num_vertices + 3 * m.num_triangles // 2 + 8
        # children tile the parent: total area is preserved
        def area(mesh):
            t = mesh.triangles
            p = mesh.positions
            c = np.cross(p[t[:, 1]] - p[t[:, 0]], p[t[:, 2]] - p[t[:, 0]])
            return float(np.linalg.norm(c, axis=1).sum())
        np.testing.assert_allclose(area(s), area(m), rtol=1e-4)

    def test_voxelization_invariant(self, tmp_path):
        """Subdivision leaves the surface unchanged -> parity grids agree."""
        from dxrvoxelizer_tpu.models.mesh import MeshBuffers
        from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref
        from dxrvoxelizer_tpu.utils.objloader import subdivide

        m = _generated_obj(tmp_path, n_tris=1280)
        s = subdivide(m, 1)
        b0 = MeshBuffers.from_obj(m)
        b1 = MeshBuffers.from_obj(s, bound=m.bound())
        g0 = np.asarray(voxelize_parity_ref(b0.positions_norm, b0.tris, n=32))
        g1 = np.asarray(voxelize_parity_ref(b1.positions_norm, b1.tris, n=32))
        # co-planar splits can flip boundary-exact crossings only
        agree = (g0 == g1).mean()
        assert agree > 0.999, agree

    def test_cli_flag(self):
        from dxrvoxelizer_tpu.utils.config import parse_args

        cfg = parse_args(["-mesh", "dragon.obj", "-subdiv", "2"])
        assert cfg.subdiv == 2


class TestProceduralMesh:
    """The seeded generator behind chip_smoke.py and the benchmarks."""

    @pytest.mark.parametrize("n_tris", [80, 1280, 81920])
    def test_exact_count_and_closed(self, n_tris):
        from dxrvoxelizer_tpu.models.procedural import displaced_icosphere

        v, nr, t = displaced_icosphere(n_tris, seed=7)
        assert t.shape == (n_tris, 3) and t.dtype == np.int32
        assert v.shape == nr.shape and v.dtype == np.float32
        # closed: every undirected edge has exactly two faces, and the
        # two traverse it in opposite directions (consistent winding)
        directed = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        und = np.sort(directed, axis=1)
        _, counts = np.unique(und, axis=0, return_counts=True)
        assert (counts == 2).all()
        assert len(np.unique(directed, axis=0)) == len(directed)
        np.testing.assert_allclose(np.linalg.norm(nr, axis=1), 1.0,
                                   atol=1e-5)
        assert np.abs(v).max() < 1.0

    def test_seeded(self):
        from dxrvoxelizer_tpu.models.procedural import displaced_icosphere

        a = displaced_icosphere(1280, seed=11)
        b = displaced_icosphere(1280, seed=11)
        c = displaced_icosphere(1280, seed=12)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert not np.array_equal(a[0], c[0])
        np.testing.assert_array_equal(a[2], c[2])  # same topology

    def test_bad_count_raises(self):
        from dxrvoxelizer_tpu.models.procedural import displaced_icosphere

        with pytest.raises(ValueError):
            displaced_icosphere(1000)

    def test_obj_roundtrip(self, tmp_path):
        from dxrvoxelizer_tpu.models.procedural import displaced_icosphere

        v, _, t = displaced_icosphere(320, seed=2)
        m = _generated_obj(tmp_path, n_tris=320, seed=2)
        assert m.num_triangles == 320
        # the loader converts to the reference's D3D frame (z mirrored,
        # winding reversed) and may reorder faces: the set of face
        # centroids survives all of that
        p = m.positions.copy()
        p[:, 2] *= -1.0

        def centroids(pos, tri):
            c = pos[tri].mean(axis=1)
            key = np.round(c, 4)  # order robust to last-bit differences
            return c[np.lexsort(key.T[::-1])]

        np.testing.assert_allclose(
            centroids(p, m.triangles), centroids(v, t), atol=1e-6
        )
