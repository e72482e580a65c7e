"""Direction-space-binned ray-stab voxelizer vs the brute-force oracles.

The production query (gen-6/7 tables, ops/raystab_fast.py) must reproduce
the radial oracle bit-for-bit: same radial expressions (ops/intersect.py
radial_hit) and the same winner rule (strictly closer t, ties to the
lowest triangle index). The gen-1 gather query reproduces the
Moller-Trumbore oracle's occupancy (same mt_hit expressions); its normals
agree to float rounding (the winning u, v are recomputed in a different
broadcast shape).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dxrvoxelizer_tpu.ops.raystab_fast import (
    bin_triangles_radial,
    build_raystab_accel,
    raystab_query,
    voxelize_raystab_fast,
)
from dxrvoxelizer_tpu.ops.voxelize_ref import (
    voxelize_raystab_radial_ref,
    voxelize_raystab_ref,
)
from meshes import box_mesh, icosphere_mesh, tetrahedron_mesh


def _cases():
    bv, bn, bt = box_mesh(np.array([-0.7, -0.5, -0.3]), np.array([0.4, 0.8, 0.6]))
    tv, tn, tt = tetrahedron_mesh()
    iv, inr, it = icosphere_mesh(3)
    return {
        "tet": (tv, tn, tt),  # all triangles overflow (origin inside balls)
        "box": (bv, bn, bt),
        "ico": (iv, inr, it),  # 1280 small triangles: exercises cell bins
    }


@pytest.mark.parametrize("name", ["tet", "box", "ico"])
def test_fast_matches_oracle(name):
    v, nr, t = _cases()[name]
    v, nr, t = jnp.asarray(v), jnp.asarray(nr), jnp.asarray(t, jnp.int32)
    n = 32
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=n)
    occ_f, rgba_f = voxelize_raystab_fast(v, nr, t, n=n)
    assert (np.asarray(occ_r) == np.asarray(occ_f)).all()
    np.testing.assert_allclose(
        np.asarray(rgba_r), np.asarray(rgba_f), atol=1e-5
    )


def test_build_then_query_reuses_accel():
    v, nr, t = _cases()["ico"]
    v, nr, t = jnp.asarray(v), jnp.asarray(nr), jnp.asarray(t, jnp.int32)
    accel = build_raystab_accel(v, t, n=32)
    occ1, _ = raystab_query(v, nr, t, accel)
    occ2, _ = voxelize_raystab_ref(v, nr, t, n=32, ray_chunk=2048)
    assert (np.asarray(occ1) == np.asarray(occ2)).all()
    # the ico bins into cells (not everything overflows)
    assert sum(int(c[0].shape[0]) for c in accel.classes) > 0


def test_radial_bins_conservative():
    """Every triangle is either in some cell bin or in overflow."""
    v, _, t = _cases()["ico"]
    v, t = jnp.asarray(v), jnp.asarray(t, jnp.int32)
    table, counts, ov_ids, stats = bin_triangles_radial(v, t)
    binned = set(np.asarray(table)[np.asarray(table) >= 0].tolist())
    over = set(np.asarray(ov_ids)[np.asarray(ov_ids) >= 0].tolist())
    assert binned | over == set(range(t.shape[0]))


def test_empty_mesh():
    occ, rgba = voxelize_raystab_fast(
        jnp.zeros((0, 3), jnp.float32),
        jnp.zeros((0, 3), jnp.float32),
        jnp.zeros((0, 3), jnp.int32),
        n=32,
    )
    assert not np.asarray(occ).any()
    assert not np.asarray(rgba).any()


def test_pipeline_caches_accel_and_rebuilds_on_deform():
    import dataclasses

    from dxrvoxelizer_tpu.core.pipeline import FramePipeline
    from dxrvoxelizer_tpu.models.mesh import MeshBuffers
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig
    from test_mips import _consts

    v, nr, t = _cases()["ico"]
    mesh = MeshBuffers(
        positions=jnp.asarray(v), normals=jnp.asarray(nr),
        tris=jnp.asarray(t, jnp.int32), positions_norm=jnp.asarray(v),
    )
    cfg = VoxelizerConfig(grid_size=32, width=32, height=32,
                          inside_mode="raystab")
    pipe = FramePipeline(cfg, mesh, render_impl="gather")
    fc = _consts(cfg)
    pipe.frame(fc)
    a1 = pipe._stab_accel
    pipe.frame(fc)
    assert pipe._stab_accel is a1  # cached across frames
    pipe.mesh = dataclasses.replace(
        mesh, positions_norm=mesh.positions_norm * 1.01
    )
    pipe.frame(fc)
    assert pipe._stab_accel is not a1  # rebuilt after deform
    pipe.sync()


@pytest.mark.parametrize("name", ["tet", "box", "ico"])
def test_pallas_query_matches_oracle(name):
    """The fold kernel (interpret mode) over the gen-6 tables is bit-exact
    against the radial oracle, normals included."""
    from dxrvoxelizer_tpu.ops.raystab_fast import (
        build_raystab_accel2,
        raystab_query2,
    )

    v, nr, t = _cases()[name]
    v, nr, t = jnp.asarray(v), jnp.asarray(nr), jnp.asarray(t, jnp.int32)
    n = 32
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=n)
    accel = build_raystab_accel2(v, t, nr, n=n)
    occ_p, rgba_p = raystab_query2(v, nr, t, accel, interpret=True)
    assert (np.asarray(occ_r) == np.asarray(occ_p)).all()
    np.testing.assert_array_equal(np.asarray(rgba_r), np.asarray(rgba_p))


def test_dir_cells_host_matches_argmax_reference_and_scale():
    """The branchless f32 cell assignment keeps np.argmax's first-max tie
    rule and is scale-invariant (callers pass unnormalized voxel centers)."""
    import numpy as np

    from dxrvoxelizer_tpu.ops.raystab_fast import _OTHERS, _dir_cells_host

    rng = np.random.default_rng(7)
    d = rng.standard_normal((50000, 3)).astype(np.float32)
    d[:2000, 0] = d[:2000, 1]  # x/y axis ties
    d[2000:4000, 1] = d[2000:4000, 2]  # y/z ties
    d[4000:5000] = np.abs(d[4000:5000])  # positive octant
    for g in (4, 32):
        got = _dir_cells_host(d, g)
        # reference: literal argmax/fancy-index formulation (f32)
        ad = np.abs(d)
        a = np.argmax(ad, axis=-1)
        i = np.arange(d.shape[0])
        da = d[i, a]
        f = 2 * a + (da < 0)
        u = d[i, _OTHERS[a, 0]] / np.abs(da)
        v = d[i, _OTHERS[a, 1]] / np.abs(da)
        iu = np.clip(((u + 1.0) * (0.5 * g)).astype(np.int64), 0, g - 1)
        iv = np.clip(((v + 1.0) * (0.5 * g)).astype(np.int64), 0, g - 1)
        ref = f * g * g + iu * g + iv
        assert (got == ref).all()
        # scale invariance under power-of-two scales (exact in f32)
        s = np.float32(2.0) ** rng.integers(-2, 3, size=(d.shape[0], 1))
        assert (_dir_cells_host(d * s.astype(np.float32), g) == got).all()


def test_native_dir_cells_bitidentical():
    """accelpack.cpp's fused center-generation + cell assignment must be
    bit-identical to the numpy path in ray_tables."""
    import numpy as np
    import pytest

    from dxrvoxelizer_tpu.ops.packing import voxel_centers_norm
    from dxrvoxelizer_tpu.ops.raystab_fast import _dir_cells_host
    from dxrvoxelizer_tpu.utils import native

    if native.get_pack_lib() is None:
        pytest.skip("native toolchain unavailable")
    # incl. an ODD g (ADVICE r4: pin the single shared dir_cell_one
    # implementation across non-power-of-two cell grids too)
    for n, g in ((16, 4), (32, 8), (32, 32), (24, 5)):
        cx, cy, cz = voxel_centers_norm(n)
        pos = np.stack(
            np.meshgrid(cx, cy, cz, indexing="ij"), axis=-1
        ).reshape(-1, 3).astype(np.float32)
        ref = _dir_cells_host(pos, g)
        nat = native.dir_cells_native(n, g)
        np.testing.assert_array_equal(ref, nat)


def test_cone_bins_host_matches_padded_key_stream():
    """The rectangle-expansion binning (_cone_bins_host) must produce the
    SAME CSR as stable-sorting the historical dense (face, du, dv, tri)
    key stream — the order contract that keeps candidate tables (and the
    on-disk accel cache) bit-stable across the expansion rewrite."""
    import jax.numpy as jnp

    from dxrvoxelizer_tpu.ops.raystab_fast import _cone_bins_host, _cone_keys

    iv, inr, it = icosphere_mesh(3)
    span, g = 8, 16
    rects_d, over_d = _cone_keys(
        jnp.asarray(iv), jnp.asarray(it, jnp.int32), g, span
    )
    rects, over = np.asarray(rects_d), np.asarray(over_d)
    t_count = rects.shape[-1]
    n_cells = 6 * g * g

    # reference: materialize the padded key tensor exactly as the pre-
    # rewrite device code did, then tile + mask + stable sort
    du = np.arange(span)[:, None, None]
    dv = np.arange(span)[None, :, None]
    keys = []
    for f in range(6):
        iu0, iu1, iv0, iv1 = (rects[f, i] for i in range(4))
        fits = rects[f, 4] != 0
        su, sv = iu1 - iu0 + 1, iv1 - iv0 + 1
        cell = f * g * g + (iu0[None, None, :] + du) * g + (
            iv0[None, None, :] + dv
        )
        ok = (
            fits[None, None, :] & (du < su[None, None, :])
            & (dv < sv[None, None, :])
        )
        keys.append(np.where(ok, cell, n_cells))
    keys_f = np.stack(keys, 0).reshape(-1)
    tri_ids = np.tile(
        np.arange(t_count, dtype=np.int32), keys_f.shape[0] // t_count
    )
    mask = keys_f < n_cells
    kv, tv = keys_f[mask], tri_ids[mask]
    order = np.argsort(kv, kind="stable")
    sk, ref_tris = kv[order], tv[order]
    ref_starts = np.searchsorted(sk, np.arange(n_cells + 1)).astype(np.int64)

    st, starts, counts, ov = _cone_bins_host(rects, over, g, span)
    assert st.size > 0  # the fixture must actually exercise the bins
    np.testing.assert_array_equal(st, ref_tris)
    np.testing.assert_array_equal(starts, ref_starts)
    np.testing.assert_array_equal(counts, (ref_starts[1:] - ref_starts[:-1]))
    np.testing.assert_array_equal(ov, np.flatnonzero(over))
