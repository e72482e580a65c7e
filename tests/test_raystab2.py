"""Gen-2 ray-stab path (mip-level cubemap + radial-form kernel).

Ground-truth chain: the radial oracle (voxelize_raystab_radial_ref) defines
the gen-2 contract bit-for-bit; the radial oracle itself must agree with the
Moller-Trumbore oracle everywhere except fp-boundary near-ties (shared
edges hit within 1 ulp — only the axis-aligned box fixture, whose faces
align with voxel rays, produces any).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dxrvoxelizer_tpu.ops import intersect
from dxrvoxelizer_tpu.ops.raystab_fast import (
    LEVELS2,
    build_raystab_accel2,
    raystab_query,
    raystab_query2,
)
from dxrvoxelizer_tpu.ops.voxelize_ref import (
    voxelize_raystab_radial_ref,
    voxelize_raystab_ref,
)

from meshes import box_mesh, icosphere_mesh, tetrahedron_mesh


def _jx(mesh):
    v, n, t = mesh[:3]
    return jnp.asarray(v), jnp.asarray(n), jnp.asarray(t)


def test_radial_hit_matches_mt_on_radial_rays():
    """The radial-form test agrees with Moller-Trumbore (up to fp noise in
    t) for rays through the origin — the only rays the voxelizer shoots."""
    rng = np.random.default_rng(7)
    tris_v = rng.standard_normal((64, 3, 3)).astype(np.float32)
    pos = rng.standard_normal((256, 3)).astype(np.float32)
    length = np.linalg.norm(pos, axis=-1, keepdims=True)
    dirs = (pos / length).astype(np.float32)

    verts = jnp.asarray(tris_v.reshape(-1, 3))
    tris = jnp.arange(64 * 3, dtype=jnp.int32).reshape(64, 3)
    v0, e1, e2 = intersect.triangle_soup(verts, tris)
    t_mt, _, _, hit_mt = intersect.mt_hit(
        jnp.asarray(pos)[:, None, :], jnp.asarray(dirs)[:, None, :],
        v0[None], e1[None], e2[None],
    )
    g0, g1, g2, c = intersect.radial_setup(verts, tris)
    d = jnp.asarray(dirs)
    t_rad, hit_rad = intersect.radial_hit(
        d[:, None, 0], d[:, None, 1], d[:, None, 2],
        jnp.asarray(length),
        g0[None, :, 0], g0[None, :, 1], g0[None, :, 2],
        g1[None, :, 0], g1[None, :, 1], g1[None, :, 2],
        g2[None, :, 0], g2[None, :, 1], g2[None, :, 2],
        c[None, :],
    )
    agree = np.asarray(hit_mt) == np.asarray(hit_rad)
    assert agree.mean() > 0.999  # fp-boundary disagreements only
    both = np.asarray(hit_mt & hit_rad)
    tm, tr = np.asarray(t_mt)[both], np.asarray(t_rad)[both]
    assert np.allclose(tm, tr, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("subdiv,n", [(1, 32), (2, 32)])
def test_radial_oracle_matches_mt_oracle_icosphere(subdiv, n):
    """normal_impl="mt" reproduces the MT oracle's normals bit-for-bit;
    the default "radial" convention (the gen-3 kernel contract) agrees to
    float tolerance and on every occupancy bit here."""
    import numpy as np

    v, nr, t = _jx(icosphere_mesh(subdiv))
    occ_mt, rgba_mt = voxelize_raystab_ref(v, nr, t, n=n, ray_chunk=2048)
    occ_rad, rgba_rad = voxelize_raystab_radial_ref(
        v, nr, t, n=n, ray_chunk=2048, normal_impl="mt"
    )
    assert bool((occ_mt == occ_rad).all())
    assert bool((rgba_mt == rgba_rad).all())
    occ_r2, rgba_r2 = voxelize_raystab_radial_ref(
        v, nr, t, n=n, ray_chunk=2048
    )
    assert bool((occ_r2 == occ_mt).all())
    np.testing.assert_allclose(
        np.asarray(rgba_r2), np.asarray(rgba_mt), atol=2e-5
    )


def test_radial_oracle_near_mt_oracle_box():
    """Axis-aligned box faces produce fp-boundary near-ties; the two
    winner rules may differ on a handful of voxels, never more."""
    v, nr, t = _jx(box_mesh((-0.55, -0.45, -0.5), (0.5, 0.6, 0.45)))
    n = 32
    occ_mt, _ = voxelize_raystab_ref(v, nr, t, n=n, ray_chunk=2048)
    occ_rad, _ = voxelize_raystab_radial_ref(v, nr, t, n=n, ray_chunk=2048)
    mism = int((occ_mt != occ_rad).sum())
    assert mism <= 64, mism  # < 0.2% of the grid


@pytest.mark.parametrize(
    "mk,n",
    [
        (lambda: icosphere_mesh(2), 32),
        (lambda: box_mesh((-0.55, -0.45, -0.5), (0.5, 0.6, 0.45)), 32),
        (lambda: tetrahedron_mesh(), 32),
    ],
    ids=["icosphere", "box-near-origin", "tetrahedron"],
)
def test_accel2_query_bitexact_vs_radial_oracle(mk, n):
    """Streaming kernel (interpret), sort-merge, and packed finalize agree
    with the radial oracle bit-for-bit — occupancy AND normals."""
    v, nr, t = _jx(mk())
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=n, ray_chunk=2048)
    accel = build_raystab_accel2(v, t, nr, n=n)
    occ2, rgba2 = raystab_query2(v, nr, t, accel, interpret=True)
    assert bool((occ2 == occ_r).all())
    assert bool((rgba2 == rgba_r).all())


def test_accel2_level_assignment_partitions_triangles():
    """Every triangle lands in exactly one cubemap level (or the global
    near-origin list); the box fixture exercises the global list."""
    v, nr, t = _jx(box_mesh((-0.55, -0.45, -0.5), (0.5, 0.6, 0.45)))
    accel = build_raystab_accel2(v, t, nr, n=32)
    assert accel.stats.near_origin == int(t.shape[0])  # all contain origin
    v2, nr2, t2 = _jx(icosphere_mesh(2))
    accel2 = build_raystab_accel2(v2, t2, nr2, n=32)
    assert accel2.stats.near_origin == 0
    assert len(accel2.stats.levels) <= len(LEVELS2)


def test_raystab_query_dispatches_accel2():
    """raystab_query routes a RaystabAccel2 to the gen-2 radial path."""
    v, nr, t = _jx(icosphere_mesh(1))
    n = 32
    accel = build_raystab_accel2(v, t, nr, n=n)
    occ_a, rgba_a = raystab_query(v, nr, t, accel, interpret=True)
    occ_b, rgba_b = raystab_query2(v, nr, t, accel, interpret=True)
    assert bool((occ_a == occ_b).all())
    assert bool((rgba_a == rgba_b).all())


def test_class_caps_satisfy_kernel_chunking():
    """Caps above K_BLOCK must chunk evenly or candidates are never tested."""
    from dxrvoxelizer_tpu.ops.raystab_fast import CLASS_CAPS2
    from dxrvoxelizer_tpu.ops.raystab_pallas import K_BLOCK

    for k in CLASS_CAPS2:
        assert k % 8 == 0, k
        if k > K_BLOCK:
            assert k % K_BLOCK == 0, k


def test_accel2_multistrip_bitexact_vs_radial_oracle():
    """Cells with more rays than one 128-lane strip replicate their
    candidate row across strips. A g=4 cubemap at 32^3 averages ~341
    rays/cell (3 strips), exercising the strip replication + sort-merge
    exactly-once contract that a default 64^3 build never reaches (its
    cells all fit one strip)."""
    v, nr, t = _jx(icosphere_mesh(2))
    n = 32
    accel = build_raystab_accel2(v, t, nr, n=n, gs=(4,))
    from dxrvoxelizer_tpu.ops.raystab_fast import ray_tables

    rt, _ = ray_tables(n, 4)
    assert int((rt >= 0).sum(axis=1).max()) > 128  # multi-strip reached
    occ2, rgba2 = raystab_query2(v, nr, t, accel, interpret=True)
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=n)
    np.testing.assert_array_equal(np.asarray(occ2), np.asarray(occ_r))
    np.testing.assert_array_equal(np.asarray(rgba2), np.asarray(rgba_r))


def test_accel2_many_near_origin_triangles():
    """> K_BLOCK (256) near-origin triangles: the global-list capacity must
    round up to a K_BLOCK multiple or the gen-2 query asserts (regression:
    a 300-tri soup straddling the origin used to crash the accel build)."""
    rng = np.random.default_rng(11)
    nt = 300
    centers = rng.standard_normal((nt, 1, 3)).astype(np.float32) * 0.02
    offsets = rng.standard_normal((nt, 3, 3)).astype(np.float32) * 0.3
    tri_v = centers + offsets
    verts = jnp.asarray(tri_v.reshape(-1, 3))
    tris = jnp.arange(nt * 3, dtype=jnp.int32).reshape(nt, 3)
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    normals = jnp.asarray(np.repeat(fn, 3, axis=0).astype(np.float32))

    n = 32
    accel = build_raystab_accel2(verts, tris, normals, n=n)
    assert accel.stats.near_origin > 256
    occ_r, rgba_r = voxelize_raystab_radial_ref(
        verts, normals, tris, n=n, ray_chunk=2048
    )
    occ2, rgba2 = raystab_query2(verts, normals, tris, accel, interpret=True)
    assert bool((occ2 == occ_r).all())
    assert bool((rgba2 == rgba_r).all())


def test_accel2_three_level_ladder_bitexact():
    """Hi-res grids use a deeper cubemap ladder (build_raystab_accel2 picks
    finer top levels at 128^3/256^3); exercise a 3-level ladder at a small
    grid and pin bit-exactness vs the radial oracle."""
    v, nr, t = _jx(icosphere_mesh(2))
    n = 32
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=n, ray_chunk=2048)
    accel = build_raystab_accel2(v, t, nr, n=n, gs=(16, 8, 4))
    assert len(accel.stats.levels) <= 3
    occ2, rgba2 = raystab_query2(v, nr, t, accel, interpret=True)
    assert bool((occ2 == occ_r).all())
    assert bool((rgba2 == rgba_r).all())


def test_accel2_chunk_skip_dense_cone_bitexact():
    """A finely tessellated small sphere far off-center packs thousands of
    candidates into a few direction cells -> multi-chunk classes with
    distance-sorted candidates and kernel chunk skipping. Must stay
    bit-exact vs the radial oracle (the skip bound is strict)."""
    import numpy as np

    v_np, n_np, t_np = icosphere_mesh(3, radius=0.08,
                                      center=(0.5, 0.3, -0.4))
    v, nr, t = (jnp.asarray(v_np), jnp.asarray(n_np), jnp.asarray(t_np))
    n = 16
    accel = build_raystab_accel2(v, t, nr, n=n)
    # the dense cone must actually produce a multi-chunk class
    from dxrvoxelizer_tpu.ops.raystab_fast import table_k

    ks = [table_k(c[1]) for lv in accel.levels for c in lv]
    assert max(ks) > 256, ks
    assert any(c[3] is not None for lv in accel.levels for c in lv)
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=n, ray_chunk=2048)
    occ2, rgba2 = raystab_query2(v, nr, t, accel, interpret=True)
    assert int(np.asarray(occ_r).sum()) > 0  # fixture is not empty
    assert bool((occ2 == occ_r).all())
    assert bool((rgba2 == rgba_r).all())


def test_fused_fold_matches_standalone_fold():
    """The fold kernel's (t, id) must be bit-identical to the plain fold
    (raystab_fast.fold_extract_xla, which never skips a chunk) on every
    class — in both table layouts — and the extracted channels must be
    the finished rgba rows (the chunk skip and the winner extraction must
    not disturb the fold). Uses the dense-cone fixture so multi-chunk
    classes with skip bounds are exercised in BOTH layouts."""
    from dxrvoxelizer_tpu.ops.raystab_fast import (
        fold_extract_dispatch,
        fold_extract_xla,
        table_k,
    )

    v_np, n_np, t_np = icosphere_mesh(3, radius=0.08,
                                      center=(0.5, 0.3, -0.4))
    v, nr, t = (jnp.asarray(v_np), jnp.asarray(n_np), jnp.asarray(t_np))
    n = 16
    tc = int(t.shape[0])
    accel = build_raystab_accel2(v, t, nr, n=n)
    ks = tuple(
        tuple(table_k(c[1]) for c in lv) for lv in accel.levels
    )
    checked_multichunk = False
    checked_lanes = False
    for level, level_ks in zip(accel.levels, ks):
        for (rays, coefs, scatter, bounds, ntab), k in zip(level, level_ks):
            lanes = coefs.shape[-2] == 12 and coefs.shape[-1] != 12
            checked_lanes |= lanes
            cf_cl = (
                jnp.swapaxes(coefs, -1, -2) if lanes else coefs
            )  # classic [C, K, 12] view for the numpy recompute
            nt_cl = jnp.swapaxes(ntab, -1, -2) if lanes else ntab
            t_ref, i_ref, _ = fold_extract_xla(
                rays, coefs, ntab, k, tc, 0.12, bounds=bounds
            )
            t_f, i_f, ns = fold_extract_dispatch(
                rays, coefs, ntab, k, tc, 0.12, interpret=True,
                bounds=bounds,
            )
            assert bool((np.asarray(t_ref) == np.asarray(t_f)).all())
            assert bool((np.asarray(i_ref) == np.asarray(i_f)).all())
            a = np.asarray(ns[:, 3, :])
            assert set(np.unique(a)) <= {0.0, 1.0}
            # recompute the finished channels from the tables per hit lane
            # (numpy; tolerance covers FMA contraction vs the kernel)
            tn, iN, nsn = (np.asarray(t_f), np.asarray(i_f), np.asarray(ns))
            rn, cf, nt = (np.asarray(rays), np.asarray(cf_cl),
                          np.asarray(nt_cl))
            hits = np.argwhere(np.isfinite(tn) & (tn > -np.inf)
                               & (iN < tc))
            rng_idx = hits[:: max(1, len(hits) // 64)][:64]
            for ci, lane in rng_idx:
                d = rn[ci, 0:3, lane]
                row = np.where(cf[ci, :, 10] == iN[ci, lane])[0]
                assert len(row) == 1
                g9 = cf[ci, row[0], 0:9]
                n9 = nt[ci, row[0], 0:9]
                w = np.array([d @ g9[0:3], d @ g9[3:6], d @ g9[6:9]])
                den = w.sum()
                nsv = (w[:, None] * n9.reshape(3, 3)).sum(0) / den
                nsv = nsv / max(np.linalg.norm(nsv), 1e-20)
                inside = (nsv @ d) > 0.12
                got = nsn[ci, :, lane]
                if inside:
                    np.testing.assert_allclose(got[0:3], nsv, atol=2e-5)
                    assert got[3] == 1.0
                else:
                    assert (got == 0.0).all()
            checked_multichunk |= k > 256 and bounds is not None
    assert checked_multichunk  # fixture must cover the skip branch
    assert checked_lanes  # and at least one gen-5 lane-aligned class


def test_native_pack_matches_python_pack():
    """The C++ strip packer (utils/_native/accelpack.cpp) must reproduce
    _make_packs_py bit-for-bit: same packs, same ray order, same
    bound-sorted unique candidate lists (incl. bound ties), same CSR."""
    import dxrvoxelizer_tpu.ops.raystab_fast as rf
    from dxrvoxelizer_tpu.utils import native

    if native.get_pack_lib() is None:
        import pytest

        pytest.skip("native toolchain unavailable")

    rng = np.random.default_rng(5)
    C, rcap, V, T = 400, 192, 2048, 300
    rc = rng.integers(0, 190, C).astype(np.int64)  # > 128 hits big cells
    ray_table = np.full((C, rcap), -1, np.int32)
    for c in range(C):
        ray_table[c, : rc[c]] = rng.choice(V, rc[c], replace=False)
    lens = rng.integers(0, 16, C).astype(np.int64)
    offs = np.zeros(C + 1, np.int64)
    offs[1:] = np.cumsum(lens)
    data = rng.integers(0, T, int(offs[-1])).astype(np.int64)
    s0 = rng.uniform(0.0, 2.0, V + 1).astype(np.float32)
    tb = rng.uniform(0.0, 1.0, T)
    tb[rng.choice(T, 40)] = tb[0]  # bound ties exercise sort stability
    for bounds in (tb, None):
        py = rf._make_packs_py((offs, data), ray_table, rc, s0, bounds)
        nat = native.accel_pack_native(offs, data, ray_table, rc, s0, bounds)
        assert nat is not None
        for a, b in zip(py, nat):
            np.testing.assert_array_equal(a, b)


def test_native_class_tables_match_python():
    """accel_pack_tables_native (one-call walk + class partition + padded
    fills in C++) must reproduce the python class-table assembly array
    for array, including the padded-refit (runified) layout."""
    import dxrvoxelizer_tpu.ops.raystab_fast as rf
    from dxrvoxelizer_tpu.utils import native

    if native.get_pack_lib() is None:
        import pytest

        pytest.skip("native toolchain unavailable")

    v_np, n_np, t_np = icosphere_mesh(3, radius=0.6, center=(0.15, 0.0, 0.1))
    v, t = jnp.asarray(v_np), jnp.asarray(t_np)
    for pad in (0.0, 0.05):
        c_auto = rf.build_raystab_compact2(v, t, 32, pad=pad)
        orig = native.accel_pack_tables_native
        native.accel_pack_tables_native = lambda *a, **k: None
        try:
            c_py = rf.build_raystab_compact2(v, t, 32, pad=pad)
        finally:
            native.accel_pack_tables_native = orig
        assert len(c_auto.classes) == len(c_py.classes)
        for (r1, t1, b1), (r2, t2, b2) in zip(c_auto.classes, c_py.classes):
            np.testing.assert_array_equal(r1, r2)
            np.testing.assert_array_equal(t1, t2)
            if b1 is None:
                assert b2 is None
            else:
                np.testing.assert_array_equal(b1, b2)
        assert c_auto.stats == c_py.stats


def test_raytab_native_matches_numpy_and_radius_order():
    """The C++ counting-sort raytab (accelpack_raytab_*) must equal the
    numpy fallback bit-for-bit, and every cell's rays must ascend by
    (origin-radius f32 bits, voxel id) — the v3 contract the pack walk's
    strip slicing relies on."""
    import dxrvoxelizer_tpu.ops.raystab_fast as rf
    from dxrvoxelizer_tpu.ops.packing import voxel_centers_norm
    from dxrvoxelizer_tpu.utils import native

    if native.get_pack_lib() is None:
        import pytest

        pytest.skip("native toolchain unavailable")
    n, g = 16, 8
    nat = native.raytab_native(n, g)
    assert nat is not None
    orig = native.raytab_native
    native.raytab_native = lambda *a, **k: None
    rf._ray_table_filled.cache_clear()
    try:
        rt_p, rc_p = rf._ray_table_filled(n, g)
    finally:
        native.raytab_native = orig
        rf._ray_table_filled.cache_clear()
    np.testing.assert_array_equal(nat[0], np.asarray(rt_p))
    np.testing.assert_array_equal(nat[1], np.asarray(rc_p))
    # radius ordering within each cell
    cx, cy, cz = voxel_centers_norm(n)
    pos = np.stack(
        np.meshgrid(cx, cy, cz, indexing="ij"), axis=-1
    ).reshape(-1, 3).astype(np.float32)
    r = np.sqrt((pos * pos).sum(-1, dtype=np.float32))
    key = (r.view(np.uint32).astype(np.uint64) << np.uint64(32)) | np.arange(
        n ** 3, dtype=np.uint64
    )
    rt, rc = nat
    for c in range(rt.shape[0]):
        row = rt[c, : rc[c]]
        k = key[row]
        assert (k[1:] > k[:-1]).all()


def test_accel_build_native_and_python_paths_identical():
    """build_raystab_accel2 through the native packer == through the
    pure-Python fallback, array for array."""
    import jax.tree_util as jtu

    import dxrvoxelizer_tpu.ops.raystab_fast as rf
    from dxrvoxelizer_tpu.utils import native

    v_np, n_np, t_np = icosphere_mesh(2, radius=0.5, center=(0.2, 0.0, -0.1))
    v, nr, t = jnp.asarray(v_np), jnp.asarray(n_np), jnp.asarray(t_np)
    a_auto = rf.build_raystab_accel2(v, t, nr, n=16)
    orig = native.accel_pack_native
    orig_t = native.accel_pack_tables_native
    native.accel_pack_native = lambda *a, **k: None
    native.accel_pack_tables_native = lambda *a, **k: None
    try:
        a_py = rf.build_raystab_accel2(v, t, nr, n=16)
    finally:
        native.accel_pack_native = orig
        native.accel_pack_tables_native = orig_t
    assert a_auto.stats == a_py.stats
    la = jtu.tree_leaves((a_auto.levels, a_auto.ov_dense, a_auto.sort_keys))
    lp = jtu.tree_leaves((a_py.levels, a_py.ov_dense, a_py.sort_keys))
    assert len(la) == len(lp)
    for x, y in zip(la, lp):
        assert x.shape == y.shape
        assert bool((np.asarray(x) == np.asarray(y)).all())
