"""Gen-7 (output-major tiled) ray-stab accel: bit-exactness vs the radial
oracle and vs gen-2/6, refit parity, cache round-trip.

Ground truth chain as tests/test_raystab2.py: the radial oracle
(ops/voxelize_ref.voxelize_raystab_radial_ref) defines the reference-rule
result (DXRVoxelizer.hlsl:58-85 semantics); gen-7 must match it
bit-for-bit — occupancy AND normals — despite its per-tile candidate
unions and near-prefix drops (supersets/arithmetic-no-op deletions only;
see ops/raystab_tiled.py module docstring for the margin analysis).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from meshes import box_mesh, icosphere_mesh, tetrahedron_mesh

from dxrvoxelizer_tpu.ops.raystab_tiled import (
    TILE,
    RaystabTiledRefitter,
    build_raystab_accel7,
    build_raystab_compact7,
    raystab_query7,
)
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_raystab_radial_ref


def _jx(mesh):
    v, nr, t = mesh
    return jnp.asarray(v), jnp.asarray(nr), jnp.asarray(t)


@pytest.mark.parametrize(
    "mk,n",
    [
        (lambda: icosphere_mesh(2), 32),
        (lambda: box_mesh((-0.55, -0.45, -0.5), (0.5, 0.6, 0.45)), 32),
        (lambda: tetrahedron_mesh(), 32),
    ],
    ids=["icosphere", "box-near-origin", "tetrahedron"],
)
def test_tiled_query_bitexact_vs_radial_oracle(mk, n):
    v, nr, t = _jx(mk())
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=n,
                                                ray_chunk=2048)
    accel = build_raystab_accel7(v, t, nr, n=n)
    occ7, rgba7 = raystab_query7(v, nr, t, accel, interpret=True)
    assert bool((occ7 == occ_r).all())
    assert bool((rgba7 == rgba_r).all())


def test_tiled_near_drop_kills_far_tiles():
    """A small off-origin mesh leaves most tiles with zero candidates
    after the near-prefix drop — those tiles never reach the kernel and
    the query still matches the oracle exactly."""
    v, nr, t = _jx(icosphere_mesh(2, radius=0.25))
    n = 32
    compact = build_raystab_compact7(v, t, n=n)
    assert compact.stats.dead_tiles > 0
    total = compact.stats.dead_tiles + compact.stats.live_tiles
    assert total == n * n * n // 128
    accel = build_raystab_accel7(v, t, nr, n=n)
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=n,
                                                ray_chunk=2048)
    occ7, rgba7 = raystab_query7(v, nr, t, accel, interpret=True)
    assert bool((occ7 == occ_r).all())
    assert bool((rgba7 == rgba_r).all())


def test_tiled_near_origin_overflow_triangles():
    """Triangles whose direction cone contains the origin are unbinnable
    and must reach every tile's candidate list (minus the near drop) —
    the same 300-tri origin-straddling soup as the gen-2 overflow test."""
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
    compact = build_raystab_compact7(verts, tris, n=n)
    assert compact.stats.near_origin > 0
    accel = build_raystab_accel7(verts, tris, normals, n=n)
    occ_r, rgba_r = voxelize_raystab_radial_ref(
        verts, normals, tris, n=n, ray_chunk=2048
    )
    occ7, rgba7 = raystab_query7(verts, normals, tris, accel,
                                 interpret=True)
    assert bool((occ7 == occ_r).all())
    assert bool((rgba7 == rgba_r).all())


def test_tiled_matches_gen2_query():
    """Gen-7 and gen-2 produce identical grids (both are bit-exact vs the
    oracle, so this is a cheap cross-check on a second mesh/size)."""
    from dxrvoxelizer_tpu.ops.raystab_fast import (
        build_raystab_accel2,
        raystab_query2,
    )

    v, nr, t = _jx(icosphere_mesh(1))
    n = 32
    a2 = build_raystab_accel2(v, t, nr, n=n)
    a7 = build_raystab_accel7(v, t, nr, n=n)
    occ2, rgba2 = raystab_query2(v, nr, t, a2, interpret=True)
    occ7, rgba7 = raystab_query7(v, nr, t, a7, interpret=True)
    assert bool((occ7 == occ2).all())
    assert bool((rgba7 == rgba2).all())


def test_tiled_empty_mesh():
    v = jnp.zeros((0, 3), jnp.float32)
    t = jnp.zeros((0, 3), jnp.int32)
    nr = jnp.zeros((0, 3), jnp.float32)
    accel = build_raystab_accel7(v, t, nr, n=32)
    occ, rgba = raystab_query7(v, nr, t, accel, interpret=True)
    assert not bool(occ.any())
    assert not bool(rgba.any())


def test_tiled_refit_bitexact_vs_fresh_build():
    """A refitted gen-7 accel equals a fresh deformed-mesh query
    bit-for-bit (same contract as gen-6's RaystabRefitter)."""
    v, nr, t = _jx(icosphere_mesh(2))
    n = 32
    pad = 0.04
    rf = RaystabTiledRefitter(v, t, nr, n=n, pad=pad, pad_dirs=nr)
    amp = 0.03
    s = amp * jnp.sin(jnp.arange(v.shape[0], dtype=jnp.float32))
    vd = v + s[:, None] * nr
    accel_d = rf.refit(vd, check=True)
    occ_d, rgba_d = raystab_query7(vd, nr, t, accel_d, interpret=True)
    occ_r, rgba_r = voxelize_raystab_radial_ref(vd, nr, t, n=n,
                                                ray_chunk=2048)
    assert bool((occ_d == occ_r).all())
    assert bool((rgba_d == rgba_r).all())


def test_tiled_refit_contract_checks():
    v, nr, t = _jx(icosphere_mesh(1))
    rf = RaystabTiledRefitter(v, t, nr, n=32, pad=0.02, pad_dirs=nr)
    with pytest.raises(RuntimeError):
        rf.refit(v + 0.05 * jnp.asarray(nr), check=True)  # |s| > pad
    perp = jnp.cross(nr, jnp.asarray([0.0, 0.0, 1.0]))
    with pytest.raises(RuntimeError):
        rf.refit(v + 0.01 * perp, check=True)  # off-axis


def test_tiled_compact_cache_roundtrip(tmp_path):
    from dxrvoxelizer_tpu.utils.accel_cache import (
        cached_compact7,
        load_compact7,
        save_compact7,
    )

    v, nr, t = _jx(icosphere_mesh(1))
    c1 = cached_compact7(v, t, n=32, cache_dir=str(tmp_path))
    c2 = cached_compact7(v, t, n=32, cache_dir=str(tmp_path))  # hit
    assert len(c1.classes) == len(c2.classes)
    for (tid1, tab1, b1), (tid2, tab2, b2) in zip(c1.classes, c2.classes):
        assert (np.asarray(tid1) == np.asarray(tid2)).all()
        assert (np.asarray(tab1) == np.asarray(tab2)).all()
        assert (b1 is None) == (b2 is None)
        if b1 is not None:
            assert (np.asarray(b1) == np.asarray(b2)).all()
    # explicit save/load path
    p = str(tmp_path / "x.npz")
    save_compact7(p, c1)
    c3 = load_compact7(p)
    assert c3 is not None and c3.n == c1.n and c3.tile == c1.tile
    del nr


def test_tile_shape_is_one_strip():
    tx, ty, tz = TILE
    assert tx * ty * tz == 128


@pytest.mark.parametrize("cps", [16, 64])
def test_fused_kernel_cps_batching_bitexact_interpret(cps):
    """The fold kernel (interpret mode) and the plain fold, batched over
    ``cps`` strips at a time, give bit-identical (t, id, channels) on
    random tables in both layouts — strip batching is a pure
    memory-bounding change."""
    from dxrvoxelizer_tpu.ops.raystab_fast import fold_extract_xla
    from dxrvoxelizer_tpu.ops.raystab_pallas import stab_fold_extract

    rng = np.random.default_rng(5)
    c, t_count = 64, 1000
    rays = rng.standard_normal((c, 8, 128), np.float32)
    rays[:, 4:] = 0.0
    rays[:, 3] = np.abs(rays[:, 3])
    rays[-1, :3] = 0.0  # an all-padding strip
    for k, lanes in ((16, False), (128, True)):
        coefs = rng.standard_normal((c, k, 12), np.float32)
        coefs[..., 10] = rng.integers(0, t_count, (c, k)).astype(np.float32)
        coefs[..., 11] = 0.0
        ntab = rng.standard_normal((c, k, 12), np.float32)
        ntab[..., 9:] = 0.0
        if lanes:
            coefs = np.swapaxes(coefs, 1, 2).copy()
            ntab = np.swapaxes(ntab, 1, 2).copy()
        args = (k, t_count, 0.12)
        base = stab_fold_extract(rays, coefs, ntab, *args, interpret=True)
        got = fold_extract_xla(rays, coefs, ntab, *args, strip_batch=cps)
        for a, b in zip(base, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pack_ids24_roundtrip():
    """24-bit wire packing of candidate id tables: exact roundtrip for
    every id value and the -1 padding sentinel."""
    from dxrvoxelizer_tpu.ops.raystab_tiled import (
        _pack_ids24,
        _unpack_ids24,
    )

    tab = np.array([[-1, 0, 1, 255, 256, 65535, 65536, (1 << 24) - 2]],
                   np.int32)
    packed = _pack_ids24(tab)
    assert packed.dtype == np.uint8 and packed.shape == tab.shape + (3,)
    out = np.asarray(_unpack_ids24(jnp.asarray(packed)))
    assert (out == tab).all()


def test_gen_routing_contract(monkeypatch):
    """Product routing: gen-7 tiled at n >= 128, gen-6 cone strips at the
    reference 64^3; DXRV_RAYSTAB_GEN forces either engine."""
    from dxrvoxelizer_tpu.ops.raystab_tiled import use_tiled_raystab

    monkeypatch.delenv("DXRV_RAYSTAB_GEN", raising=False)
    assert not use_tiled_raystab(64)
    assert use_tiled_raystab(128)
    assert use_tiled_raystab(256)
    monkeypatch.setenv("DXRV_RAYSTAB_GEN", "7")
    assert use_tiled_raystab(64)
    monkeypatch.setenv("DXRV_RAYSTAB_GEN", "6")
    assert not use_tiled_raystab(256)
