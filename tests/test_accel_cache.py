"""On-disk accel cache (utils/accel_cache.py): the cached compact product
plus device assembly must answer queries identically to a from-scratch
build, including optional parts (chunk-skip bounds, near-origin overflow)."""

import numpy as np
import jax.numpy as jnp

from dxrvoxelizer_tpu.ops.raystab_fast import (
    assemble_raystab_accel2,
    build_raystab_accel2,
    build_raystab_compact2,
    raystab_query2,
)
from dxrvoxelizer_tpu.utils.accel_cache import (
    cached_build_raystab_accel2,
    load_compact2,
    save_compact2,
)
from meshes import icosphere_mesh


def _near_origin_soup(nt=300, seed=11):
    rng = np.random.default_rng(seed)
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
    return verts, normals, tris


def _assert_compact_equal(a, b):
    assert b.n == a.n
    assert b.stats == a.stats
    assert len(b.classes) == len(a.classes)
    for (rt_a, tab_a, bd_a), (rt_b, tab_b, bd_b) in zip(
        a.classes, b.classes
    ):
        np.testing.assert_array_equal(rt_b, rt_a)
        np.testing.assert_array_equal(tab_b, tab_a)
        assert (bd_a is None) == (bd_b is None)
        if bd_a is not None:
            np.testing.assert_array_equal(bd_b, bd_a)
    assert (a.ov_ids is None) == (b.ov_ids is None)
    if a.ov_ids is not None:
        np.testing.assert_array_equal(b.ov_ids, a.ov_ids)


def test_save_load_roundtrip_query_bitexact(tmp_path):
    v_np, n_np, t_np = icosphere_mesh(2, radius=0.4, center=(0.3, 0.1, -0.2))
    v, nr, t = jnp.asarray(v_np), jnp.asarray(n_np), jnp.asarray(t_np)
    compact = build_raystab_compact2(v, t, n=16)
    path = str(tmp_path / "a.npz")
    save_compact2(path, compact)
    loaded = load_compact2(path)
    assert loaded is not None
    _assert_compact_equal(compact, loaded)
    accel_b = assemble_raystab_accel2(compact, v, t, nr)
    accel_l = assemble_raystab_accel2(loaded, v, t, nr)
    occ_b, rgba_b = raystab_query2(v, nr, t, accel_b, interpret=True)
    occ_l, rgba_l = raystab_query2(v, nr, t, accel_l, interpret=True)
    assert bool((np.asarray(occ_l) == np.asarray(occ_b)).all())
    assert bool((np.asarray(rgba_l) == np.asarray(rgba_b)).all())


def test_roundtrip_with_overflow_list(tmp_path):
    """Near-origin soup: ov_ids present; roundtrip stays bit-exact."""
    v, nr, t = _near_origin_soup()
    compact = build_raystab_compact2(v, t, n=16)
    assert compact.ov_ids is not None
    path = str(tmp_path / "ov.npz")
    save_compact2(path, compact)
    loaded = load_compact2(path)
    _assert_compact_equal(compact, loaded)
    accel_b = assemble_raystab_accel2(compact, v, t, nr)
    accel_l = assemble_raystab_accel2(loaded, v, t, nr)
    assert accel_l.ov_dense is not None
    occ_b, rgba_b = raystab_query2(v, nr, t, accel_b, interpret=True)
    occ_l, rgba_l = raystab_query2(v, nr, t, accel_l, interpret=True)
    assert bool((np.asarray(occ_l) == np.asarray(occ_b)).all())
    assert bool((np.asarray(rgba_l) == np.asarray(rgba_b)).all())


def test_split_build_matches_monolithic():
    """compact + assemble == build_raystab_accel2 (same query output)."""
    v_np, n_np, t_np = icosphere_mesh(2, radius=0.5)
    v, nr, t = jnp.asarray(v_np), jnp.asarray(n_np), jnp.asarray(t_np)
    mono = build_raystab_accel2(v, t, nr, n=16)
    split = assemble_raystab_accel2(build_raystab_compact2(v, t, n=16),
                                    v, t, nr)
    occ_m, rgba_m = raystab_query2(v, nr, t, mono, interpret=True)
    occ_s, rgba_s = raystab_query2(v, nr, t, split, interpret=True)
    assert bool((np.asarray(occ_s) == np.asarray(occ_m)).all())
    assert bool((np.asarray(rgba_s) == np.asarray(rgba_m)).all())


def test_cached_build_hits_and_keys(tmp_path):
    v_np, n_np, t_np = icosphere_mesh(1)
    v, nr, t = jnp.asarray(v_np), jnp.asarray(n_np), jnp.asarray(t_np)
    d = str(tmp_path / "cache")
    a1 = cached_build_raystab_accel2(v, t, nr, n=16, cache_dir=d)
    import os

    files = os.listdir(d)
    assert len(files) == 1
    a2 = cached_build_raystab_accel2(v, t, nr, n=16, cache_dir=d)
    assert a2.stats == a1.stats
    occ1, _ = raystab_query2(v, nr, t, a1, interpret=True)
    occ2, _ = raystab_query2(v, nr, t, a2, interpret=True)
    assert bool((np.asarray(occ1) == np.asarray(occ2)).all())
    # a different grid size keys a different entry
    cached_build_raystab_accel2(v, t, nr, n=32, cache_dir=d)
    assert len(os.listdir(d)) == 2


def test_load_missing_or_corrupt_returns_none(tmp_path):
    assert load_compact2(str(tmp_path / "nope.npz")) is None
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    assert load_compact2(str(bad)) is None
