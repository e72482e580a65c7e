"""Multi-chip ray-stab query — the DispatchRays analog sharded over cards.

The binned query (ops/raystab_fast) runs per-class strip blocks through
one fused fold + extraction; strips are independent, so the leading
strip axis shards cleanly over a 1-D device mesh: each card folds 1/N of
every capacity class (and of the shared overflow pass), then the cheap
sort-merge runs on the gathered winner streams. Per-frame cross-chip
traffic is the winner streams themselves (t, id, 4 channels — ~9 MB at
64^3), riding the all-gathers GSPMD inserts between the shard_map region
and the replicated sort.

Strip counts are padded per class to a multiple of 8 x n_devices inside
the wrapper (no accel-build changes): all-zero ray strips are inert by the
kernel's own padding contract (zero direction rows -> t = -inf, id = BIG,
zero channels) and their output slots are sliced off before the sort, so
the sharded query is bit-identical to the single-device one.

The reference app is single-GPU (SURVEY.md section 2c); this is the
scale-out of its DispatchRays(64, 64*64, 1) voxelize dispatch
(Voxelizer.cpp:367-368).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dxrvoxelizer_tpu.ops.raystab_fast import (
    INSIDE_THRESHOLD,
    RaystabAccel2,
    _merge_winners2,
    fold_extract_dispatch,
    table_k,
)
from dxrvoxelizer_tpu.ops.raystab_pallas import CELLS_PER_STEP


def _pad_lead(x, c_pad: int, fill: float = 0.0):
    c = x.shape[0]
    if c == c_pad:
        return x
    pad = jnp.full((c_pad - c,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x, pad], axis=0)


def _make_run_class(mesh: Mesh, t_count: int, threshold: float, rule: str,
                    interpret: bool):
    """A shard_map-wrapped class runner for _merge_winners2.

    Pads the strip axis to 8 x n_devices, shards it, and slices the
    padding back off. Padded coef/ntab rows are zeros with id 0; padded
    strips' lanes carry winner id BIG, which matches no zero-id row, so
    their channels stay exactly zero (and are sliced off regardless).
    Padded bounds rows are +inf so the kernel skips every chunk for them.
    """
    (axis,) = mesh.axis_names
    n_dev = mesh.devices.size
    unit = CELLS_PER_STEP * n_dev

    def run_class(rays, coefs, ntab, k, bounds, shared):
        c = rays.shape[0]
        c_pad = -(-c // unit) * unit
        rays_p = _pad_lead(rays, c_pad)
        kern = partial(
            fold_extract_dispatch, k=k, t_count=t_count,
            threshold=threshold, rule=rule, shared=shared,
            interpret=interpret,
        )
        if shared:
            fn = jax.shard_map(
                lambda r, cf, nt: kern(r, cf, nt),
                mesh=mesh,
                in_specs=(P(axis), P(), P()),
                out_specs=(P(axis), P(axis), P(axis)),
                check_vma=False,
            )
            t, i, ns = fn(rays_p, coefs, ntab)
        elif bounds is not None:
            fn = jax.shard_map(
                lambda r, cf, nt, b: kern(r, cf, nt, bounds=b),
                mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis)),
                out_specs=(P(axis), P(axis), P(axis)),
                check_vma=False,
            )
            t, i, ns = fn(
                rays_p, _pad_lead(coefs, c_pad), _pad_lead(ntab, c_pad),
                _pad_lead(bounds, c_pad, fill=jnp.inf),  # [C, k_steps]
            )
        else:
            fn = jax.shard_map(
                lambda r, cf, nt: kern(r, cf, nt),
                mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis)),
                out_specs=(P(axis), P(axis), P(axis)),
                check_vma=False,
            )
            t, i, ns = fn(
                rays_p, _pad_lead(coefs, c_pad), _pad_lead(ntab, c_pad)
            )
        return t[:c], i[:c], ns[:c]

    return run_class


@partial(
    jax.jit,
    static_argnames=("n", "tile", "threshold", "ks", "t_count",
                     "interpret", "rule", "mesh"),
)
def _sharded_query7(
    classes, n: int, tile: tuple, threshold: float, ks: tuple,
    t_count: int, interpret: bool, rule: str, mesh: Mesh,
):
    """Gen-7 (tiled, sort-free) sharded query: each class's TILE axis
    shards over the mesh through the same padded run_class wrapper as
    gen-4 strips (tiles are independent rows of the same fused kernels);
    the merge is the gen-7 row scatter + un-tiling reshape on the
    gathered channel streams — no sort, so the per-frame cross-chip
    traffic is just the [tiles, 4, 128] channels."""
    rep = NamedSharding(mesh, P())
    classes = jax.tree.map(
        lambda x: jax.lax.with_sharding_constraint(x, rep), classes
    )
    run_class = _make_run_class(mesh, t_count, threshold, rule, interpret)
    tx, ty, tz = tile
    v = n * n * n
    nt = v // 128
    out = jnp.zeros((nt + 1, 4, 128), jnp.float32)
    for (rays, coefs, ntab, bounds, tids), k in zip(classes, ks):
        _t, _i, ns = run_class(rays, coefs, ntab, k, bounds, False)
        idx = jnp.where(tids < 0, nt, tids)
        out = out.at[idx].set(ns)
    rgba = (
        out[:nt]
        .reshape(n // tx, n // ty, n // tz, 4, tx, ty, tz)
        .transpose(0, 4, 1, 5, 2, 6, 3)
        .reshape(n, n, n, 4)
    )
    return (rgba[..., 3] != 0.0), rgba


def raystab_query7_sharded(
    verts_norm: jnp.ndarray,
    normals: jnp.ndarray,
    tris: jnp.ndarray,
    accel,
    mesh: Mesh,
    threshold: float = INSIDE_THRESHOLD,
    interpret: bool = False,
    rule: str = "backface",
):
    """Multi-chip gen-7 trace -> (occupancy, rgba), bit-identical to
    :func:`~dxrvoxelizer_tpu.ops.raystab_tiled.raystab_query7`."""
    del verts_norm, normals
    ks = tuple(table_k(c[1]) for c in accel.classes)
    return _sharded_query7(
        accel.classes, accel.n, accel.tile, threshold, ks,
        int(tris.shape[0]), interpret, rule, mesh,
    )


@partial(
    jax.jit,
    static_argnames=("n", "threshold", "ks", "ov_k", "t_count", "interpret",
                     "rule", "mesh"),
)
def _sharded_query2(
    levels, sort_keys, ov_dense, n: int, threshold: float, ks: tuple,
    ov_k: int, t_count: int, interpret: bool, rule: str, mesh: Mesh,
):
    rep = NamedSharding(mesh, P())
    levels, sort_keys, ov_dense = jax.tree.map(
        lambda x: jax.lax.with_sharding_constraint(x, rep),
        (levels, sort_keys, ov_dense),
    )
    run_class = _make_run_class(mesh, t_count, threshold, rule, interpret)
    _, _, nx, ny, nz, a = _merge_winners2(
        levels, sort_keys, ov_dense, n, ks, ov_k, t_count, threshold, rule,
        interpret, run_class=run_class,
    )
    rgba = jnp.stack([nx, ny, nz, a], axis=-1)
    return (a != 0.0).reshape(n, n, n), rgba.reshape(n, n, n, 4)


def raystab_query2_sharded(
    verts_norm: jnp.ndarray,
    normals: jnp.ndarray,
    tris: jnp.ndarray,
    accel: RaystabAccel2,
    mesh: Mesh,
    threshold: float = INSIDE_THRESHOLD,
    interpret: bool = False,
    rule: str = "backface",
):
    """Multi-chip gen-4 trace -> (occupancy, rgba), bit-identical to
    :func:`~dxrvoxelizer_tpu.ops.raystab_fast.raystab_query2`.

    ``mesh``: a 1-D device mesh (parallel.make_device_mesh). The geometry
    args must be what the accel was built from (DXR-analog contract).
    """
    del verts_norm, normals
    ks = tuple(
        tuple(table_k(c[1]) for c in level) for level in accel.levels
    )
    ov_k = table_k(accel.ov_dense[1]) if accel.ov_dense else 0
    return _sharded_query2(
        accel.levels, accel.sort_keys, accel.ov_dense, accel.n, threshold,
        ks, ov_k, int(tris.shape[0]), interpret, rule, mesh,
    )


def sharded_frame_raystab(
    mesh: Mesh,
    accel: RaystabAccel2,
    t_count: int,
    n: int,
    width: int,
    height: int,
    statics: tuple,
    threshold: float = INSIDE_THRESHOLD,
    interpret: bool = False,
    render_impl: str = "warp",
    n_samples: int = 128,
    n_light: int = 32,
    point_light: bool = False,
):
    """Multi-chip raystab frame: sharded DispatchRays + band-sharded render.

    Returns ``frame(verts_norm, tris, s2l, eye, light, clear) -> image``
    (same signature as shard.sharded_frame_fast; the geometry args are
    accepted for pipeline symmetry — the accel bakes the geometry, like
    the reference's init-built AS, Voxelizer.cpp:264-326). Per frame: the
    strip-sharded gen-4 query re-traces every voxel ray, the winner rgba
    is R10G10B10A2-quantized (the reference grid format), and each device
    renders its horizontal screen band from the replicated density —
    shear-warp (``render_impl="warp"``, orientation ``statics`` required)
    or the gather marcher ("gather", statics-free). ``point_light``
    selects the point-light field in either renderer.
    """
    from dxrvoxelizer_tpu.ops.packing import quantize_r10g10b10a2

    tiled = type(accel).__name__ == "RaystabAccel7"
    if tiled:
        ks7 = tuple(table_k(c[1]) for c in accel.classes)
    else:
        ks = tuple(
            tuple(table_k(c[1]) for c in level) for level in accel.levels
        )
        ov_k = table_k(accel.ov_dense[1]) if accel.ov_dense else 0
    render = _make_band_renderer(
        mesh, n, width, height, statics, render_impl,
        n_samples, n_light, point_light,
    )
    rep = NamedSharding(mesh, P())

    @jax.jit
    def frame(verts_norm, tris, s2l, eye, light, clear):
        del verts_norm, tris  # baked into the accel
        s2l, eye, light, clear = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, rep),
            (s2l, eye, light, clear),
        )
        if tiled:
            _, rgba = _sharded_query7(
                accel.classes, n, accel.tile, float(threshold), ks7,
                t_count, interpret, "backface", mesh,
            )
        else:
            _, rgba = _sharded_query2(
                accel.levels, accel.sort_keys, accel.ov_dense, n,
                float(threshold), ks, ov_k, t_count, interpret, "backface",
                mesh,
            )
        density = quantize_r10g10b10a2(rgba)[..., 3]
        return render(density, s2l, eye, light, clear)

    return frame


def _make_band_renderer(mesh: Mesh, n: int, width: int, height: int,
                        statics: tuple, render_impl: str,
                        n_samples: int, n_light: int, point_light: bool):
    """shard_map-wrapped screen-band renderer shared by the raystab frame
    builders: each device renders its horizontal band from the replicated
    density — shear-warp (orientation ``statics`` required) or the gather
    marcher ("gather", statics-free)."""
    from dxrvoxelizer_tpu.ops import raymarch_warp as rw
    from dxrvoxelizer_tpu.parallel.shard import light_volume_from_statics

    (axis,) = mesh.axis_names
    n_dev = mesh.devices.size
    assert height % n_dev == 0, f"height {height} not divisible by {n_dev}"
    band = height // n_dev

    if render_impl == "warp":
        (waxis, wflip, wswap, m, l_axis, l_flip, l_mode, ss,
         l_d0) = statics

        def render_band(density, s2l, eye, light, clear):
            d = jax.lax.axis_index(axis)
            lv = light_volume_from_statics(
                density, light, n, l_axis, l_flip, l_mode, n_light=n_light,
                l_d0=l_d0,
            )
            return rw._shearwarp_core(
                density, lv, s2l, eye, clear, n, m, width, band,
                waxis, wflip, wswap,
                y_off=(d * band).astype(jnp.float32).reshape(()),
                ss=ss,
            )
    elif render_impl == "gather":
        from dxrvoxelizer_tpu.ops.raymarch_fast import (
            precompute_light_volume,
            raymarch_fast,
        )

        def render_band(density, s2l, eye, light, clear):
            d = jax.lax.axis_index(axis)
            lv = precompute_light_volume(
                density, light, n_light=n_light, point_light=point_light
            )
            return raymarch_fast(
                density, lv, s2l, eye, clear, width, band,
                n_samples=n_samples,
                y_offset=(d * band).astype(jnp.float32),
            )
    else:
        raise ValueError(f"unknown sharded render impl {render_impl!r}")

    return jax.shard_map(
        render_band,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(axis, None, None),
        check_vma=False,
    )


def sharded_frame_raystab_deforming(
    mesh: Mesh,
    refitter,
    n: int,
    width: int,
    height: int,
    statics: tuple,
    threshold: float = INSIDE_THRESHOLD,
    interpret: bool = False,
    render_impl: str = "warp",
    n_samples: int = 128,
    n_light: int = 32,
    point_light: bool = False,
):
    """Multi-chip DEFORMING raystab frame: per-frame accel refit + the
    strip-sharded query + band-sharded render.

    ``refitter``: an :class:`~dxrvoxelizer_tpu.ops.raystab_refit.
    RaystabRefitter` built from the rest mesh (its pad bounds the
    admissible per-frame deformation — the DXR AS-update analog; the
    reference app itself is static-geometry, Voxelizer.cpp:264-326).
    Returns ``frame(verts_norm, normals, s2l, eye, light, clear) ->
    image``: note NORMALS in the second slot where the static frame
    takes ``tris`` — the refit regathers the normal tables each frame.
    The refit's coefficient build + class gathers run replicated (they
    are a few ms of row movement vs the sharded fold); the query and
    render shard exactly like :func:`sharded_frame_raystab`.
    """
    from dxrvoxelizer_tpu.ops.packing import quantize_r10g10b10a2

    t_count = int(refitter.tris.shape[0])
    acc0 = refitter.rest_accel
    tiled = type(acc0).__name__ == "RaystabAccel7"
    if tiled:
        ks7 = tuple(table_k(c[1]) for c in acc0.classes)
    else:
        ks = tuple(
            tuple(table_k(c[1]) for c in level) for level in acc0.levels
        )
        ov_k = table_k(acc0.ov_dense[1]) if acc0.ov_dense else 0
    state = refitter.device_state()
    render = _make_band_renderer(
        mesh, n, width, height, statics, render_impl,
        n_samples, n_light, point_light,
    )
    rep = NamedSharding(mesh, P())

    @jax.jit
    def frame(verts_norm, normals, s2l, eye, light, clear):
        verts_norm, normals, s2l, eye, light, clear = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, rep),
            (verts_norm, normals, s2l, eye, light, clear),
        )
        acc = refitter.refit_with_state(state, verts_norm, normals)
        if tiled:
            _, rgba = _sharded_query7(
                acc.classes, n, acc.tile, float(threshold), ks7,
                t_count, interpret, "backface", mesh,
            )
        else:
            _, rgba = _sharded_query2(
                acc.levels, acc.sort_keys, acc.ov_dense, n,
                float(threshold), ks, ov_k, t_count, interpret, "backface",
                mesh,
            )
        density = quantize_r10g10b10a2(rgba)[..., 3]
        return render(density, s2l, eye, light, clear)

    return frame
