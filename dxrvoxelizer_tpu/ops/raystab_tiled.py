"""Gen-7 ray-stab acceleration: OUTPUT-MAJOR tiles — the sort-free query.

Generations 2-6 (ops/raystab_fast.py) group rays into 128-lane strips by
DIRECTION cone cell, which minimizes the per-strip candidate list but
scatters each strip's 128 outputs across the voxel grid; delivering them
costs a slot->ray permutation that rides ``lax.sort`` and dominates
hi-res queries.

Gen-7 inverts the grouping: a strip is a compact 8x4x4 VOXEL TILE (128
consecutive outputs in a tiled layout), and its candidate list is the
union of every direction cell the tile's 128 rays cross. Two facts
(measured on the dragon mesh) make this a win:

- A compact tile subtends a small solid angle, so the union stays close
  to the per-cone list: 1.4-3x raw inflation vs the cone strips.
- The NEAR-PREFIX DROP more than pays it back: a candidate whose
  conservative MAX hit radius lies below the tile's MIN ray-origin
  radius is behind every ray in the tile (t < 0 for all 128 lanes,
  an arithmetic no-op) and is deleted at build. Rays and tiles march
  OUTWARD from the origin, so for the dragon this kills 73-78% of the
  union pairs — net kernel work lands at 0.98x (64^3), 0.93x (128^3),
  0.39x (256^3) of the gen-6 strips — and empties 68-81% of the tiles
  entirely (they skip the kernel and stay zero).

The permutation that remains is TILE-granular, not ray-granular: class
outputs row-scatter into a [tiles, 4, 128] buffer (thousands of rows,
vs lax.sort over millions) and one reshape/transpose
un-tiles to the dense grid. No sort keys, no filler, no scatter streams,
no per-cell ray tables — the build loses four stages along with the
query's sort.

Bit-exactness vs the radial oracle (and gen-6): the fold is the same
(ops/raystab_pallas); a tile ray's candidate set is a
SUPERSET of every triangle it can hit (cone binning is conservative per
ray, the union only adds other lanes' candidates, and the near-drop
removes only triangles that cannot produce t >= 0 for any lane — margin
analysis at _tri_maxr). Extra candidates either miss or tie-lose by the
(t, id) lexmin rule, exactly like gen-2's padding rows.

Reference parity anchor: the DXR BLAS/TLAS + TraceRay this replaces is
/root/reference/DXRVoxelizer/Content/Voxelizer.cpp:264-326 (driver AS
build) and DXRVoxelizer.hlsl:58-85 (per-voxel radial TraceRay).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops.raystab_fast import (
    INSIDE_THRESHOLD,
    LANE_MIN_K,
    _assemble_class_dev,
    _capsule_params,
    _cone_bins_host,
    _cone_keys_np,
    _csr_gather,
    _dir_cells_host,
    _fold_levels_csr,
    _fused_coef_matrix,
    _pow2cap,
    _seg_origin_dist,
    _stage_timer,
    default_gs,
    fold_extract_dispatch,
    table_k,
)
from dxrvoxelizer_tpu.ops.raystab_pallas import K_BLOCK, cells_per_step_for

TILE = (8, 4, 4)  # x-major voxel tile; product must be 128 (one strip)


def use_tiled_raystab(n: int) -> bool:
    """Gen routing for the raystab accel: gen-7 tiles at n >= 128, gen-6
    strips at the reference 64^3 (gen-7's class padding roughly doubles
    the pair count at 64^3, while at 128^3 it cuts it). Override with
    DXRV_RAYSTAB_GEN=6|7."""
    forced = os.environ.get("DXRV_RAYSTAB_GEN")
    if forced in ("6", "7"):
        return forced == "7"
    return n >= 128

CLASS_CAPS7 = (
    16, 24, 32, 48, 64, 96, 128, 192, 256, 512, 768, 1024, 1536,
    2048, 3072, 4096, 6144, 8192, 12288, 16384,
)


@dataclass
class Raystab7Stats:
    g_fine: int
    live_tiles: int
    dead_tiles: int
    pairs: int  # total candidate slots across classes (incl. class padding)
    near_origin: int
    classes: tuple  # per class: (K, VC live rows)


@dataclass
class RaystabCompact7:
    """Binning half of a gen-7 accel — backend-independent host product.

    ``classes``: per capacity class, (tids [VC] i32 tile id / -1 padding,
    tab [VC, K] i32 candidate ids / -1, bounds [VC, K//256] f32 chunk
    t lower bounds or None). The expanded accel is a pure device-gather
    function of (compact, geometry): :func:`assemble_raystab_accel7`.
    """

    n: int
    tile: tuple
    classes: tuple
    stats: Raystab7Stats


@dataclass
class RaystabAccel7:
    """Device half: per class (rays [VC,8,128] dx dy dz s0 rows,
    coefs, ntab (classic [VC,K,12] or lane-aligned [VC,12,K]),
    bounds [VC,K//256] or None, tids [VC] i32)."""

    n: int
    tile: tuple
    classes: tuple
    stats: Raystab7Stats


def _host_voxel_pos_s0(n: int):
    """Host replication of raystab_fast.voxel_rays' position layout
    (packing.voxel_centers_norm: y axis negated; flat = ix*n^2+iy*n+iz).
    Feeds only conservative build DECISIONS (cells, s0 min/max with
    margins) — the kernel's exact f32 dirs/s0 come from the device
    (_assemble_class_dev), bit-equal to the oracle."""
    t = ((np.arange(n, dtype=np.float32) + 0.5) / n * 2.0 - 1.0)
    ty = (-t).astype(np.float32)
    px = np.broadcast_to(t[:, None, None], (n, n, n))
    py = np.broadcast_to(ty[None, :, None], (n, n, n))
    pz = np.broadcast_to(t[None, None, :], (n, n, n))
    pos = np.stack([px, py, pz], axis=-1).reshape(-1, 3)
    s0 = np.sqrt((pos.astype(np.float32) ** 2).sum(-1)).astype(np.float32)
    return pos, s0


def _tile_ids(n: int, tile: tuple) -> np.ndarray:
    """Flat voxel index -> tile id (x-major tiles, raster within)."""
    tx, ty, tz = tile
    v = n * n * n
    idx = np.arange(v, dtype=np.int64)
    i, rem = np.divmod(idx, n * n)
    j, k = np.divmod(rem, n)
    return ((i // tx) * (n // ty) + j // ty) * (n // tz) + k // tz


def _tri_maxr(verts_norm, tris_h, pad: float) -> np.ndarray:
    """Conservative per-triangle MAX hit radius (f64 max vertex distance,
    +pad for deforming builds, 1e-3 relative + 1e-6 absolute margin).

    Margin analysis for the near drop (tri deleted from a tile when
    maxr < s0min): any exact hit point is a convex combination of the
    (padded) vertices, so its exact radius R <= maxvert + pad; the f32
    kernel's c/den and s0 each round within ~1e-7 relative, while the
    drop requires R_f32 < s0_f32 strictly — the 1e-3 relative slack
    dwarfs both roundings plus the host/device s0 difference (<= 1 ulp),
    the same budget as gen-2's tri_bounds (raystab_fast)."""
    tv = np.asarray(verts_norm, np.float64)[np.asarray(tris_h)]
    maxr = np.sqrt((tv ** 2).sum(-1)).max(axis=1)
    if pad:
        maxr = maxr + float(pad)
    return maxr * (1.0 + 1e-3) + 1e-6


def _tri_minr(verts_norm, tris_h, pad: float, pad_dirs) -> np.ndarray:
    """Conservative per-triangle MIN hit radius lower bound (bounding
    ball |c| - r; capsule variant for directional pads) — verbatim the
    gen-2 chunk-skip bound (raystab_fast.build_raystab_compact2)."""
    verts_h = np.asarray(verts_norm, np.float32)
    tris_h = np.asarray(tris_h)
    tv = np.asarray(verts_norm, np.float64)[tris_h]
    cc = tv.mean(axis=1)
    rr = np.sqrt(((tv - cc[:, None, :]) ** 2).sum(-1)).max(axis=1)
    if pad and pad_dirs is not None:
        offs, r_extra = _capsule_params(
            verts_h, tris_h, pad, np.asarray(pad_dirs, np.float32)
        )
        cdist = _seg_origin_dist(
            (cc - offs).astype(np.float32), (cc + offs).astype(np.float32),
        ).astype(np.float64)
        rr = rr + r_extra.astype(np.float64)
        cdist = cdist * (1.0 - 3e-7)
    else:
        if pad:
            rr = rr + float(pad)
        cdist = np.linalg.norm(cc, axis=-1)
    tb = np.maximum(cdist - rr, 0.0)
    return np.maximum(tb * (1.0 - 1e-3) - 1e-6, 0.0)


def _tile_union_py(n, g_fine, tile, cell_offs, cell_data, maxr_f32,
                   bounds_f32, sub_ids, s0min):
    """Vectorized-numpy tile unions — the behavioral reference for the
    native pass (utils/_native/accelpack.cpp accelpack_tileunion_run,
    bit-identical output, pinned by tests/test_raystab_tiled.py) and the
    no-toolchain fallback. Returns (tile_offs [NT+1] i64, tile_data i32
    per-tile candidate ids ordered by (min-R bound, id))."""
    tx, ty, tz = tile
    v = n * n * n
    nt = v // 128
    kcell = cell_offs[1:] - cell_offs[:-1]
    pos, _s0 = _host_voxel_pos_s0(n)
    cells = _dir_cells_host(pos, g_fine)
    nc = 6 * g_fine * g_fine
    pairkey = _tile_ids(n, tile) * nc + cells
    upairs = np.unique(pairkey)
    ub = (upairs // nc).astype(np.int64)
    uc = (upairs % nc).astype(np.int64)
    reps = kcell[uc]
    live_pair = reps > 0
    ub_l, uc_l, reps_l = ub[live_pair], uc[live_pair], reps[live_pair]
    tri_rep = _csr_gather(cell_data, cell_offs, uc_l)
    bl_rep = np.repeat(ub_l, reps_l)
    alive = maxr_f32[tri_rep] >= s0min[bl_rep]
    key = bl_rep[alive] * (1 << 24) + tri_rep[alive]
    if sub_ids.size:
        # near-origin overflow triangles (direction cone contains the
        # origin — unbinnable) are candidates for EVERY ray: append to
        # every tile, near-drop included; dedup below removes doubles
        ov = sub_ids.astype(np.int64)
        tiles_all = np.arange(nt, dtype=np.int64)
        ov_alive = maxr_f32[ov][None, :] >= s0min[:, None]
        ovkey = (tiles_all[:, None] * (1 << 24) + ov[None, :])[ov_alive]
        key = np.concatenate([key, ovkey])
    key = np.unique(key)
    tile_of = key >> 24
    tri_of = (key & ((1 << 24) - 1)).astype(np.int64)
    order = np.lexsort((tri_of, bounds_f32[tri_of], tile_of))
    tile_of = tile_of[order]
    tri_of = tri_of[order]
    sizes_all = np.bincount(tile_of, minlength=nt)
    tile_offs = np.zeros(nt + 1, np.int64)
    np.cumsum(sizes_all, out=tile_offs[1:])
    return tile_offs, tri_of.astype(np.int32)


def build_raystab_compact7(
    verts_norm,
    tris,
    n: int = 64,
    gs: tuple | None = None,
    span: int = 8,
    pad: float = 0.0,
    pad_dirs=None,
    tile: tuple = TILE,
) -> RaystabCompact7:
    """Host half of the gen-7 build: cone binning (shared with gen-2) ->
    per-tile candidate unions with the near-prefix drop -> capacity
    classes. ``pad``/``pad_dirs`` follow the gen-2 deformation contract
    (raystab_fast.build_raystab_compact2): padded cones + padded radius
    bounds stay conservative for any in-contract deformation, so the id
    tables serve every frame and only coefficients need a refit."""
    mark = _stage_timer()
    tx, ty, tz = tile
    assert tx * ty * tz == 128
    assert n % tx == 0 and n % ty == 0 and n % tz == 0, (n, tile)
    gs = default_gs(n) if gs is None else gs
    tris_h = np.asarray(tris)
    verts_h = np.asarray(verts_norm, np.float32)
    t_count = int(tris_h.shape[0])
    assert t_count < 2**24
    v = n * n * n
    nt = v // 128

    if t_count == 0:
        stats = Raystab7Stats(gs[0], 0, nt, 0, 0, ())
        return RaystabCompact7(n=n, tile=tile, classes=(), stats=stats)

    # ---- level binning + fold to fine cells (gen-2 machinery) ----------
    sub_ids = np.arange(t_count, dtype=np.int32)
    level_runs = []
    for g in gs:
        if sub_ids.size == 0:
            break
        rects_h, over_h = _cone_keys_np(verts_h, tris_h[sub_ids], g, span,
                                        pad, pad_dirs)
        mark(f"cone keys g={g}")
        sorted_tris, starts, counts_h, ov_np = _cone_bins_host(
            rects_h, over_h, g, span
        )
        mark(f"cone bins g={g}")
        level_runs.append((sub_ids[sorted_tris].astype(np.int64), starts,
                           counts_h.astype(np.int64), g))
        sub_ids = sub_ids[ov_np]
    g_fine = gs[0]
    cell_offs, cell_data = _fold_levels_csr(level_runs, g_fine)
    mark("level fold")

    # conservative radius bounds, f32 in BOTH pipelines so the native
    # and numpy products are bit-identical (margins dwarf the casts)
    maxr = _tri_maxr(verts_h, tris_h, pad).astype(np.float32)
    tri_bounds = _tri_minr(verts_h, tris_h, pad, pad_dirs).astype(
        np.float32
    )

    from dxrvoxelizer_tpu.utils import native

    nat = native.tile_union_native(
        n, g_fine, tile, cell_offs, cell_data.astype(np.int32), maxr,
        tri_bounds, sub_ids if sub_ids.size else None,
    )
    if nat is not None:
        tile_offs_all, tile_data, _s0min, s0max = nat
        mark("tile unions (native)")
    else:
        # per-tile origin-radius extents: s0 = sqrt((x^2 + y^2) + z^2)
        # per voxel — the same f32 expression as the native pass, so the
        # near-drop decisions (and thus the tables) are bit-identical
        t1 = ((np.arange(n, dtype=np.float32) + 0.5) / n * 2.0 - 1.0)
        sq = (t1 * t1).astype(np.float32)
        s0_3d = np.sqrt(
            (sq[:, None, None] + sq[None, :, None]) + sq[None, None, :]
        ).reshape(n // tx, tx, n // ty, ty, n // tz, tz)
        s0min = np.ascontiguousarray(s0_3d.min(axis=(1, 3, 5))).reshape(-1)
        s0max = np.ascontiguousarray(s0_3d.max(axis=(1, 3, 5))).reshape(-1)
        del s0_3d
        tile_offs_all, tile_data = _tile_union_py(
            n, g_fine, tile, cell_offs, cell_data, maxr, tri_bounds,
            sub_ids, s0min,
        )
        mark("tile unions (numpy)")
    sizes_all = tile_offs_all[1:] - tile_offs_all[:-1]
    live = np.nonzero(sizes_all)[0]
    sizes = sizes_all[live]
    offs = tile_offs_all[live + 1] - sizes  # start of each live tile run
    offs = np.concatenate([offs, tile_offs_all[-1:]])  # CSR-compatible
    tri_of = tile_data.astype(np.int64)

    # ---- capacity classes ----------------------------------------------
    max_k = int(sizes.max()) if sizes.size else 0
    caps = [k for k in CLASS_CAPS7 if k < max_k]
    caps.append(max(_pow2cap(max_k), 8))
    classes = []
    stat_classes = []
    pairs = 0
    lo = 0
    for k in caps:
        sel = np.nonzero((sizes > lo) & (sizes <= k))[0]
        lo = k
        if sel.size == 0:
            continue
        sel = sel[np.argsort(-sizes[sel], kind="stable")]
        vc = int(sel.size)
        vc_pad = vc + (-vc) % cells_per_step_for(k, vc=vc)
        tab = np.full((vc_pad, k), -1, np.int32)
        tab[:vc][np.arange(k)[None, :] < sizes[sel][:, None]] = (
            _csr_gather(tri_of, offs, sel).astype(np.int32)
        )
        tids = np.full((vc_pad,), -1, np.int32)
        tids[:vc] = live[sel]
        bounds = None
        if k > K_BLOCK:
            # chunk t lower bound: candidates ascend by min-R bound, so
            # each 256-chunk's head carries its minimum; minus the
            # tile's max origin radius (host f32 + margin — s0 noise is
            # ~1 ulp, margined like _tri_maxr)
            heads = tab[:, ::K_BLOCK]
            chunk_lo = np.where(
                heads >= 0, tri_bounds[np.maximum(heads, 0)], np.inf
            )
            smax = np.where(tids >= 0, s0max[np.maximum(tids, 0)], 0.0)
            smax = smax * (1.0 + 1e-6) + 1e-7
            bounds = np.maximum(chunk_lo - smax[:, None], 0.0).astype(
                np.float32
            )
        classes.append((tids, tab, bounds))
        stat_classes.append((k, vc))
        pairs += vc_pad * k
    mark("class tables")

    stats = Raystab7Stats(
        g_fine=g_fine, live_tiles=int(live.size),
        dead_tiles=int(nt - live.size), pairs=int(pairs),
        near_origin=int(sub_ids.size), classes=tuple(stat_classes),
    )
    return RaystabCompact7(n=n, tile=tile, classes=tuple(classes),
                           stats=stats)


@partial(jax.jit, static_argnames=("n", "tile"))
def _tile_vox_ids(tids, n: int, tile: tuple):
    """Tile ids [VC] -> per-lane flat voxel ids [VC, 128] (x-major
    raster within the tile); padding tiles (-1) -> -1 lanes."""
    tx, ty, tz = tile
    bx, r = jnp.divmod(tids, (n // ty) * (n // tz))
    by, bz = jnp.divmod(r, n // tz)
    lane = jnp.arange(128, dtype=jnp.int32)
    lx, lr = jnp.divmod(lane, ty * tz)
    ly, lz = jnp.divmod(lr, tz)
    vox = (
        (bx[:, None] * tx + lx[None, :]) * (n * n)
        + (by[:, None] * ty + ly[None, :]) * n
        + (bz[:, None] * tz + lz[None, :])
    )
    return jnp.where(tids[:, None] < 0, -1, vox).astype(jnp.int32)


def _pack_ids24(tab: np.ndarray) -> np.ndarray:
    """Candidate id table i32 [VC, K] -> little-endian 24-bit bytes
    [VC, K, 3] for the wire (-1 padding -> 0xFFFFFF). Ids are < 2^24
    (asserted at build entry), so 3 bytes/id cut the per-geometry
    compact upload by a quarter."""
    u = np.asarray(tab).astype(np.int64) & 0xFFFFFF
    out = np.empty(tab.shape + (3,), np.uint8)
    out[..., 0] = u & 0xFF
    out[..., 1] = (u >> 8) & 0xFF
    out[..., 2] = (u >> 16) & 0xFF
    return out


def _unpack_ids24(packed) -> jnp.ndarray:
    """Device half of :func:`_pack_ids24` (0xFFFFFF -> -1)."""
    p = packed.astype(jnp.int32)
    u = p[..., 0] | (p[..., 1] << 8) | (p[..., 2] << 16)
    return jnp.where(u == 0xFFFFFF, jnp.int32(-1), u)


@partial(jax.jit, static_argnames=("n", "tile", "lanes"))
def _assemble_all_dev(verts_norm, tris, normals, tids_t: tuple,
                      tabs_t: tuple, n: int, tile: tuple, lanes: tuple):
    """ALL classes' device tables in ONE jit (one dispatch + one cached
    compile instead of one per class). ``tabs_t`` arrive as packed
    24-bit bytes (_pack_ids24). Gathers are value-identical to per-class
    _assemble_class_dev calls."""
    from dxrvoxelizer_tpu.ops.raystab_fast import _ray_params

    dirs_dev, s0_dev = _ray_params(n)
    fused_dev = _fused_coef_matrix(verts_norm, tris, normals)
    out = []
    for tids, tab_p, lane in zip(tids_t, tabs_t, lanes):
        rt128 = _tile_vox_ids(tids, n, tile)
        rays_d, coefs_d, ntab_d, _sc = _assemble_class_dev(
            fused_dev, dirs_dev, s0_dev, rt128, _unpack_ids24(tab_p),
            lane_aligned=lane,
        )
        out.append((rays_d, coefs_d, ntab_d))
    return tuple(out)


def assemble_raystab_accel7(
    compact: RaystabCompact7, verts_norm, tris, normals
) -> RaystabAccel7:
    """Device half: expand the compact id tables into kernel tables by
    XLA row gathers (bit-identical contract to gen-2's
    assemble_raystab_accel2 — same fused [T+1, 24] matrix, same
    _assemble_class_dev gathers, so coefficients match the oracle's
    backend exactly)."""
    mark = _stage_timer()
    n = compact.n
    tids_t = tuple(jnp.asarray(tids) for tids, _tab, _b in compact.classes)
    tabs_t = tuple(
        jnp.asarray(_pack_ids24(tab)) for _tids, tab, _b in compact.classes
    )
    lanes = tuple(
        bool(int(tab.shape[1]) >= LANE_MIN_K)
        for _tids, tab, _b in compact.classes
    )
    dev = _assemble_all_dev(
        jnp.asarray(verts_norm), jnp.asarray(tris), jnp.asarray(normals),
        tids_t, tabs_t, n, compact.tile, lanes,
    )
    classes = []
    for (rays_d, coefs_d, ntab_d), (tids, _tab, bounds_np), tids_dev in zip(
        dev, compact.classes, tids_t
    ):
        bounds_dev = (
            jnp.asarray(bounds_np) if bounds_np is not None else None
        )
        classes.append((rays_d, coefs_d, ntab_d, bounds_dev, tids_dev))
    mark("asm: one-dispatch class gathers")
    return RaystabAccel7(n=n, tile=compact.tile, classes=tuple(classes),
                         stats=compact.stats)


def build_raystab_accel7(
    verts_norm, tris, normals, n: int = 64, gs: tuple | None = None,
    span: int = 8, tile: tuple = TILE,
) -> RaystabAccel7:
    """Fresh static gen-7 accel — the DXR
    BuildRaytracingAccelerationStructure analog
    (Voxelizer.cpp:313-323)."""
    compact = build_raystab_compact7(
        verts_norm, tris, n=n, gs=gs, span=span, tile=tile
    )
    return assemble_raystab_accel7(compact, verts_norm, tris, normals)


@partial(jax.jit, static_argnames=("n", "tile", "ks", "t_count",
                                   "threshold", "rule", "interpret"))
def _raystab_query7(classes, n: int, tile: tuple, ks: tuple,
                    t_count: int, threshold: float, interpret: bool,
                    rule: str = "backface"):
    tx, ty, tz = tile
    v = n * n * n
    nt = v // 128
    out = jnp.zeros((nt + 1, 4, 128), jnp.float32)
    for (rays, coefs, ntab, bounds, tids), k in zip(classes, ks):
        _t, _i, ns = fold_extract_dispatch(
            rays, coefs, ntab, k, t_count, threshold, rule=rule,
            interpret=interpret, bounds=bounds,
        )
        # padding rows (tids -1) land on the dummy last row; their ns is
        # all-zero (zeroed rays -> den 0 -> miss), so duplicate writes
        # there are value-identical regardless of write order
        idx = jnp.where(tids < 0, nt, tids)
        out = out.at[idx].set(ns, mode="drop",
                              unique_indices=False)
    rgba = (
        out[:nt]
        .reshape(n // tx, n // ty, n // tz, 4, tx, ty, tz)
        .transpose(0, 4, 1, 5, 2, 6, 3)
        .reshape(n, n, n, 4)
    )
    return (rgba[..., 3] != 0.0), rgba


def raystab_query7(
    verts_norm, normals, tris, accel: RaystabAccel7,
    threshold: float = INSIDE_THRESHOLD, interpret: bool = False,
    rule: str = "backface",
):
    """Per-frame gen-7 trace -> (occupancy, rgba); ground truth is the
    radial oracle (ops/voxelize_ref.voxelize_raystab_radial_ref), same
    call contract as raystab_fast.raystab_query2."""
    del verts_norm, normals  # baked into the accel (API parity)
    ks = tuple(table_k(c[1]) for c in accel.classes)
    return _raystab_query7(
        accel.classes, accel.n, accel.tile, ks, int(tris.shape[0]),
        threshold, interpret, rule=rule,
    )


class RaystabTiledRefitter:
    """Gen-7 deforming-mesh refitter — build the padded compact once from
    the rest pose, regather coefficient/normal tables per frame on
    device. Same contract as raystab_refit.RaystabRefitter (whose
    gather helpers this reuses verbatim), minus the sort keys and
    scatter streams gen-7 no longer has."""

    def __init__(self, verts_rest, tris, normals_rest, n: int = 64,
                 pad: float = 0.035, gs: tuple | None = None,
                 span: int = 8, use_cache: bool = False,
                 cache_dir: str | None = None, pad_dirs=None,
                 tile: tuple = TILE):
        assert pad > 0.0, "a zero-pad refitter cannot absorb deformation"
        self.n = int(n)
        self.tile = tile
        self.pad = float(pad)
        self.tris = jnp.asarray(tris)
        self._pad_dirs = (
            None if pad_dirs is None
            else jnp.asarray(pad_dirs, jnp.float32)
        )
        if use_cache:
            from dxrvoxelizer_tpu.utils.accel_cache import cached_compact7

            compact = cached_compact7(
                verts_rest, tris, n, gs, span, pad=self.pad,
                cache_dir=cache_dir, pad_dirs=self._pad_dirs, tile=tile,
            )
        else:
            compact = build_raystab_compact7(
                verts_rest, tris, n, gs, span, pad=self.pad,
                pad_dirs=(
                    None if self._pad_dirs is None
                    else np.asarray(self._pad_dirs)
                ),
                tile=tile,
            )
        accel0 = assemble_raystab_accel7(
            compact, verts_rest, tris, normals_rest
        )
        self.stats = accel0.stats
        self._verts_rest = jnp.asarray(verts_rest)
        self._normals_rest = normals_rest
        self._static_cls = tuple(
            (cls[0], cls[3], cls[4]) for cls in accel0.classes
        )  # rays, bounds, tids
        self._ntabs_rest = tuple(cls[2] for cls in accel0.classes)
        self._lanes = tuple(
            bool(table_k(cls[1]) >= LANE_MIN_K) for cls in accel0.classes
        )
        self._tabs = tuple(
            jnp.asarray(tab) for (_tids, tab, _b) in compact.classes
        )
        self.rest_accel = accel0

    def device_state(self) -> tuple:
        """Device-buffer pytree for :meth:`refit_with_state` (pass through
        jit ARGUMENTS, not closure — see RaystabRefitter.device_state)."""
        return (self.tris, self._tabs, self._static_cls, self._ntabs_rest)

    def refit_with_state(self, state, verts_norm,
                         normals=None) -> RaystabAccel7:
        from dxrvoxelizer_tpu.ops.raystab_refit import (
            _refit_tables,
            _refit_tables_coef,
        )

        tris, tabs, static_cls, ntabs_rest = state
        if normals is None:
            couts, _ = _refit_tables_coef(
                verts_norm, tris, tabs, None, self._lanes, False,
            )
            classes = tuple(
                (rays, cf, nt, bounds, tids)
                for (rays, bounds, tids), cf, nt in zip(
                    static_cls, couts, ntabs_rest
                )
            )
        else:
            outs, _ = _refit_tables(
                verts_norm, normals, tris, tabs, None, self._lanes, False,
            )
            classes = tuple(
                (rays, cf, nf, bounds, tids)
                for (rays, bounds, tids), (cf, nf) in zip(static_cls, outs)
            )
        return RaystabAccel7(
            n=self.n, tile=self.tile, classes=classes, stats=self.stats,
        )

    def refit(self, verts_norm, normals=None,
              check: bool = False) -> RaystabAccel7:
        """Deformed (verts, normals) -> query-ready accel (async);
        ``check=True`` host-syncs to verify the displacement contract
        (magnitude AND, for directional pads, the axis + |s| bound)."""
        if check:
            check_deform_contract(
                jnp.asarray(verts_norm), self._verts_rest, self.pad,
                self._pad_dirs,
            )
        if normals is self._normals_rest:
            normals = None
        return self.refit_with_state(
            self.device_state(), jnp.asarray(verts_norm),
            None if normals is None else jnp.asarray(normals),
        )


def check_deform_contract(verts_norm, verts_rest, pad: float, pad_dirs):
    """Host-sync validation of the refit deformation contract; raises on
    violation. Shared by both refitters and the first-frame pipeline
    check (ADVICE r4: silent contract narrowing)."""
    d = verts_norm - verts_rest
    if pad_dirs is None:
        disp = float(jnp.max(jnp.linalg.norm(d, axis=-1)))
        if disp > pad:
            raise RuntimeError(
                f"deformation {disp:.4f} exceeds the refit pad "
                f"{pad:.4f}; rebuild the refitter with more"
            )
        return
    dd = jnp.sum(pad_dirs * pad_dirs, axis=-1)
    s = jnp.sum(d * pad_dirs, axis=-1) / jnp.maximum(dd, 1e-30)
    resid = float(jnp.max(jnp.linalg.norm(
        d - s[:, None] * pad_dirs, axis=-1
    )))
    if resid > 1e-5:
        raise RuntimeError(
            f"off-axis deformation {resid:.2e} violates the directional "
            "refit contract (pad_dirs); rebuild with pad_dirs=None for "
            "an isotropic bound"
        )
    # the capsule tables bound the PARAMETER |s|, not the displacement:
    # with non-unit dirs |disp| <= pad can still mean |s| > pad
    # (ADVICE r4) — check s directly
    smax = float(jnp.max(jnp.abs(s)))
    if smax > pad:
        raise RuntimeError(
            f"deformation parameter |s|={smax:.4f} exceeds the refit "
            f"pad {pad:.4f}; rebuild the refitter with more"
        )
