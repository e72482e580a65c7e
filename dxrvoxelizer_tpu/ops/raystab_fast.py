"""Accelerated ray-stab voxelizer — direction-space triangle binning.

The reference's default algorithm launches one ray per voxel from the voxel
center *radially outward* and classifies the voxel inside iff the first
surface hit is back-facing (DXRVoxelizer.hlsl:44-53,132-140); the DXR
BLAS/TLAS accelerates the per-ray traversal. This acceleration structure
exploits what is special about this ray pattern: every ray lies on
a line through the grid origin, so a triangle can only be hit by rays whose
direction falls inside the **cone of directions the triangle subtends from
the origin**. Triangles are therefore binned into a cubemap grid over
direction space (the radial-ray analog of the TLAS):

1. per triangle: bounding ball (centroid c, radius r) -> direction cone
   (axis c/|c|, half-angle asin(r/|c|)); balls containing the origin go to a
   global overflow list;
2. per cube face, the cone's exact azimuthal extents (the spherical-cap
   azimuth formula sin(dphi) = sin(alpha)/sin(colat)) give a conservative
   u/v interval -> a small rectangle of cells; triangles needing more than
   ``span`` cells per axis per face also overflow;
3. an XLA sort turns (cell, triangle) pairs into per-cell candidate lists
   padded to a shared capacity (same CSR pattern as ops/binning.py).

Voxel rays are grouped by direction cell — a grouping that is *static* per
(grid size, cubemap size) and cached host-side — so the query pass streams
cell blocks: [cells, rays-in-cell, candidates] Moller-Trumbore with a
closest-hit (t, then lowest-triangle-id) reduction, one coherent coefficient
gather per cell instead of per ray. A brute-force pass over the (rare)
overflow triangles and a lexicographic merge complete the exact first-hit.
That gen-1 query is plain XLA; the production gen-2..7 accels below run
the closest-hit fold picked by ops/route.py.

Exactness: intersection arithmetic is shared with the oracle
(ops/intersect.py ``mt_hit``) and the winner rule (strictly-closer, ties to
the lowest global triangle index) is identical, so occupancy and normal
grids match ops/voxelize_ref.voxelize_raystab_ref.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops import intersect, route
from dxrvoxelizer_tpu.ops.raystab_pallas import CELLS_PER_STEP, LANE_MIN_K
from dxrvoxelizer_tpu.ops.packing import voxel_centers_norm
from dxrvoxelizer_tpu.ops.voxelize_ref import INSIDE_THRESHOLD

# face f: axis a = f >> 1, sign s = +1 for even f; (b, c) = other axes asc.
_OTHERS = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)


def _stage_timer():
    """Opt-in per-stage build timing (DXRV_BUILD_TIMINGS=1): returns a
    ``mark(label)`` printing the time since the previous mark to stderr."""
    if not os.environ.get("DXRV_BUILD_TIMINGS"):
        return lambda label: None
    import sys
    import time

    last = [time.perf_counter()]

    def mark(label: str) -> None:
        now = time.perf_counter()
        print(f"# build stage {label}: {now - last[0]:.2f} s",
              file=sys.stderr)
        last[0] = now

    return mark


@dataclass
class RadialBinStats:
    n_cells: int
    capacity: int  # per-cell candidate capacity
    max_bin: int
    overflow: int  # triangles tested against every ray


def _dir_cells_host(d: np.ndarray, g: int) -> np.ndarray:
    """Direction [V,3] -> cubemap cell id [V] (host).

    Scale-invariant (u = d_b / |d_a|), so callers may pass UNNORMALIZED
    direction proxies (e.g. raw voxel centers). f32 single-pass math: a
    boundary ray can land one cell over vs exact arithmetic, which is safe
    — the triangle cone binning pads every rectangle by a 1e-4 rad guard
    (_cone_keys) that dwarfs f32 rounding, so each ray's candidate list
    stays a conservative superset wherever it lands. (The f64
    normalize-then-index version of this took 46 s of the 100 s 256^3
    accel build on the host.)
    """
    d = np.asarray(d, np.float32)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    # np.argmax's first-max tie rule, branchless
    a = np.where(ax >= ay, np.where(ax >= az, 0, 2),
                 np.where(ay >= az, 1, 2)).astype(np.int8)
    da = np.where(a == 0, x, np.where(a == 1, y, z))
    db = np.where(a == 0, y, x)  # _OTHERS[a, 0]
    dc = np.where(a == 2, y, z)  # _OTHERS[a, 1]
    f = 2 * a.astype(np.int64) + (da < 0)
    ada = np.abs(da)
    iu = np.clip(((db / ada + 1.0) * (0.5 * g)).astype(np.int64), 0, g - 1)
    iv = np.clip(((dc / ada + 1.0) * (0.5 * g)).astype(np.int64), 0, g - 1)
    return f * (g * g) + iu * g + iv


def _raytab_fill(order: np.ndarray, starts: np.ndarray,
                 n_cells: int) -> np.ndarray:
    """(order, starts) -> ray_table, vectorized in row chunks.

    Replaces the 6*g*g-iteration python fill loop (~9 s of the 256^3
    build at g=128); each chunk is one boolean-mask gather, identical
    rows. Chunking bounds the [rows, r_cap] index temporaries."""
    counts = (starts[1:] - starts[:-1]).astype(np.int64)
    r_cap = max(int(-(-counts.max() // 8) * 8), 8) if counts.size else 8
    ray_table = np.empty((n_cells, r_cap), dtype=np.int32)
    j = np.arange(r_cap, dtype=np.int64)[None, :]
    hi = max(order.shape[0] - 1, 0)
    step = max(1, (1 << 24) // r_cap)  # ~64 MB of index temporaries
    for lo in range(0, n_cells, step):
        sl = slice(lo, min(lo + step, n_cells))
        in_run = j < counts[sl, None]
        run_idx = np.clip(starts[sl][:, None] + j, 0, hi)
        ray_table[sl] = np.where(in_run, order[run_idx], -1)
    return ray_table


def _raytab_cache_dir() -> str | None:
    from dxrvoxelizer_tpu.utils.backend import CACHE_ROOT

    root = os.environ.get(
        "DXRVOX_RAYTAB_CACHE", os.path.join(CACHE_ROOT, "raytab")
    )
    return None if str(root) in ("0", "off", "none") else root


@lru_cache(maxsize=8)
def _ray_table_filled(n: int, g: int):
    """Static voxel->cell grouping: (ray_table [C, R_cap] int32 voxel
    ids / -1, rc [C] int64 per-cell ray counts). Within every cell the
    rays are ordered by (origin-radius f32 bits, voxel id) ascending —
    radius-banded, so the pack walk slices big cells into strips
    DIRECTLY instead of sorting 16.7M rays by s0 per geometry build.

    Pure function of (n, g) — mesh-independent — so both live in the
    on-disk raytab cache (v3 since the radius ordering): a cache hit
    memory-maps the filled table (the pack walk pages it in row-by-row
    under the native packer) and reads the counts from a tiny sibling
    file, so nothing scans the full table on the build's critical path.
    """
    from dxrvoxelizer_tpu.utils import native

    n_cells = 6 * g * g
    v = n * n * n
    root = _raytab_cache_dir()
    path2 = os.path.join(root, f"rt{n}_g{g}_f3.npy") if root else None
    path_rc = os.path.join(root, f"rt{n}_g{g}_rc3.npy") if root else None

    def _save_npy(p, arr):
        if p is None:
            return
        try:
            os.makedirs(root, exist_ok=True)
            tmp = p + f".tmp{os.getpid()}"
            np.save(tmp, arr)
            os.replace(tmp + ".npy", p)
        except OSError:
            pass

    def _save_npy_bg(p, arr):
        """Cache write off the critical path (the 256^3 table is 120 MiB;
        a foreground np.save cost ~5 s of every COLD build). Daemon
        thread + atomic tmp-replace: a torn write never becomes the
        cache file, and readers either see the old state or the new."""
        if p is None:
            return
        import threading

        threading.Thread(
            target=_save_npy, args=(p, arr), daemon=True
        ).start()

    if path2 is not None and os.path.exists(path2):
        try:
            rt = np.load(path2, mmap_mode="r")
            if (rt.ndim == 2 and rt.shape[0] == n_cells
                    and rt.dtype == np.int32):
                rc = None
                if path_rc is not None and os.path.exists(path_rc):
                    rc = np.load(path_rc)
                    if rc.shape != (n_cells,) or rc.dtype != np.int64:
                        rc = None
                if rc is None:
                    rc = (np.asarray(rt) >= 0).sum(axis=1).astype(np.int64)
                    _save_npy(path_rc, rc)
                return rt, rc
        except (OSError, ValueError):
            pass

    def _save2(rt, rc):
        _save_npy_bg(path_rc, rc)
        _save_npy_bg(path2, rt)

    nat = native.raytab_native(n, g)
    if nat is not None:  # one-call C++ counting-sort build (~3x the numpy)
        rt, rc = nat
        _save2(rt, rc)
        return rt, rc
    # pure-numpy fallback (bit-identical to the native path, see tests)
    cx, cy, cz = voxel_centers_norm(n)
    pos = np.stack(
        np.meshgrid(cx, cy, cz, indexing="ij"), axis=-1
    ).reshape(-1, 3).astype(np.float32)
    cells = native.dir_cells_native(n, g)
    if cells is None:
        # _dir_cells_host is scale-invariant: no normalize over 16.7M rays
        cells = _dir_cells_host(pos, g)
    # within-cell order = (origin-radius f32 bits, voxel id) ascending:
    # sort once by the packed secondary key, then stable-sort by cell
    r = np.sqrt((pos * pos).sum(-1, dtype=np.float32))
    skey = (
        r.view(np.uint32).astype(np.uint64) << np.uint64(32)
    ) | np.arange(v, dtype=np.uint64)
    perm1 = np.argsort(skey)
    order = perm1[np.argsort(cells[perm1], kind="stable")].astype(np.int32)
    sorted_cells = np.sort(cells)
    starts = np.searchsorted(sorted_cells, np.arange(n_cells + 1)).astype(
        np.int64
    )
    rt = _raytab_fill(order, starts, n_cells)
    rc = (starts[1:] - starts[:-1]).astype(np.int64)
    _save2(rt, rc)
    return rt, rc


@lru_cache(maxsize=8)
def ray_tables(n: int, g: int):
    """(ray_table [C, R_cap] int32 voxel ids / -1, scatter [C, R_cap]
    int32 positions into a V+1 output / V for padding) — the gen-1 accel's
    view of :func:`_ray_table_filled` (the gen-2 build path uses that
    directly and never materializes ``scatter``)."""
    rt, _ = _ray_table_filled(n, g)
    rt = np.asarray(rt)  # gen-1 keeps both resident; drop the mmap view
    scatter = np.where(rt >= 0, rt, n * n * n).astype(np.int32)
    return rt, scatter


@partial(jax.jit, static_argnames=("g", "span"))
def _cone_keys(verts_norm, tris, g: int, span: int, pad=0.0):
    """Per-triangle direction cones -> cubemap cell rectangles + overflow.

    Returns (rects [6, 5, T] int32 rows (iu0, iu1, iv0, iv1, fits),
    over [T] bool). Only the compact per-face rectangles leave the device;
    the span*span*6*T (cell, triangle) expansion runs on the host
    (_cone_bins_host) — materializing the expanded key tensor on device
    and copying it out cost ~10x the whole rest of the binning.

    ``pad`` (deformation bound, normalized units): each triangle's
    bounding ball is enlarged by ``pad`` before the cone is derived, so
    the bins stay a conservative prefilter for ANY vertex set within
    ``pad`` of this one per vertex (convexity: a deformed point is a
    convex combination of deformed vertices, each within ``pad`` of its
    rest position, so it stays inside ball(c, r + pad)). This is what
    makes per-frame accel REFIT exact for bounded deformations
    (ops/raystab_refit.py, the DXR AS-update analog). With pad > 0,
    rest-degenerate triangles are NOT dropped (deformation can open
    them up); pad == 0.0 reproduces the static binning bit-for-bit."""
    v0 = verts_norm[tris[:, 0]]
    v1 = verts_norm[tris[:, 1]]
    v2 = verts_norm[tris[:, 2]]
    t_count = tris.shape[0]
    n_cells = 6 * g * g

    c = (v0 + v1 + v2) / 3.0
    pad = jnp.float32(pad)
    r = jnp.sqrt(
        jnp.maximum(
            jnp.sum((v0 - c) ** 2, -1),
            jnp.maximum(jnp.sum((v1 - c) ** 2, -1), jnp.sum((v2 - c) ** 2, -1)),
        )
    ) + pad
    cn = jnp.linalg.norm(c, axis=-1)
    near_origin = cn <= 1.5 * r + 1e-7
    safe_cn = jnp.maximum(cn, 1e-20)
    chat = c / safe_cn[:, None]
    sin_a = jnp.minimum(r / safe_cn * (1.0 + 1e-5) + 1e-6, 1.0)

    guard = 1e-4  # angular safety padding (covers fp assignment jitter)

    def face_interval(ca, cb):
        """Azimuth interval of the cone in the (s*a, b) plane -> (lo, hi,
        full, empty) with lo/hi in u = tan(azimuth) cube coords."""
        rho = jnp.sqrt(ca * ca + cb * cb)
        full = (sin_a >= rho - 1e-6) | (sin_a >= 1.0 - 1e-6)
        dphi = jnp.arcsin(jnp.clip(sin_a / jnp.maximum(rho, 1e-20), 0.0, 1.0))
        full = full | (dphi >= jnp.pi / 2 - guard)
        az = jnp.arctan2(cb, ca)
        lo = az - dphi - guard
        hi = az + dphi + guard
        empty = (~full) & ((lo > jnp.pi / 2) | (hi < -jnp.pi / 2))
        lim = jnp.pi / 2 - 1e-4
        u_lo = jnp.where(full, -1.0, jnp.tan(jnp.clip(lo, -lim, lim)))
        u_hi = jnp.where(full, 1.0, jnp.tan(jnp.clip(hi, -lim, lim)))
        return (
            jnp.clip(u_lo - 1e-5, -1.0, 1.0),
            jnp.clip(u_hi + 1e-5, -1.0, 1.0),
            empty,
        )

    alpha = jnp.arcsin(jnp.clip(sin_a, 0.0, 1.0))
    # any direction on face (a, s) has s*omega_a >= 1/sqrt(3); the face is
    # relevant only if the cone reaches that region:
    # angle(c_hat, s*e_a) - alpha <= acos(1/sqrt(3))
    max_face_angle = jnp.float32(np.arccos(1.0 / np.sqrt(3.0)) + 1e-3)

    rects = []
    spans = []
    for f in range(6):
        a = f >> 1
        s = 1.0 if f % 2 == 0 else -1.0
        b, cax = int(_OTHERS[a, 0]), int(_OTHERS[a, 1])
        ca = s * chat[:, a]
        relevant = (
            jnp.arccos(jnp.clip(ca, -1.0, 1.0)) - alpha <= max_face_angle
        )
        u_lo, u_hi, e_u = face_interval(ca, chat[:, b])
        v_lo, v_hi, e_v = face_interval(ca, chat[:, cax])
        face_ok = relevant & (~e_u) & (~e_v) & (~near_origin)
        iu0 = jnp.clip(((u_lo + 1.0) * 0.5 * g).astype(jnp.int32), 0, g - 1)
        iu1 = jnp.clip(((u_hi + 1.0) * 0.5 * g).astype(jnp.int32), 0, g - 1)
        iv0 = jnp.clip(((v_lo + 1.0) * 0.5 * g).astype(jnp.int32), 0, g - 1)
        iv1 = jnp.clip(((v_hi + 1.0) * 0.5 * g).astype(jnp.int32), 0, g - 1)
        su = iu1 - iu0 + 1
        sv = iv1 - iv0 + 1
        fits = face_ok & (su <= span) & (sv <= span)
        spans.append((face_ok, fits))
        rects.append(
            jnp.stack([iu0, iu1, iv0, iv1, fits.astype(jnp.int32)], axis=0)
        )
    # overflow: near-origin balls or any face whose rectangle exceeds span
    over = near_origin
    for face_ok, fits in spans:
        over = over | (face_ok & ~fits)
    # rest-degenerate triangles are dropped from the overflow stream only
    # in the static build; under a deformation pad they may open up, so
    # keep them (face-rectangle binning covers them either way: the cone
    # math only sees the padded ball)
    valid_tri = (
        jnp.linalg.norm(jnp.cross(v1 - v0, v2 - v0), axis=-1) > 0.0
    ) | (pad > 0.0)
    over = over & valid_tri

    return jnp.stack(rects, axis=0), over


def _capsule_params(verts_h, tris_h, pad: float, pad_dirs):
    """Per-triangle capsule endpoints + effective radius for a
    DIRECTIONAL deformation bound.

    Contract: every frame's vertices satisfy v'_i = v_i + s_i * d_i with
    |s_i| <= pad and d_i = pad_dirs[i]. Decompose with the per-triangle
    mean direction a = (d_0 + d_1 + d_2)/3:
        v_i + s_i d_i = (v_i + s_i a) + s_i (d_i - a)
    so every deformed point lies in Minkowski(triangle, segment(+-pad*a),
    ball(pad * max_i |d_i - a|)) — the hull of two balls at c +- pad*a
    with radius r + pad*maxdev. Where the motion axis aligns with the
    view direction (outward normals on a radially-viewed surface) the
    direction cone barely grows, vs the isotropic ball's r + pad.

    Returns (offs [T,3] f32 = pad*a, r_extra [T] f32 = pad*maxdev).
    """
    d0 = pad_dirs[tris_h[:, 0]].astype(np.float32)
    d1 = pad_dirs[tris_h[:, 1]].astype(np.float32)
    d2 = pad_dirs[tris_h[:, 2]].astype(np.float32)
    a = (d0 + d1 + d2) / np.float32(3.0)
    maxdev = np.sqrt(
        np.maximum(
            ((d0 - a) ** 2).sum(-1),
            np.maximum(((d1 - a) ** 2).sum(-1), ((d2 - a) ** 2).sum(-1)),
        )
    )
    return np.float32(pad) * a, np.float32(pad) * maxdev


def _seg_origin_dist(p, q):
    """Distance from the origin to segment(p, q), vectorized f32."""
    d = q - p
    dd = (d * d).sum(-1)
    t = np.clip(
        -(p * d).sum(-1) / np.maximum(dd, np.float32(1e-30)), 0.0, 1.0
    )
    x = p + t[:, None] * d
    return np.linalg.norm(x, axis=-1).astype(np.float32)


def _cone_keys_np(verts_h: np.ndarray, tris_h: np.ndarray, g: int,
                  span: int, pad: float = 0.0, pad_dirs=None):
    """Numpy port of :func:`_cone_keys` for the build's host path.

    The jnp version cost one fresh XLA:CPU compile PER LADDER LEVEL
    (~6-7 s each at 100k tris — 20 s of the cold 256^3 build was
    compiles of this trivially-vectorizable math). Same f32 expressions;
    libm vs XLA may differ by ulps on the transcendentals, which is safe
    — the rectangles are a conservative prefilter with a 1e-4 rad guard
    and the exact intersection test rejects extras either way.

    ``pad_dirs`` (with ``pad`` > 0) selects the DIRECTIONAL deformation
    bound. Every deformed point lies in the hull of the SIX corner
    points v_i +- pad*d_i, so on faces where all six corners have a
    positive dominant coordinate the rectangle is just the corner
    direction extrema: for positive denominators the mediant inequality
    gives min_i(b_i/a_i) <= (sum l_i b_i)/(sum l_i a_i) <= max_i(b_i/a_i)
    — hull directions never leave the corner interval. Where corner
    signs mix (hull straddling a coordinate plane), the face falls back
    to the capsule bound hull(ball(c - pad*a, r_eff), ball(c + pad*a,
    r_eff)) from :func:`_capsule_params` (itself conservative: each face
    rectangle is the union of the two endpoint balls' intervals, and a
    segment's direction coordinate u(t) = p_b(t)/p_a(t) is a Mobius
    function of t with a positive denominator wherever the face is
    valid, hence monotone). Near-origin/relevance/empty flags always
    come from the capsule (a superset of the hull)."""
    verts_h = np.asarray(verts_h, np.float32)
    tris_h = np.asarray(tris_h)
    v0 = verts_h[tris_h[:, 0]]
    v1 = verts_h[tris_h[:, 1]]
    v2 = verts_h[tris_h[:, 2]]

    c = (v0 + v1 + v2) / np.float32(3.0)
    pad = np.float32(pad)
    r = np.sqrt(
        np.maximum(
            ((v0 - c) ** 2).sum(-1),
            np.maximum(((v1 - c) ** 2).sum(-1), ((v2 - c) ** 2).sum(-1)),
        )
    )
    corners = None
    if pad_dirs is not None and pad > 0.0:
        offs, r_extra = _capsule_params(verts_h, tris_h, pad, pad_dirs)
        centers = (c - offs, c + offs)
        r = r + r_extra
        d_origin = _seg_origin_dist(c - offs, c + offs)
        # the six deformed-hull corners v_i +- pad*d_i, [6, T, 3]
        dirs = np.asarray(pad_dirs, np.float32)
        d0 = np.float32(pad) * dirs[tris_h[:, 0]]
        d1 = np.float32(pad) * dirs[tris_h[:, 1]]
        d2 = np.float32(pad) * dirs[tris_h[:, 2]]
        corners = np.stack([
            v0 - d0, v0 + d0, v1 - d1, v1 + d1, v2 - d2, v2 + d2,
        ])
    else:
        centers = (c,)
        r = r + pad
        d_origin = np.linalg.norm(c, axis=-1).astype(np.float32)

    near_origin = d_origin <= np.float32(1.5) * r + np.float32(1e-7)

    guard = np.float32(1e-4)
    max_face_angle = np.float32(np.arccos(1.0 / np.sqrt(3.0)) + 1e-3)

    def ball_face_terms(cc):
        """Per endpoint ball: (chat, sin_a, alpha) used by the interval
        math — identical expressions to the single-ball path."""
        cn = np.linalg.norm(cc, axis=-1).astype(np.float32)
        safe_cn = np.maximum(cn, np.float32(1e-20))
        chat = cc / safe_cn[:, None]
        sin_a = np.minimum(
            r / safe_cn * np.float32(1.0 + 1e-5) + np.float32(1e-6),
            np.float32(1.0),
        )
        alpha = np.arcsin(np.clip(sin_a, 0.0, 1.0)).astype(np.float32)
        return chat, sin_a, alpha

    terms = [ball_face_terms(cc) for cc in centers]

    def face_interval(sin_a, ca, cb):
        rho = np.sqrt(ca * ca + cb * cb)
        full = (sin_a >= rho - np.float32(1e-6)) | (
            sin_a >= np.float32(1.0 - 1e-6)
        )
        dphi = np.arcsin(
            np.clip(sin_a / np.maximum(rho, np.float32(1e-20)), 0.0, 1.0)
        )
        full = full | (dphi >= np.float32(np.pi / 2) - guard)
        az = np.arctan2(cb, ca).astype(np.float32)
        lo = az - dphi - guard
        hi = az + dphi + guard
        empty = (~full) & (
            (lo > np.float32(np.pi / 2)) | (hi < np.float32(-np.pi / 2))
        )
        lim = np.float32(np.pi / 2 - 1e-4)
        u_lo = np.where(full, np.float32(-1.0), np.tan(np.clip(lo, -lim, lim)))
        u_hi = np.where(full, np.float32(1.0), np.tan(np.clip(hi, -lim, lim)))
        return (
            np.clip(u_lo - np.float32(1e-5), -1.0, 1.0).astype(np.float32),
            np.clip(u_hi + np.float32(1e-5), -1.0, 1.0).astype(np.float32),
            empty,
        )

    rects = []
    spans = []
    half_g = np.float32(0.5 * g)
    for f in range(6):
        a = f >> 1
        s = np.float32(1.0 if f % 2 == 0 else -1.0)
        b, cax = int(_OTHERS[a, 0]), int(_OTHERS[a, 1])
        # union over capsule endpoints (one iteration for the ball case)
        u_lo = v_lo = None
        relevant = empty_u = empty_v = None
        for chat, sin_a, alpha in terms:
            ca = s * chat[:, a]
            rel = (
                np.arccos(np.clip(ca, -1.0, 1.0)).astype(np.float32)
                - alpha <= max_face_angle
            )
            ul, uh, eu = face_interval(sin_a, ca, chat[:, b])
            vl, vh, ev = face_interval(sin_a, ca, chat[:, cax])
            if u_lo is None:
                u_lo, u_hi, v_lo, v_hi = ul, uh, vl, vh
                relevant, empty_u, empty_v = rel, eu, ev
            else:
                u_lo = np.minimum(u_lo, ul)
                u_hi = np.maximum(u_hi, uh)
                v_lo = np.minimum(v_lo, vl)
                v_hi = np.maximum(v_hi, vh)
                relevant = relevant | rel
                empty_u = empty_u & eu
                empty_v = empty_v & ev
        if corners is not None:
            # 6-point hull refinement: where every corner's dominant
            # coordinate is safely positive, the corner extrema bound
            # ALL hull directions (mediant inequality) — far tighter
            # than the capsule (no triangle-ball or normal-deviation
            # inflation). Mixed-sign faces keep the capsule interval.
            pa = s * corners[..., a]
            pb = corners[..., b]
            pc = corners[..., cax]
            all_pos = (pa > np.float32(1e-12)).all(axis=0)
            safe_pa = np.maximum(pa, np.float32(1e-30))
            uc = pb / safe_pa
            vc_ = pc / safe_pa
            hg = np.float32(2e-4)  # fp guard in u (cells are >= 2/g wide)
            u_lo = np.where(
                all_pos,
                np.clip(uc.min(axis=0) - hg, -1.0, 1.0).astype(np.float32),
                u_lo,
            )
            u_hi = np.where(
                all_pos,
                np.clip(uc.max(axis=0) + hg, -1.0, 1.0).astype(np.float32),
                u_hi,
            )
            v_lo = np.where(
                all_pos,
                np.clip(vc_.min(axis=0) - hg, -1.0, 1.0).astype(np.float32),
                v_lo,
            )
            v_hi = np.where(
                all_pos,
                np.clip(vc_.max(axis=0) + hg, -1.0, 1.0).astype(np.float32),
                v_hi,
            )
        face_ok = relevant & (~empty_u) & (~empty_v) & (~near_origin)
        iu0 = np.clip(((u_lo + 1.0) * half_g).astype(np.int32), 0, g - 1)
        iu1 = np.clip(((u_hi + 1.0) * half_g).astype(np.int32), 0, g - 1)
        iv0 = np.clip(((v_lo + 1.0) * half_g).astype(np.int32), 0, g - 1)
        iv1 = np.clip(((v_hi + 1.0) * half_g).astype(np.int32), 0, g - 1)
        su = iu1 - iu0 + 1
        sv = iv1 - iv0 + 1
        fits = face_ok & (su <= span) & (sv <= span)
        spans.append((face_ok, fits))
        rects.append(
            np.stack([iu0, iu1, iv0, iv1, fits.astype(np.int32)], axis=0)
        )
    over = near_origin
    for face_ok, fits in spans:
        over = over | (face_ok & ~fits)
    valid_tri = (
        np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1) > 0.0
    ) | (pad > 0.0)
    over = over & valid_tri

    return np.stack(rects, axis=0), over


def _cone_bins_host(rects_h: np.ndarray, over_h: np.ndarray, g: int,
                    span: int):
    """Host half of the cone binning: rectangle expansion + stable radix
    sort + CSR.

    Order contract: within every cell the candidate order is
    (du, dv, tri)-ascending — identical to stable-sorting the historical
    (face, du, dv, tri)-ordered key stream (a cell's face is fixed, so
    the interleaving of faces across the emission loop is irrelevant).
    Returns (sorted_tris, starts, counts, ov_ids) as numpy arrays.
    """
    n_cells = 6 * g * g
    t_count = rects_h.shape[-1]
    iu0 = rects_h[:, 0].reshape(-1)  # [6*T], face-major
    iv0 = rects_h[:, 2].reshape(-1)
    su = rects_h[:, 1].reshape(-1) - iu0 + 1
    sv = rects_h[:, 3].reshape(-1) - iv0 + 1
    fits = rects_h[:, 4].reshape(-1) != 0
    face_base = (
        np.repeat(np.arange(6, dtype=np.int64), t_count) * (g * g)
    )
    kparts, tparts = [], []
    for du in range(span):
        okr = fits & (du < su)
        rows = np.flatnonzero(okr)
        if rows.size == 0:
            continue
        cell_u = face_base[rows] + (iu0[rows] + du).astype(np.int64) * g
        cell_v0 = iv0[rows].astype(np.int64)
        svr = sv[rows]
        tri = (rows % t_count).astype(np.int32)
        for dv in range(span):
            # applied uniformly (at dv=0 it is all-true: _cone_keys clips
            # rectangles to the face, so sv >= 1 for every emitted row)
            sel = dv < svr
            if not sel.all():
                cell_u, cell_v0, svr, tri = (
                    cell_u[sel], cell_v0[sel], svr[sel], tri[sel]
                )
            if tri.size == 0:
                break
            kparts.append(cell_u + cell_v0 + dv)
            tparts.append(tri)
    if kparts:
        kv = np.concatenate(kparts)
        tv = np.concatenate(tparts)
    else:
        kv = np.zeros((0,), np.int64)
        tv = np.zeros((0,), np.int32)
    order = np.argsort(kv, kind="stable")
    sorted_keys = kv[order]
    sorted_tris = tv[order]
    starts = np.searchsorted(sorted_keys, np.arange(n_cells + 1)).astype(
        np.int64
    )
    counts = (starts[1:] - starts[:-1]).astype(np.int32)
    ov_ids = np.flatnonzero(over_h).astype(np.int32)
    return sorted_tris, starts, counts, ov_ids


def _cell_table_host(sorted_tris, starts, counts, cap: int) -> np.ndarray:
    """Padded per-cell candidate id table [C, cap] (-1 = empty slot)."""
    j = np.arange(cap, dtype=np.int64)[None, :]
    in_run = j < counts[:, None]
    if sorted_tris.size == 0:
        return np.full((counts.shape[0], cap), -1, np.int32)
    run_idx = np.clip(starts[:-1][:, None] + j, 0, sorted_tris.shape[0] - 1)
    return np.where(in_run, sorted_tris[run_idx], -1).astype(np.int32)


def bin_triangles_radial(
    verts_norm: jnp.ndarray,
    tris: jnp.ndarray,
    g: int = 32,
    span: int = 8,
):
    """Direction-space binning -> (cell_table [C,K], counts, ov_ids, stats).

    ``counts`` comes back on the host — the query partitions cells into
    capacity classes from it (bin sizes are long-tailed: a handful of
    grazing-direction cells see 30x the median candidate count).
    """
    cpu = _host_cpu()
    if cpu is not None:
        with jax.default_device(cpu):
            rects_d, over_d = _cone_keys(
                jnp.asarray(np.asarray(verts_norm)),
                jnp.asarray(np.asarray(tris)), g, span,
            )
            rects_h, over_h = np.asarray(rects_d), np.asarray(over_d)
    else:
        rects_d, over_d = _cone_keys(verts_norm, tris, g, span)
        rects_h, over_h = np.asarray(rects_d), np.asarray(over_d)
    sorted_tris, starts, counts_h, ov_np = _cone_bins_host(
        rects_h, over_h, g, span
    )
    max_bin = int(counts_h.max()) if counts_h.size else 0
    n_ov = int(ov_np.size)
    cap = 8
    while cap < max(max_bin, 1):
        cap *= 2
    table = jnp.asarray(_cell_table_host(sorted_tris, starts, counts_h, cap))
    o_cap = max(-(-max(n_ov, 1) // 64) * 64, 8) if n_ov > 8 else 8
    ov = np.full((o_cap,), -1, np.int32)
    ov[: min(n_ov, o_cap)] = ov_np[:o_cap]
    stats = RadialBinStats(
        n_cells=6 * g * g, capacity=cap, max_bin=max_bin, overflow=n_ov
    )
    return table, counts_h, jnp.asarray(ov), stats


@partial(jax.jit, static_argnames=("n",))
def voxel_rays(n: int):
    """Per-voxel ray origins + directions, exactly the oracle's expressions
    (ops/voxelize_ref.py) so closest-hit t values agree bit-for-bit."""
    cx, cy, cz = (jnp.asarray(t) for t in voxel_centers_norm(n))
    px = cx[:, None, None]
    py = cy[None, :, None]
    pz = cz[None, None, :]
    pos = jnp.stack(jnp.broadcast_arrays(px, py, pz), axis=-1).reshape(-1, 3)
    length = jnp.linalg.norm(pos, axis=-1, keepdims=True)
    dirs = pos / jnp.maximum(length, 1e-20)
    return pos, dirs


@partial(jax.jit, static_argnames=("n", "cell_chunk"))
def _query_cells(
    verts_norm, tris, cell_table, ray_table, scatter, n: int,
    cell_chunk: int = 32,
):
    """Closest hit per voxel over its cell's candidates.

    ``cell_table`` [C, K] / ``ray_table`` [C, R] / ``scatter`` [C, R] may be
    any *subset* of cells (a capacity class) padded to a cell_chunk multiple.
    Returns (t [V+1... clipped to V], idx [V], pos, dirs); slots of cells
    outside the subset keep t=+inf.
    """
    pos, dirs = voxel_rays(n)

    v0, e1, e2 = intersect.triangle_soup(verts_norm, tris)
    t_count = tris.shape[0]
    zero = jnp.zeros((1, 3), v0.dtype)
    v0p = jnp.concatenate([v0, zero])
    e1p = jnp.concatenate([e1, zero])
    e2p = jnp.concatenate([e2, zero])
    pos_p = jnp.concatenate([pos, jnp.zeros((1, 3), pos.dtype)])
    dirs_p = jnp.concatenate([dirs, jnp.zeros((1, 3), dirs.dtype)])

    n_cells = cell_table.shape[0]
    assert n_cells % cell_chunk == 0
    big = jnp.int32(2**30)

    def body(chunk):
        rays, cand = chunk  # [cc, R], [cc, K]
        ray_idx = jnp.where(rays >= 0, rays, n * n * n)
        o = pos_p[ray_idx]  # [cc, R, 3]
        d = dirs_p[ray_idx]
        cid = jnp.where(cand >= 0, cand, t_count)
        tv0 = v0p[cid]  # [cc, K, 3]
        te1 = e1p[cid]
        te2 = e2p[cid]
        t, _, _, _ = intersect.mt_hit(
            o[:, :, None, :], d[:, :, None, :],
            tv0[:, None, :, :], te1[:, None, :, :], te2[:, None, :, :],
        )  # [cc, R, K]
        t = jnp.where((cand >= 0)[:, None, :], t, jnp.inf)
        t_min = jnp.min(t, axis=-1)  # [cc, R]
        idx = jnp.min(
            jnp.where(t == t_min[..., None], cid[:, None, :], big), axis=-1
        )
        return t_min, idx.astype(jnp.int32)

    rt = ray_table.reshape(n_cells // cell_chunk, cell_chunk, -1)
    ct = cell_table.reshape(n_cells // cell_chunk, cell_chunk, -1)
    t_cells, idx_cells = jax.lax.map(body, (rt, ct))

    out_t = jnp.full((n * n * n + 1,), jnp.inf, jnp.float32)
    out_i = jnp.full((n * n * n + 1,), big, jnp.int32)
    flat_scatter = scatter.reshape(-1)
    out_t = out_t.at[flat_scatter].set(t_cells.reshape(-1), mode="drop")
    out_i = out_i.at[flat_scatter].set(idx_cells.reshape(-1), mode="drop")
    return out_t[:-1], out_i[:-1], pos, dirs


@partial(jax.jit, static_argnames=("n", "threshold"))
def _finalize(
    verts_norm, normals, tris, pos, dirs, best_t, best_i, n: int,
    threshold: float,
):
    """Recompute (u, v) at each voxel's winning triangle; normals + rgba."""
    t_count = tris.shape[0]
    hit = jnp.isfinite(best_t) & (best_i < t_count)
    idx = jnp.where(hit, best_i, 0)
    v0, e1, e2 = intersect.triangle_soup(verts_norm, tris)
    _, u, v, _ = intersect.mt_hit(pos, dirs, v0[idx], e1[idx], e2[idx])
    n0 = normals[tris[idx, 0]]
    n1 = normals[tris[idx, 1]]
    n2 = normals[tris[idx, 2]]
    nrm = n0 + u[:, None] * (n1 - n0) + v[:, None] * (n2 - n0)
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    inside = hit & (jnp.sum(nrm * dirs, axis=-1) > threshold)
    rgba = jnp.where(
        inside[:, None],
        jnp.concatenate([nrm, jnp.ones_like(u)[:, None]], axis=-1),
        0.0,
    )
    return inside.reshape(n, n, n), rgba.reshape(n, n, n, 4)


@partial(jax.jit, static_argnames=("n",))
def _overflow_pass(verts_norm, tris, ov_ids, pos, dirs, n: int):
    """Brute closest hit of every ray against the overflow triangles."""
    t_count = tris.shape[0]
    safe = jnp.where(ov_ids >= 0, ov_ids, 0)
    ov_tris = jnp.where(ov_ids[:, None] >= 0, tris[safe], 0)
    # degenerate (0,0,0)-index triangles from padding never hit (det == 0)
    ov_tris = jnp.where(ov_ids[:, None] >= 0, ov_tris, jnp.zeros_like(ov_tris))
    v0, e1, e2 = intersect.triangle_soup(verts_norm, ov_tris)
    zero_mask = (ov_ids < 0)[:, None]
    v0 = jnp.where(zero_mask, 0.0, v0)
    e1 = jnp.where(zero_mask, 0.0, e1)
    e2 = jnp.where(zero_mask, 0.0, e2)
    t, u, v, i = intersect.closest_hit(pos, dirs, v0, e1, e2, tri_chunk=min(
        2048, max(8, v0.shape[0])
    ))
    gid = jnp.where(
        jnp.isfinite(t), ov_ids[jnp.clip(i, 0, ov_ids.shape[0] - 1)], 2**30
    )
    return t, gid.astype(jnp.int32)


CLASS_CAPS = (64, 256, 1024)  # capacity-class boundaries (then stats.capacity)


@dataclass
class RaystabAccel:
    """The built acceleration structure (the DXR TLAS analog).

    ``classes``: per capacity class, (cell_table [Cc,K], ray_table [Cc,R],
    scatter [Cc,R]) with the class's cells padded to a cell_chunk multiple.
    """

    n: int
    g: int
    classes: tuple
    ov_ids: jnp.ndarray
    stats: RadialBinStats


def build_raystab_accel(
    verts_norm: jnp.ndarray,
    tris: jnp.ndarray,
    n: int = 64,
    g: int = 32,
    span: int = 8,
    cell_chunk: int = 32,
) -> RaystabAccel:
    """Bin triangles + partition cells into capacity classes (two host
    syncs; rebuild only when geometry deforms — reference builds its AS once
    at init, Voxelizer.cpp:264-326)."""
    table, counts, ov_ids, stats = bin_triangles_radial(
        verts_norm, tris, g, span
    )
    ray_table, scatter = ray_tables(n, g)
    v = n * n * n

    classes = []
    caps = [c for c in CLASS_CAPS if c < stats.capacity] + [stats.capacity]
    lo = 0
    for k in caps:
        cls = np.nonzero((counts > lo) & (counts <= k))[0]
        lo = k
        if cls.size == 0:
            continue
        pad = (-cls.size) % cell_chunk
        rt = ray_table[cls]
        sc = scatter[cls]
        if pad:
            rt = np.concatenate([rt, np.full((pad, rt.shape[1]), -1, rt.dtype)])
            sc = np.concatenate([sc, np.full((pad, sc.shape[1]), v, sc.dtype)])
        ct = table[jnp.asarray(cls)][:, :k]
        if pad:
            ct = jnp.concatenate([ct, jnp.full((pad, k), -1, ct.dtype)], axis=0)
        classes.append((ct, jnp.asarray(rt), jnp.asarray(sc)))

    return RaystabAccel(
        n=n, g=g, classes=tuple(classes), ov_ids=ov_ids, stats=stats,
    )


@partial(
    jax.jit,
    static_argnames=("n", "threshold", "cell_chunk", "with_overflow"),
)
def _raystab_query_all(
    verts_norm, normals, tris, classes, ov_ids, n: int,
    threshold: float, cell_chunk: int, with_overflow: bool,
):
    """One-dispatch query: all capacity classes + overflow + finalize."""
    v = n * n * n
    big = jnp.int32(2**30)
    best_t = jnp.full((v,), jnp.inf, jnp.float32)
    best_i = jnp.full((v,), big, jnp.int32)
    pos, dirs = voxel_rays(n)

    for ct, rt, sc in classes:
        t_c, i_c, _, _ = _query_cells(
            verts_norm, tris, ct, rt, sc, n, cell_chunk=cell_chunk
        )
        # classes cover disjoint cells -> disjoint voxels; plain where-merge
        take = t_c < best_t
        best_t = jnp.where(take, t_c, best_t)
        best_i = jnp.where(take, i_c, best_i)

    if with_overflow:
        t_ov, i_ov = _overflow_pass(verts_norm, tris, ov_ids, pos, dirs, n)
        closer = (t_ov < best_t) | ((t_ov == best_t) & (i_ov < best_i))
        best_t = jnp.where(closer, t_ov, best_t)
        best_i = jnp.where(closer, i_ov, best_i)
    return _finalize(
        verts_norm, normals, tris, pos, dirs, best_t, best_i, n, threshold
    )


def raystab_query(
    verts_norm: jnp.ndarray,
    normals: jnp.ndarray,
    tris: jnp.ndarray,
    accel: RaystabAccel,
    threshold: float = INSIDE_THRESHOLD,
    cell_chunk: int = 32,
    interpret: bool = False,
):
    """Per-frame trace against a built accel -> (occupancy, rgba).

    A gen-1 :class:`RaystabAccel` runs the gather-based XLA query; a
    :class:`RaystabAccel2` or gen-7 accel routes to its own query
    (``interpret`` runs their fold kernel in interpret mode).
    """
    if type(accel).__name__ == "RaystabAccel7":
        from dxrvoxelizer_tpu.ops.raystab_tiled import raystab_query7

        return raystab_query7(
            verts_norm, normals, tris, accel, threshold, interpret
        )
    if isinstance(accel, RaystabAccel2):
        return raystab_query2(
            verts_norm, normals, tris, accel, threshold, interpret
        )
    return _raystab_query_all(
        verts_norm, normals, tris, accel.classes, accel.ov_ids, accel.n,
        threshold, cell_chunk, accel.stats.overflow > 0,
    )


# ---- gen-2: mip-level cubemap + radial-form kernel -------------------------
#
# Two structural upgrades over the gen-1 accel above, driven by measured
# padding (dragon 64^3, g=32: 17 M real ray-triangle pairs vs 211 M padded):
#
# 1. **Cubemap mip levels instead of a global overflow list.** Gen-1 sends
#    every triangle whose direction cone spans more than ``span`` cells per
#    face to a brute-force pass over ALL rays — 263 dragon triangles cost
#    69 M of the 211 M pairs. Here those triangles are re-binned into
#    coarser cubemaps (g = 32 -> 8); at g=8 with span=8 a face rectangle
#    always fits, so only cones whose bounding ball contains the origin
#    remain truly global (zero for typical closed meshes). This is the
#    TLAS analog with interior levels (reference: Voxelizer.cpp:264-326
#    delegates the same long-tail problem to the driver's BVH).
# 2. **Radial-form intersection + finer capacity classes.** The per-pair
#    test is intersect.radial_hit (see radial_setup for the math) and class
#    boundaries are every power of two, with cells split into 128-ray
#    strips so any (grid, cubemap) combination gets the streaming kernel.

CLASS_CAPS2 = (
    # ~1.5x steps: vs pure powers of two this cuts the mean candidate-
    # padding ratio from ~1.4x to ~1.2x of each cell's true bin size.
    # Constraint (raystab_pallas.stab_fold_extract): k > 256 must be a
    # multiple of K_BLOCK=256 (the distance-bound chunks).
    16, 24, 32, 48, 64, 96, 128, 192, 256, 512, 768, 1024, 1536,
    2048, 3072, 4096, 6144, 8192,
)
LEVELS2 = (32, 8)  # cubemap sizes, fine -> coarse


def default_gs(n: int) -> tuple:
    """Default cubemap ladder by grid size (see build_raystab_compact2):
    hi-res grids get finer top levels so rays-per-cell stays near one
    128-lane strip."""
    if n >= 256:
        return (128, 32, 8)
    if n >= 128:
        return (64, 16, 8)
    return LEVELS2


@dataclass
class Raystab2Stats:
    levels: tuple  # per level: (g, live_cells, capacity, max_bin, virtual_cells)
    near_origin: int  # triangles tested against every ray


@dataclass
class RaystabAccel2:
    """Gen-2/4 acceleration structure (mip-level direction-space cubemaps).

    ``levels``: per cubemap level, a tuple of capacity classes — 5-tuples
    (rays [VC,8,128] with rows dx dy dz s0, coefs [VC,K,12] with rows
    g0 g1 g2 c id, scatter [VC,128] int32 into a V+1 buffer, bounds
    [VC/8, K/256] f32 chunk distance lower bounds or None, ntab [VC,K,12]
    with rows n0 n1 n2 pad). ``ov_dense``: (rays [V/128,8,128],
    coefs [O,12], ntab [O,12]) for near-origin triangles, or None.

    ``sort_keys``: per level, the int32 ray id of every kernel output slot
    (concatenated class streams + a filler for rays the level doesn't
    cover; padding slots get V). The query applies the slot->ray
    permutation by SORTING (key, t, id, channels) and slicing the first V
    rows. The query needs nothing else: the fused fold finalizes the rgba
    channels in slot space (fold_extract_dispatch).
    """

    n: int
    levels: tuple
    ov_dense: tuple | None
    stats: Raystab2Stats
    sort_keys: tuple = ()


def _pow2cap(max_bin: int) -> int:
    cap = 8
    while cap < max_bin:
        cap *= 2
    return cap


def _host_cpu():
    """The local CPU device, or None when the platform exposes none.

    The accel build runs its BINNING math there: binning only decides
    conservative candidate SETS
    (guard bands of 1e-4 rad dwarf any cross-backend fp difference). The
    kernel-facing coefficient VALUES are still computed on the default
    backend so they match the oracle bit-for-bit.
    """
    try:
        return jax.local_devices(backend="cpu")[0]
    except Exception:
        return None


@partial(jax.jit, static_argnames=("n",))
def _ray_params(n: int):
    """Per-voxel (dirs [V,3], s0 [V]) with the oracle's exact expressions
    (voxelize_raystab_radial_ref) so t = c/den - s0 matches bit-for-bit."""
    pos, dirs = voxel_rays(n)
    return dirs, jnp.linalg.norm(pos, axis=-1)


@partial(jax.jit, static_argnames=("lane_aligned",))
def _assemble_class_dev(fused_pad, dirs, s0, rt128, tab,
                        lane_aligned: bool):
    """Device-side class table assembly: ray blocks [VC, 8, 128] (rows
    dx dy dz s0 + 4 pad; padding slots give d = 0, s0 = 0 -> den == 0 ->
    guaranteed miss), coefficient/normal tables gathered from the full
    per-triangle matrices, and the slot scatter stream.

    This replaces host-numpy gathers + layout transposes + dense ray
    assembly (single-core fancy indexing) with XLA row gathers on the
    accelerator, and cuts the host-to-device upload ~12x: candidate IDS
    (4 B each) move instead of 48 B coefficient+normal rows. Gathers are
    pure row movement, so every
    table is bit-identical to the host-assembled original (pinned by the
    oracle bit-exactness tests).

    ``fused_pad`` [T+1, 24]: coefficient rows | normal rows, fused so each
    candidate costs ONE gather row (the candidate row count is the
    assembly's dominant cost); the split back into the two kernel operands
    is pure slicing. ``tab`` == -1 selects the padding row: all-zero with id 2^30
    (den == 0 -> miss, loses ties), normal half all-zero.
    """
    v = s0.shape[0]
    vc = rt128.shape[0]
    ridx = jnp.where(rt128 >= 0, rt128, v)
    dirs_p = jnp.concatenate([dirs, jnp.zeros((1, 3), dirs.dtype)], axis=0)
    s0_p = jnp.concatenate([s0, jnp.zeros((1,), s0.dtype)], axis=0)
    rays = jnp.concatenate([
        dirs_p[ridx].transpose(0, 2, 1),
        s0_p[ridx][:, None, :],
        jnp.zeros((vc, 4, 128), jnp.float32),
    ], axis=1)
    tpad = fused_pad.shape[0] - 1
    ti = jnp.where(tab >= 0, tab, tpad)
    g = fused_pad[ti]  # [VC, K, 24]
    if lane_aligned:
        g = g.transpose(0, 2, 1)
        coefs, ntab = g[:, :12], g[:, 12:]
    else:
        coefs, ntab = g[..., :12], g[..., 12:]
    sc128 = jnp.where(rt128 >= 0, rt128, v).astype(jnp.int32)
    return rays, coefs, ntab, sc128


@partial(jax.jit, static_argnames=("lane_aligned",))
def _assemble_ov_dev(fused_pad, dirs, s0, ids,
                     lane_aligned: bool):
    """Device-side overflow-stream assembly: every ray in natural order
    (the ov stream needs no scatter), candidates = the near-origin ids.
    Same bit contract as :func:`_assemble_class_dev` (fused 24-wide
    gather, split by slicing)."""
    v = s0.shape[0]
    strips = v // 128
    rays = jnp.concatenate([
        dirs.reshape(strips, 128, 3).transpose(0, 2, 1),
        s0.reshape(strips, 1, 128),
        jnp.zeros((strips, 4, 128), jnp.float32),
    ], axis=1)
    tpad = fused_pad.shape[0] - 1
    ti = jnp.where(ids >= 0, ids, tpad)
    g = fused_pad[ti]  # [K, 24]
    if lane_aligned:
        g = g.T
        cf, nf = g[:12], g[12:]
    else:
        cf, nf = g[:, :12], g[:, 12:]
    return rays, cf, nf


@jax.jit
def _radial_coef_matrix(verts_norm, tris_subset, global_ids):
    """Radial coefficient rows [Ts+1, 12]: g0 g1 g2 c id pad; the appended
    padding row is all-zero with id BIG (den == 0 -> miss, loses ties)."""
    # ids ride the kernels as f32 coefficient rows; >= 2^24 would silently
    # lose precision and corrupt winner ids/normals (e.g. deep -subdiv)
    assert int(tris_subset.shape[0]) < 2**24, (
        f"{int(tris_subset.shape[0])} triangles exceed the 2^24 id range "
        "of the f32 id channel"
    )
    g0, g1, g2, c = intersect.radial_setup(verts_norm, tris_subset)
    idf = global_ids.astype(jnp.float32)[:, None]
    cf = jnp.concatenate(
        [g0, g1, g2, c[:, None], idf, jnp.zeros_like(idf)], axis=-1
    )  # [Ts, 12]
    pad_row = jnp.zeros((1, 12), cf.dtype).at[0, 10].set(2.0**30)
    return jnp.concatenate([cf, pad_row]).astype(jnp.float32)


@jax.jit
def _normal_rows_matrix(normals, tris):
    """Per-triangle normal rows [T+1, 12]: n0(3) n1(3) n2(3) pad(3), last
    row all-zero — raw vertex-normal row gathers, bit-identical to the
    oracle's ``normals[tris[:, k]]``."""
    t_count = tris.shape[0]
    rows = jnp.concatenate(
        [
            normals[tris[:, 0]].astype(jnp.float32),
            normals[tris[:, 1]].astype(jnp.float32),
            normals[tris[:, 2]].astype(jnp.float32),
            jnp.zeros((t_count, 3), jnp.float32),
        ],
        axis=-1,
    )
    return jnp.concatenate([rows, jnp.zeros((1, 12), jnp.float32)])


@jax.jit
def _fused_coef_matrix(verts_norm, tris, normals):
    """[T+1, 24] = radial coefficient rows | normal rows (one fused matrix
    so per-candidate table assembly costs ONE gather row; split back by
    slicing, pure row movement — see _assemble_class_dev)."""
    t_count = tris.shape[0]
    coef = _radial_coef_matrix(
        verts_norm, tris, jnp.arange(t_count, dtype=jnp.int32)
    )
    return jnp.concatenate([coef, _normal_rows_matrix(normals, tris)],
                           axis=-1)


@partial(jax.jit, static_argnames=("v", "filler_len"))
def _sort_keys_dev(scs: tuple, v: int, filler_len: int):
    """Device-side slot->ray sort-key stream: the classes' scatter streams
    concatenated, plus the ascending list of rays no strip covers (strips
    partition the rays, so ``filler_len`` is static). Values identical to
    the retired host builder (scatter + nonzero, ascending filler)."""
    sc_all = jnp.concatenate([s.reshape(-1) for s in scs])
    covered = jnp.zeros((v + 1,), bool).at[sc_all].set(True)
    filler = jnp.nonzero(~covered[:v], size=filler_len)[0].astype(jnp.int32)
    return jnp.concatenate([sc_all, filler])


# LANE_MIN_K (the lane-aligned layout threshold) lives in
# ops/raystab_pallas.py beside the kernels and the cells-per-step policy
# that both depend on it; re-exported here for the build/query callers.


def table_k(coefs) -> int:
    """Candidate count K of a class table, either layout: gen-4
    [..., K, 12] or gen-5 lane-aligned [..., 12, K] (K is never 12 —
    class caps start at 16 and overflow capacities are multiples of 8)."""
    s = coefs.shape
    if s[-2] == 12 and s[-1] != 12:
        return int(s[-1])
    return int(s[-2])


def fold_extract_dispatch(rays, coefs, ntab, k, t_count, threshold,
                          rule="backface", shared=False, interpret=False,
                          bounds=None):
    """Run one class's closest-hit fold + extraction with the platform's
    implementation (ops/route.py), or the kernel in interpret mode when
    asked. Every implementation reads both table layouts."""
    if interpret:
        from dxrvoxelizer_tpu.ops.raystab_pallas import stab_fold_extract

        fn = partial(stab_fold_extract, interpret=True)
    else:
        fn = route.raystab_query()
    return fn(rays, coefs, ntab, k, t_count, threshold, rule=rule,
              shared=shared, bounds=bounds)


@partial(jax.jit, static_argnames=("k", "t_count", "threshold", "rule",
                                   "shared", "strip_batch"))
def fold_extract_xla(rays, coefs, ntab, k: int, t_count: int,
                     threshold: float, rule: str = "backface",
                     shared: bool = False, bounds=None,
                     strip_batch: int = 64):
    """Plain-jnp closest-hit fold + extraction, the contract of
    ops/raystab_pallas.stab_fold_extract (bit-identical outputs): every
    (ray, candidate) pair through ``intersect.radial_hit``, the (t, id)
    lexicographic minimum by two reductions, the winner's rows by index.
    ``bounds`` (a skip hint) is not needed for the result and ignored.
    Strips run in batches of ``strip_batch`` to bound the [strips, K, 128]
    intermediates."""
    from dxrvoxelizer_tpu.ops.raystab_pallas import (
        BIG_ID, C_ROW, ID_ROW2, NCF2, finish_channels,
    )

    del bounds
    lane_aligned = coefs.shape[-2] == NCF2 and coefs.shape[-1] != NCF2
    if lane_aligned:  # -> classic [..., K, 12]
        coefs = jnp.swapaxes(coefs, -1, -2)
        ntab = jnp.swapaxes(ntab, -1, -2)

    def strip_block(args):
        ray, cf, nt = args  # [B, 8, 128], [B or 1, K, 12] x2
        dx, dy, dz, s0 = (ray[:, j, None, :] for j in range(4))  # [B,1,128]

        def col(j):
            return cf[:, :, j, None]  # [B or 1, K, 1]

        tt, hit = intersect.radial_hit(
            dx, dy, dz, s0, col(0), col(1), col(2), col(3), col(4), col(5),
            col(6), col(7), col(8), col(C_ROW),
        )  # [B, K, 128]
        ii = jnp.where(hit, col(ID_ROW2), float(BIG_ID))
        pad = (dx == 0.0) & (dy == 0.0) & (dz == 0.0)  # [B, 1, 128]
        bt = jnp.min(tt, axis=1)
        bt = jnp.where(pad[:, 0], -jnp.inf, bt)
        bi = jnp.min(jnp.where(tt == bt[:, None], ii, float(BIG_ID)), axis=1)
        pos = jnp.argmax((tt == bt[:, None]) & (ii == bi[:, None]), axis=1)
        take = jnp.broadcast_to(
            pos[:, None, :], (pos.shape[0], 9, pos.shape[1])
        )
        cfb = jnp.broadcast_to(cf, (ray.shape[0],) + cf.shape[1:])
        ntb = jnp.broadcast_to(nt, (ray.shape[0],) + nt.shape[1:])
        gr = jnp.take_along_axis(jnp.swapaxes(cfb[:, :, :9], 1, 2), take, 2)
        nr = jnp.take_along_axis(jnp.swapaxes(ntb[:, :, :9], 1, 2), take, 2)
        chans = finish_channels(
            dx[:, 0], dy[:, 0], dz[:, 0],
            [gr[:, j] for j in range(9)], [nr[:, j] for j in range(9)],
            bt, bi, t_count, threshold, rule,
        )
        return bt, bi, jnp.stack(chans, axis=1)

    c = rays.shape[0]
    b = min(strip_batch, c)
    pad_c = (-c) % b
    rays_p = jnp.pad(rays, ((0, pad_c), (0, 0), (0, 0)))
    nb = (c + pad_c) // b
    if shared:
        def run(ray):
            return strip_block((ray, coefs[None], ntab[None]))

        bt, bi, ns = jax.lax.map(run, rays_p.reshape(nb, b, 8, 128))
    else:
        cf_p = jnp.pad(coefs, ((0, pad_c), (0, 0), (0, 0)))
        nt_p = jnp.pad(ntab, ((0, pad_c), (0, 0), (0, 0)))
        bt, bi, ns = jax.lax.map(strip_block, (
            rays_p.reshape(nb, b, 8, 128),
            cf_p.reshape((nb, b) + cf_p.shape[1:]),
            nt_p.reshape((nb, b) + nt_p.shape[1:]),
        ))
    return (bt.reshape(-1, 128)[:c], bi.reshape(-1, 128)[:c].astype(jnp.int32),
            ns.reshape(-1, 4, 128)[:c])


def _csr_gather(data, offs, sel):
    """Concatenate CSR runs ``sel`` of (data, offs) — vectorized equivalent
    of ``np.concatenate([data[offs[i]:offs[i+1]] for i in sel])``."""
    lens = offs[sel + 1] - offs[sel]
    total = int(lens.sum())
    if total == 0:
        return data[:0]
    heads = np.repeat(offs[sel], lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    return data[heads + within]


def _fold_levels_csr(level_runs, g_fine: int):
    """Fold every ladder level's cell bins into the FINEST level's cells
    as one CSR (offs [C+1] i64, data i64 global ids).

    Each fine cell has exactly one ancestor cell per level, so its merged
    list is the concatenation of (at most) one run per level, in ladder
    order (fine -> coarse), each run in its level's bin order — identical
    to the per-cell append loop this replaces, fully vectorized.
    """
    nc_fine = 6 * g_fine * g_fine
    fine = np.arange(nc_fine, dtype=np.int64)
    f, rem = np.divmod(fine, g_fine * g_fine)
    iu, iv = np.divmod(rem, g_fine)
    per_level = []
    lens = np.zeros((nc_fine,), np.int64)
    for glob_ids, starts, counts, g in level_runs:
        factor = g_fine // g
        parent = f * (g * g) + (iu // factor) * g + (iv // factor)
        m = counts[parent]
        per_level.append((glob_ids, starts[parent].astype(np.int64), m))
        lens += m
    offs = np.zeros((nc_fine + 1,), np.int64)
    np.cumsum(lens, out=offs[1:])
    data = np.empty((int(offs[-1]),), np.int64)
    prefix = offs[:-1].copy()
    for glob_ids, pstart, m in per_level:
        total = int(m.sum())
        if total == 0:
            continue
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(m) - m, m
        )
        data[np.repeat(prefix, m) + within] = (
            glob_ids[np.repeat(pstart, m) + within]
        )
        prefix += m
    return offs, data


def _make_packs_py(cell_csr, ray_table, rc, s0_p, tri_bounds):
    """Greedy strip packing (see _pack_classes2 docstring) — pure-Python
    reference implementation. Returns CSR quadruple
    (ray_data i32, ray_offs i64, id_data i64, id_offs i64): pack p owns
    rays ray_data[ray_offs[p]:ray_offs[p+1]] (<= 128 of them) and the
    bound-sorted unique candidate ids id_data[id_offs[p]:id_offs[p+1]]."""
    cell_offs, cell_data = cell_csr
    packs: list = []  # (rays [<=128] int32, union candidate ids)
    cur_rays: list = []
    cur_ids: list = []
    cur_n = 0

    # packed dedupe+order key per id: the bound's high 40 IEEE bits with
    # the id in the low 24 (ids < 2^24, asserted at build entry; bounds
    # are non-negative doubles, so bit patterns order like values). One
    # sort+unique of the packed keys = unique ids ascending by
    # (40-bit-truncated bound, id) — the native packer computes the same.
    max_id = int(cell_data.max()) if cell_data.size else 0
    if tri_bounds is not None:
        hi = np.asarray(tri_bounds[: max_id + 1], np.float64).view(np.uint64)
        key_tab = (hi & np.uint64(~np.uint64(0xFFFFFF))) | np.arange(
            max_id + 1, dtype=np.uint64
        )
    else:
        key_tab = np.arange(max_id + 1, dtype=np.uint64)

    def uniq_ids(ids):
        keys = np.unique(key_tab[ids])
        return (keys & np.uint64(0xFFFFFF)).astype(np.int64)

    def close():
        nonlocal cur_rays, cur_ids, cur_n
        if cur_rays:
            ids = uniq_ids(np.concatenate(cur_ids))
            packs.append((np.concatenate(cur_rays), ids))
        cur_rays, cur_ids, cur_n = [], [], 0

    for cell in range(cell_offs.shape[0] - 1):
        ids_c = cell_data[cell_offs[cell] : cell_offs[cell + 1]]
        nray = int(rc[cell])
        if ids_c.shape[0] == 0 or nray == 0:
            continue  # no candidates / no voxel direction in this cell
        if nray > 128:
            close()
            ids_sorted = uniq_ids(ids_c)
            # split strips in origin-radius order: the chunk skip bound is
            # chunk_R_min - max(s0 over the strip's lanes), so radius-band
            # strips keep the bound tight for near-origin strips instead
            # of every strip inheriting the cell's farthest voxel. The ray
            # table stores each cell pre-sorted by (radius, id)
            # (_ray_table_filled), so the slice IS the radius band.
            full = ray_table[cell, :nray]
            for s in range(0, nray, 128):
                seg = full[s : s + 128]
                if seg.shape[0] == 128:
                    packs.append((seg, ids_sorted))
                else:  # tail strip joins the packing pool
                    cur_rays.append(seg)
                    cur_ids.append(ids_c)
                    cur_n = seg.shape[0]
            continue
        if cur_n + nray > 128:
            close()
        cur_rays.append(ray_table[cell, :nray])
        cur_ids.append(ids_c)
        cur_n += nray
    close()

    ray_offs = np.zeros((len(packs) + 1,), np.int64)
    id_offs = np.zeros((len(packs) + 1,), np.int64)
    if packs:
        ray_offs[1:] = np.cumsum([p[0].shape[0] for p in packs])
        id_offs[1:] = np.cumsum([p[1].shape[0] for p in packs])
        ray_data = np.concatenate([p[0] for p in packs]).astype(np.int32)
        id_data = np.concatenate([p[1] for p in packs]).astype(np.int64)
    else:
        ray_data = np.zeros((0,), np.int32)
        id_data = np.zeros((0,), np.int64)
    return ray_data, ray_offs, id_data, id_offs


def _make_packs(cell_csr, ray_table, rc, s0_p, tri_bounds):
    """Strip packing, via the native C++ packer when available (the
    AS-builder hot loop: the greedy pack walk is irregular sequential
    work, exactly what the native runtime tier is for) with the
    pure-Python implementation as the behavioral reference and fallback.
    Both return identical CSR quadruples (pinned by tests)."""
    from dxrvoxelizer_tpu.utils import native

    out = native.accel_pack_native(
        cell_csr[0], cell_csr[1], ray_table, rc, s0_p, tri_bounds
    )
    if out is not None:
        return out
    return _make_packs_py(cell_csr, ray_table, rc, s0_p, tri_bounds)


def _pack_classes2(cell_ids, ray_table, rc, s0_p, tri_bounds):
    """Partition one level's rays into capacity classes of packed strips
    -> the COMPACT per-class product (rt128 [VC,128] i32 ray ids / -1,
    tab [VC,K] i32 candidate ids / -1, bounds [VC,K/256] f32 or None).
    Host-only; the expensive coefficient/normal/ray tables are gathered
    from these on device later (:func:`_assemble_classes`), and the
    compact product is what the on-disk accel cache stores
    (utils/accel_cache.py, format 4).

    ``cell_ids``: CSR (offs [C+1], data) of per-cell candidate GLOBAL
    triangle ids, from :func:`_fold_levels_csr` — coarser cubemap levels
    folded into the finest level's cells (same pair count, one sort-merge
    stream instead of one per level). ``s0_p`` is the padded HOST copy of
    per-voxel origin radii for the radius-ordered packing walk. ``rc``
    [C] i64: per-cell ray counts (cached beside the ray table — counting
    ``ray_table >= 0`` here scanned the whole mmapped table up front).

    ``tri_bounds`` (per global id, f64): strict lower bound on any hit
    distance R of the triangle from the grid origin (bounding-ball
    ``|c|-r`` with a conservative margin). Candidates are sorted by it so
    multi-chunk classes carry per-(strip, chunk) bounds the kernel can
    branch over once every lane's winner beats them (near-to-far
    traversal, ops/raystab_pallas._stab_kernel2 ``skip``).

    A strip is 128 ray lanes; SMALL cells are PACKED several-to-a-strip
    (face-raster order keeps packed cells direction-adjacent) and the
    strip's candidate list is the union of its cells' lists. The union is
    safe: the cone binning is a conservative prefilter — a candidate whose
    cone excludes a ray's direction fails the exact intersection test
    anyway. Packing removes the ~3x lane padding of solo small cells
    (64^3 @ g=32: 43 rays/cell), which inflated both the kernel pair count
    and the sort-merge row count ~2.3x. Cells larger than a strip span
    multiple strips, replicating their candidate row (hi-res grids scale
    the cubemap instead, see build_raystab_accel2).
    """
    mark = _stage_timer()

    def caps_fn(max_k):
        caps = [k for k in CLASS_CAPS2 if k < max_k]
        caps.append(max(_pow2cap(max_k), 8))
        return caps

    def chunk_bounds(rt128, tab, k):
        if tri_bounds is None or k <= 256:
            return None
        # chunk lower bound on t = (min candidate R in chunk) - (max
        # ray origin radius in strip). Candidates ascend by the 40-bit-
        # TRUNCATED bound key (the native packer's packed u64 sort), so
        # within a truncation tie the chunk head can sit ~2^-28 relative
        # ABOVE the true chunk minimum; the skip stays conservative only
        # because tri_bounds carries the 1e-3 relative / 1e-6 absolute
        # slack applied at build — neither margin may be tightened
        # without revisiting the other (ADVICE r4). Gather only the
        # chunk-head columns, not the full [rows, k] bound table.
        tab_sub = tab[:, ::256]  # [rows, k//256] chunk heads
        chunk_lo = np.where(
            tab_sub >= 0, tri_bounds[np.maximum(tab_sub, 0)], np.inf
        )
        idx = np.where(rt128 >= 0, rt128, 0)
        s0m = np.where(rt128 >= 0, s0_p[idx], 0.0).max(axis=1)
        return np.maximum(chunk_lo - s0m[:, None], 0.0).astype(np.float32)

    from dxrvoxelizer_tpu.ops.raystab_pallas import cells_per_step_for
    from dxrvoxelizer_tpu.utils import native

    nat = native.accel_pack_tables_native(
        cell_ids[0], cell_ids[1], ray_table, rc, s0_p, tri_bounds,
        caps_fn, cells_per_step_for,
    )
    if nat is not None:
        mark("  pack walk + class tables (native)")
        compact = [
            (rt128, tab, chunk_bounds(rt128, tab, int(tab.shape[1])))
            for rt128, tab, _vc in nat
        ]
        total_vc = sum(vc for _r, _t, vc in nat)
        mark("  chunk bounds")
        return compact, total_vc

    ray_data, ray_offs, id_data, id_offs = _make_packs(
        cell_ids, ray_table, rc, s0_p, tri_bounds
    )  # cell_ids: CSR (offs, data) from _fold_levels_csr
    mark("  pack walk")

    compact = []
    total_vc = 0
    sizes = id_offs[1:] - id_offs[:-1]
    max_k = int(sizes.max()) if sizes.size else 0
    caps = caps_fn(max_k)
    lo = 0
    for k in caps:
        sel = np.nonzero((sizes > lo) & (sizes <= k))[0]
        lo = k
        if sel.size == 0:
            continue
        sel = sel[np.argsort(-sizes[sel], kind="stable")]
        # vectorized row assembly: row-major boolean-mask fill == a
        # per-pack loop (same order, same padding)
        vc = sel.size
        # pad rows to the kernel's strips-per-grid-step for this K
        # (small-K classes batch up to 64 strips per step — see
        # raystab_pallas.cells_per_step_for; vc bounds the padding)
        vc_pad = vc + (-vc) % cells_per_step_for(k, vc=vc)
        ray_lens = ray_offs[sel + 1] - ray_offs[sel]
        rt128 = np.full((vc_pad, 128), -1, np.int32)
        rt128[:vc][np.arange(128)[None, :] < ray_lens[:, None]] = (
            _csr_gather(ray_data, ray_offs, sel)
        )
        # candidate ids as int32 (< 2^24 asserted at build entry)
        tab = np.full((vc_pad, k), -1, np.int32)
        tab[:vc][np.arange(k)[None, :] < sizes[sel][:, None]] = (
            _csr_gather(id_data, id_offs, sel)
        )
        compact.append((rt128, tab, chunk_bounds(rt128, tab, k)))
        total_vc += vc
    mark("  class tables")
    return compact, total_vc


def _assemble_classes(compact_classes, fused_dev, dirs_dev, s0_dev):
    """Device-side assembly of a level's classes from the compact product
    -> 5-tuples (rays, coefs, scatter, bounds-or-None, ntab) per class.

    ``fused_dev`` [T+1, 24]: the radial coefficient matrix fused with the
    per-triangle normal rows (one gather row per candidate instead of
    two — see _assemble_class_dev); lives on the default backend, as do
    ``dirs_dev``/``s0_dev`` — only the compact id tables leave the host.
    Each class shape costs one compile of a trivial gather graph — the
    same per-shape compile set the query pays, and the persistent compile
    cache (utils/backend.enable_compile_cache) makes repeats free.

    Classes with K >= LANE_MIN_K get the lane-aligned layout [VC, 12, K]
    (candidate-contiguous rows); smaller classes keep the classic
    [VC, K, 12] layout. Every fold reads both (see LANE_MIN_K).
    """
    classes = []
    for rt128, tab, bounds_np in compact_classes:
        k = int(tab.shape[1])
        bounds_dev = jnp.asarray(bounds_np) if bounds_np is not None else None
        rays_d, coefs_d, ntab_d, sc_d = _assemble_class_dev(
            fused_dev, dirs_dev, s0_dev,
            jnp.asarray(rt128), jnp.asarray(tab),
            lane_aligned=bool(k >= LANE_MIN_K),
        )
        classes.append((rays_d, coefs_d, sc_d, bounds_dev, ntab_d))
    return classes


@dataclass
class RaystabCompact2:
    """The COMPACT half of a gen-2..7 accel: everything the binning +
    packing stages decide, none of the expanded device tables.

    ``classes``: per capacity class, (rt128 [VC,128] i32 ray ids / -1,
    tab [VC,K] i32 candidate triangle ids / -1, bounds [VC,K/256] f32
    chunk-skip lower bounds or None). ``ov_ids``: padded near-origin id
    list [O] i32 / -1, or None. The expanded accel is a pure device-gather
    function of (compact, geometry) — :func:`assemble_raystab_accel2` —
    so this is what the on-disk cache stores (utils/accel_cache.py):
    ~12x smaller than the expanded tables (ids are 4 B where
    coefficient+normal rows are 96 B) and backend-independent.
    """

    n: int
    classes: tuple
    ov_ids: np.ndarray | None
    stats: Raystab2Stats


def build_raystab_compact2(
    verts_norm: jnp.ndarray,
    tris: jnp.ndarray,
    n: int = 64,
    gs: tuple | None = None,
    span: int = 8,
    pad: float = 0.0,
    pad_dirs=None,
) -> RaystabCompact2:
    """Binning + packing half of the gen-2 accel build: bin each triangle
    at the finest cubemap level whose ``span``-cell rectangle covers its
    direction cone; only cones containing the origin fall through to the
    global list. Host-side product only — pair with
    :func:`assemble_raystab_accel2`.

    ``gs`` (cubemap sizes, fine -> coarse) defaults by grid size: hi-res
    grids get finer top levels so rays-per-cell stays near one 128-lane
    strip — the per-strip candidate replication in _pack_classes2 would
    otherwise multiply accel memory by the strips-per-cell factor (a 32^2
    top level at 256^3 puts ~2.7k rays = 22 strips in every cell).

    ``pad`` > 0 builds a DEFORMATION-padded compact: bins and chunk-skip
    bounds stay conservative for any per-vertex displacement <= pad (see
    _cone_keys), so the same id tables serve every frame of a bounded
    deformation and only the coefficient/normal tables need a per-frame
    refit (ops/raystab_refit.py).

    ``pad_dirs`` ([V, 3], with pad > 0) declares the deformation
    DIRECTIONAL: every frame must satisfy v'_i = v_i + s_i * pad_dirs[i]
    with |s_i| <= pad (the app's -deform wobble moves along vertex
    normals). The padded volume is then a CAPSULE instead of a ball
    (_capsule_params) — where the motion axis aligns with the direction
    from the origin, the candidate cone barely grows: the 64^3 dragon's
    padded tables shrink several-fold vs the isotropic bound, and the
    refit query's kernel pair count with them."""
    gs = default_gs(n) if gs is None else gs
    t_count = int(tris.shape[0])
    assert t_count < 2**24, (
        f"{t_count} triangles exceed the 2^24 id range of the f32 id "
        "channel (reduce -subdiv or decimate the mesh)"
    )
    mark = _stage_timer()
    v = n * n * n
    sub_ids = np.arange(t_count, dtype=np.int32)
    tris_h = np.asarray(tris)
    verts_h = np.asarray(verts_norm, np.float32)
    stat_levels = []

    # s0 (per-voxel origin radius) orders the packing walk and feeds the
    # conservative chunk-skip bounds; computed with the oracle's exact
    # expressions and read back once
    _, s0_d = _ray_params(n)
    s0_h = jax.device_get(s0_d)
    s0_p = np.concatenate([s0_h, np.zeros((1,), np.float32)])
    mark("ray params")

    # Bin at each ladder level, then FOLD every level's cells into the
    # FINEST level's cell lists (a coarse cell's candidates go to all its
    # children). The covered-ray set per triangle is its own level's —
    # unchanged — so the kernel pair count is conserved, but the query gets
    # ONE sort-merge stream instead of one per level. Binning is pure numpy (_cone_keys_np) — host-side
    # and backend-independent by construction.
    g_fine = gs[0]
    level_runs = []  # per level: (global ids in bin order, starts, counts, g)
    for g in gs:
        if sub_ids.size == 0:
            break
        rects_h, over_h = _cone_keys_np(
            verts_h, tris_h[sub_ids], g, span, pad, pad_dirs
        )
        mark(f"cone keys g={g}")
        sorted_tris, starts, counts_h, ov_np = _cone_bins_host(
            rects_h, over_h, g, span
        )
        mark(f"cone bins g={g}")
        level_runs.append((
            sub_ids[sorted_tris].astype(np.int64), starts,
            counts_h.astype(np.int64), g,
        ))
        stat_levels.append((g, int((counts_h > 0).sum()), 0,
                            int(counts_h.max()) if counts_h.size else 0, 0))
        sub_ids = sub_ids[ov_np]
        del sorted_tris, starts, counts_h

    cell_offs, cell_data = _fold_levels_csr(level_runs, g_fine)
    mark("level fold")
    m_counts = cell_offs[1:] - cell_offs[:-1]
    compact_classes, total_vc = [], 0
    if m_counts.size and m_counts.max() > 0:
        # per-triangle strict lower bound on hit distance from the origin
        # (bounding ball |c| - r, f64, conservative margin for the f32
        # kernel's rounding) — drives near-to-far chunk skipping
        tv = np.asarray(verts_norm, np.float64)[tris_h]
        cc = tv.mean(axis=1)
        rr = np.sqrt(((tv - cc[:, None, :]) ** 2).sum(-1)).max(axis=1)
        if pad and pad_dirs is not None:
            # capsule bound: distance from origin to the padded segment
            # minus the capsule radius (conservative for directional
            # deformation; see _capsule_params)
            offs, r_extra = _capsule_params(
                verts_h, tris_h, pad, np.asarray(pad_dirs, np.float32)
            )
            cdist = _seg_origin_dist(
                (cc - offs).astype(np.float32),
                (cc + offs).astype(np.float32),
            ).astype(np.float64)
            rr = rr + r_extra.astype(np.float64)
            # f32 segment distance can round above exact: shave 2 ulp
            cdist = cdist * (1.0 - 3e-7)
        else:
            if pad:  # deformed hits stay inside the padded ball
                rr = rr + float(pad)
            cdist = np.linalg.norm(cc, axis=-1)
        tb = np.maximum(cdist - rr, 0.0)
        tri_bounds = np.maximum(tb * (1.0 - 1e-3) - 1e-6, 0.0)
        ray_table, rc = _ray_table_filled(n, g_fine)
        mark("ray tables")
        compact_classes, total_vc = _pack_classes2(
            (cell_offs, cell_data), ray_table, rc, s0_p, tri_bounds
        )
        mark("pack classes")
    # stats: one row per ladder level; the fine row carries the MERGED
    # numbers (live cells, class cap, max bin, strips) since the single
    # query stream runs at the fine level
    if stat_levels:
        stat_levels[0] = (g_fine, int((m_counts > 0).sum()),
                          _pow2cap(int(m_counts.max())),
                          int(m_counts.max()), total_vc)

    ov_ids = None
    if sub_ids.size > 0:
        # the fold chunks candidates by K_BLOCK=256: k > 256 must be a
        # multiple of 256 (CLASS_CAPS2 note)
        from dxrvoxelizer_tpu.ops.raystab_pallas import K_BLOCK

        size = int(sub_ids.size)
        if size > K_BLOCK:
            o_cap = -(-size // K_BLOCK) * K_BLOCK
        elif size > 96:
            o_cap = 128 if size <= 128 else K_BLOCK
        else:
            o_cap = max(-(-size // 8) * 8, 8)
        ov_ids = np.full((o_cap,), -1, np.int32)
        ov_ids[: sub_ids.size] = sub_ids
        assert (v // 128) % CELLS_PER_STEP == 0

    return RaystabCompact2(
        n=n,
        classes=tuple(compact_classes),
        ov_ids=ov_ids,
        stats=Raystab2Stats(
            levels=tuple(stat_levels), near_origin=int(sub_ids.size)
        ),
    )


def assemble_raystab_accel2(
    compact: RaystabCompact2,
    verts_norm: jnp.ndarray,
    tris: jnp.ndarray,
    normals: jnp.ndarray,
) -> RaystabAccel2:
    """Device half of the accel build: expand a compact product (fresh or
    cache-loaded) into kernel tables by XLA row gathers on the accelerator.

    ``verts_norm``/``tris``/``normals`` must be the geometry the compact
    was built from. The coefficient/normal values are computed here on the
    default backend, so they match the same-backend oracle bit-for-bit
    regardless of where (or when) the binning ran."""
    mark = _stage_timer()
    n = compact.n
    v = n * n * n
    t_count = int(tris.shape[0])
    # the fused per-triangle matrix once (device) — it STAYS there:
    # per-class tables are gathered from it on the accelerator
    # (_assemble_class_dev); only compact int32 id tables ride the wire.
    # Rows: radial coefficients (12: g0 g1 g2 c id pad) | normal rows
    # (12: n0 n1 n2 pad) — fused so each candidate costs ONE gather row;
    # normal rows are raw vertex-normal gathers, bit-identical to the
    # oracle's normals[tris[:, k]]; the padding row is the coef matrix's
    # inert always-miss row with an all-zero normal half.
    fused_d = _fused_coef_matrix(verts_norm, tris, normals)
    dirs_d, s0_d = _ray_params(n)
    mark("asm: fused coef+normal matrix + ray params")

    cls = _assemble_classes(compact.classes, fused_d, dirs_d, s0_d)
    levels = (tuple(cls),)
    mark("asm: class gathers (dispatch)")

    ov_dense = None
    if compact.ov_ids is not None:
        # device assembly; id -1 -> padding rows (coef: zeros + id 2^30,
        # the inert always-miss row; normals: zeros). [12, O] lane-aligned
        # when the capacity clears LANE_MIN_K, like the class tables.
        o_cap = int(compact.ov_ids.shape[0])
        ov_dense = _assemble_ov_dev(
            fused_d, dirs_d, s0_d, jnp.asarray(compact.ov_ids),
            lane_aligned=bool(o_cap >= LANE_MIN_K),
        )

    # slot -> ray sort keys per level: the class ray tables already hold
    # the ray id per slot (V for padding); append a filler so every ray
    # appears exactly once, making row r of the sorted stream ray r.
    # Built ON DEVICE from the classes' already-assembled scatter streams
    # (position 2 of each 5-tuple = where(rt128 >= 0, rt128, v)) instead of
    # uploading a host-scattered [V] mask. Strips PARTITION the rays, so the
    # filler length is exactly v - (real slots) — a static shape known
    # from the compact tables.
    sort_keys = []
    for level_cls, level_compact in zip(levels, (compact.classes,)):
        if not level_compact:
            sort_keys.append(None)
            continue
        total_rays = int(sum(
            (rt128 >= 0).sum() for rt128, _, _ in level_compact
        ))
        sort_keys.append(_sort_keys_dev(
            tuple(c[2] for c in level_cls), v, v - total_rays
        ))
    mark("asm: sort keys")

    return RaystabAccel2(
        n=n,
        levels=levels,
        ov_dense=ov_dense,
        stats=compact.stats,
        sort_keys=tuple(sort_keys),
    )


def build_raystab_accel2(
    verts_norm: jnp.ndarray,
    tris: jnp.ndarray,
    normals: jnp.ndarray,
    n: int = 64,
    gs: tuple | None = None,
    span: int = 8,
    pad: float = 0.0,
    pad_dirs=None,
) -> RaystabAccel2:
    """Build the gen-2 accel (compact binning/packing + device assembly).
    ``normals`` are baked into the per-class normal tables — like the
    reference's AS, the accel is built once per geometry
    (Voxelizer.cpp:264-326); deforming meshes refit it per frame
    (ops/raystab_refit.py, pass the deformation bound as ``pad``) or
    rebuild it. Callers that want the on-disk cache use
    utils/accel_cache.cached_build_raystab_accel2 (it persists the
    compact half and re-runs only the assembly)."""
    compact = build_raystab_compact2(
        verts_norm, tris, n, gs, span, pad, pad_dirs
    )
    return assemble_raystab_accel2(compact, verts_norm, tris, normals)


def _merge_winners2(levels, sort_keys, ov_dense, n: int, ks: tuple,
                    ov_k: int, t_count: int, threshold: float, rule: str,
                    interpret: bool, run_class=None):
    """Stream kernels + in-slot finalize + sort-merge -> per-ray
    (best_t, best_i, nx, ny, nz, a) with (nx, ny, nz, a) FINISHED rgba
    channels (normalized winner normal masked by the inside rule).

    The slot->ray permutation rides the sort engine: lax.sort of
    (ray key, t, id, nx, ny, nz, a) then slicing the first V rows puts
    every ray in natural order (keys are unique reals + V-sentinel
    padding). The channels come finished from the fused fold+extraction
    (fold_extract_dispatch — one read of the candidate tables), so after
    the sort the query is pure selects."""
    if run_class is None:
        # single-device: direct dispatch. parallel/raystab_shard.py passes
        # a shard_map-wrapped
        # runner instead (same kernels, strip axis sharded over the mesh).
        def run_class(rays, coefs, ntab, k, bounds, shared):
            return fold_extract_dispatch(
                rays, coefs, ntab, k, t_count, threshold, rule=rule,
                shared=shared, interpret=interpret, bounds=bounds,
            )

    v = n * n * n
    big = jnp.int32(2**30)

    if ov_dense is None and sum(1 for lv in levels if lv) == 1:
        # Overflow-free single-level accel (every static default build):
        # strips PARTITION the rays, so each ray's winner is its one
        # slot's in-kernel winner and the sort is a pure permutation —
        # the t/id channels exist only to merge overflow/extra levels.
        # Sorting 5 channels instead of 7 shrinks the merge, which is the
        # bulk of a hi-res query.
        for level, level_ks, keys in zip(levels, ks, sort_keys):
            if not level:
                continue
            nparts = [[], [], [], []]
            rows = 0
            for (rays, coefs, scatter, bounds, ntab), k in zip(
                level, level_ks
            ):
                _t_c, _i_c, ns = run_class(rays, coefs, ntab, k, bounds,
                                           False)
                rows += ns.shape[0] * ns.shape[2]
                for j in range(4):
                    nparts[j].append(ns[:, j, :].reshape(-1))
            filler = keys.shape[0] - rows
            fz = jnp.zeros((filler,), jnp.float32)
            for j in range(4):
                nparts[j].append(fz)
            sorted_arrs = jax.lax.sort(
                (keys,) + tuple(jnp.concatenate(p) for p in nparts),
                dimension=0, is_stable=False, num_keys=1,
            )
            best = [sorted_arrs[1 + j][:v] for j in range(4)]
            return (None, None) + tuple(best)

    best_t = jnp.full((v,), jnp.inf, jnp.float32)
    best_i = jnp.full((v,), big, jnp.int32)
    zero = jnp.zeros((v,), jnp.float32)
    best_ns = [zero, zero, zero, zero]  # nx, ny, nz, a

    for level, level_ks, keys in zip(levels, ks, sort_keys):
        if not level:
            continue
        tparts, iparts = [], []
        nparts = [[], [], [], []]
        for (rays, coefs, scatter, bounds, ntab), k in zip(level, level_ks):
            t_c, i_c, ns = run_class(rays, coefs, ntab, k, bounds, False)
            tparts.append(t_c.reshape(-1))
            iparts.append(i_c.reshape(-1))
            for j in range(4):
                nparts[j].append(ns[:, j, :].reshape(-1))
        filler = keys.shape[0] - sum(p.shape[0] for p in tparts)
        tparts.append(jnp.full((filler,), jnp.inf, jnp.float32))
        iparts.append(jnp.full((filler,), big, jnp.int32))
        fz = jnp.zeros((filler,), jnp.float32)
        for j in range(4):
            nparts[j].append(fz)
        sorted_arrs = jax.lax.sort(
            (keys, jnp.concatenate(tparts), jnp.concatenate(iparts))
            + tuple(jnp.concatenate(p) for p in nparts),
            dimension=0, is_stable=False, num_keys=1,
        )
        lt, li = sorted_arrs[1][:v], sorted_arrs[2][:v]
        closer = (lt < best_t) | ((lt == best_t) & (li < best_i))
        best_t = jnp.where(closer, lt, best_t)
        best_i = jnp.where(closer, li, best_i)
        best_ns = [
            jnp.where(closer, sorted_arrs[3 + j][:v], best_ns[j])
            for j in range(4)
        ]

    if ov_dense is not None:
        rays_ov, cf_ov, nf_ov = ov_dense
        t_ov, i_ov, ns_ov = run_class(rays_ov, cf_ov, nf_ov, ov_k, None,
                                      True)
        t_ov = t_ov.reshape(-1)  # natural ray order already
        i_ov = i_ov.reshape(-1)
        closer = (t_ov < best_t) | ((t_ov == best_t) & (i_ov < best_i))
        best_t = jnp.where(closer, t_ov, best_t)
        best_i = jnp.where(closer, i_ov, best_i)
        best_ns = [
            jnp.where(closer, ns_ov[:, j, :].reshape(-1), best_ns[j])
            for j in range(4)
        ]
    return (best_t, best_i) + tuple(best_ns)


@partial(
    jax.jit,
    static_argnames=("n", "threshold", "ks", "ov_k", "t_count", "interpret",
                     "rule"),
)
def _raystab_query2(
    levels, sort_keys, ov_dense, n: int, threshold: float,
    ks: tuple, ov_k: int, t_count: int, interpret: bool,
    rule: str = "backface",
):
    """One-dispatch gen-4 query: fused stream kernels (fold + extract +
    in-slot finalize) -> sort-merge -> channel assembly.

    The rgba channels arrive finished from the fused kernel; here we only
    select the cross-level winner per ray and reshape."""
    _, _, nx, ny, nz, a = _merge_winners2(
        levels, sort_keys, ov_dense, n, ks, ov_k, t_count, threshold, rule,
        interpret
    )
    rgba = jnp.stack([nx, ny, nz, a], axis=-1)
    return (a != 0.0).reshape(n, n, n), rgba.reshape(n, n, n, 4)


def raystab_query2(
    verts_norm: jnp.ndarray,
    normals: jnp.ndarray,
    tris: jnp.ndarray,
    accel: RaystabAccel2,
    threshold: float = INSIDE_THRESHOLD,
    interpret: bool = False,
    rule: str = "backface",
):
    """Per-frame gen-2 trace -> (occupancy, rgba); ground truth is the
    radial oracle (ops/voxelize_ref.voxelize_raystab_radial_ref).

    ``verts_norm``/``normals`` must be the geometry the accel was built
    from (the coefficient and normal tables are baked in — the DXR-analog
    contract: rebuild the AS when geometry changes).
    """
    del verts_norm, normals  # baked into the accel (kept for API parity)
    ks = tuple(
        tuple(table_k(c[1]) for c in level) for level in accel.levels
    )
    ov_k = table_k(accel.ov_dense[1]) if accel.ov_dense else 0
    return _raystab_query2(
        accel.levels, accel.sort_keys, accel.ov_dense,
        accel.n, threshold, ks, ov_k, int(tris.shape[0]), interpret,
        rule=rule,
    )


def voxelize_raystab_fast(
    verts_norm: jnp.ndarray,
    normals: jnp.ndarray,
    tris: jnp.ndarray,
    n: int = 64,
    threshold: float = INSIDE_THRESHOLD,
):
    """Binned reference-rule solid voxelization -> (occupancy, rgba).

    Builds the direction-space accel (gen-7 tiles at n >= 128, gen-6
    strips below — ops/raystab_tiled.use_tiled_raystab) and traces it once;
    ground truth is the radial oracle
    (ops/voxelize_ref.voxelize_raystab_radial_ref). Build-once/trace-per-
    frame callers use the builders and queries directly.
    """
    if tris.shape[0] == 0:
        return (
            jnp.zeros((n, n, n), bool),
            jnp.zeros((n, n, n, 4), jnp.float32),
        )
    from dxrvoxelizer_tpu.ops.raystab_tiled import use_tiled_raystab

    if use_tiled_raystab(n):
        from dxrvoxelizer_tpu.ops.raystab_tiled import (
            build_raystab_accel7,
            raystab_query7,
        )

        accel7 = build_raystab_accel7(verts_norm, tris, normals, n=n)
        return raystab_query7(verts_norm, normals, tris, accel7, threshold)
    accel2 = build_raystab_accel2(verts_norm, tris, normals, n=n)
    return raystab_query2(verts_norm, normals, tris, accel2, threshold)
