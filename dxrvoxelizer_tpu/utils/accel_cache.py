"""On-disk cache of built ray-stab acceleration structures.

The reference builds its BLAS/TLAS once per geometry at init and ships
precompiled shader blobs next to the app (Voxelizer.cpp:264-326; the dxc
offline-compile rule in DXRVoxelizer.vcxproj:169-189) — init cost is paid
once, offline where possible. The analog here: the gen-2..7 accel is a pure
function of (geometry bytes, grid size, cubemap ladder, span), and its
binning + packing half (ops/raystab_fast.build_raystab_compact2) costs
seconds of host work at 256^3. So cache the COMPACT product on disk keyed
by that tuple's hash and rebuild only on miss; the device-gather assembly
(assemble_raystab_accel2) re-runs on load — it ships only int32 id tables
to the accelerator and XLA expands them in place.

Format history: formats <= 3 stored the EXPANDED device tables
(coefficient/normal/ray rows) — ~6 GB and a 206 s load at 256^3. Format 4
stores the compact id tables instead (~12x smaller: 4 B ids vs 96 B
coefficient+normal rows) and is backend-independent — the binning always
runs on host CPU and the backend-sensitive coefficient values are computed
at assembly time on the current default backend, so one cache entry serves
CPU tests and GPU runs alike.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np

_FORMAT = 7  # bump when RaystabCompact2's layout or packing contract
# changes (5: numpy cone-key binning — libm transcendentals can move a
# boundary rectangle one cell vs the old XLA:CPU build; 6-7: per-class
# vc padding follows raystab_pallas.cells_per_step_for incl. its
# vc-bounded padding rule)
# (2: gen-5 lane-aligned tables; 3: lane-aligned only for K >= LANE_MIN_K;
#  4: compact binning product only — assembly re-runs on load)


def default_cache_dir() -> str:
    from dxrvoxelizer_tpu.utils.backend import CACHE_ROOT

    return os.environ.get(
        "DXRVOX_ACCEL_CACHE", os.path.join(CACHE_ROOT, "accel")
    )


def _accel_key(verts_h, tris_h, n: int, gs, span: int,
               pad: float = 0.0, pad_dirs_h=None) -> str:
    import hashlib

    h = hashlib.sha256()
    tag = f"fmt{_FORMAT}|n{n}|gs{gs}|span{span}"
    if pad:  # pad extends the key only when set: old entries stay valid
        tag += f"|pad{pad!r}"
    if pad_dirs_h is not None:  # directional (capsule) pads: key on dirs
        tag += "|dirs"
    h.update(tag.encode())
    arrays = (verts_h, tris_h) if pad_dirs_h is None else (
        verts_h, tris_h, pad_dirs_h
    )
    for a in arrays:
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:24]


def save_compact2(path: str, compact) -> None:
    """Serialize a RaystabCompact2 to ``path`` (.npz, atomic rename)."""
    arrays: dict[str, np.ndarray] = {}
    manifest = {
        "format": _FORMAT,
        "n": compact.n,
        "stats_levels": [list(x) for x in compact.stats.levels],
        "near_origin": compact.stats.near_origin,
        "classes": [],
        "ov": compact.ov_ids is not None,
    }
    for j, (rt128, tab, bounds) in enumerate(compact.classes):
        pre = f"C{j}_"
        arrays[pre + "rt"] = np.asarray(rt128)
        arrays[pre + "tab"] = np.asarray(tab)
        if bounds is not None:
            arrays[pre + "bounds"] = np.asarray(bounds)
        manifest["classes"].append({"bounds": bounds is not None})
    if compact.ov_ids is not None:
        arrays["OV_ids"] = np.asarray(compact.ov_ids)
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_compact2(path: str):
    """Load a RaystabCompact2 saved by :func:`save_compact2` (host arrays
    only), or None when the file is absent/unreadable/stale-format."""
    from dxrvoxelizer_tpu.ops.raystab_fast import (
        Raystab2Stats,
        RaystabCompact2,
    )

    try:
        z = np.load(path)
        manifest = json.loads(bytes(z["manifest"]).decode())
        if manifest.get("format") != _FORMAT:
            return None
        classes = []
        for j, meta in enumerate(manifest["classes"]):
            pre = f"C{j}_"
            classes.append((
                z[pre + "rt"],
                z[pre + "tab"],
                z[pre + "bounds"] if meta["bounds"] else None,
            ))
        ov_ids = z["OV_ids"] if manifest["ov"] else None
        return RaystabCompact2(
            n=manifest["n"],
            classes=tuple(classes),
            ov_ids=ov_ids,
            stats=Raystab2Stats(
                levels=tuple(tuple(x) for x in manifest["stats_levels"]),
                near_origin=manifest["near_origin"],
            ),
        )
    except (OSError, KeyError, ValueError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return None


def cached_compact2(
    verts_norm, tris, n: int = 64, gs=None, span: int = 8,
    pad: float = 0.0, cache_dir: str | None = None, pad_dirs=None,
):
    """build_raystab_compact2 behind the on-disk cache.

    Key: sha256 of (geometry bytes, n, gs, span, pad, pad_dirs bytes,
    format) — normals are NOT in the key (they don't influence
    binning/packing; pad_dirs ARE — directional pads shape the bins).
    Miss -> bin/pack + persist; hit -> load.
    """
    import jax

    from dxrvoxelizer_tpu.ops.raystab_fast import build_raystab_compact2

    root = cache_dir or default_cache_dir()
    if str(root) in ("0", "off", "none"):
        return build_raystab_compact2(
            verts_norm, tris, n, gs, span, pad, pad_dirs
        )
    verts_h, tris_h = jax.device_get((verts_norm, tris))
    dirs_h = None if pad_dirs is None else np.asarray(
        jax.device_get(pad_dirs), np.float32
    )
    key = _accel_key(verts_h, tris_h, n, gs, span, pad, dirs_h)
    path = os.path.join(root, key + ".npz")
    compact = load_compact2(path)
    if compact is None:
        compact = build_raystab_compact2(
            verts_norm, tris, n, gs, span, pad, dirs_h
        )
        try:
            save_compact2(path, compact)
        except OSError:
            pass  # read-only cache dir: serve the built accel anyway
    return compact


def save_compact7(path: str, compact) -> None:
    """Serialize a RaystabCompact7 (gen-7 tiled compact) — same .npz +
    manifest scheme as :func:`save_compact2`, tile-id tables instead of
    ray tables."""
    arrays: dict[str, np.ndarray] = {}
    manifest = {
        "format": _FORMAT,
        "kind": "tiled7",
        "n": compact.n,
        "tile": list(compact.tile),
        "stats": {
            "g_fine": compact.stats.g_fine,
            "live_tiles": compact.stats.live_tiles,
            "dead_tiles": compact.stats.dead_tiles,
            "pairs": compact.stats.pairs,
            "near_origin": compact.stats.near_origin,
            "classes": [list(x) for x in compact.stats.classes],
        },
        "classes": [],
    }
    for j, (tids, tab, bounds) in enumerate(compact.classes):
        pre = f"C{j}_"
        arrays[pre + "tids"] = np.asarray(tids)
        arrays[pre + "tab"] = np.asarray(tab)
        if bounds is not None:
            arrays[pre + "bounds"] = np.asarray(bounds)
        manifest["classes"].append({"bounds": bounds is not None})
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_compact7(path: str):
    """Load a RaystabCompact7, or None when absent/unreadable/stale."""
    from dxrvoxelizer_tpu.ops.raystab_tiled import (
        Raystab7Stats,
        RaystabCompact7,
    )

    try:
        z = np.load(path)
        manifest = json.loads(bytes(z["manifest"]).decode())
        if (manifest.get("format") != _FORMAT
                or manifest.get("kind") != "tiled7"):
            return None
        classes = []
        for j, meta in enumerate(manifest["classes"]):
            pre = f"C{j}_"
            classes.append((
                z[pre + "tids"],
                z[pre + "tab"],
                z[pre + "bounds"] if meta["bounds"] else None,
            ))
        st = manifest["stats"]
        return RaystabCompact7(
            n=manifest["n"],
            tile=tuple(manifest["tile"]),
            classes=tuple(classes),
            stats=Raystab7Stats(
                g_fine=st["g_fine"], live_tiles=st["live_tiles"],
                dead_tiles=st["dead_tiles"], pairs=st["pairs"],
                near_origin=st["near_origin"],
                classes=tuple(tuple(x) for x in st["classes"]),
            ),
        )
    except (OSError, KeyError, ValueError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return None


def cached_compact7(
    verts_norm, tris, n: int = 64, gs=None, span: int = 8,
    pad: float = 0.0, cache_dir: str | None = None, pad_dirs=None,
    tile=None,
):
    """build_raystab_compact7 behind the on-disk cache (key scheme of
    :func:`cached_compact2` plus a gen-7 discriminator + tile shape)."""
    import jax

    from dxrvoxelizer_tpu.ops.raystab_tiled import (
        TILE,
        build_raystab_compact7,
    )

    tile = TILE if tile is None else tuple(tile)
    root = cache_dir or default_cache_dir()
    if str(root) in ("0", "off", "none"):
        return build_raystab_compact7(
            verts_norm, tris, n, gs, span, pad, pad_dirs, tile=tile
        )
    verts_h, tris_h = jax.device_get((verts_norm, tris))
    dirs_h = None if pad_dirs is None else np.asarray(
        jax.device_get(pad_dirs), np.float32
    )
    key = _accel_key(verts_h, tris_h, n, gs, span, pad, dirs_h)
    path = os.path.join(root, f"t7_{'x'.join(map(str, tile))}_{key}.npz")
    compact = load_compact7(path)
    if compact is None:
        compact = build_raystab_compact7(
            verts_norm, tris, n, gs, span, pad, dirs_h, tile=tile
        )
        try:
            save_compact7(path, compact)
        except OSError:
            pass
    return compact


def cached_build_raystab_accel7(
    verts_norm, tris, normals, n: int = 64, gs=None, span: int = 8,
    cache_dir: str | None = None, pad: float = 0.0, tile=None,
):
    """build_raystab_accel7 behind the on-disk compact cache."""
    from dxrvoxelizer_tpu.ops.raystab_tiled import assemble_raystab_accel7

    compact = cached_compact7(
        verts_norm, tris, n, gs, span, pad, cache_dir, tile=tile
    )
    return assemble_raystab_accel7(compact, verts_norm, tris, normals)


def cached_build_raystab_accel2(
    verts_norm, tris, normals, n: int = 64, gs=None, span: int = 8,
    cache_dir: str | None = None, pad: float = 0.0,
):
    """build_raystab_accel2 behind the on-disk compact cache
    (:func:`cached_compact2`): assembly bakes the caller's normals in
    fresh every time; only the binning/packing product is persisted."""
    from dxrvoxelizer_tpu.ops.raystab_fast import assemble_raystab_accel2

    compact = cached_compact2(
        verts_norm, tris, n, gs, span, pad, cache_dir
    )
    return assemble_raystab_accel2(compact, verts_norm, tris, normals)
