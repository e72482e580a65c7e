"""Batch voxelization data generation (the Thingi10K throughput config).

BASELINE.json configs include "voxelize 1k-mesh Thingi10K subset at 128^3,
throughput mode". Each mesh runs the work-queue parity voxelizer, whose
chunk-count bucketing bounds recompiles across the heterogeneous mesh set.

Multi-device: :func:`voxelize_batch` round-robins meshes over the given
devices — each mesh's buffers are ``jax.device_put`` to its device, the
kernel dispatches there asynchronously (device i crunches mesh i while the
host parses mesh i+1), and the occupancy counts drain in ONE
``jax.device_get`` at the end. Multi-host (SURVEY.md §5: "DCN only for
multi-host batch datagen" — the work is embarrassingly parallel, so the
only cross-host traffic is the input file list): each process calls
:func:`shard_paths` to keep its ``jax.process_index()``-strided slice and
runs the batch on its local devices; no collective is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops.packing import pack_bits_z, unpack_bits_z
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref
from dxrvoxelizer_tpu.utils.objloader import load_obj


@dataclass
class DatagenResult:
    path: str
    n: int
    occupied: int
    out_file: str | None
    device: str = ""


def shard_paths(paths: list, process_index: int | None = None,
                process_count: int | None = None) -> list:
    """This host's strided slice of the mesh list (multi-host datagen).

    Strided (``paths[i::count]``) rather than blocked so heterogeneous
    mesh sizes spread evenly across hosts. Defaults read
    ``jax.process_index()/process_count()`` (1 process locally -> no-op).
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return list(paths)[pi::pc]


def _dispatch_mesh(path, n: int, impl: str, device):
    """Load one OBJ and dispatch its voxelization on ``device`` (async).

    Returns (words, occupied) as in-flight device arrays committed to
    ``device`` — the caller drains them; nothing here blocks on compute.
    """
    mesh = load_obj(path)
    bound = mesh.bound()
    verts_h = np.asarray(
        (mesh.positions - bound[:3]) / max(float(bound[3]), 1e-20),
        dtype=np.float32,
    )
    verts = jax.device_put(jnp.asarray(verts_h), device)
    tris = jax.device_put(jnp.asarray(mesh.triangles), device)
    if impl in ("auto", "queue"):
        from dxrvoxelizer_tpu.ops.voxelize_queue import voxelize_parity_queue

        words = voxelize_parity_queue(verts, tris, n)
    else:
        occ = voxelize_parity_ref(verts, tris, n=n)
        words = pack_bits_z(occ)
    occupied = unpack_bits_z(words, n).sum()
    return words, occupied


def voxelize_mesh_file(
    path: str | Path,
    n: int = 128,
    impl: str = "auto",
    out_dir: str | Path | None = None,
    device=None,
) -> DatagenResult:
    """Load one OBJ, solid-voxelize at n^3 on ``device``, optionally save
    packed .npy."""
    if device is None:
        device = jax.local_devices()[0]
    words, occupied = _dispatch_mesh(path, n, impl, device)
    out_file = None
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        out_file = str(out_dir / (Path(path).stem + f"_{n}.npy"))
        np.save(out_file, np.asarray(words))
    return DatagenResult(
        str(path), n, int(occupied), out_file, device=str(device)
    )


def voxelize_batch(
    paths: list[str | Path],
    n: int = 128,
    impl: str = "auto",
    out_dir: str | Path | None = None,
    devices: list | None = None,
) -> list[DatagenResult]:
    """Throughput mode over a mesh list, round-robin over ``devices``.

    Mesh i dispatches asynchronously to ``devices[i % D]`` — D meshes are
    in flight at once while the host parses the next OBJ — and all counts
    drain in one ``jax.device_get``. ``devices`` defaults to all
    local devices; pass ``[jax.local_devices()[0]]`` to pin one.
    For multi-host runs, pre-slice the list with :func:`shard_paths`.
    """
    if devices is None:
        devices = jax.local_devices()
    pending = []  # (path, device, words, occupied) — in flight
    for i, p in enumerate(paths):
        dev = devices[i % len(devices)]
        words, occupied = _dispatch_mesh(p, n, impl, dev)
        pending.append((p, dev, words, occupied))

    counts = jax.device_get(tuple(occ for (_, _, _, occ) in pending))
    results = []
    for (p, dev, words, _), occ in zip(pending, counts):
        out_file = None
        if out_dir is not None:
            od = Path(out_dir)
            od.mkdir(parents=True, exist_ok=True)
            out_file = str(od / (Path(p).stem + f"_{n}.npy"))
            np.save(out_file, np.asarray(words))
        results.append(
            DatagenResult(str(p), n, int(occ), out_file, device=str(dev))
        )
    return results


def main(argv=None) -> int:
    """CLI: ``python -m dxrvoxelizer_tpu.parallel.datagen mesh1.obj ...``

    The Thingi10K throughput config (BASELINE.json): voxelize a mesh list at
    128^3 and write packed ``.npy`` grids. Round-robins over all local
    devices; under multi-host JAX each process takes its shard_paths slice.
    """
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("meshes", nargs="+", help="OBJ files to voxelize")
    ap.add_argument("-grid", type=int, default=128)
    ap.add_argument("-out", default="datagen_out")
    ap.add_argument("-impl", default="auto",
                    choices=["auto", "queue", "xla"])
    ap.add_argument("-devices", type=int, default=0,
                    help="use only the first D local devices (0 = all)")
    args = ap.parse_args(argv)
    import time as _time

    devices = jax.local_devices()
    if args.devices > 0:
        devices = devices[: args.devices]
    meshes = shard_paths(args.meshes)
    t0 = _time.perf_counter()
    results = voxelize_batch(
        meshes, n=args.grid, impl=args.impl, out_dir=args.out,
        devices=devices,
    )
    dt = _time.perf_counter() - t0
    for r in results:
        print(f"{r.path}: {r.occupied} occupied -> {r.out_file} [{r.device}]")
    print(f"{len(results)} meshes at {args.grid}^3 on {len(devices)} "
          f"device(s) in {dt:.2f}s ({len(results)/max(dt,1e-9):.2f} mesh/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
