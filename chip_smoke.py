"""Smoke run of the voxelize -> render frame loop on NVIDIA GPUs.

Run from the repository root:

    python chip_smoke.py [--seed S]        # one card: every phase below
    python chip_smoke.py --chips 4         # four cards: the sharded frame only

One process drives every phase (a JAX process reserves most of a card's
memory, so a second one would fail):

1. the card's name and power limit (from a child that never imports JAX),
   then a check that JAX's default device is a GPU;
2. seeded closed meshes (displaced icospheres, models/procedural.py) at
   81,920 triangles (the reference's 69,666-triangle bunny scale) and
   327,680 triangles (hi-res), written as OBJ files;
3. the app (``dxrvoxelizer_tpu.app.main.main``) in four configurations,
   each writing a PNG;
4. occupancy against the oracles of ops/voxelize_ref.py and the image
   against the exact renderer and against the CPU;
5. each hand-written kernel's time against the plain XLA version, isolated
   and through the frame, plus the 256^3 frame's memory analysis.

Any failed check raises, so the script exits non-zero and prints no result;
the last line of a passing run is one JSON object naming the device.
Outputs (PNGs, OBJs) go under ``chiprun_out/smoke``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "chiprun_out" / "smoke"
# triangle counts of the two seeded meshes, by role
MESHES = {"small": 81_920, "hires": 327_680}
# the app's A/B image bounds (dxrvoxelizer_tpu/app/main.py, -ab)
IMG_MEAN_BOUND, IMG_P99_BOUND = 0.03, 0.35
# ray-stab normals, kernel vs oracle on the card (see check_raystab): the
# H100 measured at most 3.0e-7 (about 2.5 ulp of 1.0) at 64^3 and 128^3
NORMAL_TOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """``name, power.limit`` of each card, from nvidia-smi (no JAX here)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def make_meshes(out_dir: Path, seed: int, sizes: dict = MESHES) -> dict:
    """Seeded closed meshes -> {role: OBJ path}."""
    from dxrvoxelizer_tpu.models.procedural import (
        displaced_icosphere,
        write_obj,
    )

    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (role, n_tris) in enumerate(sizes.items()):
        v, nr, t = displaced_icosphere(n_tris, seed=seed + i)
        # world placement in front of the default camera, which looks at
        # (0, 4, 0) like the reference's (voxelization normalizes it away)
        v = v * np.float32(4.0) + np.float32([0.0, 4.0, 0.0])
        paths[role] = write_obj(
            out_dir / f"ico_{n_tris}_s{seed + i}.obj", v, nr, t
        )
    return paths


def run_app(name: str, argv: list[str]) -> float:
    """One in-process app run; returns its wall seconds (compile incl.)."""
    from dxrvoxelizer_tpu.app.main import main

    t0 = time.perf_counter()
    rc = main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"app run {name!r} exited {rc}")
    log(f"app {name}: {' '.join(argv)} -> {dt:.2f} s wall")
    return dt


def app_runs(meshes: dict, out_dir: Path, small: bool = False) -> dict:
    """The four app configurations (``small``: tiny sizes for the CPU)."""
    m64, m256 = str(meshes["small"]), str(meshes["hires"])
    g, gh = ("32", "64") if small else ("64", "256")
    wh = ["-width", "64", "-height", "48"] if small else []
    whh = ["-width", "64", "-height", "48"] if small else [
        "-width", "1920", "-height", "1080"]
    f8, f3 = ("2", "1") if small else ("8", "3")
    runs = {
        "default": ["-mesh", m64, "-grid", g, "-hq", *wh, "-frames", f8],
        "reference_rule": ["-mesh", m64, "-inside", "raystab", "-grid", g,
                           *wh, "-frames", f3],
        "deforming": ["-mesh", m256, "-deform", "-grid", gh, *whh,
                      "-frames", f3],
        "hires": ["-mesh", m256, "-grid", gh, *whh, "-frames", f3],
    }
    return {
        name: run_app(name, argv + ["-out", str(out_dir / f"{name}.png")])
        for name, argv in runs.items()
    }


def load_scene(obj: Path):
    from dxrvoxelizer_tpu.models.scene import Scene
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig

    return Scene.load(VoxelizerConfig(mesh=str(obj)))


def _wall(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def check_parity(mesh, n: int) -> dict:
    """Work-queue voxelizer (the platform's fold) vs voxelize_parity_ref."""
    from dxrvoxelizer_tpu.ops.packing import pack_bits_z, unpack_bits_z
    from dxrvoxelizer_tpu.ops.voxelize_queue import StaticVoxelizer
    from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref

    sv = StaticVoxelizer(mesh.positions_norm, mesh.tris, n)
    got, _ = _wall(sv)
    ref, ref_s = _wall(
        lambda: pack_bits_z(
            voxelize_parity_ref(mesh.positions_norm, mesh.tris, n=n)
        )
    )
    diff = np.asarray(unpack_bits_z(got, n)) != np.asarray(
        unpack_bits_z(ref, n))
    res = {
        "n": n, "tris": int(mesh.tris.shape[0]),
        "occupied": int(np.asarray(unpack_bits_z(ref, n)).sum()),
        "mismatched_voxels": int(diff.sum()), "oracle_s": round(ref_s, 3),
    }
    log(f"check parity {n}^3: {res}")
    if res["mismatched_voxels"] or not res["occupied"]:
        raise AssertionError(f"parity {n}^3 differs from the oracle: {res}")
    return res


def _quantize(rgba: np.ndarray) -> np.ndarray:
    """The grid's R10G10B10A2 store (ops/packing.quantize_r10g10b10a2)."""
    rgb = np.round(np.clip(rgba[..., :3], 0.0, 1.0) * 1023.0)
    return np.concatenate([rgb, np.round(np.clip(rgba[..., 3:], 0, 1) * 3)],
                          axis=-1)


def check_raystab(mesh, n: int) -> dict:
    """Binned ray-stab query (gen-6 below 128^3, gen-7 above) vs the radial
    oracle: occupancy bit-exact; normals within NORMAL_TOL.

    The kernel (Triton) and the oracle (XLA) contract multiply-adds into
    FMAs differently on the GPU, so the float normals of the same winner
    can differ in their last bits; the stored grid (10-bit UNORM) can then
    differ by one step, but only where a component lies within NORMAL_TOL
    of a rounding boundary — checked voxel by voxel."""
    from dxrvoxelizer_tpu.ops.raystab_fast import voxelize_raystab_fast
    from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_raystab_radial_ref

    args = (mesh.positions_norm, mesh.normals, mesh.tris)
    (occ, rgba), fast_s = _wall(lambda: voxelize_raystab_fast(*args, n=n))
    (occ_r, rgba_r), ref_s = _wall(
        lambda: voxelize_raystab_radial_ref(*args, n=n)
    )
    occ, occ_r = np.asarray(occ), np.asarray(occ_r)
    rgba, rgba_r = np.asarray(rgba), np.asarray(rgba_r)
    diff = np.abs(rgba - rgba_r)
    q_diff = _quantize(rgba) != _quantize(rgba_r)
    # distance (in float units) of the oracle's components from the nearest
    # 10-bit rounding boundary; a quantized difference must sit within tol
    frac = np.abs((np.clip(rgba_r[..., :3], 0, 1) * 1023.0) % 1.0 - 0.5)
    off_tie = q_diff[..., :3] & (frac / 1023.0 > NORMAL_TOL)
    res = {
        "n": n, "occupied": int(occ_r.sum()),
        "mismatched_voxels": int((occ != occ_r).sum()),
        "float_rgba_differ": int((diff > 0).any(axis=-1).sum()),
        "max_abs_normal_diff": float(diff.max()),
        "quantized_rgba_differ": int(q_diff.any(axis=-1).sum()),
        "quantized_not_at_tie": int(off_tie.any(axis=-1).sum()),
        "build_query_s": round(fast_s, 3), "oracle_s": round(ref_s, 3),
    }
    log(f"check raystab {n}^3: {res}")
    if (res["mismatched_voxels"] or not res["occupied"]
            or res["max_abs_normal_diff"] > NORMAL_TOL
            or res["quantized_not_at_tie"] or q_diff[..., 3].any()):
        raise AssertionError(f"raystab {n}^3 differs from the oracle: {res}")
    return res


def check_image(scene, n: int, width: int, height: int) -> dict:
    """Production frame (-hq shear-warp) vs the exact renderer with the
    app's A/B bounds, and vs the same frame rendered on the CPU."""
    import jax
    import jax.numpy as jnp

    from dxrvoxelizer_tpu.core.pipeline import FramePipeline, VoxelGrid, render
    from dxrvoxelizer_tpu.models.camera import OrbitCamera
    from dxrvoxelizer_tpu.ops.raymarch_ref import raymarch_ref
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig

    cfg = VoxelizerConfig(grid_size=n, width=width, height=height)
    pipe = FramePipeline(cfg, scene.buffers)
    cam = OrbitCamera(width, height)
    consts = scene.update_frame(cam.eye, cam.view_proj, width, height)
    img = np.asarray(pipe.frame(consts))
    words = np.asarray(pipe._static_vox())
    ref = np.asarray(raymarch_ref(
        VoxelGrid(words=jnp.asarray(words)).density(),
        jnp.asarray(consts.screen_to_local),
        jnp.asarray(consts.local_space_eye_pt),
        jnp.asarray(consts.local_space_light_pt),
        jnp.asarray(np.array(cfg.clear_color, np.float32)), width, height,
        n_samples=cfg.num_samples, n_light=cfg.num_light_samples,
    ))
    err = np.abs(img - ref)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        grid_cpu = VoxelGrid(words=jax.device_put(words, cpu))
        img_cpu = np.asarray(render(grid_cpu, consts, cfg))
    dcpu = np.abs(img - img_cpu)
    res = {
        "size": f"{n}^3 {width}x{height}",
        "vs_ref_mean": float(err.mean()),
        "vs_ref_p99": float(np.percentile(err, 99)),
        "vs_cpu_max": float(dcpu.max()), "vs_cpu_mean": float(dcpu.mean()),
        "finite": bool(np.isfinite(img).all()),
    }
    log(f"check image: {res}")
    if not (res["finite"] and res["vs_ref_mean"] < IMG_MEAN_BOUND
            and res["vs_ref_p99"] < IMG_P99_BOUND):
        raise AssertionError(f"image outside the A/B bounds: {res}")
    # CPU and GPU run the same XLA graphs; only fused-multiply-add
    # contraction and reduction order differ, so a u8 step is the bound
    if res["vs_cpu_max"] > 1.0 / 255.0:
        raise AssertionError(f"GPU image differs from the CPU one: {res}")
    return res


def _median_ms(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def _frame_ms(scene, cfg, reps: int) -> float:
    from dxrvoxelizer_tpu.core.pipeline import FramePipeline
    from dxrvoxelizer_tpu.models.camera import OrbitCamera

    pipe = FramePipeline(cfg, scene.buffers)
    cam = OrbitCamera(cfg.width, cfg.height)
    consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    return _median_ms(lambda: pipe.frame(consts), reps)


def kernel_vs_xla(scenes: dict, reps: int = 20, small: bool = False) -> dict:
    """Each hand-written kernel against the plain XLA version of the same
    job: isolated, and through the frame that uses it (route swapped).
    Runs in the order kernel, xla, xla, kernel and keeps every run, so the
    spread between a version's own runs shows beside the difference."""
    import jax

    from dxrvoxelizer_tpu.ops import raystab_fast as rf
    from dxrvoxelizer_tpu.ops import route
    from dxrvoxelizer_tpu.ops import voxelize_queue as vq
    from dxrvoxelizer_tpu.ops.raystab_pallas import stab_fold_extract
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig

    s64, s256 = scenes["small"], scenes["hires"]
    n_lo, n_hi = (32, 64) if small else (64, 256)
    wh = (64, 48) if small else (1280, 720)
    whh = (64, 48) if small else (1920, 1080)
    interp = {"interpret": True} if small else {}  # no card: interpret
    variants = {
        "parity_fold": ("parity_voxelize",
                        partial(vq.queue_fold_triton, **interp),
                        vq.queue_fold_xla),
        "raystab_fold": ("raystab_query",
                         partial(stab_fold_extract, **interp),
                         rf.fold_extract_xla),
    }
    frames = {
        "parity_fold": [
            (s64, VoxelizerConfig(grid_size=n_lo, width=wh[0],
                                  height=wh[1])),
            (s256, VoxelizerConfig(grid_size=n_hi, width=whh[0],
                                   height=whh[1])),
        ],
        "raystab_fold": [
            (s64, VoxelizerConfig(grid_size=n_lo, width=wh[0], height=wh[1],
                                  inside_mode="raystab")),
        ],
    }
    out = {}
    saved = {name: getattr(route, name) for name, _, _ in variants.values()}
    try:
        for job, (route_name, kern, plain) in variants.items():
            impls = {"kernel": kern, "xla": plain}
            for label in ("kernel", "xla", "xla", "kernel"):
                impl = impls[label]
                setattr(route, route_name, lambda impl=impl: impl)
                jax.clear_caches()  # jitted callers re-trace the route
                out.setdefault(f"{job}.{label}.isolated_ms", []).append(
                    _isolated_ms(
                        job, s64 if job == "raystab_fold" else s256,
                        n_lo if job == "raystab_fold" else n_hi, reps,
                    ))
                for scene, cfg in frames[job]:
                    key = (f"{job}.{label}.frame_{cfg.grid_size}_"
                           f"{cfg.width}x{cfg.height}_ms")
                    out.setdefault(key, []).append(
                        _frame_ms(scene, cfg, reps))
            setattr(route, route_name, saved[route_name])
    finally:
        for name, fn in saved.items():
            setattr(route, name, fn)
        jax.clear_caches()
    for k, v in out.items():
        log(f"time {k}: {' '.join(f'{x:.4f}' for x in v)}")
    return out


def _isolated_ms(job: str, scene, n: int, reps: int) -> float:
    mesh = scene.buffers
    if job == "parity_fold":
        from dxrvoxelizer_tpu.ops.voxelize_queue import StaticVoxelizer

        sv = StaticVoxelizer(mesh.positions_norm, mesh.tris, n)
        return _median_ms(sv, reps)
    from dxrvoxelizer_tpu.ops.raystab_fast import (
        build_raystab_accel2,
        raystab_query2,
    )

    accel = build_raystab_accel2(mesh.positions_norm, mesh.tris,
                                 mesh.normals, n)
    return _median_ms(
        lambda: raystab_query2(mesh.positions_norm, mesh.normals, mesh.tris,
                               accel), reps)


def compile_report(scene, n: int, width: int, height: int) -> dict:
    """Compile seconds and memory analysis of the frame's two programs at
    ``n``^3: the parity fold and the -hq shear-warp render."""
    import jax
    import jax.numpy as jnp

    from dxrvoxelizer_tpu.models.camera import OrbitCamera
    from dxrvoxelizer_tpu.ops import raymarch_warp as rw
    from dxrvoxelizer_tpu.ops import route
    from dxrvoxelizer_tpu.ops.voxelize_queue import build_queue

    mesh = scene.buffers
    coefs, row0, count, _ = build_queue(mesh.positions_norm, mesh.tris, n)
    cam = OrbitCamera(width, height)
    consts = scene.update_frame(cam.eye, cam.view_proj, width, height)
    axis, flip, swap, m = rw.shearwarp_statics(
        consts.screen_to_local, consts.local_space_eye_pt, width, height)
    vol = jnp.zeros((n, n, n), jnp.float32)
    progs = {
        "parity_fold": (
            jax.jit(lambda c, r, k: route.parity_voxelize()(c, r, k, 0, n)),
            (coefs, row0, count)),
        "render_hq": (
            jax.jit(lambda d, l, s, e, c: rw._shearwarp_core(
                d, l, s, e, c, n, m, width, height, axis, flip, swap, ss=2)),
            (vol, vol, jnp.asarray(consts.screen_to_local),
             jnp.asarray(consts.local_space_eye_pt),
             jnp.zeros((3,), jnp.float32))),
    }
    out = {}
    for name, (fn, args) in progs.items():
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        dt = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        out[name] = {"compile_s": round(dt, 3), "memory": str(mem)}
        log(f"compile {name} at {n}^3 {width}x{height}: {dt:.3f} s; "
            f"memory_analysis: {mem}")
    return out


def multichip(scenes: dict, chips: int, small: bool = False) -> dict:
    """The sharded frame on ``chips`` cards vs the one-card frame from the
    same process, and the frame's all_gather alone."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dxrvoxelizer_tpu.core.pipeline import FramePipeline
    from dxrvoxelizer_tpu.models.camera import OrbitCamera
    from dxrvoxelizer_tpu.parallel.mesh import make_device_mesh
    from dxrvoxelizer_tpu.parallel.pipeline import ShardedFramePipeline
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig

    n_hi, n_lo = (64, 32) if small else (256, 64)
    w, h = (64, 48) if small else (1920, 1080)
    cases = {
        # (scene, cfg, bound): the bounds of tests/test_parallel.py
        "parity": (scenes["hires"],
                   VoxelizerConfig(grid_size=n_hi, width=w, height=h), 2e-2),
        "raystab": (scenes["small"],
                    VoxelizerConfig(grid_size=n_lo, width=w, height=h,
                                    inside_mode="raystab"), 2e-6),
    }
    out = {}
    for name, (scene, cfg, bound) in cases.items():
        cam = OrbitCamera(cfg.width, cfg.height)
        consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width,
                                    cfg.height)
        sharded = ShardedFramePipeline(cfg, scene.buffers, chips)
        single = FramePipeline(cfg, scene.buffers)
        img_n = np.asarray(sharded.frame(consts))
        img_1 = np.asarray(single.frame(consts))
        diff = float(np.abs(img_n - img_1).max())
        ms_n = _median_ms(lambda: sharded.frame(consts), 10)
        ms_1 = _median_ms(lambda: single.frame(consts), 10)
        out[name] = {"max_abs_diff": diff, "frame_ms_sharded": ms_n,
                     "frame_ms_one_card": ms_1}
        log(f"multichip {name} {cfg.grid_size}^3 {w}x{h} on {chips} cards: "
            f"{out[name]}")
        if not diff <= bound:
            raise AssertionError(f"sharded {name} frame differs: {diff}")
    # the parity frame's one collective: all_gather of the tile groups
    mesh = make_device_mesh(chips)
    words = (n_hi // 16) * (n_hi // 8) // chips
    x = jnp.zeros((chips * words, n_hi // 32, 128), jnp.int32)
    gather = jax.jit(jax.shard_map(
        lambda a: jax.lax.all_gather(a, "slab", axis=0, tiled=True),
        mesh=mesh, in_specs=P("slab"), out_specs=P(), check_vma=False))
    out["all_gather_ms"] = _median_ms(lambda: gather(x), 50)
    log(f"multichip all_gather of {x.nbytes} B over {chips} cards: "
        f"{out['all_gather_ms']:.4f} ms")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    log(f"card: {card_info()}")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev}")
    if len(jax.devices()) < args.chips:
        raise SystemExit(f"--chips {args.chips}: found {jax.devices()}")
    from dxrvoxelizer_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    meshes = make_meshes(OUT, args.seed)
    scenes = {k: load_scene(p) for k, p in meshes.items()}
    log(f"meshes: {[str(p) for p in meshes.values()]} "
        f"({time.perf_counter() - t0:.1f} s)")

    if args.chips > 1:
        multichip(scenes, args.chips)
    else:
        app_runs(meshes, OUT)
        s64, s256 = scenes["small"], scenes["hires"]
        check_parity(s64.buffers, 64)
        check_parity(s256.buffers, 256)
        check_raystab(s64.buffers, 64)
        check_raystab(s64.buffers, 128)
        check_image(s64, 64, 1280, 720)
        kernel_vs_xla(scenes)
        compile_report(s256, 256, 1920, 1080)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
