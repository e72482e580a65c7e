"""Benchmark harness. Prints ONE JSON line with the headline metric.

Headline (BASELINE.json): solid voxelization at 256^3 of a seeded closed
mesh of 327,680 triangles (models/procedural.py; the canonical OBJ assets
are not shipped), target <= 2 ms/frame. ``vs_baseline`` = measured_ms / 2.0
(< 1.0 beats the target). Every secondary is also machine-readable: the JSON
line carries a ``secondaries`` dict (ms per entry), and the device it ran
on. The bench needs a GPU and fails without one.

Timing: each measured op is repeated r1 and r2 times inside one jitted scan
(with an opaque no-op data dependence between iterations so XLA cannot
hoist or dedupe), and (t(r2) - t(r1)) / (r2 - r1) is the per-iteration
time. The method is due to be replaced by the end-to-end benchmark
(ROADMAP.md queue 1 item 1).

Run: python bench.py  (add --quick for a smaller sanity config)
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time


def main() -> int:
    quick = "--quick" in sys.argv
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default device is {dev}")
    from dxrvoxelizer_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    secondaries, headline = run(quick)
    print(json.dumps({
        "metric": "voxelize_ms",
        "value": round(headline, 4),
        "vs_baseline": round(headline / 2.0, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "secondaries": secondaries,
    }))
    return 0


def run(quick: bool) -> tuple[dict, float]:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dxrvoxelizer_tpu.models.camera import OrbitCamera
    from dxrvoxelizer_tpu.models.mesh import MeshBuffers
    from dxrvoxelizer_tpu.models.procedural import displaced_icosphere
    from dxrvoxelizer_tpu.models.scene import Scene
    from dxrvoxelizer_tpu.ops import raymarch_warp as rw
    from dxrvoxelizer_tpu.ops.packing import unpack_bits_z
    from dxrvoxelizer_tpu.ops.raystab_fast import (
        build_raystab_accel2,
        raystab_query2,
    )
    from dxrvoxelizer_tpu.ops.voxelize_queue import (
        DeformingVoxelizer,
        StaticVoxelizer,
        run_queue,
    )
    from dxrvoxelizer_tpu.utils.objloader import ObjMesh

    n_hi, n_lo = (64, 32) if quick else (256, 64)
    w, h = (320, 180) if quick else (1920, 1080)
    r1, r2 = (2, 6) if quick else (25, 100)
    secondaries: dict[str, float] = {}

    def scene_of(n_tris: int, seed: int) -> Scene:
        v, nr, t = displaced_icosphere(n_tris, seed=seed)
        return Scene(ObjMesh(positions=v, normals=nr,
                             indices=t.reshape(-1).astype(np.int32),
                             aabb_min=v.min(0), aabb_max=v.max(0)))

    def slope(body, label: str, key: str, args=()) -> float:
        """Seconds per iteration as the slope between two scan lengths.
        ``body(carry, args) -> scalar``; ``args`` ride the jit as arguments
        (closed-over arrays would be baked into the program as constants)."""
        def make(r):
            @jax.jit
            def f(a):
                out, _ = jax.lax.scan(lambda c, _: (body(c, a), None),
                                      jnp.float32(0.0), None, length=r)
                return out
            return f

        fa, fb = make(r1), make(r2)
        float(fa(args))
        float(fb(args))

        def best(f):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(f(args))
                ts.append(time.perf_counter() - t0)
            return min(ts)

        dt = (best(fb) - best(fa)) / (r2 - r1)
        print(f"# {label}: {dt * 1e3:.4f} ms/iter", file=sys.stderr)
        secondaries[key] = round(dt * 1e3, 4)
        return dt

    s_hi = scene_of(5120 if quick else 327_680, 1)
    s_lo = scene_of(1280 if quick else 81_920, 0)
    b_hi: MeshBuffers = s_hi.buffers

    def first_bit(words):
        return (words[0, 0, 0] % 2).astype(jnp.float32)

    # ---- headline: static parity voxelize (queue built once) --------------
    sv = StaticVoxelizer(b_hi.positions_norm, b_hi.tris, n_hi)
    sv_lo = StaticVoxelizer(s_lo.buffers.positions_norm, s_lo.buffers.tris,
                            n_lo)
    head = None
    for vox, n in ((sv, n_hi), (sv_lo, n_lo)):
        dt = slope(
            lambda c, a, vox=vox, n=n: first_bit(run_queue(
                a + c * 1e-38, vox.row0, vox.count, n)),
            f"voxelize {n}^3", f"voxelize_{n}_ms", args=vox.coefs,
        )
        head = dt if head is None else head

    # ---- deforming: device re-bin + voxelize per frame --------------------
    dv = DeformingVoxelizer(b_hi.positions_norm, b_hi.tris, n_hi)
    slope(lambda c, a: first_bit(dv(a + c * 1e-38)),
          f"deforming voxelize {n_hi}^3", f"deforming_voxelize_{n_hi}_ms",
          args=b_hi.positions_norm)

    # ---- -hq render at w x h from both grids ------------------------------
    for scene, vox, n in ((s_lo, sv_lo, n_lo), (s_hi, sv, n_hi)):
        density = unpack_bits_z(vox(), n).astype(jnp.float32)
        cam = OrbitCamera(w, h)
        fc = scene.update_frame(cam.eye, cam.view_proj, w, h)
        axis, flip, swap, m = rw.shearwarp_statics(
            fc.screen_to_local, fc.local_space_eye_pt, w, h)
        l_axis, l_flip, l_d0 = rw.light_ref_statics(
            fc.local_space_light_pt, n)
        args = (density, jnp.asarray(fc.local_space_light_pt),
                jnp.asarray(fc.screen_to_local),
                jnp.asarray(fc.local_space_eye_pt),
                jnp.asarray([0.0, 0.2, 0.4], jnp.float32))

        def render_body(c, a, n=n, m=m, axis=axis, flip=flip, swap=swap,
                        l_axis=l_axis, l_flip=l_flip, l_d0=l_d0):
            density, light, s2l, eye, clear = a
            d2 = density + c * 1e-38
            lv = rw.light_sweep_ref(d2, light, n, l_axis, l_flip, l_d0)
            img = rw._shearwarp_core(d2, lv, s2l, eye, clear, n, m, w, h,
                                     axis, flip, swap, ss=2)
            return img[0, 0, 0]

        slope(render_body, f"-hq render {w}x{h} from {n}^3",
              f"render_{h}p_grid{n}_hq_ms", args=args)

    # ---- ray-stab query (the reference's rule) at n_lo ---------------------
    b = s_lo.buffers
    accel = build_raystab_accel2(b.positions_norm, b.tris, b.normals, n_lo)

    def stab_body(c, levels):
        # the carry perturbs the coefficient tables by an exact no-op so
        # the query cannot be hoisted out of the scan
        levels = tuple(
            tuple((r, cf + c * 1e-38, sc, bd, nt)
                  for r, cf, sc, bd, nt in level)
            for level in levels
        )
        occ, _rgba = raystab_query2(
            b.positions_norm, b.normals, b.tris,
            dataclasses.replace(accel, levels=levels),
        )
        return c + occ[0, 0, 0].astype(jnp.float32)

    slope(stab_body, f"raystab query {n_lo}^3", f"raystab_query_{n_lo}_ms",
          args=accel.levels)
    return secondaries, head * 1e3


if __name__ == "__main__":
    sys.exit(main())
