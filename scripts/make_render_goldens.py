"""Generate 1280x720 canonical-scene render goldens + error report.

For each canonical scene (bunny, dragon, TuringBowl — the reference's
shipped assets + launcher posScale, Bin/*.bat) at the reference resolution
(1280x720, Main.cpp:17) and default camera:

- voxelize at 64^3 (production kernel; bit-exact vs the oracle by test),
- render with the shader-exact reference marcher (ops/raymarch_ref.py,
  128/32 samples — PSRayCast.hlsl:7-8),
- render with the production shear-warp renderer at several intermediate
  caps, and report max / p99 / mean absolute error per channel-pixel,
- write the reference image as a u8 PNG golden to tests/goldens/.

Run on the GPU (the ref march at 720p is gather-bound), with the assets
resolvable (utils/assets.py):
    python scripts/make_render_goldens.py [--out tests/goldens]
The printed JSON block is the source for PARITY.md's render-quality table.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SCENES = [
    ("bunny", "bunny.obj", (0.0, 0.0, 0.0, 1.0)),
    ("dragon", "dragon.obj", (0.0, 0.0, 0.0, 1.0)),
    ("turingbowl", "TuringBowl.obj", (0.0, 2.8, 0.0, 0.03)),
]


def main() -> int:
    out_dir = "tests/goldens"
    if "--out" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--out") + 1]
    os.makedirs(out_dir, exist_ok=True)

    import numpy as np

    from dxrvoxelizer_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from dxrvoxelizer_tpu.core.pipeline import render, voxelize
    from dxrvoxelizer_tpu.models.camera import OrbitCamera
    from dxrvoxelizer_tpu.models.scene import Scene
    from dxrvoxelizer_tpu.ops.raymarch_ref import raymarch_ref
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu.utils.image import to_u8, write_png

    report = {}
    for name, mesh_file, pos_scale in SCENES:
        cfg = VoxelizerConfig(mesh=mesh_file, pos_scale=pos_scale,
                              grid_size=64, width=1280, height=720)
        scene = Scene.load(cfg)
        cam = OrbitCamera(cfg.width, cfg.height)
        fc = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
        grid = voxelize(scene.buffers, cfg.grid_size, mode="parity")
        density = grid.density()

        # band-chunked: one jit call per 48-row band, all dispatched
        # async and drained by ONE device_get
        import jax

        band = 48
        bands = []
        for y0 in range(0, cfg.height, band):
            bands.append(raymarch_ref(
                density, jnp.asarray(fc.screen_to_local),
                jnp.asarray(fc.local_space_eye_pt),
                jnp.asarray(fc.local_space_light_pt),
                jnp.asarray(np.array(cfg.clear_color, np.float32)),
                cfg.width, min(band, cfg.height - y0),
                y_offset=float(y0),
            ))
        img_ref = np.concatenate(jax.device_get(tuple(bands)), axis=0)
        print(f"# {name}: ref render done", file=sys.stderr)
        golden_path = os.path.join(out_dir, f"render_{name}_720p.png")
        write_png(golden_path, img_ref)
        print(f"# wrote {golden_path}", file=sys.stderr)

        entry = {"golden": os.path.basename(golden_path), "caps": {}}
        for cap in (128, 256, 512):
            img_w = np.asarray(render(
                grid, fc, cfg.replace(intermediate_cap=cap), impl="warp"
            ))
            err = np.abs(img_w - img_ref)
            # also in golden-u8 space: what the CI test can reproduce
            err_u8 = np.abs(
                to_u8(img_w).astype(np.int32) - to_u8(img_ref).astype(np.int32)
            )
            entry["caps"][cap] = {
                "max": round(float(err.max()), 4),
                "p99": round(float(np.percentile(err, 99)), 4),
                "mean": round(float(err.mean()), 5),
                "u8_max": int(err_u8.max()),
                "u8_p99": float(np.percentile(err_u8, 99)),
                "u8_mean": round(float(err_u8.mean()), 3),
            }
            print(f"# {name} cap={cap}: {entry['caps'][cap]}",
                  file=sys.stderr)
        report[name] = entry

    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
