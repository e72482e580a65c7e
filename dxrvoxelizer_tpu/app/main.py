"""Application shell: CLI, frame loop, FPS stats, capture sinks.

The reference app (DXRVoxelizer/DXRVoxelizer.cpp) runs an interactive Win32
loop with an orbit camera, 1 Hz FPS stats in the window title
(CalculateFrameStats, :553-584), F11 PNG screenshots (:531-551) and runtime
path switching with X (:295-297). Headless analog:

- same CLI surface (``-mesh <file> [x y z scale]``, ``-warp`` -> CPU backend,
  ``-``/``/`` prefixes accepted, DXRVoxelizer.cpp:363-408) plus explicit
  extensions (``-grid``, ``-width``, ``-height``, ``-frames``, ...);
- a frame loop that orbits the camera (the mouse-drag analog), prints FPS at
  1 Hz, and writes PNG / .npy artifacts.
"""

from __future__ import annotations

import sys

import numpy as np

from dxrvoxelizer_tpu.ez import Engine
from dxrvoxelizer_tpu.models.camera import OrbitCamera
from dxrvoxelizer_tpu.utils.config import parse_args
from dxrvoxelizer_tpu.utils.image import save_grid_npy, screenshot_name, write_png
from dxrvoxelizer_tpu.utils.timer import StepTimer


def _parse_extras(argv: list[str]) -> dict:
    """Extension flags beyond the reference's (reference-style prefixes)."""
    out = {
        "frames": 8,
        "out": None,
        "save_grid": None,
        "orbit": True,
        "vox_impl": "auto",
        "render_impl": "warp",
        "timings": False,
        "ab": False,
        "deform": False,
        "interactive": False,
        "load_grid": None,
        "profile": None,
        "chips": 0,
        "preview": None,  # None = off; -1 = auto port; else the port
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        key = a[1:].lower() if a[:1] in "-/" else ""
        if key == "frames" and i + 1 < len(argv):
            out["frames"] = int(argv[i + 1])
        elif key == "out" and i + 1 < len(argv):
            out["out"] = argv[i + 1]
        elif key == "savegrid" and i + 1 < len(argv):
            out["save_grid"] = argv[i + 1]
        elif key == "noorbit":
            out["orbit"] = False
        elif key == "voximpl" and i + 1 < len(argv):
            out["vox_impl"] = argv[i + 1]
        elif key == "renderimpl" and i + 1 < len(argv):
            out["render_impl"] = argv[i + 1]
        elif key == "timings":
            out["timings"] = True
        elif key == "ab":
            out["ab"] = True
        elif key == "deform":
            out["deform"] = True
        elif key == "interactive":
            out["interactive"] = True
        elif key == "loadgrid" and i + 1 < len(argv):
            out["load_grid"] = argv[i + 1]
        elif key == "profile" and i + 1 < len(argv):
            out["profile"] = argv[i + 1]
        elif key == "chips" and i + 1 < len(argv):
            out["chips"] = int(argv[i + 1])
        elif key == "preview":
            # optional port operand: -preview [PORT]
            port = -1
            if i + 1 < len(argv):
                try:
                    port = int(argv[i + 1])
                except ValueError:
                    port = -1
            out["preview"] = port
        i += 1
    return out


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    cfg = parse_args(argv)
    extras = _parse_extras(argv)

    if extras["chips"] > 1 and cfg.backend == "cpu":
        # -warp -chips N: N virtual host devices (must be set before the
        # CPU backend client initializes; tests/conftest.py recipe)
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={extras['chips']}"
            ).strip()

    from dxrvoxelizer_tpu.utils.backend import (
        enable_compile_cache,
        filter_benign_aot_noise,
        select_backend,
    )

    # the accelerator, or the CPU only when asked: -warp maps to the CPU
    # (DXRVoxelizer.cpp:392); a missing accelerator is an error, never a
    # silent CPU fallback
    filter_benign_aot_noise()
    platform = select_backend("cpu" if cfg.backend == "cpu" else "default")
    enable_compile_cache()

    engine = Engine(
        cfg,
        vox_impl=extras["vox_impl"],
        render_impl=extras["render_impl"],
        deforming=extras["deform"],
        chips=extras["chips"],
    )
    cam = OrbitCamera(cfg.width, cfg.height)
    timer = StepTimer()

    print(
        f"dxrvoxelizer_tpu: {cfg.mesh} "
        f"({engine.scene.buffers.num_triangles} tris) grid={cfg.grid_size}^3 "
        f"{cfg.width}x{cfg.height} mode={cfg.inside_mode} "
        f"vox={extras['vox_impl']} render={extras['render_impl']} "
        f"backend={platform}"
    )

    preview = None
    if extras["preview"] is not None:
        # live view (the swap-chain Present analog): open the printed URL
        # in any browser to watch frames as they render
        from dxrvoxelizer_tpu.app.preview import PreviewServer

        port = extras["preview"]
        preview = PreviewServer(port=0 if port < 0 else port)
        print(f"live preview: {preview.url}")

    if extras["interactive"]:
        # hotkey loop (Space/f/s/x/q — the reference's WndProc analog,
        # DXRVoxelizer.cpp:282-299); -frames still bounds it if given
        from dxrvoxelizer_tpu.app.interactive import run_interactive

        frames = run_interactive(
            engine, cam, extras["frames"], orbit=extras["orbit"],
            preview=preview,
        )
        print(f"rendered {frames} frames")
        if preview is not None:
            preview.close()
        return 0

    if extras["load_grid"]:
        # checkpoint/resume analog (SURVEY.md section 5): render a saved
        # occupancy grid without re-voxelizing
        import jax.numpy as jnp

        from dxrvoxelizer_tpu.core.pipeline import VoxelGrid, render
        from dxrvoxelizer_tpu.ops.packing import pack_bits_z

        occ = np.load(extras["load_grid"])
        if occ.dtype == np.int32 and occ.ndim == 3 and (
            occ.shape[2] * 32 == occ.shape[0]
        ):
            grid = VoxelGrid(words=jnp.asarray(occ))  # packed words
        else:
            grid = VoxelGrid(words=pack_bits_z(jnp.asarray(occ.astype(bool))))
        consts = engine.scene.update_frame(
            cam.eye, cam.view_proj, cfg.width, cfg.height
        )
        img = render(grid, consts, cfg, impl=extras["render_impl"])
        out = extras["out"] or screenshot_name()
        write_png(out, np.asarray(img))
        print(f"rendered saved grid {extras['load_grid']} -> {out}")
        return 0

    base_mesh = engine.pipeline.mesh
    img = None
    last_fps = 0.0
    import contextlib

    from dxrvoxelizer_tpu.utils.profiling import device_trace

    # -profile DIR: capture a JAX profiler trace of the frame loop
    # (the PIX-capture analog; view with tensorboard --logdir DIR)
    trace_ctx = (
        device_trace(extras["profile"]) if extras["profile"]
        else contextlib.nullcontext()
    )
    with trace_ctx:
        for frame in range(extras["frames"]):
            timer.tick()
            if preview is not None:
                # browser drag-orbit / wheel-zoom (the reference's window
                # input, DXRVoxelizer.cpp:301-356)
                preview.apply_camera_inputs(cam)
            if extras["orbit"] and frame:
                cam.orbit(12.0, 0.0)  # slow yaw, the mouse-drag analog
            if extras["deform"]:
                # deforming-geometry config (BASELINE.json): per-frame vertex
                # wobble along normals; re-bins + re-voxelizes every frame
                import dataclasses

                import jax.numpy as jnp

                t = frame / 15.0
                amp = 0.03 * np.sin(
                    2 * np.pi * t + np.asarray(base_mesh.positions_norm)[:, :1] * 5.0
                )
                engine.pipeline.mesh = dataclasses.replace(
                    base_mesh,
                    positions_norm=base_mesh.positions_norm
                    + jnp.asarray(amp) * base_mesh.normals,
                )
            engine.update_frame(frame % 3, cam.eye, cam.view_proj)
            img = engine.render(frame % 3)
            if preview is not None and preview.wants_frame():
                preview.publish(np.asarray(img))
            if timer.frames_per_second != last_fps:
                last_fps = timer.frames_per_second
                print(f"fps: {last_fps:.1f}")
    engine.sync()
    if preview is not None:
        preview.close()

    if extras["ab"]:
        # runtime A/B of the two voxelizer paths (the reference's X-key
        # Core/EZ switch analog, DXRVoxelizer.cpp:295-297): the production
        # voxelizer vs the jnp oracle must produce identical occupancy
        from dxrvoxelizer_tpu.core import render, voxelize

        engine.pipeline.mesh = base_mesh
        # the binned raystab query runs radial-form intersections, so its
        # bit-exact ground truth is the radial oracle
        oracle = "xla-radial" if cfg.inside_mode == "raystab" else "xla"
        a = voxelize(base_mesh, cfg.grid_size, mode=cfg.inside_mode, impl="auto")
        b = voxelize(base_mesh, cfg.grid_size, mode=cfg.inside_mode, impl=oracle)
        same = bool((np.asarray(a.words) == np.asarray(b.words)).all())
        print(f"A/B voxelizer paths identical: {same}")
        if not same:
            return 1
        # ...and the rendered images of the two full pipelines (primary vs
        # alternate), like the reference's visual Core/EZ equivalence: the
        # renderers are independent implementations (shear-warp vs gather),
        # so the bound is an image tolerance, not bit-equality
        consts_ab = engine.scene.update_frame(
            cam.eye, cam.view_proj, cfg.width, cfg.height
        )
        img_a = np.asarray(engine.render_grid(a, consts_ab))
        img_b = np.asarray(
            render(b, consts_ab, cfg, impl="gather")
        )
        mean_err = float(np.abs(img_a - img_b).mean())
        p99_err = float(np.percentile(np.abs(img_a - img_b), 99))
        ok_img = mean_err < 0.03 and p99_err < 0.35
        print(
            f"A/B rendered images: mean|err|={mean_err:.4f} "
            f"p99={p99_err:.4f} -> {'OK' if ok_img else 'FAIL'}"
        )
        if not ok_img:
            return 1

    if img is not None:
        out = extras["out"] or screenshot_name()
        host = np.asarray(img)
        write_png(out, host)
        print(f"wrote {out}")
    if extras["save_grid"]:
        grid = engine.voxelize_only()
        save_grid_npy(extras["save_grid"], np.asarray(grid.occupancy()))
        print(f"wrote {extras['save_grid']}")

    if extras["timings"]:
        # one synchronous instrumented frame: per-pass wall-clock with fences
        from dxrvoxelizer_tpu.utils.profiling import PassTimers

        timers = PassTimers()
        consts = engine.scene.update_frame(
            cam.eye, cam.view_proj, cfg.width, cfg.height
        )
        for _ in range(3):
            with timers.measure("voxelize"):
                grid = engine.voxelize_only()
                grid.words.block_until_ready()
            with timers.measure("raycast"):
                img2 = engine.render_grid(grid, consts)
                img2.block_until_ready()
        print(f"pass timings (ms): {timers.summary()}")
    return 0
