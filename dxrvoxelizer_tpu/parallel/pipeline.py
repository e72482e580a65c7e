"""Multi-chip frame orchestration — the product surface of ``parallel/``.

:class:`ShardedFramePipeline` is a drop-in for
:class:`~dxrvoxelizer_tpu.core.pipeline.FramePipeline` that runs the whole
frame (queue voxelize + shear-warp render) as ONE ``shard_map``-ped jitted
program over a 1-D device mesh (parallel/shard.py). The reference app has no
multi-GPU analog (SURVEY.md section 2c: single-GPU, single-process); this is
the scale-out of its frame loop (DXRVoxelizer.cpp:258-270).

The shear-warp compile-time statics (view major axis/flip/swap, intermediate
resolution, light axis) depend on the camera: an orbiting camera crossing a
major-axis boundary changes them. They are re-derived from the frame
constants on the host every frame and compiled frames are cached per
statics tuple — steady orbits touch a handful of orientations, so after the
first lap every frame is a cache hit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.parallel.mesh import make_device_mesh
from dxrvoxelizer_tpu.parallel.shard import (
    frame_statics,
    queue_capacity,
    sharded_frame_fast,
)

FRAME_COUNT = 3  # matches core.pipeline (Voxelizer.h:24)


class ShardedFramePipeline:
    """FramePipeline-compatible multi-chip frame loop.

    Supports the shear-warp renderer (default) or the gather ray-marcher
    (``render_impl="gather"``), each with directional or point light
    (``cfg.point_light``), with either inside test: parity
    (queue voxelize, deforming-capable) or raystab (strip-sharded gen-4
    query over an init-built accel — parallel/raystab_shard.py; deforming
    meshes refit the accel per frame within ``cfg.deform_pad``,
    ops/raystab_refit.py).
    In parity mode the voxelize stage re-bins fully on device every frame
    (deforming meshes work by swapping ``self.mesh`` — fixed topology, like
    ops/voxelize_queue.DeformingVoxelizer), so ``frame`` issues zero host
    syncs after warmup.
    """

    def __init__(self, cfg, mesh_buffers, chips: int,
                 vox_impl: str = "auto", render_impl: str = "warp",
                 deforming: bool = False, k_chunk: int = 64,
                 interpret: bool = False):
        if cfg.inside_mode not in ("parity", "raystab"):
            raise ValueError(
                "-chips supports the parity and raystab inside modes "
                f"(got {cfg.inside_mode!r})"
            )
        if cfg.inside_mode == "raystab" and deforming and cfg.deform_pad <= 0:
            raise ValueError(
                "-chips deforming raystab needs a positive -deformpad (the "
                "per-frame refit's displacement bound, ops/raystab_refit.py)"
            )
        if render_impl not in ("warp", "fast", "auto", "gather"):
            raise ValueError(
                "-chips supports the warp and gather renderers "
                f"(got {render_impl!r})"
            )
        if cfg.height % chips:
            raise ValueError(
                f"height {cfg.height} not divisible by {chips} chips"
            )
        self.cfg = cfg
        self.mesh = mesh_buffers
        self.vox_impl = vox_impl
        self.render_impl = "gather" if render_impl == "gather" else "warp"
        self.deforming = deforming
        self.k_chunk = k_chunk
        self.device_mesh = make_device_mesh(chips)
        self.interpret = interpret
        # per-device queue capacity from the rest mesh (deformation head-
        # room absorbed by the DeformingVoxelizer sizing rule); parity only
        self.num_chunks_cap = None
        if cfg.inside_mode == "parity":
            self.num_chunks_cap = queue_capacity(
                mesh_buffers.positions_norm, mesh_buffers.tris,
                cfg.grid_size, chips, k_chunk=k_chunk,
                headroom=1.5 if deforming else 1.1,
            )
        self._frames: dict[tuple, object] = {}  # statics -> compiled frame
        self._clear = jnp.asarray(np.array(cfg.clear_color, np.float32))
        self._inflight: list[jax.Array] = []
        self.accel = None
        self.refitter = None
        self._refit_checked = False
        if cfg.inside_mode == "raystab":
            if deforming:
                # rest-pose padded AS + per-frame refit under the same
                # row sharding (ops/raystab_refit.py gen-6 strips at
                # 64^3, ops/raystab_tiled.py gen-7 tiles at >= 128^3)
                from dxrvoxelizer_tpu.ops.raystab_tiled import (
                    use_tiled_raystab,
                )

                if use_tiled_raystab(cfg.grid_size):
                    from dxrvoxelizer_tpu.ops.raystab_tiled import (
                        RaystabTiledRefitter as RaystabRefitter,
                    )
                else:
                    from dxrvoxelizer_tpu.ops.raystab_refit import (
                        RaystabRefitter,
                    )

                self.refitter = RaystabRefitter(
                    mesh_buffers.positions_norm, mesh_buffers.tris,
                    mesh_buffers.normals, cfg.grid_size,
                    pad=cfg.deform_pad,
                    use_cache=getattr(cfg, "accel_cache", True),
                    # -deform displaces along vertex normals (capsule
                    # bound; see core/pipeline.py)
                    pad_dirs=(
                        mesh_buffers.normals
                        if getattr(cfg, "deform_dirs", "normals")
                        == "normals" else None
                    ),
                )
            else:
                # init-built AS, strip-sharded per-frame re-trace
                # (parallel/raystab_shard.py); disk-cached like the
                # reference's precompiled pipeline blobs (-noaccelcache)
                from dxrvoxelizer_tpu.core.pipeline import _stab_accel_for

                self.accel = _stab_accel_for(cfg, mesh_buffers)

    def _frame_fn(self, statics: tuple):
        fn = self._frames.get(statics)
        if fn is None:
            render_kw = dict(
                render_impl=self.render_impl,
                n_samples=self.cfg.num_samples,
                n_light=self.cfg.num_light_samples,
                point_light=self.cfg.point_light,
            )
            if self.refitter is not None:
                from dxrvoxelizer_tpu.parallel.raystab_shard import (
                    sharded_frame_raystab_deforming,
                )

                fn = sharded_frame_raystab_deforming(
                    self.device_mesh, self.refitter, self.cfg.grid_size,
                    self.cfg.width, self.cfg.height, statics,
                    threshold=self.cfg.inside_threshold,
                    interpret=self.interpret, **render_kw,
                )
            elif self.accel is not None:
                from dxrvoxelizer_tpu.parallel.raystab_shard import (
                    sharded_frame_raystab,
                )

                fn = sharded_frame_raystab(
                    self.device_mesh, self.accel,
                    int(self.mesh.tris.shape[0]), self.cfg.grid_size,
                    self.cfg.width, self.cfg.height, statics,
                    threshold=self.cfg.inside_threshold,
                    interpret=self.interpret, **render_kw,
                )
            else:
                fn = sharded_frame_fast(
                    self.device_mesh, self.cfg.grid_size, self.cfg.width,
                    self.cfg.height, int(self.mesh.tris.shape[0]),
                    num_chunks_cap=self.num_chunks_cap, k_chunk=self.k_chunk,
                    interpret=self.interpret, statics=statics, **render_kw,
                )
            self._frames[statics] = fn
        return fn

    def frame(self, consts) -> jax.Array:
        """Voxelize + render one frame (async); returns the device image."""
        if self.render_impl == "gather":
            statics = ("gather",)  # orientation-free: one compiled frame
        else:
            statics = frame_statics(
                consts, self.cfg.width, self.cfg.height,
                m_cap=self.cfg.intermediate_cap,
                point_light=self.cfg.point_light,
                grid_size=self.cfg.grid_size,
                render_ss=self.cfg.render_ss,
            )
        fn = self._frame_fn(statics)
        # the deforming-raystab frame takes NORMALS where the others take
        # tris (the refit regathers the normal tables each frame)
        second = (
            self.mesh.normals if self.refitter is not None
            else self.mesh.tris
        )
        if self.refitter is not None and not self._refit_checked:
            # validate the deformation contract on the first refit frame
            # (one host sync — the sharded frame itself refits with no
            # check every frame)
            from dxrvoxelizer_tpu.ops.raystab_tiled import (
                check_deform_contract,
            )

            check_deform_contract(
                jnp.asarray(self.mesh.positions_norm),
                self.refitter._verts_rest, self.refitter.pad,
                self.refitter._pad_dirs,
            )
            self._refit_checked = True
        img = fn(
            self.mesh.positions_norm, second,
            jnp.asarray(consts.screen_to_local),
            jnp.asarray(consts.local_space_eye_pt),
            jnp.asarray(consts.local_space_light_pt),
            self._clear,
        )
        self._inflight.append(img)
        if len(self._inflight) > FRAME_COUNT:
            self._inflight.pop(0).block_until_ready()  # fence on oldest
        return img

    def sync(self) -> None:
        for img in self._inflight:
            img.block_until_ready()
        self._inflight.clear()
