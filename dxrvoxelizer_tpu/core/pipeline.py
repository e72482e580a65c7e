"""Explicit pass functions + frame pipeline.

The reference's per-frame loop (Content/Voxelizer.cpp:108-113):
``Render = voxelize() ; renderRayCast()`` against triple-buffered grids
(FrameCount = 3, Voxelizer.h:24). Here the two passes are jitted functions
over HBM arrays; "descriptor tables" and "barriers" vanish into XLA dataflow,
and frames-in-flight are simply async dispatches kept un-synced until the
host reads a frame back.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.models.mesh import MeshBuffers
from dxrvoxelizer_tpu.models.scene import FrameConstants
from dxrvoxelizer_tpu.ops import voxelize_ref
from dxrvoxelizer_tpu.ops.packing import quantize_r10g10b10a2, unpack_bits_z
from dxrvoxelizer_tpu.ops.raymarch_fast import (
    precompute_light_volume,
    raymarch_fast,
)
from dxrvoxelizer_tpu.ops.raymarch_ref import raymarch_ref
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig

FRAME_COUNT = 3  # frames in flight (reference: Voxelizer.h:24)


@jax.tree_util.register_pytree_node_class
@dataclass
class VoxelGrid:
    """One voxelization result.

    ``words``: packed occupancy bits [N,N,N//32] int32 (production layout);
    ``rgba``: optional [N,N,N,4] float32 normal+alpha grid (the reference's
    R10G10B10A2 texture analog; present in raystab mode).
    """

    words: jax.Array
    rgba: jax.Array | None = None

    def tree_flatten(self):
        return (self.words, self.rgba), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n(self) -> int:
        return int(self.words.shape[0])

    def occupancy(self) -> jax.Array:
        return unpack_bits_z(self.words, self.n)

    def density(self) -> jax.Array:
        """Alpha channel as float (the raymarcher's input)."""
        if self.rgba is not None:
            return self.rgba[..., 3]
        return self.occupancy().astype(jnp.float32)


def voxelize(
    mesh: MeshBuffers,
    n: int,
    mode: str = "parity",
    impl: str = "auto",
    quantize: bool = True,
    accel=None,
    with_normals: bool = False,
) -> VoxelGrid:
    """Solid-voxelize a mesh -> :class:`VoxelGrid`.

    ``mode``: "parity" (axis-parity fill, the default) or "raystab"
    (the reference's radial back-face rule, DXRVoxelizer.hlsl:132-140).
    ``impl``: "auto" | "queue" | "xla" (raystab also: "xla-radial") — for
    parity, "auto" picks the work-queue voxelizer (ops/voxelize_queue.py,
    its fold chosen per platform by ops/route.py) wherever n % 32 == 0 and
    the jnp oracle otherwise; for raystab it picks the binned fast path.
    "xla" is always the brute-force oracle (for raystab the
    Moller-Trumbore form, the reference's own rule); "xla-radial" is the
    radial-form oracle that is bit-exact ground truth for the binned
    raystab query.
    """
    from dxrvoxelizer_tpu.ops.packing import pack_bits_z

    if mode == "raystab":
        if impl in ("auto", "fast", "queue"):
            # binned direction-space accel (ops/raystab_fast.py); a
            # stateless call rebuilds the accel — pass ``accel`` (or use
            # build_raystab_accel + raystab_query) for static geometry
            if accel is not None:
                from dxrvoxelizer_tpu.ops.raystab_fast import raystab_query

                occ, rgba = raystab_query(
                    mesh.positions_norm, mesh.normals, mesh.tris, accel
                )
            else:
                from dxrvoxelizer_tpu.ops.raystab_fast import (
                    voxelize_raystab_fast,
                )

                occ, rgba = voxelize_raystab_fast(
                    mesh.positions_norm, mesh.normals, mesh.tris, n=n
                )
        elif impl == "xla":
            # the Moller-Trumbore brute-force oracle — the reference's own
            # rule (DXR hardware MT intersection)
            occ, rgba = voxelize_ref.voxelize_raystab_ref(
                mesh.positions_norm, mesh.normals, mesh.tris, n=n
            )
        elif impl == "xla-radial":
            # the radial-form oracle: bit-exact ground truth of the binned
            # query; differs from "xla" only on fp-boundary near-ties
            # (ops/voxelize_ref.py)
            occ, rgba = voxelize_ref.voxelize_raystab_radial_ref(
                mesh.positions_norm, mesh.normals, mesh.tris, n=n
            )
        else:
            raise ValueError(f"unknown raystab impl {impl!r}")
        if quantize:
            rgba = quantize_r10g10b10a2(rgba)
        return VoxelGrid(words=pack_bits_z(occ), rgba=rgba)
    if mode != "parity":
        raise ValueError(f"unknown inside mode {mode!r}")

    if impl == "auto":
        impl = "queue" if _queue_ok(n) else "xla"
    if impl == "queue":
        from dxrvoxelizer_tpu.ops.voxelize_queue import voxelize_parity_queue

        words = voxelize_parity_queue(mesh.positions_norm, mesh.tris, n)
    elif impl == "xla":
        occ = voxelize_ref.voxelize_parity_ref(mesh.positions_norm, mesh.tris, n=n)
        words = pack_bits_z(occ)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    if not with_normals:
        return VoxelGrid(words=words)
    return VoxelGrid(
        words=words,
        rgba=_parity_rgba(mesh, words, n, accel=accel, quantize=quantize),
    )


def _parity_rgba(mesh: MeshBuffers, words: jax.Array, n: int, accel=None,
                 quantize: bool = True) -> jax.Array:
    """Normal channel for a parity grid: the reference's grid always stores
    float4(Normal, 1.0) (DXRVoxelizer.hlsl:83-84). The normal content is
    the radial first-hit normal — computed by the same machinery the
    raystab mode uses (rule="hit" skips the back-face test) — gated by
    the parity occupancy bit."""
    occ_b = unpack_bits_z(words, n)
    if accel is None:
        accel = _build_stab_accel(mesh, n)
    if type(accel).__name__ == "RaystabAccel7":
        from dxrvoxelizer_tpu.ops.raystab_tiled import raystab_query7

        _, rgba_hit = raystab_query7(
            mesh.positions_norm, mesh.normals, mesh.tris, accel, rule="hit",
        )
    else:
        from dxrvoxelizer_tpu.ops.raystab_fast import raystab_query2

        _, rgba_hit = raystab_query2(
            mesh.positions_norm, mesh.normals, mesh.tris, accel, rule="hit",
        )
    occ_f = occ_b.astype(jnp.float32)[..., None]
    rgba = jnp.concatenate(
        [rgba_hit[..., :3] * occ_f, occ_f], axis=-1
    )
    if quantize:
        rgba = quantize_r10g10b10a2(rgba)
    return rgba


def _use_tiled_raystab(n: int) -> bool:
    """Gen routing for the raystab accel (see
    ops/raystab_tiled.use_tiled_raystab: gen-7 at n >= 128, gen-6 at
    the reference 64^3; DXRV_RAYSTAB_GEN=6|7 overrides)."""
    from dxrvoxelizer_tpu.ops.raystab_tiled import use_tiled_raystab

    return use_tiled_raystab(n)


def _build_stab_accel(mesh, n: int):
    """Fresh raystab accel: gen-7 tiles or gen-6 strips by grid size
    (_use_tiled_raystab)."""
    if _use_tiled_raystab(n):
        from dxrvoxelizer_tpu.ops.raystab_tiled import build_raystab_accel7

        return build_raystab_accel7(
            mesh.positions_norm, mesh.tris, mesh.normals, n
        )
    from dxrvoxelizer_tpu.ops.raystab_fast import build_raystab_accel2

    return build_raystab_accel2(
        mesh.positions_norm, mesh.tris, mesh.normals, n
    )


def _stab_accel_for(cfg, mesh):
    """The raystab accel for (cfg, mesh), through the on-disk cache when
    ``cfg.accel_cache`` (the reference ships precompiled pipeline blobs;
    utils/accel_cache.py is the AS-analog of that)."""
    n = cfg.grid_size
    if not getattr(cfg, "accel_cache", True):
        return _build_stab_accel(mesh, n)
    from dxrvoxelizer_tpu.utils import accel_cache as ac

    fn = (ac.cached_build_raystab_accel7 if _use_tiled_raystab(n)
          else ac.cached_build_raystab_accel2)
    return fn(mesh.positions_norm, mesh.tris, mesh.normals, n)


def _queue_ok(n: int) -> bool:
    """The work queue covers every grid size that is a multiple of 32."""
    return n % 32 == 0


def render(
    grid: VoxelGrid,
    consts: FrameConstants,
    cfg: VoxelizerConfig,
    impl: str = "warp",
    light_volume: jax.Array | None = None,
) -> jax.Array:
    """Ray-march a grid -> [H,W,3] float32 image.

    ``impl``: "warp" (shear-warp, the regular-access production path),
    "gather" (loop-free per-sample gather path), or "ref" (the
    shader-exact sequential reference). ``cfg.show_mip`` renders from that mip level of
    the grid (SharedConst.h:5); ``cfg.use_mutex`` selects the float-grid
    sampling path (no 2-bit alpha quantization, PSRayCast.hlsl:42-46).
    """
    density = grid.density()
    if cfg.show_mip > 0:
        from dxrvoxelizer_tpu.ops.mips import mip_level

        density = mip_level(
            density, cfg.show_mip, quantize_alpha=not cfg.use_mutex
        )
    clear = jnp.asarray(np.array(cfg.clear_color, np.float32))
    s2l = jnp.asarray(consts.screen_to_local)
    eye = jnp.asarray(consts.local_space_eye_pt)
    light = jnp.asarray(consts.local_space_light_pt)
    if impl == "ref":
        return raymarch_ref(
            density, s2l, eye, light, clear, cfg.width, cfg.height,
            n_samples=cfg.num_samples, n_light=cfg.num_light_samples,
            point_light=cfg.point_light,
        )
    if impl == "gather":
        if light_volume is None:
            light_volume = precompute_light_volume(
                density, light, n_light=cfg.num_light_samples,
                point_light=cfg.point_light,
            )
        return raymarch_fast(
            density, light_volume, s2l, eye, clear, cfg.width, cfg.height,
            n_samples=cfg.num_samples,
        )
    if impl not in ("warp", "fast"):  # "fast" kept as an alias
        raise ValueError(f"unknown renderer impl {impl!r}")
    from dxrvoxelizer_tpu.ops.raymarch_warp import (
        light_sweep_host,
        light_sweep_point_host,
        light_sweep_ref_host,
        raymarch_shearwarp,
    )

    if light_volume is None:
        if cfg.point_light:
            sweep = light_sweep_point_host
        elif cfg.render_ss > 1:
            # -hq: reference-step light field (the dominant error of the
            # fast sweep was its light model — docs/RENDER_QUALITY.md)
            sweep = light_sweep_ref_host
        else:
            sweep = light_sweep_host
        light_volume = sweep(
            density, consts.local_space_light_pt, density.shape[0]
        )
    return raymarch_shearwarp(
        density, light_volume, consts.screen_to_local,
        consts.local_space_eye_pt, np.array(cfg.clear_color, np.float32),
        cfg.width, cfg.height, m_cap=cfg.intermediate_cap,
        ss=cfg.render_ss,
    )


class FramePipeline:
    """Explicit per-frame orchestration with FRAME_COUNT slots in flight.

    The reference throttles the CPU to <= 3 recorded frames via a fence ring
    (DXRVoxelizer.cpp:496-529). XLA dispatch is already async; the analog is
    keeping up to FRAME_COUNT un-awaited frame results and blocking on the
    oldest before reusing its slot.
    """

    def __init__(self, cfg: VoxelizerConfig, mesh: MeshBuffers,
                 vox_impl: str = "auto", render_impl: str = "warp",
                 deforming: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.vox_impl = vox_impl
        self.render_impl = render_impl
        self.deforming = deforming
        self._inflight: list[jax.Array] = []
        self._stab_accel = None
        self._stab_mesh = None  # identity of the mesh the accel was built for
        self._deformer = None  # lazy DeformingVoxelizer (fixed topology)
        self._rest_mesh = mesh  # the refit pad is anchored to this pose
        self._refitter = None  # lazy RaystabRefitter (deforming raystab)
        self._refit_checked = False  # first-frame contract check done?
        self._static_vox = None  # build-once parity queue (static meshes)
        self._static_vox_mesh = None

    def _raystab_accel(self):
        """Build-once direction-space accel; rebuilt when ``self.mesh`` is
        replaced (the deforming-geometry path swaps the buffers object).

        Deforming + raystab goes through the per-frame REFIT instead (ops/raystab_refit.py): pad-conservative
        id tables built once from the rest pose, coefficient/normal
        tables regathered on device each frame — the DXR AS-update
        analog. A full rebuild per frame costs seconds of host binning;
        the refit is a few device gathers."""
        if self.deforming and self.cfg.deform_pad > 0.0:
            if self._refitter is None:
                if _use_tiled_raystab(self.cfg.grid_size):
                    from dxrvoxelizer_tpu.ops.raystab_tiled import (
                        RaystabTiledRefitter as RaystabRefitter,
                    )
                else:
                    from dxrvoxelizer_tpu.ops.raystab_refit import (
                        RaystabRefitter,
                    )

                # the engine's -deform animation displaces along vertex
                # normals, so the refit uses the directional (capsule)
                # bound — several-fold smaller candidate tables than the
                # any-direction ball (raystab_fast._capsule_params).
                # API callers deforming meshes off-axis should rebuild
                # with cfg.deform_dirs="any" (refit(check=True) verifies
                # the contract).
                dirs = (
                    self._rest_mesh.normals
                    if getattr(self.cfg, "deform_dirs", "normals")
                    == "normals" else None
                )
                self._refitter = RaystabRefitter(
                    self._rest_mesh.positions_norm, self._rest_mesh.tris,
                    self._rest_mesh.normals, self.cfg.grid_size,
                    pad=self.cfg.deform_pad,
                    use_cache=getattr(self.cfg, "accel_cache", True),
                    pad_dirs=dirs,
                )
            # validate the deformation contract (magnitude, axis, |s|
            # bound) on the FIRST refit frame — one host sync, then
            # trust the caller (an unchecked out-of-contract deformation
            # would silently produce non-conservative tables)
            do_check = not self._refit_checked
            self._refit_checked = True
            return self._refitter.refit(
                self.mesh.positions_norm, self.mesh.normals,
                check=do_check,
            )
        if self._stab_accel is None or self._stab_mesh is not self.mesh:
            self._stab_accel = _stab_accel_for(self.cfg, self.mesh)
            self._stab_mesh = self.mesh
        return self._stab_accel

    def frame(self, consts: FrameConstants) -> jax.Array:
        """Voxelize + render one frame (async); returns the device image."""
        # named scopes surface the two passes in jax.profiler traces (the
        # PIX BeginEvent/EndEvent analog, SURVEY.md section 5 tracing)
        accel = None
        want_normals = (
            self.cfg.inside_mode == "parity" and self.cfg.parity_normals
        )
        if (
            self.cfg.inside_mode == "raystab"
            and self.vox_impl not in ("xla", "xla-radial")
        ) or want_normals:
            accel = self._raystab_accel()
        with jax.named_scope("voxelize"):
            if (
                self.deforming
                and self.cfg.inside_mode == "parity"
                and not want_normals
                and self.vox_impl in ("auto", "queue")
                and _queue_ok(self.cfg.grid_size)
            ):
                # fixed-topology deforming path: device-only queue rebuild,
                # zero host syncs per frame (ops/voxelize_queue.py)
                if self._deformer is None:
                    from dxrvoxelizer_tpu.ops.voxelize_queue import (
                        DeformingVoxelizer,
                    )

                    self._deformer = DeformingVoxelizer(
                        self.mesh.positions_norm, self.mesh.tris,
                        self.cfg.grid_size,
                    )
                grid = VoxelGrid(
                    words=self._deformer(self.mesh.positions_norm)
                )
            elif (
                not self.deforming
                and self.cfg.inside_mode == "parity"
                and self.vox_impl in ("auto", "queue")
                and _queue_ok(self.cfg.grid_size)
            ):
                # STATIC parity path: build the binned queue once and per
                # frame only dispatch the fold — the reference's
                # build-AS-once (Voxelizer.cpp:264-326) + per-frame
                # DispatchRays-only (:351-369) split. Rebuilds only when
                # the mesh object is swapped.
                if (
                    self._static_vox is None
                    or self._static_vox_mesh is not self.mesh
                ):
                    from dxrvoxelizer_tpu.ops.voxelize_queue import (
                        StaticVoxelizer,
                    )

                    self._static_vox = StaticVoxelizer(
                        self.mesh.positions_norm, self.mesh.tris,
                        self.cfg.grid_size,
                    )
                    self._static_vox_mesh = self.mesh
                words = self._static_vox()
                rgba = None
                if want_normals:
                    rgba = _parity_rgba(
                        self.mesh, words, self.cfg.grid_size, accel=accel,
                        quantize=not self.cfg.use_mutex,
                    )
                grid = VoxelGrid(words=words, rgba=rgba)
            else:
                grid = voxelize(
                    self.mesh, self.cfg.grid_size, mode=self.cfg.inside_mode,
                    impl=self.vox_impl, quantize=not self.cfg.use_mutex,
                    accel=accel, with_normals=want_normals,
                )
        with jax.named_scope("raycast"):
            img = render(grid, consts, self.cfg, impl=self.render_impl)
        self._inflight.append(img)
        if len(self._inflight) > FRAME_COUNT:
            self._inflight.pop(0).block_until_ready()  # fence on oldest
        return img

    def sync(self) -> None:
        for img in self._inflight:
            img.block_until_ready()
        self._inflight.clear()
