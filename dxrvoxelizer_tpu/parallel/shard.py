"""Multi-chip frame step via shard_map (the scale-out path).

Design (SURVEY.md section 5 "distributed communication backend"):

- **voxelize**: data-parallel over voxel columns — each device computes the
  occupancy of its grid-x slab (triangles replicated; the parity test is
  embarrassingly parallel over columns);
- **grid exchange**: one ``all_gather`` of the slab occupancies — the only
  collective in the frame;
- **ray-march**: data-parallel over screen rows — each device renders a
  horizontal band of the image from the gathered grid.

Everything happens inside a single ``shard_map``-ped, jitted frame function,
so XLA overlaps the collective with compute where possible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from dxrvoxelizer_tpu.ops.raymarch_fast import (
    precompute_light_volume,
    raymarch_fast,
)
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref


def sharded_frame(
    mesh: Mesh,
    n: int,
    width: int,
    height: int,
    n_samples: int = 64,
    n_light: int = 16,
):
    """Build the jitted multi-chip frame step.

    Returns ``frame(verts_norm, tris, s2l, eye, light, clear) -> image``
    with the image sharded row-wise over the mesh axis. Grid-x and screen
    rows must divide the axis size.
    """
    (axis,) = mesh.axis_names
    n_dev = mesh.devices.size
    assert n % n_dev == 0, f"grid {n} not divisible by {n_dev} devices"
    assert height % n_dev == 0, f"height {height} not divisible by {n_dev}"
    slab = n // n_dev
    band = height // n_dev

    def frame(verts_norm, tris, s2l, eye, light, clear):
        d = jax.lax.axis_index(axis)

        # pass 1: my x-slab of the occupancy grid (replicated triangles)
        occ_local = voxelize_parity_ref(
            verts_norm, tris, n=n, x_slab=slab, x_offset=d * slab
        )

        # the frame's one collective: assemble the full grid
        occ_full = jax.lax.all_gather(occ_local, axis, axis=0, tiled=True)
        density = occ_full.astype(jnp.float32)

        # pass 2: light field (cheap, replicated) + my screen band
        lv = precompute_light_volume(density, light, n_light=n_light)
        img_band = raymarch_fast(
            density, lv, s2l, eye, clear, width, band,
            n_samples=n_samples,
            y_offset=(d * band).astype(jnp.float32),
        )
        return img_band

    shmapped = jax.shard_map(
        frame,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=P(axis, None, None),
        check_vma=False,
    )

    rep = NamedSharding(mesh, P())

    @jax.jit
    def run(verts_norm, tris, s2l, eye, light, clear):
        args = jax.tree.map(lambda x: jax.lax.with_sharding_constraint(x, rep),
                            (verts_norm, tris, s2l, eye, light, clear))
        return shmapped(*args)

    return run


def _light_mode(light_local, n: int) -> tuple[int, bool, str]:
    """Host statics for a POINT light field: (axis, flip, mode).

    The same decision as ops/raymarch_warp.light_sweep_point_host, hoisted
    to compile time so the sharded frame stays a single jitted program:
    the perspective slab sweep ("persp") needs the light outside the
    volume along its major axis; otherwise the exact per-voxel march
    ("exact") is used.
    """
    from dxrvoxelizer_tpu.ops.raymarch_warp import TEX_SCALE

    l_t = np.asarray(TEX_SCALE) * np.asarray(light_local) + 0.5
    axis = int(np.argmax(np.abs(l_t - 0.5)))
    flip = bool(l_t[axis] < 0.5)
    lz = 1.0 - l_t[axis] if flip else l_t[axis]
    mode = "exact" if lz <= 1.0 + 1.0 / n else "persp"
    return axis, flip, mode


def light_volume_from_statics(density, light, n: int, l_axis: int,
                              l_flip: bool, l_mode: str, n_light: int = 32,
                              l_d0: int = 0):
    """Traced light-field dispatch on the host-derived mode statics —
    usable inside shard_map bodies (no data-dependent control flow)."""
    from dxrvoxelizer_tpu.ops import raymarch_warp as rw

    if l_mode == "persp":
        return rw.light_sweep_point(density, light, n, l_axis, l_flip)
    if l_mode == "exact":
        return precompute_light_volume(
            density, light, n_light=n_light, point_light=True
        )
    if l_mode == "ref":
        # -hq: the reference-step directional field (raymarch_warp
        # light_sweep_ref; d0 from light_ref_statics)
        return rw.light_sweep_ref(
            density, light, n, l_axis, l_flip, l_d0, n_light=n_light
        )
    if l_mode == "exact-dir":
        # -hq on a grid too small for the slab recurrence (d0 < 1):
        # the exact per-voxel directional march, light_sweep_ref_host's
        # own fallback
        return precompute_light_volume(density, light, n_light=n_light)
    return rw.light_sweep(density, light, n, l_axis, l_flip)


def frame_statics(consts, width: int, height: int, m_cap: int = 128,
                  point_light: bool = False, grid_size: int | None = None,
                  render_ss: int = 1):
    """Host-derived compile-time statics of the fast multi-chip frame.

    ``(warp axis, flip, swap, intermediate m, light axis, light flip,
    light mode, render ss, light d0)`` — hashable; cache
    compiled frames keyed on this tuple and rebuild when an orbiting camera
    crosses a major-axis boundary (parallel/pipeline.py does).
    ``point_light`` selects the point-light field mode (needs ``grid_size``
    for the outside-the-volume check); ``render_ss > 1`` is the -hq mode
    (z-supersampled warp + reference-step light field — same selection as
    core.pipeline.render); the light mode is "dir" | "persp" | "exact" |
    "ref" | "exact-dir".
    """
    from dxrvoxelizer_tpu.ops import raymarch_warp as rw

    waxis, wflip, wswap, m = rw.shearwarp_statics(
        consts.screen_to_local, consts.local_space_eye_pt, width, height,
        m_cap=m_cap,
    )
    l_d0 = 0
    if point_light:
        assert grid_size is not None, "point-light statics need grid_size"
        l_axis, l_flip, l_mode = _light_mode(
            consts.local_space_light_pt, grid_size
        )
    elif render_ss > 1:
        assert grid_size is not None, "-hq statics need grid_size"
        l_axis, l_flip, l_d0 = rw.light_ref_statics(
            consts.local_space_light_pt, grid_size
        )
        if l_d0 >= 1:
            l_mode = "ref"
        else:  # tiny grid: light_sweep_ref_host's exact fallback
            l_axis, l_flip = rw.light_statics(consts.local_space_light_pt)
            l_mode, l_d0 = "exact-dir", 0
    else:
        l_axis, l_flip = rw.light_statics(consts.local_space_light_pt)
        l_mode = "dir"
    return (waxis, wflip, wswap, m, l_axis, l_flip, l_mode, int(render_ss),
            l_d0)


def sharded_frame_fast(
    mesh: Mesh,
    n: int,
    width: int,
    height: int,
    tris_count: int,
    sample_consts=None,
    num_chunks_cap: int = 512,
    k_chunk: int = 64,
    interpret: bool = False,
    statics: tuple | None = None,
    render_impl: str = "warp",
    n_samples: int = 128,
    n_light: int = 32,
    point_light: bool = False,
):
    """Production multi-chip frame: the work queue and the shear-warp under
    ``shard_map``.

    - voxelize: each device runs the device-layout queue build restricted to
      its TILE GROUP plus the queue fold (ops/voxelize_queue.py) — binning
      is embarrassingly parallel, so triangles are replicated and no
      collective runs until...
    - grid exchange: ONE ``all_gather`` of the per-group packed words
      (2 MB at 256^3);
    - render: each device shear-warps its horizontal screen band from the
      gathered grid (compositing over the small intermediate is replicated;
      the per-pixel resolve is band-local).

    The shear-warp orientation statics come from ``statics`` (a
    :func:`frame_statics` tuple) or are derived from ``sample_consts`` (a
    FrameConstants); a camera crossing a major-axis boundary needs a
    rebuild — :class:`~dxrvoxelizer_tpu.parallel.pipeline.
    ShardedFramePipeline` re-derives them per frame and caches compiled
    frames per orientation. ``interpret`` runs the kernels in interpret
    mode (tests on a CPU mesh); otherwise ops/route.py picks the fold.

    ``render_impl``: "warp" (shear-warp, orientation statics required) or
    "gather" (the loop-free gather ray-marcher — orientation-free, so
    ``statics`` is unused). ``point_light`` selects the point-light field
    in either renderer (warp reads the mode from the statics tuple).
    """
    from dxrvoxelizer_tpu.ops.packing import unpack_bits_z
    from dxrvoxelizer_tpu.ops import raymarch_warp as rw

    (axis,) = mesh.axis_names
    n_dev = mesh.devices.size
    assert height % n_dev == 0, f"height {height} not divisible by {n_dev}"
    vox_group = _group_voxelizer(mesh, n, num_chunks_cap, k_chunk, interpret)
    band = height // n_dev

    if render_impl == "warp":
        if statics is None:
            assert sample_consts is not None, "need sample_consts or statics"
            statics = frame_statics(
                sample_consts, width, height, point_light=point_light,
                grid_size=n,
            )
        (waxis, wflip, wswap, m, l_axis, l_flip, l_mode, ss,
         l_d0) = statics

        def render_band(d, density, s2l, eye, light, clear):
            lv = light_volume_from_statics(
                density, light, n, l_axis, l_flip, l_mode, n_light=n_light,
                l_d0=l_d0,
            )
            return rw._shearwarp_core(
                density, lv, s2l, eye, clear, n, m, width, band,
                waxis, wflip, wswap,
                y_off=(d * band).astype(jnp.float32).reshape(()),
                ss=ss,
            )
    elif render_impl == "gather":

        def render_band(d, density, s2l, eye, light, clear):
            lv = precompute_light_volume(
                density, light, n_light=n_light, point_light=point_light
            )
            return raymarch_fast(
                density, lv, s2l, eye, clear, width, band,
                n_samples=n_samples,
                y_offset=(d * band).astype(jnp.float32),
            )
    else:
        raise ValueError(f"unknown sharded render impl {render_impl!r}")

    def frame(verts_norm, tris, s2l, eye, light, clear):
        d = jax.lax.axis_index(axis)
        words = vox_group(verts_norm, tris)
        density = unpack_bits_z(words, n).astype(jnp.float32)
        return render_band(d, density, s2l, eye, light, clear)

    shmapped = jax.shard_map(
        frame,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=P(axis, None, None),
        check_vma=False,
    )

    rep = NamedSharding(mesh, P())

    @jax.jit
    def run(verts_norm, tris, s2l, eye, light, clear):
        args = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, rep),
            (verts_norm, tris, s2l, eye, light, clear),
        )
        return shmapped(*args)

    return run


def _group_voxelizer(mesh: Mesh, n: int, num_chunks_cap: int,
                     k_chunk: int, interpret: bool):
    """The per-device voxelize body of the sharded frames (call it inside
    ``shard_map``): build this device's TILE GROUP queue fully on device,
    fold it, and ``all_gather`` the groups -> packed words [N, N, N//32],
    replicated."""
    from dxrvoxelizer_tpu.ops.voxelize_queue import (
        TILE_X,
        TILE_Y,
        _build_queue_device,
        _fold_for,
        _tiles_to_grid,
    )

    (axis,) = mesh.axis_names
    n_dev = mesh.devices.size
    n_tiles = (n // TILE_X) * (n // TILE_Y)
    assert n_tiles % n_dev == 0, f"{n_tiles} tiles not divisible by {n_dev}"
    tpd = n_tiles // n_dev
    fold = _fold_for(interpret)

    def vox(verts_norm, tris):
        lo = jax.lax.axis_index(axis) * tpd
        coefs, row0, count, _ok = _build_queue_device(
            verts_norm, tris, n, num_chunks_cap, k_chunk, 4, 8,
            tile_lo=lo, n_win=tpd,
        )
        group = fold(coefs, row0, count, lo, n)
        # the frame's one collective: assemble all tile groups
        tiles_all = jax.lax.all_gather(group, axis, axis=0, tiled=True)
        return _tiles_to_grid(tiles_all, n)

    return vox


def sharded_voxelize(
    mesh: Mesh,
    n: int,
    num_chunks_cap: int,
    k_chunk: int = 64,
    interpret: bool = False,
):
    """Collective multi-chip parity voxelize (the ONE mechanism).

    Returns a jitted ``vox(verts_norm, tris) -> packed words [N,N,N//32]``
    (replicated). Each device builds the queue slice for its contiguous
    tile group fully on device (no host sync — deforming meshes re-bin
    every frame) and folds it; the only cross-chip traffic is one
    ``all_gather`` of the packed tile outputs (2 MB at 256^3).
    Bit-identical to the single-chip queue.

    ``num_chunks_cap`` is the static per-device queue capacity: frames
    whose densest tile group exceeds it produce truncated queues — size it
    from the rest mesh like ops/voxelize_queue.DeformingVoxelizer does
    (parallel/pipeline.py sizes it with :func:`queue_capacity`).
    """
    vox = _group_voxelizer(mesh, n, num_chunks_cap, k_chunk, interpret)
    shmapped = jax.shard_map(
        vox, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
        check_vma=False,
    )
    rep = NamedSharding(mesh, P())

    @jax.jit
    def run(verts_norm, tris):
        verts_norm = jax.lax.with_sharding_constraint(verts_norm, rep)
        tris = jax.lax.with_sharding_constraint(tris, rep)
        return shmapped(verts_norm, tris)

    return run


def queue_capacity(verts_norm, tris, n: int, n_groups: int,
                   k_chunk: int = 64, headroom: float = 1.5) -> int:
    """Per-group queue chunk capacity sized from a rest mesh.

    Same rule as ops/voxelize_queue.DeformingVoxelizer: the densest group's
    chunk count x ``headroom`` (absorbing cross-group drift under
    deformation), rounded up to 128.
    """
    from dxrvoxelizer_tpu.ops.voxelize_queue import TILE_X, TILE_Y, build_queue

    n_tiles = (n // TILE_X) * (n // TILE_Y)
    tiles_grp = n_tiles // n_groups
    _, row0, count, _ = build_queue(verts_norm, tris, n, k_chunk=k_chunk)
    chunks = (np.asarray(count) + k_chunk - 1) // k_chunk  # per tile
    per_group = chunks.reshape(n_groups, tiles_grp).sum(axis=1)
    cap = int(per_group.max() * headroom) + 8
    return -(-cap // 128) * 128


def voxelize_parity_multichip(
    verts_norm,
    tris,
    n: int,
    devices: list | None = None,
    k_chunk: int = 64,
    interpret: bool = False,
):
    """Stateless multi-chip parity voxelize -> packed words [N,N,N//32].

    Convenience wrapper over :func:`sharded_voxelize` (one extra host-side
    phase-A pass to size the queue capacity); hold a
    :class:`~dxrvoxelizer_tpu.parallel.pipeline.ShardedFramePipeline` (or
    call :func:`sharded_voxelize` directly) for per-frame use.
    """
    from dxrvoxelizer_tpu.parallel.mesh import make_device_mesh
    from dxrvoxelizer_tpu.ops.voxelize_queue import TILE_X, TILE_Y

    devices = list(jax.devices()) if devices is None else list(devices)
    n_tiles = (n // TILE_X) * (n // TILE_Y)
    n_dev = len(devices)
    while n_tiles % n_dev:
        n_dev -= 1
    mesh = Mesh(np.array(devices[:n_dev]), ("slab",))
    cap = queue_capacity(verts_norm, tris, n, n_dev, k_chunk=k_chunk)
    vox = sharded_voxelize(mesh, n, cap, k_chunk=k_chunk, interpret=interpret)
    return vox(verts_norm, tris)
