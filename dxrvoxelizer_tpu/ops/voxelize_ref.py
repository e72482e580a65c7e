"""Trusted reference (oracle) voxelizers in plain jax.numpy.

Two inside/outside rules, mirroring SURVEY.md section 7:

- :func:`voxelize_raystab_ref` — the reference's exact algorithm: one radial
  ray per voxel from the voxel center outward, closest hit, voxel is inside
  iff the interpolated (normalized) surface normal faces away:
  ``dot(n, dir) > 0.12`` (DXRVoxelizer.hlsl:44-53, 132-140). Also returns the
  normal grid the reference writes (``float4(Normal, 1.0)``,
  DXRVoxelizer.hlsl:83-84).
- :func:`voxelize_parity_ref` — axis-aligned column rays with
  intersection-parity counting (watertight; the default). This oracle
  *counts* crossings per voxel; the production work queue
  (ops/voxelize_queue.py) folds XOR masks — two independent reductions over identical per-triangle tests,
  the "dual path" analog of the reference's Core/EZ A/B (SURVEY.md section 4).

These are the correctness anchors: slow, obvious, and used to generate golden
grids for every other implementation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dxrvoxelizer_tpu.ops import intersect
from dxrvoxelizer_tpu.ops.geom import column_crossing, parity_tri_setup
from dxrvoxelizer_tpu.ops.packing import voxel_centers_norm

INSIDE_THRESHOLD = 0.12  # DXRVoxelizer.hlsl:5


@partial(jax.jit, static_argnames=("n", "ray_chunk", "tri_chunk", "rule"))
def voxelize_raystab_ref(
    verts_norm: jnp.ndarray,
    normals: jnp.ndarray,
    tris: jnp.ndarray,
    n: int = 64,
    threshold: float = INSIDE_THRESHOLD,
    ray_chunk: int = 4096,
    tri_chunk: int = 2048,
    rule: str = "backface",
):
    """Reference-rule solid voxelization.

    Returns ``(occupancy[n,n,n] bool, rgba[n,n,n,4] float32)`` where rgba is
    the un-quantized ``float4(Normal, 1.0)`` write (zeros where outside).
    ``rule``: "backface" (the reference inside test) or "hit" (mark every
    voxel whose radial ray hits anything, storing its first-hit normal —
    the parity-mode normal-channel source).
    """
    cx, cy, cz = (jnp.asarray(t) for t in voxel_centers_norm(n))
    px = cx[:, None, None]
    py = cy[None, :, None]
    pz = cz[None, None, :]
    pos = jnp.stack(jnp.broadcast_arrays(px, py, pz), axis=-1).reshape(-1, 3)

    # generateRay (DXRVoxelizer.hlsl:44-53): origin = voxel center,
    # direction = normalize(center) — radially outward from the grid origin.
    length = jnp.linalg.norm(pos, axis=-1, keepdims=True)
    dirs = pos / jnp.maximum(length, 1e-20)

    v0, e1, e2 = intersect.triangle_soup(verts_norm, tris)
    n0 = normals[tris[:, 0]]
    n1 = normals[tris[:, 1]]
    n2 = normals[tris[:, 2]]

    def process(chunk):
        o, d = chunk
        t, u, v, idx = intersect.closest_hit(o, d, v0, e1, e2, tri_chunk=tri_chunk)
        hit = jnp.isfinite(t)
        # barycentric normal interpolation (DXRVoxelizer.hlsl:110-116)
        nrm = (
            n0[idx]
            + u[:, None] * (n1[idx] - n0[idx])
            + v[:, None] * (n2[idx] - n0[idx])
        )
        nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
        if rule == "hit":
            inside = hit
        else:
            inside = hit & (jnp.sum(nrm * d, axis=-1) > threshold)
        rgba = jnp.where(
            inside[:, None],
            jnp.concatenate([nrm, jnp.ones_like(t)[:, None]], axis=-1),
            0.0,
        )
        return inside, rgba

    num_rays = pos.shape[0]
    assert num_rays % ray_chunk == 0
    chunks = (pos.reshape(-1, ray_chunk, 3), dirs.reshape(-1, ray_chunk, 3))
    inside, rgba = jax.lax.map(process, chunks)
    return (
        inside.reshape(n, n, n),
        rgba.reshape(n, n, n, 4),
    )


@partial(jax.jit, static_argnames=("n", "ray_chunk", "tri_chunk", "rule",
                                   "normal_impl"))
def voxelize_raystab_radial_ref(
    verts_norm: jnp.ndarray,
    normals: jnp.ndarray,
    tris: jnp.ndarray,
    n: int = 64,
    threshold: float = INSIDE_THRESHOLD,
    ray_chunk: int = 4096,
    tri_chunk: int = 2048,
    rule: str = "backface",
    normal_impl: str = "radial",
):
    """Reference-rule voxelization via the radial-form intersection.

    Ground truth for the gen-2 binned/Pallas ray-stab path
    (ops/raystab_fast.build_raystab_accel2): same ray set and inside rule as
    :func:`voxelize_raystab_ref`, but the closest-hit winner is picked with
    the radial-form test (intersect.radial_hit — exploits origin = s0 * dir,
    DXRVoxelizer.hlsl:44-53) instead of Moller-Trumbore.

    ``normal_impl`` picks the winner-normal interpolation chain:

    - "radial" (default, the production gen-3 contract): barycentrics from
      the radial signed volumes — ``w_i = d . g_i``, ``den = (w0+w1)+w2``,
      ``nrm = normalize((w0 n0 + w1 n1 + w2 n2) / den)`` — the exact
      expressions the fold kernel carries in its in-strip finalize
      (raystab_pallas.finish_channels), so the fast path matches
      bit-for-bit (up to FMA contraction on the GPU, see chip_smoke.py).
    - "mt": the legacy mt_hit (u, v) interpolation, bit-identical to the
      Moller-Trumbore oracle's normals (used by the oracle-vs-oracle test).
    """
    cx, cy, cz = (jnp.asarray(t) for t in voxel_centers_norm(n))
    px = cx[:, None, None]
    py = cy[None, :, None]
    pz = cz[None, None, :]
    pos = jnp.stack(jnp.broadcast_arrays(px, py, pz), axis=-1).reshape(-1, 3)
    length = jnp.linalg.norm(pos, axis=-1, keepdims=True)
    dirs = pos / jnp.maximum(length, 1e-20)
    s0 = length[:, 0]

    g0, g1, g2, c = intersect.radial_setup(verts_norm, tris)
    v0, e1, e2 = intersect.triangle_soup(verts_norm, tris)
    n0 = normals[tris[:, 0]]
    n1 = normals[tris[:, 1]]
    n2 = normals[tris[:, 2]]
    t_count = tris.shape[0]

    def process(chunk):
        o, d, s = chunk
        t, idx = intersect.radial_closest_hit(
            d, s, g0, g1, g2, c, tri_chunk=tri_chunk
        )
        hit = jnp.isfinite(t) & (idx < t_count)
        idx = jnp.where(hit, idx, 0)
        if normal_impl == "radial":
            dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
            gg0, gg1, gg2 = g0[idx], g1[idx], g2[idx]
            # w / den / ns chains verbatim from the fold's finalize
            # (raystab_pallas.finish_channels) — shared bit contract
            w0 = dx * gg0[:, 0] + dy * gg0[:, 1] + dz * gg0[:, 2]
            w1 = dx * gg1[:, 0] + dy * gg1[:, 1] + dz * gg1[:, 2]
            w2 = dx * gg2[:, 0] + dy * gg2[:, 1] + dz * gg2[:, 2]
            den = (w0 + w1) + w2
            n0i, n1i, n2i = n0[idx], n1[idx], n2[idx]
            nsx = w0 * n0i[:, 0] + w1 * n1i[:, 0] + w2 * n2i[:, 0]
            nsy = w0 * n0i[:, 1] + w1 * n1i[:, 1] + w2 * n2i[:, 1]
            nsz = w0 * n0i[:, 2] + w1 * n1i[:, 2] + w2 * n2i[:, 2]
            dn = jnp.where(den == 0.0, 1.0, den)
            nx, ny, nz = nsx / dn, nsy / dn, nsz / dn
            # scalarized norm + dot chains, shared shape with the fold's
            # finalize (raystab_pallas.finish_channels)
            ss = (nx * nx + ny * ny) + nz * nz
            ln = jnp.maximum(jnp.sqrt(ss), 1e-20)
            nx, ny, nz = nx / ln, ny / ln, nz / ln
            if rule == "hit":
                inside = hit
            else:
                dot = (nx * dx + ny * dy) + nz * dz
                inside = hit & (dot > threshold)
            one = jnp.ones_like(nx)
            rgba = jnp.stack(
                [jnp.where(inside, nx, 0.0), jnp.where(inside, ny, 0.0),
                 jnp.where(inside, nz, 0.0), jnp.where(inside, one, 0.0)],
                axis=-1,
            )
            return inside, rgba
        _, u, v, _ = intersect.mt_hit(o, d, v0[idx], e1[idx], e2[idx])
        nrm = (
            n0[idx]
            + u[:, None] * (n1[idx] - n0[idx])
            + v[:, None] * (n2[idx] - n0[idx])
        )
        nrm = nrm / jnp.maximum(
            jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20
        )
        if rule == "hit":
            inside = hit
        else:
            inside = hit & (jnp.sum(nrm * d, axis=-1) > threshold)
        rgba = jnp.where(
            inside[:, None],
            jnp.concatenate([nrm, jnp.ones_like(t)[:, None]], axis=-1),
            0.0,
        )
        return inside, rgba

    num_rays = pos.shape[0]
    assert num_rays % ray_chunk == 0
    chunks = (
        pos.reshape(-1, ray_chunk, 3),
        dirs.reshape(-1, ray_chunk, 3),
        s0.reshape(-1, ray_chunk),
    )
    inside, rgba = jax.lax.map(process, chunks)
    return (
        inside.reshape(n, n, n),
        rgba.reshape(n, n, n, 4),
    )


@partial(jax.jit, static_argnames=("n", "tri_chunk", "x_slab"))
def voxelize_parity_ref(
    verts_norm: jnp.ndarray,
    tris: jnp.ndarray,
    n: int = 64,
    tri_chunk: int = 1024,
    x_slab: int | None = None,
    x_offset: jnp.ndarray | int = 0,
):
    """Axis-parity solid voxelization oracle -> occupancy [x_slab,n,n] bool.

    Counts, per voxel column, the crossings strictly above each voxel center
    and takes the parity. Independent reduction from the production kernel's
    XOR fold (see ops/voxelize_queue.py) over the shared per-triangle setup.

    ``x_slab``/``x_offset`` restrict computation to grid-x rows
    [x_offset, x_offset + x_slab) — the unit of multi-chip sharding
    (parallel/shard.py); the offset may be traced (e.g. from axis_index).
    """
    pt = parity_tri_setup(verts_norm, tris, n)
    num_tris = tris.shape[0]
    pad = (-num_tris) % tri_chunk
    if pad:
        pt = jax.tree.map(lambda x: jnp.pad(x, (0, pad)), pt)
    n_chunks = pt.valid.shape[0] // tri_chunk
    pt_chunks = jax.tree.map(lambda x: x.reshape(n_chunks, tri_chunk), pt)

    # column centers in index space are the integers 0..n-1
    x_slab = n if x_slab is None else x_slab
    gx = (
        jnp.arange(x_slab, dtype=jnp.float32) + jnp.float32(x_offset)
    )[:, None, None]  # [x_slab,1,1]
    gy = jnp.arange(n, dtype=jnp.float32)[None, :, None]  # [1,n,1]

    def body(counts, ptc):
        covered, m = column_crossing(ptc, gx, gy)  # [n,n,Tc]
        m = jnp.clip(m, 0, n)

        def k_body(k, cnts):
            contrib = (covered & (k < m)).sum(axis=-1, dtype=jnp.int32)
            return cnts.at[:, :, k].add(contrib)

        return jax.lax.fori_loop(0, n, k_body, counts), None

    counts0 = jnp.zeros((x_slab, n, n), dtype=jnp.int32)
    counts, _ = jax.lax.scan(body, counts0, pt_chunks)
    return (counts & 1).astype(bool)
