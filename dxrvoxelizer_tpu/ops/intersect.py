"""Batched ray-triangle intersection primitives (jax.numpy).

The replacement for DXR's fixed-function ``TraceRay`` BVH traversal
(reference: DXRVoxelizer.hlsl:80): a no-culling Moller-Trumbore test over
triangle chunks with a running closest-hit reduction. Everything is static
shapes + ``lax.scan``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS_DET = 1e-10
T_MAX = 1e4  # ray.TMax (DXRVoxelizer.hlsl:77)


def triangle_soup(verts: jnp.ndarray, tris: jnp.ndarray):
    """Gather (v0, e1, e2) triangle soup from indexed buffers."""
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    return v0, v1 - v0, v2 - v0


def mt_hit(o, d, v0, e1, e2):
    """Moller-Trumbore test, broadcasting over leading dims -> (t, u, v, hit).

    ``o``/``d`` and ``v0``/``e1``/``e2`` must already be broadcast-compatible
    on their leading axes (last axis = xyz). No backface culling; t >= 0
    (TMin = 0, TMax = 1e4, DXRVoxelizer.hlsl:76-77). t = +inf on miss.

    Every implementation (the oracle's brute-force scan and the gen-1
    binned XLA query) shares
    this exact SCALARIZED expression sequence — component-wise cross/dot
    expansions, not jnp.cross/sum — so closest-hit results agree
    bit-for-bit even on boundary-exact hits where a different
    fused-multiply-add contraction would flip a comparison.
    """
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    v0x, v0y, v0z = v0[..., 0], v0[..., 1], v0[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(jnp.abs(det) > EPS_DET, 1.0 / det, 0.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (
        (jnp.abs(det) > EPS_DET)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
        & (t <= T_MAX)
    )
    t = jnp.where(hit, t, jnp.inf)
    return t, u, v, hit


def radial_setup(verts: jnp.ndarray, tris: jnp.ndarray):
    """Per-triangle coefficients for rays through the grid origin.

    The reference's voxelize rays all satisfy ``origin = s0 * direction``
    (generateRay, DXRVoxelizer.hlsl:44-53: the ray starts at the voxel
    center and travels radially outward), so the line carrying every ray
    passes through the origin. Intersection with triangle (v0, v1, v2) then
    needs only three signed volumes that are LINEAR in the direction d:

        w_i = d . g_i,   g_0 = v1 x v2,  g_1 = v2 x v0,  g_2 = v0 x v1

    The unnormalized barycentrics of the hit point are w_i / (w0+w1+w2),
    the plane equation gives the hit parameter s = c / (w0+w1+w2) with
    ``c = det(v0, v1, v2) = g_0 . v0``, and the ray-relative t = s - s0.
    (w0+w1+w2 equals n . d with n = e1 x e2 because the three g_i sum to n.)

    Returns (g0, g1, g2 [T,3], c [T]) — 10 floats/triangle vs mt's 9, but
    the per-pair test drops from ~60 to ~35 operations. Expressions are
    scalarized; :func:`radial_hit` must see these exact values.
    """
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]

    def cross(a, b):
        ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
        bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
        return jnp.stack(
            [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
        )

    g0 = cross(v1, v2)
    g1 = cross(v2, v0)
    g2 = cross(v0, v1)
    c = (
        g0[..., 0] * v0[..., 0]
        + g0[..., 1] * v0[..., 1]
        + g0[..., 2] * v0[..., 2]
    )
    return g0, g1, g2, c


def radial_hit(dx, dy, dz, s0, g0x, g0y, g0z, g1x, g1y, g1z,
               g2x, g2y, g2z, c):
    """Radial-ray/triangle test -> (t, hit); t = +inf on miss.

    All operands must be broadcast-compatible. This SCALARIZED expression
    sequence is shared verbatim by the radial oracle
    (ops/voxelize_ref.voxelize_raystab_radial_ref) and both closest-hit
    folds (ops/raystab_pallas.stab_fold_extract, raystab_fast.
    fold_extract_xla) so winners agree bit-for-bit wherever the compilers
    contract FMAs alike (on the CPU; on the GPU the occupancy stays exact
    and normals move by a few ulp, see chip_smoke.py). Inclusive w_i >= 0 / <= 0 bounds match mt_hit's
    u >= 0, v >= 0, u + v <= 1 (hits on edges/vertices count).
    """
    w0 = dx * g0x + dy * g0y + dz * g0z
    w1 = dx * g1x + dy * g1y + dz * g1z
    w2 = dx * g2x + dy * g2y + dz * g2z
    den = (w0 + w1) + w2  # = (e1 x e2) . d, the mt determinant (sign-flipped)
    wmin = jnp.minimum(w0, jnp.minimum(w1, w2))
    wmax = jnp.maximum(w0, jnp.maximum(w1, w2))
    t = c / den - s0
    hit = (
        (jnp.abs(den) > EPS_DET)
        & ((wmin >= 0.0) | (wmax <= 0.0))
        & (t >= 0.0)
        & (t <= T_MAX)
    )
    return jnp.where(hit, t, jnp.inf), hit


def radial_closest_hit(dirs, s0, g0, g1, g2, c, tri_chunk: int = 2048):
    """Radial-form closest hit over the whole soup -> (t, tri_idx).

    ``dirs`` [R,3], ``s0`` [R]; ties resolved to the lowest triangle index
    (matching the binned query's lexicographic (t, id) fold).
    """
    num_tris = c.shape[0]
    pad = (-num_tris) % tri_chunk
    if pad:
        z3 = jnp.zeros((pad, 3), dtype=g0.dtype)
        g0 = jnp.concatenate([g0, z3])
        g1 = jnp.concatenate([g1, z3])
        g2 = jnp.concatenate([g2, z3])
        c = jnp.concatenate([c, jnp.zeros((pad,), dtype=c.dtype)])
    n_chunks = c.shape[0] // tri_chunk
    chunks = (
        g0.reshape(n_chunks, tri_chunk, 3),
        g1.reshape(n_chunks, tri_chunk, 3),
        g2.reshape(n_chunks, tri_chunk, 3),
        c.reshape(n_chunks, tri_chunk),
        jnp.arange(n_chunks, dtype=jnp.int32) * tri_chunk,
    )
    r = dirs.shape[0]
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    s0c = s0[:, None]
    init = (
        jnp.full((r,), jnp.inf, dtype=dirs.dtype),
        jnp.full((r,), 2**30, dtype=jnp.int32),
    )

    def body(carry, chunk):
        bt, bi = carry
        cg0, cg1, cg2, cc, off = chunk
        t, _ = radial_hit(
            dx, dy, dz, s0c,
            cg0[None, :, 0], cg0[None, :, 1], cg0[None, :, 2],
            cg1[None, :, 0], cg1[None, :, 1], cg1[None, :, 2],
            cg2[None, :, 0], cg2[None, :, 1], cg2[None, :, 2],
            cc[None, :],
        )  # [R, Tc]
        t_min = jnp.min(t, axis=1)
        i_min = jnp.min(
            jnp.where(
                t == t_min[:, None],
                jnp.arange(t.shape[1], dtype=jnp.int32)[None, :] + off,
                2**30,
            ),
            axis=1,
        )
        closer = (t_min < bt) | ((t_min == bt) & (i_min < bi))
        return (
            jnp.where(closer, t_min, bt),
            jnp.where(closer, i_min, bi),
        ), None

    (bt, bi), _ = jax.lax.scan(body, init, chunks)
    return bt, bi


def _closest_hit_chunk(origins, dirs, v0, e1, e2, tri_offset):
    """Closest hit of rays [R,3] against one triangle chunk [Tc,3].

    Returns (t, u, v, idx) per ray, with idx global (tri_offset added) and
    t = +inf on miss.
    """
    # [R, 1, 3] x [1, Tc, 3]
    t, u, v, _ = mt_hit(
        origins[:, None, :], dirs[:, None, :],
        v0[None, :, :], e1[None, :, :], e2[None, :, :],
    )
    # closest hit in the chunk; ties resolved to the lowest triangle index
    best = jnp.argmin(t, axis=1)
    r = jnp.arange(t.shape[0])
    return t[r, best], u[r, best], v[r, best], best + tri_offset


def closest_hit(origins, dirs, v0, e1, e2, tri_chunk: int = 2048):
    """Closest hit over the whole soup, scanning triangle chunks.

    Returns (t, u, v, tri_idx); t = +inf where the ray misses everything.
    """
    num_tris = v0.shape[0]
    pad = (-num_tris) % tri_chunk
    if pad:
        # degenerate padding triangles never hit (det == 0)
        z = jnp.zeros((pad, 3), dtype=v0.dtype)
        v0 = jnp.concatenate([v0, z])
        e1 = jnp.concatenate([e1, z])
        e2 = jnp.concatenate([e2, z])
    n_chunks = v0.shape[0] // tri_chunk
    v0c = v0.reshape(n_chunks, tri_chunk, 3)
    e1c = e1.reshape(n_chunks, tri_chunk, 3)
    e2c = e2.reshape(n_chunks, tri_chunk, 3)

    r = origins.shape[0]
    init = (
        jnp.full((r,), jnp.inf, dtype=origins.dtype),
        jnp.zeros((r,), dtype=origins.dtype),
        jnp.zeros((r,), dtype=origins.dtype),
        jnp.zeros((r,), dtype=jnp.int32),
    )

    def body(carry, chunk):
        bt, bu, bv, bi = carry
        cv0, ce1, ce2, off = chunk
        t, u, v, i = _closest_hit_chunk(origins, dirs, cv0, ce1, ce2, off)
        # strictly-closer wins; equal t keeps the earlier (lower-index) hit
        take = t < bt
        return (
            jnp.where(take, t, bt),
            jnp.where(take, u, bu),
            jnp.where(take, v, bv),
            jnp.where(take, i.astype(jnp.int32), bi),
        ), None

    offsets = jnp.arange(n_chunks, dtype=jnp.int32) * tri_chunk
    (bt, bu, bv, bi), _ = jax.lax.scan(body, init, (v0c, e1c, e2c, offsets))
    return bt, bu, bv, bi
