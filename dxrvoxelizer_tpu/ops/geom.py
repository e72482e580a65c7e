"""Shared triangle setup for the parity (axis-ray) voxelizers.

Both the jax.numpy oracle and the production work queue consume the exact
same per-triangle quantities computed by :func:`parity_tri_setup`, in the same
float32 expression order, so their boundary tie-breaking agrees bit-for-bit
(SURVEY.md section 7 "hard parts": bit-exact occupancy needs consistent
tie-breaking on edge/vertex hits).

Formulation: one axis-aligned ray per voxel column along +z in *index space*
(voxel centers at integer coordinates, see ops/packing.py). A column (x, y) is
crossed by a triangle iff its 2D projection covers the column center under a
top-left-style boundary rule; the crossing depth z is interpolated from the
triangle plane. Voxel (x, y, k) is inside iff the number of crossings with
z > k is odd — the intersection-parity solid fill (BASELINE.json north star).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from dxrvoxelizer_tpu.ops.packing import norm_to_index_space


class ParityTris(NamedTuple):
    """Per-triangle constants for the column-parity test (all [T] float32).

    Edge i has function e_i(P) = ex_i * P.x + ey_i * P.y + eo_i, positive
    inside the (orientation-normalized) triangle. ``tl_i`` is 1.0 where the
    boundary counts (top-left-style rule), 0.0 otherwise. ``z*`` interpolates
    the crossing depth: z(P) = (zx * P.x + zy * P.y + zo).
    ``valid`` is 0.0 for degenerate (z-parallel / zero-area) projections.
    """

    ex0: jnp.ndarray; ey0: jnp.ndarray; eo0: jnp.ndarray; tl0: jnp.ndarray
    ex1: jnp.ndarray; ey1: jnp.ndarray; eo1: jnp.ndarray; tl1: jnp.ndarray
    ex2: jnp.ndarray; ey2: jnp.ndarray; eo2: jnp.ndarray; tl2: jnp.ndarray
    zx: jnp.ndarray; zy: jnp.ndarray; zo: jnp.ndarray
    valid: jnp.ndarray
    # conservative 2D bounds in index space (for binning / culling)
    xmin: jnp.ndarray; xmax: jnp.ndarray
    ymin: jnp.ndarray; ymax: jnp.ndarray


def _edge(px, py, qx, qy):
    """Edge function coefficients for edge p->q: e(P) = cross2(q-p, P-p).

    e(P) = dx*(P.y - p.y) - dy*(P.x - p.x) = (-dy)*P.x + dx*P.y + (dy*p.x - dx*p.y)
    Positive to the left of the directed edge (CCW interior).
    """
    dx = qx - px
    dy = qy - py
    ex = -dy
    ey = dx
    eo = dy * px - dx * py
    # boundary-inclusion rule: exactly one of a shared edge's two directions
    # qualifies -> shared edges are counted exactly once.
    tl = jnp.where((dy > 0) | ((dy == 0) & (dx < 0)), 1.0, 0.0).astype(jnp.float32)
    return ex, ey, eo, tl


def parity_tri_setup(verts_norm: jnp.ndarray, tris: jnp.ndarray, n: int) -> ParityTris:
    """Build :class:`ParityTris` from normalized-space vertices [-1,1]^3."""
    g = norm_to_index_space(verts_norm, n)
    a = g[tris[:, 0]]
    b = g[tris[:, 1]]
    c = g[tris[:, 2]]

    area2 = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (
        c[:, 0] - a[:, 0]
    )
    # orientation-normalize: flip b<->c where the projected winding is negative
    flip = area2 < 0
    bx = jnp.where(flip, c[:, 0], b[:, 0]); by = jnp.where(flip, c[:, 1], b[:, 1])
    bz = jnp.where(flip, c[:, 2], b[:, 2])
    cx = jnp.where(flip, b[:, 0], c[:, 0]); cy = jnp.where(flip, b[:, 1], c[:, 1])
    cz = jnp.where(flip, b[:, 2], c[:, 2])
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    abs_area2 = jnp.abs(area2)
    valid = (abs_area2 > 0).astype(jnp.float32)

    ex0, ey0, eo0, tl0 = _edge(ax, ay, bx, by)
    ex1, ey1, eo1, tl1 = _edge(bx, by, cx, cy)
    ex2, ey2, eo2, tl2 = _edge(cx, cy, ax, ay)

    # Plane through the 3 index-space points: z(P) barycentric-interpolated.
    # z = (e_bc(P)*az + e_ca(P)*bz + e_ab(P)*cz) / area2; expand into affine
    # coefficients so the kernel evaluates 2 FMAs per column.
    inv = jnp.where(abs_area2 > 0, 1.0 / abs_area2, 0.0)
    zx = (ex1 * az + ex2 * bz + ex0 * cz) * inv
    zy = (ey1 * az + ey2 * bz + ey0 * cz) * inv
    zo = (eo1 * az + eo2 * bz + eo0 * cz) * inv

    xmin = jnp.minimum(ax, jnp.minimum(bx, cx))
    xmax = jnp.maximum(ax, jnp.maximum(bx, cx))
    ymin = jnp.minimum(ay, jnp.minimum(by, cy))
    ymax = jnp.maximum(ay, jnp.maximum(by, cy))

    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    return ParityTris(
        f32(ex0), f32(ey0), f32(eo0), tl0,
        f32(ex1), f32(ey1), f32(eo1), tl1,
        f32(ex2), f32(ey2), f32(eo2), tl2,
        f32(zx), f32(zy), f32(zo), valid,
        f32(xmin), f32(xmax), f32(ymin), f32(ymax),
    )


def column_crossing(pt: ParityTris, px: jnp.ndarray, py: jnp.ndarray):
    """Evaluate crossing for columns x broadcast against triangles.

    ``px``/``py``: column-center coordinates (integers as float32), shapes
    broadcastable against the [T] triangle axis. Returns (covered, m) where
    ``covered`` is boolean and ``m`` = int32 cutoff: the crossing flips the
    parity of voxels k < m (m = clip(ceil(z), 0, N-ish); clip to the caller's
    range).
    """
    e0 = pt.ex0 * px + pt.ey0 * py + pt.eo0
    e1 = pt.ex1 * px + pt.ey1 * py + pt.eo1
    e2 = pt.ex2 * px + pt.ey2 * py + pt.eo2
    in0 = (e0 > 0) | ((e0 == 0) & (pt.tl0 > 0))
    in1 = (e1 > 0) | ((e1 == 0) & (pt.tl1 > 0))
    in2 = (e2 > 0) | ((e2 == 0) & (pt.tl2 > 0))
    covered = in0 & in1 & in2 & (pt.valid > 0)
    z = pt.zx * px + pt.zy * py + pt.zo
    m = jnp.ceil(z).astype(jnp.int32)
    return covered, m


NCOEF = 16  # packed ParityTris coefficients per triangle

# coefficient columns of the packed [T, NCOEF] matrix
_EX0, _EY0, _EO0, _TL0 = 0, 1, 2, 3
_EX1, _EY1, _EO1, _TL1 = 4, 5, 6, 7
_EX2, _EY2, _EO2, _TL2 = 8, 9, 10, 11
_ZX, _ZY, _ZO, _VALID = 12, 13, 14, 15


def pack_coeffs(pt: ParityTris) -> jnp.ndarray:
    """Stack the 16 per-triangle coefficients into a [T, NCOEF] f32 matrix."""
    return jnp.stack(
        [
            pt.ex0, pt.ey0, pt.eo0, pt.tl0,
            pt.ex1, pt.ey1, pt.eo1, pt.tl1,
            pt.ex2, pt.ey2, pt.eo2, pt.tl2,
            pt.zx, pt.zy, pt.zo, pt.valid,
        ],
        axis=1,
    ).astype(jnp.float32)
