"""Closest-hit fold + winner extraction for the binned ray-stab query.

A Pallas kernel on the Triton route. The accel (ops/raystab_fast.py,
ops/raystab_tiled.py) packs each capacity class into 128-ray strips: a
ray block [C, 8, 128] (rows dx dy dz s0 + padding rows) and the strip's
candidate tables — radial coefficients ``coefs`` (g0 g1 g2 c id pad) and
vertex normals ``ntab`` (n0 n1 n2 pad) — in either of two layouts: classic
[C, K, 12] or lane-aligned [C, 12, K] (classes with K >= LANE_MIN_K). The
kernel reads both by stride.

One program per strip, one ray per thread (4 warps = 128 lanes):

- walk the strip's K candidates, reading each candidate's row once;
- keep the (t, id) lexicographic minimum and the winner's table position
  in registers — exact and order-independent, matching the oracle's
  strictly-closer / lowest-id rule;
- skip a 256-candidate chunk when its distance lower bound (``bounds``,
  candidates are distance-sorted at build) cannot beat any lane's current
  winner — the DXR near-to-far traversal analog;
- load the winner's coefficient and normal rows by index and finish the
  rgba channels in the strip (inside rule, normalized interpolated normal).

Every arithmetic chain is the radial oracle's scalarized expression order
(ops/intersect.py ``radial_hit``, ops/voxelize_ref.py
``voxelize_raystab_radial_ref``), so winners and normals are bit-identical.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from dxrvoxelizer_tpu.ops.intersect import radial_hit

CELLS_PER_STEP = 8  # strip counts are padded to multiples of this

LANE_MIN_K = 96
"""Capacity classes with K >= this store their tables lane-aligned
([..., 12, K], candidate-contiguous rows); smaller classes keep the classic
[..., K, 12] layout. The kernel reads both."""

K_BLOCK = 256  # candidates per distance-bound chunk
BIG_ID = 2**30  # exactly representable in f32
NCF2 = 12  # coefficient row: g0(3) g1(3) g2(3) c(1) id-as-f32(1) pad(1)
C_ROW = 9
ID_ROW2 = 10
NNC = 12  # normal-table row: n0(3) n1(3) n2(3) pad(3)


def cells_per_step_for(k: int, c: int | None = None,
                       vc: int | None = None) -> int:
    """Strip-count granule a class of candidate capacity ``k`` is padded to
    at build (part of the packed-table layout, so of the accel cache key).

    Small-K classes pad to larger granules, bounded by ``vc`` (the class's
    real strip count: padding stays <= ~vc/4) and, when given, reduced to a
    divisor of ``c`` (an already-padded strip count).
    """
    kblk = min(k, K_BLOCK)
    cps = 64
    while cps > 8 and cps * kblk > 2048:
        cps //= 2
    if vc is not None:
        while cps > 8 and cps * 4 > vc:
            cps //= 2
    if c is not None:
        while c % cps:
            cps //= 2
    assert cps >= 1
    return cps


def _lexmin(t1, i1, k1, t2, i2, k2):
    take = (t2 < t1) | ((t2 == t1) & (i2 < i1))
    return (jnp.where(take, t2, t1), jnp.where(take, i2, i1),
            jnp.where(take, k2, k1))


def finish_channels(dx, dy, dz, gr, nr, wt, wi, t_count: int,
                    threshold: float, rule: str):
    """Winner rows -> finished (nx, ny, nz, a) channels.

    ``gr``/``nr``: the winner's 9 coefficient (g0 g1 g2) and 9 normal
    (n0 n1 n2) values; ``wt``/``wi``: its t and id (as f32). Shared
    verbatim by the kernel and the plain fold (ops/raystab_fast.py
    ``fold_extract_xla``) — the radial oracle's normal convention:
    w_i = d . g_i, den = (w0 + w1) + w2, ns = w0*n0 + w1*n1 + w2*n2,
    nrm = (ns / den) / max(sqrt(ss), 1e-20)."""
    w0 = dx * gr[0] + dy * gr[1] + dz * gr[2]
    w1 = dx * gr[3] + dy * gr[4] + dz * gr[5]
    w2 = dx * gr[6] + dy * gr[7] + dz * gr[8]
    den = (w0 + w1) + w2
    nsx = w0 * nr[0] + w1 * nr[3] + w2 * nr[6]
    nsy = w0 * nr[1] + w1 * nr[4] + w2 * nr[7]
    nsz = w0 * nr[2] + w1 * nr[5] + w2 * nr[8]
    dn = jnp.where(den == 0.0, 1.0, den)
    nx, ny, nz = nsx / dn, nsy / dn, nsz / dn
    ss = (nx * nx + ny * ny) + nz * nz
    ln = jnp.maximum(jnp.sqrt(ss), 1e-20)
    nx, ny, nz = nx / ln, ny / ln, nz / ln
    hit = jnp.isfinite(wt) & (wi < float(t_count))
    if rule == "hit":
        inside = hit
    else:
        dot = (nx * dx + ny * dy) + nz * dz
        inside = hit & (dot > threshold)
    zero = jnp.zeros_like(nx)
    return (jnp.where(inside, nx, zero), jnp.where(inside, ny, zero),
            jnp.where(inside, nz, zero), jnp.where(inside, 1.0, zero))


def _fold_extract_kernel(*refs, k: int, kblk: int, shared: bool,
                         lane_aligned: bool, skip: bool, t_count: int,
                         threshold: float, rule: str):
    if skip:
        ray_ref, coef_ref, ntab_ref, bnd_ref, t_ref, i_ref, ns_ref = refs
    else:
        ray_ref, coef_ref, ntab_ref, t_ref, i_ref, ns_ref = refs
    s = pl.program_id(0)

    def row(ref, pos, j):
        """Candidate ``pos`` (scalar or per-lane index), column ``j``."""
        if shared:
            return ref[j, pos] if lane_aligned else ref[pos, j]
        return ref[s, j, pos] if lane_aligned else ref[s, pos, j]

    dx = ray_ref[s, 0, :]
    dy = ray_ref[s, 1, :]
    dz = ray_ref[s, 2, :]
    s0 = ray_ref[s, 3, :]
    # padding ray slots (all-zero directions) start at -inf: they never
    # block a chunk skip and are sliced off by the caller's merge
    pad = (dx == 0.0) & (dy == 0.0) & (dz == 0.0)

    def step(j, carry):
        def c(col):
            return row(coef_ref, j, col)

        tt, hit = radial_hit(
            dx, dy, dz, s0,
            c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), c(8), c(C_ROW),
        )
        ii = jnp.where(hit, c(ID_ROW2), float(BIG_ID))
        return _lexmin(*carry, tt, ii, jnp.full_like(carry[2], j))

    carry = (
        jnp.where(pad, -jnp.inf, jnp.inf),
        jnp.full((128,), float(BIG_ID), jnp.float32),
        jnp.zeros((128,), jnp.int32),
    )
    for kc in range(k // kblk):
        def fold(cr, kc=kc):
            return jax.lax.fori_loop(kc * kblk, (kc + 1) * kblk, step, cr)

        if skip:
            carry = jax.lax.cond(
                bnd_ref[s, kc] <= jnp.max(carry[0]), fold, lambda cr: cr,
                carry,
            )
        else:
            carry = fold(carry)
    bt, bi, bk = carry

    gr = [row(coef_ref, bk, j) for j in range(9)]
    nr = [row(ntab_ref, bk, j) for j in range(9)]
    chans = finish_channels(dx, dy, dz, gr, nr, bt, bi, t_count, threshold,
                            rule)
    t_ref[s, :] = bt
    i_ref[s, :] = bi
    for j in range(4):
        ns_ref[s, j, :] = chans[j]


@partial(jax.jit, static_argnames=("k", "shared", "interpret", "t_count",
                                   "threshold", "rule"))
def stab_fold_extract(
    rays: jnp.ndarray,
    coefs: jnp.ndarray,
    ntab: jnp.ndarray,
    k: int,
    t_count: int,
    threshold: float,
    shared: bool = False,
    interpret: bool = False,
    bounds: jnp.ndarray | None = None,
    rule: str = "backface",
):
    """Fused closest hit + winner extraction + in-strip finalize.

    ``rays`` [C, 8, 128] (rows dx dy dz s0); ``coefs``/``ntab`` [C, K, 12]
    or lane-aligned [C, 12, K] — or [K, 12] / [12, K] with ``shared`` (one
    candidate list for every strip: the near-origin overflow pass);
    ``bounds`` [C, K // K_BLOCK] chunk distance lower bounds (multi-chunk
    classes). Returns (t [C,128] f32, id [C,128] i32, ns [C,4,128] finished
    (nx, ny, nz, a) channels).
    """
    c = rays.shape[0]
    lane_aligned = coefs.shape[-2] == NCF2 and coefs.shape[-1] != NCF2
    kblk = min(k, K_BLOCK)
    # k > K_BLOCK must chunk evenly or tail candidates are never tested
    assert k % kblk == 0, f"k={k} not a multiple of K_BLOCK={K_BLOCK}"
    skip = bounds is not None and k > kblk and not shared
    args = [rays, coefs, ntab] + ([bounds] if skip else [])
    t_out, i_out, ns = pl.pallas_call(
        partial(_fold_extract_kernel, k=k, kblk=kblk, shared=shared,
                lane_aligned=lane_aligned, skip=skip, t_count=t_count,
                threshold=threshold, rule=rule),
        grid=(c,),
        out_shape=[
            jax.ShapeDtypeStruct((c, 128), jnp.float32),
            jax.ShapeDtypeStruct((c, 128), jnp.float32),
            jax.ShapeDtypeStruct((c, 4, 128), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="raystab_fold_extract",
    )(*args)
    return t_out, i_out.astype(jnp.int32), ns
