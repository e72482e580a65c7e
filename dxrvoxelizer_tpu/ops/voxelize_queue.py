"""Work-queue parity voxelizer — the production parity path.

Triangles are binned to **16x8-column tiles** (128 columns, one per thread
of a 4-warp program) and laid out as an exact per-tile run in one flat
coefficient array: tile t owns rows ``[tile_row0[t], tile_row0[t] +
tile_count[t])``, each run starting on a ``k_chunk`` boundary (padding
rows carry zero coefficients, so they are XOR no-ops). Tiles with many
triangles get long runs, empty tiles none (the DXR analog: rays traverse
only their own BVH subtree, reference Voxelizer.cpp:313-323 builds
exactly that).

The fold (one implementation per platform, picked by ``ops/route.py``):

- **GPU**: :func:`queue_fold_triton`, a Pallas kernel on the Triton route.
  One program per tile walks its run, XOR-accumulates each column's
  crossing bit into the ``n//32`` words it keeps in registers, converts
  the crossing field to occupancy (suffix parity) and stores the tile
  once. No atomics and no cross-program order: the result is
  deterministic.
- **CPU**: :func:`queue_fold_xla`, the same per-row expressions in plain
  jnp over 8-row sub-chunks, a per-tile XOR by prefix-XOR differences and
  :func:`suffix_parity_words`. It is also the plain version the kernel is
  timed against on the card.

Coverage/cutoff arithmetic is expression-for-expression the oracle's
(ops/geom.py), so both folds reproduce ``voxelize_parity_ref`` bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from dxrvoxelizer_tpu.ops import route
from dxrvoxelizer_tpu.ops.geom import (
    NCOEF,
    pack_coeffs,
    parity_tri_setup,
)
from dxrvoxelizer_tpu.ops.geom import (
    _EX0, _EY0, _EO0, _TL0, _EX1, _EY1, _EO1, _TL1,
    _EX2, _EY2, _EO2, _TL2, _ZX, _ZY, _ZO, _VALID,
)

TILE_X = 16  # tile extent in grid-x columns
TILE_Y = 8  # tile extent in grid-y columns (16*8 = 128 columns per tile)
FOLD_ROWS = 8  # row sub-chunk of the plain fold; k_chunk must be a multiple


@dataclass
class QueueStats:
    n_tiles: int
    num_chunks: int  # padded queue length in k_chunk-row chunks
    real_chunks: int
    pairs: int  # (tile, triangle) pairs before chunk padding
    overflow: int  # triangles appended to every tile


def _crossing(c, px, py, n: int):
    """One triangle row's crossing against columns (px, py) -> (word index,
    crossing bit): the oracle's coverage/cutoff expressions (ops/geom.py
    ``column_crossing``). A crossing with cutoff m flips voxels k < m, i.e.
    contributes ONE bit at position m-1 of the crossing field; occupancy
    is the suffix parity of that field. ``c(j)`` reads coefficient j."""
    e0 = c(_EX0) * px + c(_EY0) * py + c(_EO0)
    e1 = c(_EX1) * px + c(_EY1) * py + c(_EO1)
    e2 = c(_EX2) * px + c(_EY2) * py + c(_EO2)
    in0 = (e0 > 0) | ((e0 == 0) & (c(_TL0) > 0))
    in1 = (e1 > 0) | ((e1 == 0) & (c(_TL1) > 0))
    in2 = (e2 > 0) | ((e2 == 0) & (c(_TL2) > 0))
    covered = in0 & in1 & in2 & (c(_VALID) > 0)
    z = c(_ZX) * px + c(_ZY) * py + c(_ZO)
    cutoff = jnp.clip(jnp.ceil(z), 0.0, float(n)).astype(jnp.int32)
    ci = cutoff - 1  # -1 (no crossing below any voxel) matches no word
    bit = jnp.where(covered, jnp.int32(1) << (ci & 31), jnp.int32(0))
    return ci >> 5, bit  # arithmetic shift: -1 -> -1


def _tile_columns(tile, nty: int):
    """Column centers (px, py) [..., 128] of global tile ids ``tile`` [...]:
    column l of a tile is (x_local, y_local) = (l // TILE_Y, l % TILE_Y)."""
    tx = tile // nty
    ty = tile - tx * nty
    lane = jnp.arange(128, dtype=jnp.int32)
    px = (tx[..., None] * TILE_X + lane // TILE_Y).astype(jnp.float32)
    py = (ty[..., None] * TILE_Y + lane % TILE_Y).astype(jnp.float32)
    return px, py


def _fold_kernel(row0_ref, cnt_ref, off_ref, coef_ref, out_ref, *, n: int,
                 nty: int, wp: int):
    """One tile: XOR its run's crossing bits into [wp, 128] words held in
    registers, suffix-parity them, store once."""
    t = pl.program_id(0)
    px, py = _tile_columns(t + off_ref[0], nty)
    word = jax.lax.broadcasted_iota(jnp.int32, (wp, 128), 0)

    def body(r, acc):
        pw, bit = _crossing(lambda j: coef_ref[r, j], px, py, n)
        return acc ^ jnp.where(pw[None, :] == word, bit[None, :], 0)

    r0 = row0_ref[t]
    acc = jax.lax.fori_loop(
        r0, r0 + cnt_ref[t], body, jnp.zeros((wp, 128), jnp.int32)
    )
    # crossing field -> occupancy: suffix parity within each word, then the
    # parity of all strictly-higher words as a full-word flip
    s = acc
    for sh in (1, 2, 4, 8, 16):
        s = s ^ jax.lax.shift_right_logical(s, jnp.int32(sh))
    par = s & 1
    higher = (jnp.sum(par, axis=0, keepdims=True) - jnp.cumsum(par, axis=0)) & 1
    out_ref[t] = s ^ (0 - higher)


@partial(jax.jit, static_argnames=("n", "interpret"))
def queue_fold_triton(coefs, tile_row0, tile_count, tile_off, n: int,
                      interpret: bool = False):
    """Kernel fold of a built queue -> occupancy tiles [tiles, n//32, 128].

    ``tile_off`` ([1] or scalar int32, may be traced — a shard_map axis
    index) is the global id of the first tile in ``tile_row0``."""
    n_win = tile_row0.shape[0]
    w = n // 32
    wp = pl.next_power_of_2(w)  # Triton blocks are powers of two
    out = pl.pallas_call(
        partial(_fold_kernel, n=n, nty=n // TILE_Y, wp=wp),
        grid=(n_win,),
        out_shape=jax.ShapeDtypeStruct((n_win, wp, 128), jnp.int32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="parity_queue_fold",
    )(
        tile_row0.astype(jnp.int32), tile_count.astype(jnp.int32),
        jnp.asarray(tile_off, jnp.int32).reshape(1), coefs,
    )
    return out[:, :w]


@partial(jax.jit, static_argnames=("n",))
def queue_fold_xla(coefs, tile_row0, tile_count, tile_off, n: int):
    """Plain-jnp fold of a built queue, same contract as
    :func:`queue_fold_triton`: per 8-row sub-chunk crossing words (XOR
    reduce), a per-tile XOR from prefix-XOR differences, suffix parity."""
    n_win = tile_row0.shape[0]
    w = n // 32
    cf = coefs.reshape(-1, FOLD_ROWS, NCOEF)  # [C, R, NCOEF]
    n_sub = cf.shape[0]
    row0 = tile_row0.astype(jnp.int32)
    cnt = tile_count.astype(jnp.int32)
    start = jnp.arange(n_sub, dtype=jnp.int32) * FOLD_ROWS
    tile_of = jnp.clip(
        jnp.searchsorted(row0, start, side="right").astype(jnp.int32) - 1,
        0, n_win - 1,
    )
    live = start < row0[tile_of] + cnt[tile_of]
    tile = tile_of + jnp.asarray(tile_off, jnp.int32).reshape(())
    px, py = _tile_columns(tile, n // TILE_Y)  # [C, 128]
    pw, bit = _crossing(
        lambda j: cf[:, :, j][:, :, None], px[:, None, :], py[:, None, :], n
    )  # [C, R, 128]
    words = jnp.stack(
        [
            jax.lax.reduce(
                jnp.where(pw == wi, bit, 0), jnp.int32(0),
                jax.lax.bitwise_xor, (1,),
            )
            for wi in range(w)
        ],
        axis=1,
    )  # [C, W, 128]
    words = jnp.where(live[:, None, None], words, 0)
    cx = jax.lax.associative_scan(jnp.bitwise_xor, words, axis=0)
    first = row0 // FOLD_ROWS
    last = first + (cnt + FOLD_ROWS - 1) // FOLD_ROWS - 1
    hi = cx[jnp.clip(last, 0, n_sub - 1)]
    lo = jnp.where(
        (first > 0)[:, None, None], cx[jnp.clip(first - 1, 0, n_sub - 1)], 0
    )
    tiles = jnp.where((cnt > 0)[:, None, None], hi ^ lo, 0)
    return suffix_parity_words(tiles)


def _fold_for(interpret: bool):
    """The platform's fold, or the kernel in interpret mode when asked."""
    if interpret:
        return partial(queue_fold_triton, interpret=True)
    return route.parity_voxelize()


def suffix_parity_words(words: jnp.ndarray) -> jnp.ndarray:
    """Crossing-bit field -> occupancy: bit k := parity of bits >= k.

    ``words``: int32 [..., W, lanes] with the word axis second-to-last
    (z-minor packing). Exact integer parity — no rounding anywhere.
    """
    u = words.astype(jnp.uint32)
    s = u
    for sh in (1, 2, 4, 8, 16):  # within-word suffix parity
        s = s ^ (s >> jnp.uint32(sh))
    # carry: parity of all bits in strictly-higher words, spread to 32 bits
    par = (s & jnp.uint32(1)).astype(jnp.int32)  # full-word parity
    rev = par[..., ::-1, :]
    carry = (jnp.cumsum(rev, axis=-2)[..., ::-1, :] - par) & 1
    return (s ^ (jnp.uint32(0) - carry.astype(jnp.uint32))).astype(jnp.int32)


def _tiles_to_grid(out: jnp.ndarray, n: int) -> jnp.ndarray:
    """Occupancy tiles [n_tiles, W, 128] -> packed occupancy [N, N, W]
    (pure layout: the suffix-parity conversion already happened)."""
    w_words = n // 32
    ntx, nty = n // TILE_X, n // TILE_Y
    x = out.reshape(ntx, nty, w_words, TILE_X, TILE_Y)
    x = x.transpose(0, 3, 1, 4, 2)  # [ntx, xl, nty, yl, W]
    return x.reshape(n, n, w_words)


@partial(jax.jit, static_argnames=("n", "max_span_x", "max_span_y", "ov_cap"))
def _queue_phase_a(verts_norm, tris, n: int, max_span_x: int, max_span_y: int,
                   ov_cap: int | None = None):
    """Device phase A: setup, (tile, tri) pairs, sort -> per-tile runs.

    ``ov_cap`` bounds the static size of the overflow id list (triangles
    whose tile span exceeds the caps). None -> t_count (always enough; the
    host build path uses it). The device-build path passes a small cap so
    downstream overflow-coefficient gathers stay cheap — frames whose true
    overflow count exceeds the cap are flagged through _assemble_window's
    ``ok`` word (same grow-and-retry contract as the chunk capacity)."""
    pt = parity_tri_setup(verts_norm, tris, n)
    coef = pack_coeffs(pt)  # [T, NCOEF]
    t_count = coef.shape[0]
    ntx, nty = n // TILE_X, n // TILE_Y
    n_tiles = ntx * nty

    x0 = jnp.ceil(pt.xmin)
    x1 = jnp.floor(pt.xmax)
    y0 = jnp.ceil(pt.ymin)
    y1 = jnp.floor(pt.ymax)
    nonempty = (
        (pt.valid > 0) & (x1 >= x0) & (y1 >= y0)
        & (x1 >= 0) & (x0 <= n - 1) & (y1 >= 0) & (y0 <= n - 1)
    )
    tx0 = (jnp.clip(x0, 0, n - 1).astype(jnp.int32)) // TILE_X
    tx1 = (jnp.clip(x1, 0, n - 1).astype(jnp.int32)) // TILE_X
    ty0 = (jnp.clip(y0, 0, n - 1).astype(jnp.int32)) // TILE_Y
    ty1 = (jnp.clip(y1, 0, n - 1).astype(jnp.int32)) // TILE_Y
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    small = nonempty & (span_x <= max_span_x) & (span_y <= max_span_y)
    overflow_mask = nonempty & ~small

    cands = []
    for dx in range(max_span_x):
        for dy in range(max_span_y):
            tid = (tx0 + dx) * nty + (ty0 + dy)
            ok = small & (dx < span_x) & (dy < span_y)
            cands.append(jnp.where(ok, tid, n_tiles))  # sentinel = n_tiles
    keys = jnp.stack(cands, axis=0).reshape(-1)
    tri_ids = jnp.broadcast_to(
        jnp.arange(t_count, dtype=jnp.int32)[None, :],
        (max_span_x * max_span_y, t_count),
    ).reshape(-1)

    # When (tile, tri) fits in 32 bits, pack both into ONE uint32 and sort
    # a single array instead of a two-array tuple sort with a payload.
    # Run order within a tile becomes tri-ascending instead of slot-major,
    # which is invisible to the XOR parity fold (commutative).
    t_bits = max(int(np.ceil(np.log2(max(t_count, 2)))), 1)
    if (n_tiles + 1) << t_bits <= (1 << 32) - 1:
        packed = (
            (keys.astype(jnp.uint32) << t_bits) | tri_ids.astype(jnp.uint32)
        )
        sp = jax.lax.sort(packed, dimension=0, is_stable=False)
        sorted_tris = (sp & ((1 << t_bits) - 1)).astype(jnp.int32)
        starts = jnp.searchsorted(
            sp, jnp.arange(n_tiles + 1, dtype=jnp.uint32) << t_bits
        )
    else:  # huge mesh x huge grid: fall back to the tuple sort
        sorted_keys, sorted_tris = jax.lax.sort(
            (keys, tri_ids), dimension=0, is_stable=True, num_keys=1
        )
        starts = jnp.searchsorted(
            sorted_keys, jnp.arange(n_tiles + 1, dtype=jnp.int32)
        )
    counts = starts[1:] - starts[:-1]
    o_cap = t_count if ov_cap is None else min(ov_cap, t_count)
    ov_ids = jnp.nonzero(overflow_mask, size=max(o_cap, 1), fill_value=-1)[0]
    return coef, sorted_tris, starts, counts, ov_ids, overflow_mask.sum()


@partial(jax.jit, static_argnames=("num_chunks", "k_chunk"))
def _queue_phase_b(coef, sorted_tris, ov_ids, gather_rows, num_chunks: int,
                   k_chunk: int):
    """Device phase B: gather the flat queue coefficient array.

    ``gather_rows`` [num_chunks * k_chunk] indexes a virtual concatenation
    [sorted_tris | overflow ids | zero sentinel] (built host-side from the
    tiny per-tile counts vector).
    """
    t_count = coef.shape[0]
    s_len = sorted_tris.shape[0]
    combined = jnp.concatenate(
        [sorted_tris, ov_ids.astype(jnp.int32), jnp.full((1,), -1, jnp.int32)]
    )
    tri_id = combined[jnp.clip(gather_rows, 0, combined.shape[0] - 1)]
    tri_id = jnp.where(gather_rows < 0, -1, tri_id)
    coef_padded = jnp.concatenate(
        [coef, jnp.zeros((1, NCOEF), dtype=coef.dtype)], axis=0
    )
    rows = jnp.where(tri_id < 0, t_count, tri_id)
    return coef_padded[rows].reshape(num_chunks * k_chunk, NCOEF), s_len


def build_queue(
    verts_norm: jnp.ndarray,
    tris: jnp.ndarray,
    n: int,
    k_chunk: int = 64,
    max_span_x: int = 4,
    max_span_y: int = 8,
):
    """Build the flat work queue -> (coefs, tile_row0, tile_count, stats).

    One host sync (the per-tile counts, ~n^2/128 int32s) between the two
    jitted device phases; the layout itself is tiny host numpy work. The
    chunk count is bucketed (multiples of 128) so the fold's executable is
    stable across frames of a deforming mesh.
    """
    assert k_chunk % FOLD_ROWS == 0, k_chunk
    ntx, nty = n // TILE_X, n // TILE_Y
    n_tiles = ntx * nty
    coef, sorted_tris, starts, counts, ov_ids, n_ov_d = _queue_phase_a(
        verts_norm, tris, n, max_span_x, max_span_y
    )
    counts_h = np.asarray(counts).astype(np.int64)  # host sync
    starts_h = np.asarray(starts[:-1]).astype(np.int64)
    n_ov = int(n_ov_d)
    s_total = int(sorted_tris.shape[0])

    # overflow triangles (too big for the span cap) may cover any column, so
    # with any overflow present every tile gets a run; otherwise empty tiles
    # get none
    per_tile = np.where(
        (counts_h > 0) | (n_ov > 0), counts_h + n_ov, 0
    )
    chunks_per_tile = (per_tile + k_chunk - 1) // k_chunk
    real_chunks = int(chunks_per_tile.sum())
    num_chunks = max(-(-real_chunks // 128) * 128, 128)
    first_pos = np.zeros(n_tiles, dtype=np.int64)
    first_pos[1:] = np.cumsum(chunks_per_tile)[:-1]

    # rows of the virtual [sorted_tris | ov_ids | sentinel] concatenation
    slot = np.arange(num_chunks * k_chunk, dtype=np.int64)
    chunk_of_slot = slot // k_chunk
    tile_of_chunk = np.append(
        np.repeat(np.arange(n_tiles, dtype=np.int64), chunks_per_tile), 0
    )  # + a dummy entry for the padding chunks (masked by real_slot)
    real_slot = chunk_of_slot < real_chunks
    tile_of_slot = tile_of_chunk[np.minimum(chunk_of_slot, real_chunks)]
    t_idx = np.where(real_slot, slot - first_pos[tile_of_slot] * k_chunk, -1)
    cnt = counts_h[tile_of_slot]
    in_run = real_slot & (t_idx >= 0) & (t_idx < cnt)
    in_ov = real_slot & (t_idx >= cnt) & (t_idx < cnt + n_ov)
    rows = np.where(
        in_run,
        starts_h[tile_of_slot] + t_idx,
        np.where(in_ov, s_total + (t_idx - cnt), -1),
    )

    coefs, _ = _queue_phase_b(
        coef, sorted_tris, ov_ids, jnp.asarray(rows, jnp.int32),
        num_chunks, k_chunk,
    )
    stats = QueueStats(
        n_tiles=n_tiles,
        num_chunks=num_chunks,
        real_chunks=real_chunks,
        pairs=int(per_tile.sum()),
        overflow=n_ov,
    )
    return (
        coefs,
        jnp.asarray(first_pos * k_chunk, jnp.int32),
        jnp.asarray(per_tile, jnp.int32),
        stats,
    )


def run_queue(coefs, tile_row0, tile_count, n: int, interpret: bool = False,
              tile_off=0) -> jnp.ndarray:
    """Fold a built queue -> packed occupancy words [N, N, N//32]."""
    tiles = _fold_for(interpret)(coefs, tile_row0, tile_count, tile_off, n)
    return _tiles_to_grid(tiles, n)


class StaticVoxelizer:
    """Build-once / dispatch-per-frame parity voxelizer for STATIC meshes.

    The reference builds its acceleration structure once at init
    (Content/Voxelizer.cpp:264-326) and per frame only re-dispatches rays
    (:351-369). This is that split for the queue: ``build_queue``'s
    binning (device sort + one host sync) runs ONCE here; ``__call__`` is
    pure fold dispatch — no host sync, no per-frame layout work.
    """

    def __init__(self, verts_norm, tris, n: int, k_chunk: int = 64,
                 interpret: bool = False):
        self.n = n
        self.interpret = interpret
        self.coefs, self.row0, self.count, self.stats = build_queue(
            verts_norm, tris, n, k_chunk=k_chunk
        )

    def __call__(self, perturb=None) -> jnp.ndarray:
        """-> packed occupancy words [N, N, N//32] (async device dispatch).

        ``perturb``: optional f32 scalar added as ``coef + perturb * 1e-38``
        — an exact f32 no-op that gives benchmark loops a carry dependence
        without re-binning."""
        coefs = self.coefs
        if perturb is not None:
            coefs = coefs + perturb * 1e-38
        return run_queue(coefs, self.row0, self.count, self.n,
                         interpret=self.interpret)


def voxelize_parity_queue(
    verts_norm: jnp.ndarray,
    tris: jnp.ndarray,
    n: int,
    k_chunk: int = 64,
    interpret: bool = False,
) -> jnp.ndarray:
    """Bin + fold: the production parity voxelizer (any n % 32 == 0)."""
    assert n % 32 == 0, f"grid size must be a multiple of 32, got {n}"
    if tris.shape[0] == 0:
        return jnp.zeros((n, n, n // 32), dtype=jnp.int32)
    coefs, row0, count, _ = build_queue(verts_norm, tris, n, k_chunk=k_chunk)
    return run_queue(coefs, row0, count, n, interpret=interpret)


# ---- deforming-mesh path: device-only queue build ---------------------------

def _assemble_window(phase_a_out, n: int, num_chunks: int, k_chunk: int,
                     tile_lo, n_win: int):
    """Assemble the queue of tiles [tile_lo, tile_lo + n_win) from shared
    phase-A results (traced; ``tile_lo`` may be a shard_map axis value).

    Returns (coefs, tile_row0, tile_count, ok) with rows local to the
    window. ``ok`` is False when the window's chunks exceed ``num_chunks``
    OR the overflow count exceeds phase A's ov_ids capacity (either way the
    queue is truncated — every run is clamped inside the array; grow and
    retry).
    """
    coef, sorted_tris, starts, counts, ov_ids, n_ov = phase_a_out
    t_count = coef.shape[0]
    counts_w = jax.lax.dynamic_slice(counts, (tile_lo,), (n_win,))
    starts_w = jax.lax.dynamic_slice(starts[:-1], (tile_lo,), (n_win,))

    per_tile = jnp.where((counts_w > 0) | (n_ov > 0), counts_w + n_ov, 0)
    cpt = (per_tile + k_chunk - 1) // k_chunk  # chunks per tile
    first_chunk = jnp.concatenate(
        [jnp.zeros((1,), cpt.dtype), jnp.cumsum(cpt)[:-1]]
    )
    total_chunks = first_chunk[-1] + cpt[-1]
    ok = (total_chunks <= num_chunks) & (n_ov <= ov_ids.shape[0])

    # chunk j -> tile: repeat-via-searchsorted on the chunk cumsum
    bounds = first_chunk + cpt  # end chunk (exclusive) per tile
    j = jnp.arange(num_chunks, dtype=jnp.int32)
    tile_of = jnp.searchsorted(bounds, j, side="right").astype(jnp.int32)
    valid_chunk = j < total_chunks
    tile_of = jnp.where(valid_chunk, jnp.minimum(tile_of, n_win - 1),
                        n_win - 1)
    within = j - first_chunk[tile_of]

    # slot -> row of [sorted_tris | ov_ids | sentinel]; per-chunk values
    # gather at chunk granularity and broadcast over the k_chunk axis
    s_total = sorted_tris.shape[0]
    chunk_start = starts_w[tile_of]  # [num_chunks]
    cnt = counts_w[tile_of][:, None]  # [num_chunks, 1]
    kk = jnp.arange(k_chunk, dtype=jnp.int32)[None, :]
    t_idx = (within * k_chunk)[:, None] + kk  # [num_chunks, k_chunk]
    t_idx = jnp.where(valid_chunk[:, None], t_idx, -1)
    in_run = (t_idx >= 0) & (t_idx < cnt)
    in_ov = (t_idx >= cnt) & (t_idx < cnt + n_ov)
    rows = jnp.where(
        in_run,
        chunk_start[:, None] + t_idx,
        jnp.where(in_ov, s_total + (t_idx - cnt), -1),
    ).reshape(-1)
    combined = jnp.concatenate(
        [sorted_tris, ov_ids.astype(jnp.int32), jnp.full((1,), -1, jnp.int32)]
    )
    tri_id = combined[jnp.clip(rows, 0, combined.shape[0] - 1)]
    tri_id = jnp.where(rows < 0, -1, tri_id)
    coef_padded = jnp.concatenate(
        [coef, jnp.zeros((1, NCOEF), dtype=coef.dtype)], axis=0
    )
    coefs = coef_padded[jnp.where(tri_id < 0, t_count, tri_id)]
    cap_rows = num_chunks * k_chunk
    row0 = jnp.minimum(first_chunk * k_chunk, cap_rows).astype(jnp.int32)
    count = jnp.clip(per_tile, 0, cap_rows - row0).astype(jnp.int32)
    return coefs.reshape(cap_rows, NCOEF), row0, count, ok


OV_CAP_DEVICE = 512  # static overflow-list capacity of the device build


@partial(jax.jit, static_argnames=("n", "num_chunks", "k_chunk", "max_span_x",
                                   "max_span_y", "n_win", "ov_cap"))
def _build_queue_device(verts_norm, tris, n: int, num_chunks: int,
                        k_chunk: int, max_span_x: int, max_span_y: int,
                        tile_lo=0, n_win: int | None = None,
                        ov_cap: int = OV_CAP_DEVICE):
    """Fully-on-device queue build (no host sync) for per-frame rebinning
    of the tile window [tile_lo, tile_lo + n_win) (default: every tile).

    ``num_chunks`` is a static capacity (see :class:`DeformingVoxelizer`);
    frames whose queue exceeds it — or whose span-overflow triangle count
    exceeds ``ov_cap`` — flag via the checked ``ok`` word.
    """
    if n_win is None:
        n_win = (n // TILE_X) * (n // TILE_Y)
    pa = _queue_phase_a(verts_norm, tris, n, max_span_x, max_span_y,
                        ov_cap=ov_cap)
    return _assemble_window(pa, n, num_chunks, k_chunk, tile_lo, n_win)


def rest_mesh_spans(verts_norm, tris, n: int,
                    cap: tuple = (4, 8)) -> tuple:
    """Tile-span caps (span_x, span_y) covering every triangle of the REST
    mesh, clamped to ``cap`` (larger rest spans route through overflow).

    The device build's pair-sort cost scales with max_span_x*max_span_y*T
    candidate rows, and real meshes at hi-res grids span 1-2 tiles per axis
    (dragon/bunny/TuringBowl at 256^3: max span 2x2 — 4 candidate slots
    instead of the conservative default's 32, a ~4x phase-A cut). Deformed
    frames whose triangles outgrow the caps fall into the EXACT overflow
    path (appended to every tile) and, past ov_cap of them, flag ``ok``.
    """
    pt = parity_tri_setup(verts_norm, tris, n)
    x0, x1, y0, y1, valid = jax.device_get((
        jnp.ceil(pt.xmin), jnp.floor(pt.xmax),
        jnp.ceil(pt.ymin), jnp.floor(pt.ymax), pt.valid > 0,
    ))
    ne = valid & (x1 >= x0) & (y1 >= y0) & (x1 >= 0) & (x0 <= n - 1) \
        & (y1 >= 0) & (y0 <= n - 1)
    if not ne.any():
        return (1, 1)
    tx0 = np.clip(x0, 0, n - 1).astype(np.int64) // TILE_X
    tx1 = np.clip(x1, 0, n - 1).astype(np.int64) // TILE_X
    ty0 = np.clip(y0, 0, n - 1).astype(np.int64) // TILE_Y
    ty1 = np.clip(y1, 0, n - 1).astype(np.int64) // TILE_Y
    sx = int((tx1 - tx0 + 1)[ne].max())
    sy = int((ty1 - ty0 + 1)[ne].max())
    return (min(sx, cap[0]), min(sy, cap[1]))


class DeformingVoxelizer:
    """Per-frame re-bin + voxelize with zero host syncs after warmup.

    The reference rebuilds nothing per frame (static AS) but re-voxelizes;
    the BASELINE.json deforming config re-bins too. The chunk capacity is
    sized from the rest mesh (x ``headroom``); a frame that overflows it
    raises when checked (grow and retry by constructing a new instance).
    """

    def __init__(self, verts_norm, tris, n: int, k_chunk: int = 64,
                 headroom: float = 1.5, interpret: bool = False):
        # span caps from the rest mesh: the pair sort scales with
        # span_x*span_y*T candidate rows (see rest_mesh_spans)
        self.spans = rest_mesh_spans(verts_norm, tris, n)
        _, _, _, stats = build_queue(
            verts_norm, tris, n, k_chunk=k_chunk,
            max_span_x=self.spans[0], max_span_y=self.spans[1],
        )
        cap = int(stats.real_chunks * headroom) + 8
        self.num_chunks = -(-cap // 128) * 128
        self.n = n
        self.k_chunk = k_chunk
        self.tris = tris
        self.interpret = interpret

    def __call__(self, verts_norm, check: bool = False):
        """Deformed vertices -> packed occupancy words [N,N,N//32]."""
        coefs, row0, count, ok = _build_queue_device(
            verts_norm, self.tris, self.n, self.num_chunks, self.k_chunk,
            self.spans[0], self.spans[1],
        )
        if check and not bool(ok):  # host sync only when asked
            raise RuntimeError(
                "deforming queue overflowed its capacity; rebuild with "
                "more headroom"
            )
        return run_queue(coefs, row0, count, self.n, interpret=self.interpret)
