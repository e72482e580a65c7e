"""Gather volume ray-marcher (loop-free; the alternate render path).

The reference's pixel shader (PSRayCast.hlsl:117-187) is a sequential
128-step march with a nested 32-step light march. Sequential tiny loop
bodies serialize an accelerator; this formulation exploits that the march
is *affine in the step index* and the breaks are *monotone*:

1. **Light volume precompute** — per voxel center, the reference's exact
   32-step directional light march (PSRayCast.hlsl:156-173) computed for all
   voxels at once; per-sample light transmittance then becomes one trilinear
   read. (The reference re-marches light from every primary sample; sampling
   the precomputed field is the one approximation of this renderer —
   ops/raymarch_ref.py keeps the exact semantics for golden tests.)
2. **All-steps gather** — sample positions ``pos_s = entry + s * step`` do
   not depend on any carry, so all 128 densities arrive in one batched
   trilinear gather (flat ``jnp.take``).
3. **Monotone masks as scans** — a convex box means the in-box predicate is
   a running AND; attenuation factors are <= 1 so transmittance is a cumprod
   and the ``transmit < 0.01`` break is "first crossing" — all expressible
   as dense per-step arithmetic, zero sequential dependencies beyond a
   single O(log S) scan.

Shader-rule mapping is annotated inline. Output matches ops/raymarch_ref.py
up to the light-field approximation (tests assert a tight image tolerance).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dxrvoxelizer_tpu.ops.raymarch_ref import (
    ABSORPTION,
    MAX_DIST,
    TEX_SCALE,
    ZERO_THRESHOLD,
    compute_start_point,
)

__all__ = ["precompute_light_volume", "raymarch_fast"]


def _flat_trilinear(vol_flat: jnp.ndarray, n: int, tex: jnp.ndarray) -> jnp.ndarray:
    """Trilinear sample of a flattened [n^3] volume at tex in [0,1]^3.

    Linear-clamp semantics (texel centers at (i+0.5)/n), by flat
    ``jnp.take``.
    """
    c = tex * n - 0.5
    c0 = jnp.floor(c)
    f = c - c0
    i0 = jnp.clip(c0.astype(jnp.int32), 0, n - 1)
    i1 = jnp.clip(c0.astype(jnp.int32) + 1, 0, n - 1)

    def flat(ix, iy, iz):
        return (ix * n + iy) * n + iz

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]

    v000 = jnp.take(vol_flat, flat(x0, y0, z0))
    v100 = jnp.take(vol_flat, flat(x1, y0, z0))
    v010 = jnp.take(vol_flat, flat(x0, y1, z0))
    v110 = jnp.take(vol_flat, flat(x1, y1, z0))
    v001 = jnp.take(vol_flat, flat(x0, y0, z1))
    v101 = jnp.take(vol_flat, flat(x1, y0, z1))
    v011 = jnp.take(vol_flat, flat(x0, y1, z1))
    v111 = jnp.take(vol_flat, flat(x1, y1, z1))

    c00 = v000 + (v100 - v000) * fx
    c10 = v010 + (v110 - v010) * fx
    c01 = v001 + (v101 - v001) * fx
    c11 = v011 + (v111 - v011) * fx
    c0_ = c00 + (c10 - c00) * fy
    c1_ = c01 + (c11 - c01) * fy
    return c0_ + (c1_ - c0_) * fz


def _get_sample(vol_flat, n, tex):
    """GetSample (PSRayCast.hlsl:103-112): min(trilinear * 8, 16)."""
    return jnp.minimum(_flat_trilinear(vol_flat, n, tex) * 8.0, 16.0)


@partial(jax.jit, static_argnames=("n_light", "point_light"))
def precompute_light_volume(
    density: jnp.ndarray, light_local: jnp.ndarray, n_light: int = 32,
    point_light: bool = False,
) -> jnp.ndarray:
    """Light transmittance at every voxel center -> [N,N,N] f32.

    Runs the reference's light loop (PSRayCast.hlsl:156-173) from each voxel
    center: 32 steps of length 2*sqrt(3)/32 toward the light, sampling the
    density field trilinearly, with both break rules (out-of-box, trans <
    0.01) expressed as monotone masks. ``point_light``: per-voxel direction
    ``normalize(lightPt - pos)`` (the _POINT_LIGHT_ branch,
    PSRayCast.hlsl:151-154) instead of the shared directional step.
    """
    n = density.shape[0]
    v = n * n * n
    vol_flat = density.reshape(-1)
    light_step_scale = MAX_DIST / n_light

    t = (jnp.arange(n, dtype=jnp.float32) + 0.5) / n * 2.0 - 1.0
    px, py, pz = jnp.meshgrid(t, -t, t, indexing="ij")
    pos0 = jnp.stack([px, py, pz], axis=-1).reshape(-1, 3)  # [V,3] voxel centers

    if not point_light:
        light_dir = light_local / jnp.linalg.norm(light_local)
        dir_step = (light_dir * light_step_scale)[None, None, :]  # [1,1,3]

    def chunk_lt(pos0_c):
        # per-voxel-chunk light march: positions j = pos0 + (j+1) * step
        # (first sample is one step off, PSRayCast.hlsl:157)
        if point_light:
            ld = light_local[None, :] - pos0_c  # [C,3]
            step = (
                ld / jnp.linalg.norm(ld, axis=-1, keepdims=True)
            )[None] * light_step_scale  # [1,C,3]
        else:
            step = dir_step
        j = jnp.arange(n_light, dtype=jnp.float32)[:, None, None]
        pos = pos0_c[None] + step * (j + 1.0)  # [J,C,3]
        in_box = jnp.all(jnp.abs(pos) <= 1.0, axis=-1)  # [J,C]
        # the loop breaks at the first out-of-box step; monotone prefix AND
        in_box = jnp.cumprod(in_box.astype(jnp.float32), axis=0) > 0

        tex = TEX_SCALE * pos + 0.5
        dens = _get_sample(vol_flat, n, tex)  # [J,C]
        att = jnp.clip(1.0 - ABSORPTION * light_step_scale * dens, 0.0, 1.0)
        att = jnp.where(in_box, att, 1.0)

        cp = jnp.cumprod(att, axis=0)  # transmittance after each step
        # break when trans < 0.01 *after* the multiply: the final value is
        # the first element below threshold (cp non-increasing), else last.
        below = cp < ZERO_THRESHOLD
        first_below = jnp.max(jnp.where(below, cp, -1.0), axis=0)
        return jnp.where(below.any(axis=0), first_below, cp[-1])

    # chunk the voxel axis: the march's [n_light, V, 3] intermediates are
    # 6 GB at 256^3 in one piece (OOM on a 16 GB chip — caught by the
    # -ab 256^3 image A/B); per-voxel results are independent, so
    # lax.map over fixed chunks is value-identical
    chunk = min(v, 1 << 19)
    assert v % chunk == 0, (v, chunk)
    if v == chunk:
        lt = chunk_lt(pos0)
    else:
        lt = jax.lax.map(chunk_lt, pos0.reshape(-1, chunk, 3)).reshape(-1)
    return lt.reshape(n, n, n)


@partial(
    jax.jit,
    static_argnames=("width", "height", "n_samples", "px_chunk"),
)
def raymarch_fast(
    density: jnp.ndarray,
    light_volume: jnp.ndarray,
    screen_to_local: jnp.ndarray,
    eye_local: jnp.ndarray,
    clear_color: jnp.ndarray,
    width: int,
    height: int,
    n_samples: int = 128,
    px_chunk: int = 1 << 17,
    y_offset: jnp.ndarray | float = 0.0,
) -> jnp.ndarray:
    """Render -> [height, width, 3] float32 in [0,1]. Loop-free march.

    ``density``: [N,N,N] alpha grid; ``light_volume``: from
    :func:`precompute_light_volume`; matrices in row-vector convention.
    ``y_offset`` (may be traced): first screen row — lets multi-chip shards
    each render a horizontal band (parallel/shard.py).
    """
    n = density.shape[0]
    dens_flat = density.reshape(-1)
    light_flat = light_volume.reshape(-1)
    step_scale = MAX_DIST / n_samples

    # ray setup (identical to raymarch_ref)
    sx = jnp.arange(width, dtype=jnp.float32) + 0.5
    sy = jnp.arange(height, dtype=jnp.float32) + 0.5 + y_offset
    px, py = jnp.meshgrid(sx, sy, indexing="xy")
    screen = jnp.stack([px, py, jnp.zeros_like(px), jnp.ones_like(px)], axis=-1)
    h = jnp.matmul(
        screen.reshape(-1, 4), screen_to_local,
        precision=jax.lax.Precision.HIGHEST,
    )
    pos = h[:, :3] / h[:, 3:4]
    d = pos - eye_local
    ray_dir = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    entry, is_hit = compute_start_point(pos, ray_dir)

    n_px = width * height
    pad = (-n_px) % px_chunk
    if pad:
        entry = jnp.pad(entry, ((0, pad), (0, 0)))
        ray_dir = jnp.pad(
            ray_dir, ((0, pad), (0, 0)), constant_values=1.0
        )
        is_hit = jnp.pad(is_hit, (0, pad))

    s = jnp.arange(n_samples, dtype=jnp.float32)[:, None, None]  # [S,1,1]

    def chunk_fn(args):
        entry_c, dir_c, hit_c = args  # [C,3],[C,3],[C]
        pos_s = entry_c[None] + dir_c[None] * (s * step_scale)  # [S,C,3]
        in_box = jnp.all(jnp.abs(pos_s) <= 1.0, axis=-1)  # [S,C]
        in_box = jnp.cumprod(in_box.astype(jnp.float32), axis=0) > 0
        active = in_box & hit_c[None]

        tex = TEX_SCALE * pos_s + 0.5
        dens = _get_sample(dens_flat, n, tex)  # [S,C]
        occupied = active & (dens > ZERO_THRESHOLD)

        sigma = dens * step_scale
        att = jnp.where(
            occupied, jnp.clip(1.0 - sigma * ABSORPTION, 0.0, 1.0), 1.0
        )
        transmit = jnp.cumprod(att, axis=0)  # post-update transmittance
        # break-BEFORE-scatter when transmit dies (PSRayCast.hlsl:147-148)
        contributes = occupied & (transmit >= ZERO_THRESHOLD)

        lt = _flat_trilinear(light_flat, n, tex)  # light transmittance
        scatter = jnp.sum(
            jnp.where(contributes, lt * transmit * sigma, 0.0), axis=0
        )  # [C]
        final_transmit = transmit[-1]
        # if the march died early, transmit at the break is what the shader
        # keeps; cumprod continues multiplying 1s after (att=1 when not
        # occupied) and the dying step's value persists only if no later
        # occupied steps -- recover the shader value: transmit at the last
        # contributing step, else the running product.
        died = (transmit < ZERO_THRESHOLD) & occupied
        first_dead = jnp.max(jnp.where(died, transmit, -1.0), axis=0)
        final_transmit = jnp.where(died.any(axis=0), first_dead, final_transmit)
        return scatter, final_transmit

    n_chunks = (n_px + pad) // px_chunk
    if n_chunks == 1:
        scatter, transmit = chunk_fn((entry, ray_dir, is_hit))
    else:
        scatter, transmit = jax.lax.map(
            chunk_fn,
            (
                entry.reshape(n_chunks, px_chunk, 3),
                ray_dir.reshape(n_chunks, px_chunk, 3),
                is_hit.reshape(n_chunks, px_chunk),
            ),
        )
        scatter = scatter.reshape(-1)
        transmit = transmit.reshape(-1)

    scatter = scatter[:n_px]
    transmit = transmit[:n_px]
    is_hit = is_hit[:n_px]

    result = scatter[:, None] * 0.8 + 0.2
    cc2 = clear_color * clear_color
    result = result + (cc2[None, :] - result) * transmit[:, None]
    rgb = jnp.sqrt(result)
    out = jnp.where(is_hit[:, None], rgb, clear_color[None, :])
    return out.reshape(height, width, 3).astype(jnp.float32)
