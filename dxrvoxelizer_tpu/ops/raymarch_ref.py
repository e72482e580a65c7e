"""Reference volume ray-marcher (jax.numpy), shader-exact.

Replicates ``PSRayCast.hlsl`` step by step (reference: Content/Shaders/
PSRayCast.hlsl:117-187): screen -> local near-plane point, ray-box entry
clamp, 128 fixed primary steps with early-out, per-occupied-sample 32-step
directional light march, absorption-only transmittance, final
``sqrt(scatter*0.8 + 0.2)`` tone curve lerped to the clear color by
transmittance. "Breaks" become masks: a broken lane keeps marching but
contributes nothing — results are identical to the sequential shader.

This is the correctness renderer; the production shear-warp renderer
(ops/raymarch_warp.py) must match it to image tolerance.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops.sampling import sample_trilinear

NUM_SAMPLES = 128  # PSRayCast.hlsl:7
NUM_LIGHT_SAMPLES = 32  # PSRayCast.hlsl:8
ABSORPTION = 1.0  # PSRayCast.hlsl:9
ZERO_THRESHOLD = 0.01  # PSRayCast.hlsl:10
MAX_DIST = 2.0 * math.sqrt(3.0)  # PSRayCast.hlsl:33
TEX_SCALE = np.array([0.5, -0.5, 0.5], dtype=np.float32)  # PSRayCast.hlsl:137


def get_sample(density: jnp.ndarray, tex: jnp.ndarray) -> jnp.ndarray:
    """GetSample (PSRayCast.hlsl:103-112): min(trilinear(alpha) * 8, 16)."""
    return jnp.minimum(sample_trilinear(density, tex) * 8.0, 16.0)


def compute_start_point(pos: jnp.ndarray, ray_dir: jnp.ndarray):
    """ComputeStartPoint (PSRayCast.hlsl:71-98), vectorized over rays.

    Returns (clamped entry pos, is_hit). Points already inside [-1,1]^3 are
    hits with unchanged pos.
    """
    inside = jnp.all(jnp.abs(pos) <= 1.0, axis=-1)

    big = jnp.float32(3.402823466e38)
    u_best = jnp.full(pos.shape[:-1], big, dtype=pos.dtype)
    hit = jnp.zeros(pos.shape[:-1], dtype=bool)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        di = ray_dir[..., i]
        # -sign(d) target plane; d == 0 -> sign 0 -> u = -pos/0 = +-inf (skip)
        u = jnp.where(
            di != 0.0,
            (-jnp.sign(di) - pos[..., i]) / jnp.where(di != 0.0, di, 1.0),
            big,
        )
        ok = (
            (u >= 0.0)
            & (jnp.abs(ray_dir[..., j] * u + pos[..., j]) <= 1.0)
            & (jnp.abs(ray_dir[..., k] * u + pos[..., k]) <= 1.0)
            & (u < u_best)
        )
        u_best = jnp.where(ok, u, u_best)
        hit = hit | ok

    u_final = jnp.where(inside, 0.0, jnp.where(hit, u_best, 0.0))
    entry = jnp.clip(ray_dir * u_final[..., None] + pos, -1.0, 1.0)
    entry = jnp.where(inside[..., None], pos, entry)
    return entry, inside | hit


def _light_march(density, pos, light_step, n_light: int):
    """Inner light loop (PSRayCast.hlsl:156-173) -> lightTrans per ray."""
    light_step_scale = MAX_DIST / n_light

    def body(_i, carry):
        light_trans, light_pos, alive = carry
        in_box = jnp.all(jnp.abs(light_pos) <= 1.0, axis=-1)
        active = alive & in_box
        tex = TEX_SCALE * light_pos + 0.5
        dens = get_sample(density, tex)
        new_trans = light_trans * jnp.clip(
            1.0 - ABSORPTION * light_step_scale * dens, 0.0, 1.0
        )
        light_trans = jnp.where(active, new_trans, light_trans)
        # break if transmittance died (skips future steps only)
        alive = active & (light_trans >= ZERO_THRESHOLD)
        light_pos = light_pos + light_step
        return light_trans, light_pos, alive

    init = (
        jnp.ones(pos.shape[:-1], dtype=pos.dtype),
        pos + light_step,
        jnp.ones(pos.shape[:-1], dtype=bool),
    )
    light_trans, _, _ = jax.lax.fori_loop(0, n_light, body, init)
    return light_trans


@partial(jax.jit, static_argnames=("width", "height", "n_samples", "n_light",
                                   "point_light"))
def raymarch_ref(
    density: jnp.ndarray,
    screen_to_local: jnp.ndarray,
    eye_local: jnp.ndarray,
    light_local: jnp.ndarray,
    clear_color: jnp.ndarray,
    width: int,
    height: int,
    n_samples: int = NUM_SAMPLES,
    n_light: int = NUM_LIGHT_SAMPLES,
    y_offset: jnp.ndarray | float = 0.0,
    point_light: bool = False,
) -> jnp.ndarray:
    """Render the density grid -> [height, width, 3] float32 image in [0,1].

    ``density``: [N,N,N] alpha grid (post R10G10B10A2 quantization);
    ``screen_to_local``: [4,4] row-vector matrix; ``clear_color``: [3].
    ``y_offset`` (may be traced): first screen row — band renders and
    multi-card shards use it. ``point_light``: the
    reference's _POINT_LIGHT_ compile branch — per-sample light direction
    ``normalize(lightPt - pos)`` instead of the fixed directional step
    (PSRayCast.hlsl:125-127 vs 151-154).
    """
    step_scale = MAX_DIST / n_samples
    light_step_scale = MAX_DIST / n_light

    # SV_POSITION pixel centers
    sx = jnp.arange(width, dtype=jnp.float32) + 0.5
    sy = jnp.arange(height, dtype=jnp.float32) + 0.5 + y_offset
    px, py = jnp.meshgrid(sx, sy, indexing="xy")  # [H,W]
    screen = jnp.stack(
        [px, py, jnp.zeros_like(px), jnp.ones_like(px)], axis=-1
    )  # [H,W,4]

    # row-vector transform at full f32 precision (reduced-precision matmul
    # passes, e.g. TF32 on GPUs, visibly shift ray origins)
    h = jnp.matmul(screen, screen_to_local, precision=jax.lax.Precision.HIGHEST)
    pos = h[..., :3] / h[..., 3:4]  # ScreenToLocal (PSRayCast.hlsl:61-66)

    d = pos - eye_local
    ray_dir = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    entry, is_hit = compute_start_point(pos, ray_dir)

    step = ray_dir * step_scale
    light_dir = light_local / jnp.linalg.norm(light_local)
    light_step = light_dir * light_step_scale  # directional (PSRayCast.hlsl:126)

    def body(_i, carry):
        pos, transmit, scatter, alive = carry
        in_box = jnp.all(jnp.abs(pos) <= 1.0, axis=-1)
        active = alive & in_box
        tex = TEX_SCALE * pos + 0.5
        dens = get_sample(density, tex)
        occupied = active & (dens > ZERO_THRESHOLD)

        scaled_dens = dens * step_scale
        new_transmit = transmit * jnp.clip(1.0 - scaled_dens * ABSORPTION, 0.0, 1.0)
        transmit = jnp.where(occupied, new_transmit, transmit)
        # the shader breaks BEFORE accumulating scatter when transmit dies
        # (PSRayCast.hlsl:147-148)
        contributes = occupied & (transmit >= ZERO_THRESHOLD)

        if point_light:
            # per-sample light direction (PSRayCast.hlsl:151-154)
            ld = light_local - pos
            ld = ld / jnp.linalg.norm(ld, axis=-1, keepdims=True)
            step_l = ld * light_step_scale
        else:
            step_l = light_step
        light_trans = _light_march(density, pos, step_l, n_light)
        scatter = scatter + jnp.where(
            contributes, light_trans * transmit * scaled_dens, 0.0
        )

        alive = jnp.where(occupied, contributes, active)
        pos = pos + step
        return pos, transmit, scatter, alive

    shape = entry.shape[:-1]
    init = (
        entry,
        jnp.ones(shape, dtype=jnp.float32),
        jnp.zeros(shape, dtype=jnp.float32),
        is_hit,
    )
    _, transmit, scatter, _ = jax.lax.fori_loop(0, n_samples, body, init)

    result = scatter[..., None] * 0.8 + 0.2  # [H,W,3] broadcast
    cc2 = (clear_color * clear_color)[None, None, :]
    result = result + (cc2 - result) * transmit[..., None]  # lerp by transmit
    rgb = jnp.sqrt(result)
    # misses return the clear color directly (PSRayCast.hlsl:121)
    return jnp.where(is_hit[..., None], rgb, clear_color[None, None, :]).astype(
        jnp.float32
    )
