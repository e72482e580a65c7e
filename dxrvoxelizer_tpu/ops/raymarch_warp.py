"""Shear-warp volume renderer — the production render path.

This renderer restructures the reference's per-pixel ray march so every
volume access is **regular** (slab-wise dense matmuls instead of
per-sample trilinear gathers):

1. **Factorization.** Rays are parameterized by their intersection ``g`` with
   a fixed reference plane behind the volume (perpendicular to the view's
   major axis). A ray hits voxel slab k at
   ``p_xy = e_xy + s_k * (g_xy - e_xy)``, ``s_k = (z_k - e_z)/(z_ref - e_z)``
   — for a fixed slab this is a pure per-axis scale+translate of the slab
   image, i.e. two small dense matmuls with 2-tap interpolation matrices
   (ops/warp.py).
2. **Compositing** runs front-to-back over slabs on the intermediate grid
   with the shader's absorption rules (PSRayCast.hlsl:134-179): per-pixel
   step length ``delta = (2/N) * |w|/|w_z|``, attenuation
   ``clip(1 - dens*delta, 0, 1)``, early-out masks expressed as monotone
   clamps. A 64-step elementwise scan — no gathers.
3. **Light transmittance** comes from :func:`light_sweep`: a slab-order
   recurrence along the light's major axis (constant fractional shift per
   slab = one interpolation-matrix pair), replacing the reference's 32-step
   per-sample light march with an N-step per-voxel field.
4. **Screen resolve**: each screen pixel bilinearly reads the composited
   intermediate (scatter, transmit) at one point (:func:`bilinear_take`).

The march and the resolve are picked per platform by ops/route.py.

Approximations vs the exact renderer (ops/raymarch_ref.py): sampling along
the major axis at slab spacing instead of 128 uniform ray steps; light field
at voxel resolution; screen-space bilinear resolve of radiance instead of
per-pixel marching. Tests bound the image difference on canonical scenes.

Sampling-direction degeneracies (rays nearly parallel to the slab planes)
cannot occur for the major axis with the reference's FOV (pi/4: every ray's
major-axis component dominates).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops.raymarch_ref import (
    ABSORPTION,
    TEX_SCALE,
    ZERO_THRESHOLD,
)
from dxrvoxelizer_tpu.ops import route
from dxrvoxelizer_tpu.ops.warp import interp_matrix, scale_offset_coords, warp2d

Z_REF = 1.25  # reference plane (tex space), just past the far slab
S_MIN = 0.05  # near clipping for slabs almost at the eye plane


def _perm_for_axis(axis: int) -> tuple[int, ...]:
    """Permutation moving ``axis`` last, keeping the other two in order."""
    rest = [a for a in range(3) if a != axis]
    return (*rest, axis)


def _tex_params(consts_eye_local: np.ndarray, screen_to_local: np.ndarray,
                width: int, height: int):
    """Host-side static config: major axis, flip, and intermediate-axis swap.

    ``swap``: True when the first non-marching tex axis tracks screen-x more
    than screen-y; the intermediate is then transposed so its *rows* vary
    along screen-y, like the screen's own rows.
    """
    def ray_dir(sx, sy):
        h = np.array([sx, sy, 0.0, 1.0], dtype=np.float32) @ screen_to_local
        p = h[:3] / h[3]
        w = p - consts_eye_local
        return w / np.linalg.norm(w)

    w_tex = TEX_SCALE * ray_dir(width * 0.5, height * 0.5)
    axis = int(np.argmax(np.abs(w_tex)))
    flip = bool(w_tex[axis] < 0)
    rest = [a for a in range(3) if a != axis]
    # how much does the first intermediate axis move per screen-x vs screen-y
    ddx = TEX_SCALE * (ray_dir(width * 0.5 + 8, height * 0.5) - ray_dir(width * 0.5, height * 0.5))
    ddy = TEX_SCALE * (ray_dir(width * 0.5, height * 0.5 + 8) - ray_dir(width * 0.5, height * 0.5))
    swap = bool(abs(ddx[rest[0]]) > abs(ddy[rest[0]]))
    return axis, flip, swap


def _to_tex(p_norm: jnp.ndarray) -> jnp.ndarray:
    return jnp.asarray(TEX_SCALE) * p_norm + 0.5


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """f32 matmul at full precision (GPUs default f32 dots to TF32)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=("n", "axis", "flip"))
def light_sweep(density: jnp.ndarray, light_local: jnp.ndarray,
                n: int, axis: int, flip: bool) -> jnp.ndarray:
    """Directional light-transmittance volume by slab recurrence -> [N,N,N].

    ``axis``/``flip``: the light direction's major tex axis and sign (use
    :func:`light_sweep_host` to compute them).
    """
    ld_n = light_local / jnp.linalg.norm(light_local)
    ld_t = jnp.asarray(TEX_SCALE) * ld_n
    perm = _perm_for_axis(axis)
    dens = jnp.transpose(density, perm)  # [X, Y, K]
    ld = ld_t[jnp.asarray(perm)]
    if flip:
        dens = dens[:, :, ::-1]
        ld = ld * jnp.asarray([1.0, 1.0, -1.0])
    dens = jnp.moveaxis(dens, -1, 0)  # [K, X, Y]

    # per-slab constant shift (texels) and normalized-space step length
    shift_x = ld[0] / ld[2]
    shift_y = ld[1] / ld[2]
    delta_l = (2.0 / n) * jnp.linalg.norm(ld_n) / jnp.maximum(jnp.abs(ld[2]), 1e-6)

    coords_x = jnp.arange(n, dtype=jnp.float32) + shift_x
    coords_y = jnp.arange(n, dtype=jnp.float32) + shift_y
    wx = interp_matrix(coords_x, n)  # [n, n]
    wy = interp_matrix(coords_y, n)
    wsum = wx.sum(-1)[:, None] * wy.sum(-1)[None, :]  # [n, n]

    g = jnp.minimum(dens * 8.0, 16.0)
    att = jnp.clip(1.0 - ABSORPTION * delta_l * g, 0.0, 1.0)  # [K, X, Y]

    # blocked scan: CB sequential sub-steps unrolled per lax.scan step —
    # same expressions in the same order (bit-identical), 16x fewer
    # scan steps against a tiny [N, N] matmul each
    cb = 16
    while n % cb:
        cb //= 2

    def body(carry, att_b):
        outs = []
        for j in range(cb):
            # carry = L[k+1] * att[k+1] field; produce L[k]
            l_k = _mm(_mm(wx, carry), wy.T) + (1.0 - wsum)
            outs.append(l_k)
            carry = l_k * att_b[j]
        return carry, jnp.stack(outs)

    init = jnp.ones((n, n), dtype=jnp.float32)  # beyond the last slab: 1
    _, ls = jax.lax.scan(
        body, init, att[::-1].reshape(n // cb, cb, n, n)
    )
    lvol = ls.reshape(n, n, n)[::-1]  # [K, X, Y]

    lvol = jnp.moveaxis(lvol, 0, -1)
    if flip:
        lvol = lvol[:, :, ::-1]
    inv = np.argsort(perm)
    return jnp.transpose(lvol, tuple(inv))


@partial(jax.jit, static_argnames=("n", "axis", "flip"))
def light_sweep_point(density: jnp.ndarray, light_local: jnp.ndarray,
                      n: int, axis: int, flip: bool) -> jnp.ndarray:
    """Point-light transmittance volume by perspective slab sweep -> [N,N,N].

    The _POINT_LIGHT_ variant of :func:`light_sweep` (PSRayCast.hlsl:151-154):
    rays emanate from the light POINT, so the per-slab resample is a
    scale+offset toward the light's xy (the same perspective factorization
    as the eye-ray warp in :func:`_shearwarp_core`) instead of a constant
    shift, and the per-crossing path length varies per voxel
    (``(2/N)*|p-l|/|p_z-l_z|``). Requires the light outside the volume
    beyond the ``axis``/``flip`` side (:func:`light_sweep_point_host`
    checks and falls back to the exact per-voxel field otherwise).
    """
    perm = _perm_for_axis(axis)
    dens = jnp.transpose(density, perm)  # [X, Y, K]
    l_t = _to_tex(light_local)[jnp.asarray(perm)]
    if flip:
        dens = dens[:, :, ::-1]
        l_t = l_t * jnp.asarray([1.0, 1.0, -1.0]) + jnp.asarray(
            [0.0, 0.0, 1.0]
        )
    dens = jnp.moveaxis(dens, -1, 0)  # [K, X, Y]
    lx, ly, lz = l_t[0], l_t[1], l_t[2]

    k = jnp.arange(n, dtype=jnp.float32)
    z_k = (k + 0.5) / n
    # slab k reads the carry field at its light-ray crossing of slab k+1:
    # q = l + a_k (p - l), a_k = (z_{k+1}-lz)/(z_k-lz); the last slab's map
    # is arbitrary (the carry is all-ones there)
    z_next = jnp.concatenate([z_k[1:], jnp.asarray([(n + 0.5) / n])])
    a_k = (z_next - lz) / (z_k - lz)  # [K]
    wx = interp_matrix(
        scale_offset_coords(n, a_k, n * lx * (1.0 - a_k) - 0.5), n
    )  # [K, n, n]
    wy = interp_matrix(
        scale_offset_coords(n, a_k, n * ly * (1.0 - a_k) - 0.5), n
    )

    # per-voxel crossing length in normalized-space units (obliquity ratio
    # is scale-invariant, so tex-space components work directly)
    x_t = (jnp.arange(n, dtype=jnp.float32) + 0.5) / n
    dx2 = (x_t[:, None] - lx) ** 2  # [X,1]
    dy2 = (x_t[None, :] - ly) ** 2  # [1,Y]
    dz = z_k - lz  # [K]
    delta = (2.0 / n) * jnp.sqrt(
        dx2[None] + dy2[None] + (dz**2)[:, None, None]
    ) / jnp.abs(dz)[:, None, None]  # [K, X, Y]

    g = jnp.minimum(dens * 8.0, 16.0)
    att = jnp.clip(1.0 - ABSORPTION * delta * g, 0.0, 1.0)  # [K, X, Y]

    def body(carry, xs):
        att_k, wx_k, wy_k = xs
        wsum = wx_k.sum(-1)[:, None] * wy_k.sum(-1)[None, :]
        l_k = _mm(_mm(wx_k, carry), wy_k.T) + (1.0 - wsum)
        return l_k * att_k, l_k

    init = jnp.ones((n, n), dtype=jnp.float32)
    _, ls = jax.lax.scan(body, init, (att[::-1], wx[::-1], wy[::-1]))
    lvol = ls[::-1]  # [K, X, Y]

    lvol = jnp.moveaxis(lvol, 0, -1)
    if flip:
        lvol = lvol[:, :, ::-1]
    inv = np.argsort(perm)
    return jnp.transpose(lvol, tuple(inv))


def light_sweep_point_host(density: jnp.ndarray, light_local: np.ndarray,
                           n: int) -> jnp.ndarray:
    """Point-light field: perspective sweep when the light clears the
    volume along its major axis, else the exact per-voxel march."""
    light_local = np.asarray(light_local)
    l_t = np.asarray(TEX_SCALE) * light_local + 0.5
    axis = int(np.argmax(np.abs(l_t - 0.5)))
    flip = bool(l_t[axis] < 0.5)
    lz = 1.0 - l_t[axis] if flip else l_t[axis]
    if lz <= 1.0 + 1.0 / n:
        from dxrvoxelizer_tpu.ops.raymarch_fast import (
            precompute_light_volume,
        )

        return precompute_light_volume(
            density, jnp.asarray(light_local), point_light=True
        )
    return light_sweep_point(density, jnp.asarray(light_local), n, axis, flip)


def light_statics(light_local: np.ndarray) -> tuple[int, bool]:
    """Host-side light statics: the light direction's major tex axis+sign."""
    light_local = np.asarray(light_local)
    ld_t = np.asarray(TEX_SCALE) * (light_local / np.linalg.norm(light_local))
    axis = int(np.argmax(np.abs(ld_t)))
    flip = bool(ld_t[axis] < 0)
    return axis, flip


def light_ref_statics(light_local: np.ndarray, n: int,
                      n_light: int = 32) -> tuple[int, bool, int]:
    """Host statics for :func:`light_sweep_ref`: (axis, flip, d0).

    ``d0`` = whole slabs per reference light step along the major axis
    (the recurrence's static window size). d0 == 0 means the step spans
    less than one slab (tiny grids) — callers fall back to the exact
    per-voxel field (``light_sweep_ref_host`` does).
    """
    from dxrvoxelizer_tpu.ops.raymarch_ref import MAX_DIST

    light_local = np.asarray(light_local)
    ld = light_local / np.linalg.norm(light_local)
    s_t = np.asarray(TEX_SCALE) * ld * (MAX_DIST / n_light)
    axis = int(np.argmax(np.abs(s_t)))
    flip = bool(s_t[axis] < 0)
    d0 = int(np.floor(abs(s_t[axis]) * n))
    return axis, flip, d0


@partial(jax.jit, static_argnames=("n", "axis", "flip", "d0", "n_light"))
def light_sweep_ref(density: jnp.ndarray, light_local: jnp.ndarray,
                    n: int, axis: int, flip: bool, d0: int,
                    n_light: int = 32) -> jnp.ndarray:
    """REFERENCE-step directional light field -> [N,N,N] transmittance.

    The reference's light loop (PSRayCast.hlsl:156-173) marches
    ``n_light`` steps of constant vector ``s = dir * MAX_DIST/n_light``
    from the sample toward the light, sampling density trilinearly with
    LINEAR_CLAMP and breaking at the first out-of-box step. Because
    ``n_light * |s| = MAX_DIST`` equals the box diagonal, the step-count
    cap never truncates a ray inside the box, so the loop's product obeys
    the exact recurrence ``L(p) = att(p+s) * L(p+s)`` — computable on the
    slab grid far-to-near along the step's major tex axis:

    - ``att(p+s)``: the shader's attenuation at the trilinearly resampled
      density (2-slab z-mix + constant-shift CLAMP xy warp — two shared
      matmuls per slab, batched);
    - ``L(p+s)``: 2-slab z-mix of already-computed L slabs + constant-
      shift xy warp where out-of-volume reads contribute 1 (no absorption
      outside);
    - out-of-box sample positions (exactly decidable per texel: voxel
      centers shift by the constant s) yield L = 1 — the loop's
      first-step break.

    ``d0``/``axis``/``flip`` come from :func:`light_ref_statics`
    (``d0 >= 1`` required — tiny grids fall back). The only semantic gap
    vs the exact per-voxel march (raymarch_fast.precompute_light_volume)
    is (a) the ``transmit < 0.01`` early-break (absolute error <= 0.01 in
    a region that is essentially black) and (b) L between slabs is
    interpolated rather than re-marched — the -hq image bounds
    (tests/test_goldens.py) pin the end-to-end effect.
    """
    from dxrvoxelizer_tpu.ops.raymarch_ref import MAX_DIST

    assert d0 >= 1, "light step spans < 1 slab; use the exact field"
    ls = MAX_DIST / n_light
    ld = light_local / jnp.linalg.norm(light_local)
    s_full = jnp.asarray(TEX_SCALE) * ld * ls  # tex-space step vector
    perm = _perm_for_axis(axis)
    dens = jnp.transpose(density, perm)  # [X, Y, K]
    s_t = s_full[jnp.asarray(perm)]
    if flip:
        dens = dens[:, :, ::-1]
        s_t = s_t * jnp.asarray([1.0, 1.0, -1.0])
    dvol = jnp.moveaxis(dens, -1, 0)  # [K, X, Y]

    delta = s_t[2] * n  # slabs per step (> 0 by flip), d0 = floor(delta)
    w = delta - d0  # traced fractional part (host floor is consistent)
    sx = s_t[0] * n  # xy shift in texels (constant across slabs)
    sy = s_t[1] * n

    i = jnp.arange(n, dtype=jnp.float32)
    coords_x = i + sx
    coords_y = i + sy
    # L resample: zero-weight outside + complement (outside the volume the
    # transmittance is 1 — nothing absorbs)
    wx_l = interp_matrix(coords_x, n)  # [n, n]
    wy_l = interp_matrix(coords_y, n)
    corr_l = 1.0 - wx_l.sum(-1)[:, None] * wy_l.sum(-1)[None, :]
    # density resample: LINEAR_CLAMP (the sampler clamps the coordinate)
    wx_d = interp_matrix(jnp.clip(coords_x, 0.0, n - 1.0), n)
    wy_d = interp_matrix(jnp.clip(coords_y, 0.0, n - 1.0), n)

    # exact per-texel out-of-box mask for p+s (voxel centers are exactly
    # (i+0.5)/n, the shift is constant)
    px = (i + 0.5) / n + s_t[0]
    py = (i + 0.5) / n + s_t[1]
    in_xy = ((px >= 0.0) & (px <= 1.0))[:, None] & (
        (py >= 0.0) & (py <= 1.0)
    )[None, :]  # [X, Y]
    k = jnp.arange(n, dtype=jnp.float32)
    in_z = (k + 0.5) / n + s_t[2] <= 1.0  # [K] (s_z > 0: lower bound holds)

    # attenuation at p+s for every slab (batched; no scan dependence):
    # z-mix with CLAMP indices, then the shared xy warp
    ki = jnp.arange(n)
    z0 = jnp.clip(ki + d0, 0, n - 1)
    z1 = jnp.clip(ki + d0 + 1, 0, n - 1)
    dmix = dvol[z0] * (1.0 - w) + dvol[z1] * w  # [K, X, Y]
    dres = jnp.einsum("mn,kny->kmy", wx_d, dmix, precision="highest")
    dres = jnp.einsum("kmy,py->kmp", dres, wy_d, precision="highest")
    g = jnp.minimum(dres * 8.0, 16.0)
    att = jnp.clip(1.0 - ABSORPTION * ls * g, 0.0, 1.0)  # [K, X, Y]
    mask = in_xy[None] & in_z[:, None, None]  # [K, X, Y]

    # BLOCKED far-to-near recurrence (a naive per-slab scan copies its
    # [d0+1, N, N] sliding window every slab — ~1.9 GB of pure window
    # movement at 256^3 — and issues 2N latency-bound [N, N] matmuls).
    # Slab k reads only slabs k+d0 and k+d0+1, so a block of d0
    # CONSECUTIVE slabs has no intra-block dependence: scan over
    # ceil(N/d0) blocks, each resampling its whole block with two batched
    # einsums and carrying the last d0+1 slabs.
    # Per-slab arithmetic (mix weights, matmul contractions, select) is
    # the scalar recurrence's, op for op — pinned bit-exact against the
    # per-slab scan by tests/test_raymarch_warp.py.
    # Reversed (far-to-near) slab space: r = n-1-k; slab r reads r-d0-1
    # (weight w) and r-d0 (weight 1-w) — strictly earlier outputs.
    attr = att[::-1]
    maskr = mask[::-1]
    nb = -(-n // d0)
    padn = nb * d0 - n
    if padn:
        # padding slabs sit at the NEAR end (processed last), masked to
        # the constant 1 and sliced off — they feed nothing
        attr = jnp.concatenate(
            [attr, jnp.ones((padn, n, n), attr.dtype)], axis=0
        )
        maskr = jnp.concatenate(
            [maskr, jnp.zeros((padn, n, n), bool)], axis=0
        )

    def body(carry, xs):
        # carry[i] = L[(b-1)*d0 - 1 + i], i in [0, d0]; block slab j
        # (r = b*d0 + j) reads r-d0-1 = carry[j] (w) and r-d0 =
        # carry[j+1] (1-w)
        att_b, mask_b = xs  # [d0, n, n]
        lmix = carry[1:] * (1.0 - w) + carry[:-1] * w
        lres = jnp.einsum("mn,jny->jmy", wx_l, lmix, precision="highest")
        lres = jnp.einsum(
            "jmy,py->jmp", lres, wy_l, precision="highest"
        ) + corr_l
        l_b = jnp.where(mask_b, att_b * lres, 1.0)
        return jnp.concatenate([carry[-1:], l_b], axis=0), l_b

    init = jnp.ones((d0 + 1, n, n), jnp.float32)  # beyond the far face: 1
    _, lb = jax.lax.scan(
        body, init,
        (attr.reshape(nb, d0, n, n), maskr.reshape(nb, d0, n, n)),
    )
    lvol = lb.reshape(nb * d0, n, n)[:n][::-1]  # [K, X, Y]

    lvol = jnp.moveaxis(lvol, 0, -1)
    if flip:
        lvol = lvol[:, :, ::-1]
    inv = np.argsort(perm)
    return jnp.transpose(lvol, tuple(inv))


def light_sweep_ref_host(density: jnp.ndarray, light_local: np.ndarray,
                         n: int, n_light: int = 32) -> jnp.ndarray:
    """Reference-step light field: the matmul recurrence when the step
    spans >= 1 slab, else the exact per-voxel march (tiny grids)."""
    axis, flip, d0 = light_ref_statics(light_local, n, n_light)
    if d0 < 1:
        from dxrvoxelizer_tpu.ops.raymarch_fast import (
            precompute_light_volume,
        )

        return precompute_light_volume(
            density, jnp.asarray(light_local), n_light=n_light
        )
    return light_sweep_ref(
        density, jnp.asarray(light_local), n, axis, flip, d0,
        n_light=n_light,
    )


def light_sweep_host(density: jnp.ndarray, light_local: np.ndarray,
                     n: int) -> jnp.ndarray:
    axis, flip = light_statics(light_local)
    return light_sweep(density, jnp.asarray(light_local), n, axis, flip)


@partial(
    jax.jit,
    static_argnames=(
        "n", "m", "width", "height", "axis", "flip", "swap", "ss",
    ),
)
def _shearwarp_core(
    density: jnp.ndarray,
    light_vol: jnp.ndarray,
    screen_to_local: jnp.ndarray,
    eye_local: jnp.ndarray,
    clear_color: jnp.ndarray,
    n: int,
    m: int,
    width: int,
    height: int,
    axis: int,
    flip: bool,
    swap: bool,
    y_off: jnp.ndarray | None = None,
    ss: int = 1,
):
    perm = _perm_for_axis(axis)
    inv_scale = jnp.asarray(TEX_SCALE)[jnp.asarray(perm)]

    vol2 = jnp.stack([density, light_vol], axis=0)  # [2, N, N, N]
    vol2 = jnp.transpose(vol2, (0, *[p + 1 for p in perm]))  # [2, X, Y, K]
    if flip:
        vol2 = vol2[..., ::-1]
    slabs = jnp.moveaxis(vol2, -1, 1)  # [2, K, X, Y]

    # ``ss``: z-supersampling factor (the high-fidelity mode). ss=1 marches
    # one sample per voxel slab (point-sampled in z, the speed default);
    # ss>1 marches n*ss sub-slabs whose density/light planes are z-LERPed
    # between adjacent voxel slabs with LINEAR_CLAMP edge semantics — with
    # the warp's bilinear xy this makes every sub-slab sample fully
    # trilinear, matching the reference's SampleLevel along the ray
    # (PSRayCast.hlsl:103-112) at 2x its 64-slab z-rate for ss=2.
    ks = n * ss
    if ss > 1:
        pos = (jnp.arange(ks, dtype=jnp.float32) + 0.5) / ss - 0.5
        i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 1)
        i1 = jnp.clip(i0 + 1, 0, n - 1)
        w1 = jnp.clip(pos - i0.astype(jnp.float32), 0.0, 1.0)
        slabs = (
            slabs[:, i0] * (1.0 - w1)[None, :, None, None]
            + slabs[:, i1] * w1[None, :, None, None]
        )  # [2, KS, X, Y]

    e_t_full = _to_tex(eye_local)[jnp.asarray(perm)]
    if flip:
        e_t_full = e_t_full * jnp.asarray([1.0, 1.0, -1.0]) + jnp.asarray(
            [0.0, 0.0, 1.0]
        )
    e_xy = e_t_full[:2]
    e_z = e_t_full[2]
    c_ref = Z_REF - e_z  # positive whenever the volume is in front

    # intermediate footprint: box corners projected from the eye to the
    # reference plane (slabs closer than S_MIN*c_ref are near-clipped)
    corners_z = jnp.asarray([0.0, 1.0])
    c_z = jnp.maximum(corners_z - e_z, S_MIN * c_ref)  # [2]
    scale_c = c_ref / c_z  # [2]
    corners_xy = jnp.asarray([0.0, 1.0])
    # g = e + (corner - e) * scale for each (corner_xy, corner_z) combo
    gx_c = e_xy[0] + (corners_xy[:, None] - e_xy[0]) * scale_c[None, :]
    gy_c = e_xy[1] + (corners_xy[:, None] - e_xy[1]) * scale_c[None, :]
    gmin = jnp.stack([gx_c.min(), gy_c.min()])
    gmax = jnp.stack([gx_c.max(), gy_c.max()])
    gext = gmax - gmin

    # per-(sub-)slab warp matrices
    k = jnp.arange(ks, dtype=jnp.float32)
    z_k = (k + 0.5) / ks
    s_k = jnp.maximum((z_k - e_z) / c_ref, 0.0)  # <=0: slab behind the eye
    scale_x = s_k * gext[0] * n / m
    off_x = n * (e_xy[0] + s_k * (gmin[0] - e_xy[0])) - 0.5
    scale_y = s_k * gext[1] * n / m
    off_y = n * (e_xy[1] + s_k * (gmin[1] - e_xy[1])) - 0.5
    wx = interp_matrix(scale_offset_coords(m, scale_x, off_x), n)  # [K, M, N]
    wy = interp_matrix(scale_offset_coords(m, scale_y, off_y), n)

    dens_w = warp2d(slabs[0], wx, wy)  # [K, M, M]
    light_w = warp2d(slabs[1], wx, wy)

    # per-intermediate-pixel step length (normalized-space units)
    gi = (jnp.arange(m, dtype=jnp.float32) + 0.5) / m
    g_x = gmin[0] + gi * gext[0]
    g_y = gmin[1] + gi * gext[1]
    w_x = (g_x - e_xy[0])[:, None]
    w_y = (g_y - e_xy[1])[None, :]
    # tex -> normalized direction scale is uniform (|2|) per axis, so the
    # obliquity ratio is computable in tex space directly
    delta = (2.0 / ks) * jnp.sqrt(w_x**2 + w_y**2 + c_ref**2) / jnp.abs(c_ref)

    front = (s_k > S_MIN).astype(jnp.float32)  # near-clip mask per slab
    transmit_i, scatter_i = route.march()(dens_w, light_w, front, delta)

    # ---- screen resolve ----------------------------------------------------
    # y_off: first screen row of this band (traced; multi-chip row sharding)
    # Planar [P] layout throughout: one array per component instead of a
    # [P,3] AoS array. Expressions stay identical per component (the screen
    # point is (px, py, 0, 1), so the matmul row-combination is a pure
    # elementwise affine, f32 exact).
    sx = jnp.arange(width, dtype=jnp.float32) + 0.5
    sy = jnp.arange(height, dtype=jnp.float32) + 0.5
    if y_off is not None:
        sy = sy + y_off.astype(jnp.float32)
    px, py = jnp.meshgrid(sx, sy, indexing="xy")
    pxf = px.reshape(-1)
    pyf = py.reshape(-1)
    s_m = screen_to_local
    h = [pxf * s_m[0][c] + pyf * s_m[1][c] + s_m[3][c] for c in range(4)]
    pn = [h[c] / h[3] for c in range(3)]
    d = [pn[c] - eye_local[c] for c in range(3)]
    d_len = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dn = [d[c] / d_len for c in range(3)]

    # ComputeStartPoint hit test (PSRayCast.hlsl:71-98), planar
    inside = (
        (jnp.abs(pn[0]) <= 1.0)
        & (jnp.abs(pn[1]) <= 1.0)
        & (jnp.abs(pn[2]) <= 1.0)
    )
    big = jnp.float32(3.402823466e38)
    u_best = jnp.full(pxf.shape, big, jnp.float32)
    hit = jnp.zeros(pxf.shape, bool)
    for i in range(3):
        j, k2 = (i + 1) % 3, (i + 2) % 3
        di = dn[i]
        u = jnp.where(
            di != 0.0,
            (-jnp.sign(di) - pn[i]) / jnp.where(di != 0.0, di, 1.0),
            big,
        )
        okc = (
            (u >= 0.0)
            & (jnp.abs(dn[j] * u + pn[j]) <= 1.0)
            & (jnp.abs(dn[k2] * u + pn[k2]) <= 1.0)
            & (u < u_best)
        )
        u_best = jnp.where(okc, u, u_best)
        hit = hit | okc
    is_hit = inside | hit

    tex_scale = tuple(float(v) for v in np.asarray(TEX_SCALE))
    d_t = [dn[perm[c]] * tex_scale[perm[c]] for c in range(3)]
    if flip:
        d_t[2] = -d_t[2]
    dz = d_t[2]
    valid = jnp.abs(dz) > 1e-6
    safe_dz = jnp.where(valid, dz, 1.0)
    g_px = e_xy[0] + c_ref * d_t[0] / safe_dz
    g_py = e_xy[1] + c_ref * d_t[1] / safe_dz
    gi_x = (g_px - gmin[0]) / gext[0] * m - 0.5
    gi_y = (g_py - gmin[1]) / gext[1] * m - 0.5

    if swap:
        # intermediate rows track screen-y
        scatter_i = scatter_i.T
        transmit_i = transmit_i.T
        gi_x, gi_y = gi_y, gi_x
    ok = is_hit & valid
    resolve = route.resolve()
    sc = resolve(scatter_i, gi_x, gi_y, m)
    tr = resolve(transmit_i, gi_x, gi_y, m)
    # composite per channel in planar form; the single [P,3] stack at the
    # end is the only AoS materialization
    base = sc * 0.8 + 0.2
    trc = jnp.clip(tr, 0.0, 1.0)
    cc2 = clear_color * clear_color
    chans = []
    for c in range(3):
        res_c = base + (cc2[c] - base) * trc
        rgb_c = jnp.sqrt(jnp.maximum(res_c, 0.0))
        chans.append(jnp.where(ok, rgb_c, clear_color[c]))
    out = jnp.stack(chans, axis=-1)
    return out.reshape(height, width, 3).astype(jnp.float32)


def march_xla(dens_w, light_w, front, delta):
    """Front-to-back compositing over the warped slabs -> (transmit,
    scatter) [M, M] with the shader's absorption rules
    (PSRayCast.hlsl:134-179). ``dens_w``/``light_w`` [KS, M, M] warped
    density and light slabs, ``front`` [KS] near-clip mask, ``delta``
    [M, M] per-pixel step length."""
    ks, m = dens_w.shape[0], dens_w.shape[1]

    def step(transmit, scatter, d_k, l_k, f_k):
        g_s = jnp.minimum(d_k * 8.0, 16.0)
        occupied = (g_s > ZERO_THRESHOLD) & (f_k > 0)
        sigma = g_s * delta
        att = jnp.where(
            occupied, jnp.clip(1.0 - sigma * ABSORPTION, 0.0, 1.0), 1.0
        )
        new_transmit = transmit * att
        contributes = occupied & (new_transmit >= ZERO_THRESHOLD)
        scatter = scatter + jnp.where(
            contributes, l_k * new_transmit * sigma, 0.0
        )
        # shader break: once transmit dies it stays at the dying value
        transmit = jnp.where(
            transmit >= ZERO_THRESHOLD, new_transmit, transmit
        )
        return transmit, scatter

    # BLOCKED compositing scan: CB sequential sub-steps unrolled per
    # lax.scan step, same order and expressions as the per-slab scan (so
    # the composite is bit-identical) with CB-fold fewer scan steps
    cb = 16
    while ks % cb:
        cb //= 2

    def body(carry, xs):
        transmit, scatter = carry
        d_b, l_b, f_b = xs
        for j in range(cb):
            transmit, scatter = step(
                transmit, scatter, d_b[j], l_b[j], f_b[j]
            )
        return (transmit, scatter), None

    init = (jnp.ones((m, m), jnp.float32), jnp.zeros((m, m), jnp.float32))
    (transmit, scatter), _ = jax.lax.scan(
        body, init,
        (
            dens_w.reshape(ks // cb, cb, m, m),
            light_w.reshape(ks // cb, cb, m, m),
            front.reshape(ks // cb, cb, 1, 1),
        ),
    )
    return transmit, scatter


def bilinear_take(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, m: int):
    """Bilinear sample of the [m, m] ``img`` at (x, y), edge-clamped."""
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, m - 1)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, m - 1)
    x1 = jnp.clip(x0 + 1, 0, m - 1)
    y1 = jnp.clip(y0 + 1, 0, m - 1)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    flat = img.reshape(-1)
    v00 = jnp.take(flat, x0 * m + y0)
    v10 = jnp.take(flat, x1 * m + y0)
    v01 = jnp.take(flat, x0 * m + y1)
    v11 = jnp.take(flat, x1 * m + y1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v10 * fx * (1 - fy)
        + v01 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _box_screen_px(screen_to_local: np.ndarray, width: int, height: int) -> float:
    """Host estimate of the volume's screen-space extent in pixels."""
    l2s = np.linalg.inv(screen_to_local.astype(np.float64))
    corners = np.array(
        [[x, y, z, 1.0] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        dtype=np.float64,
    )
    s = corners @ l2s
    w_ok = np.abs(s[:, 3]) > 1e-9
    if not w_ok.any():
        return float(max(width, height))
    p = s[w_ok, :2] / s[w_ok, 3:4]
    ext = p.max(axis=0) - p.min(axis=0)
    return float(np.clip(max(ext[0], ext[1]), 16.0, 4096.0))


def shearwarp_statics(
    screen_to_local,
    eye_local,
    width: int,
    height: int,
    m_cap: int = 128,
    m: int | None = None,
) -> tuple[int, bool, bool, int]:
    """Host-side camera statics ``(axis, flip, swap, m)``.

    These are the compile-time parameters of :func:`_shearwarp_core`; a
    camera crossing a major-axis boundary (or a volume whose screen
    footprint crosses an m bucket) changes the tuple and needs a re-jit —
    callers that keep compiled frames cache them keyed on this tuple
    (parallel/pipeline.py does for the multi-chip frame).
    """
    s2l_np = np.asarray(screen_to_local)
    eye_np = np.asarray(eye_local)
    if m is None:
        # track the volume's screen footprint (magnification ~1) up to
        # ``m_cap`` and at most 512^2 (larger caps sharpen hi-res renders
        # at ~linear march and resolve cost)
        box_px = _box_screen_px(s2l_np, width, height)
        m = int(np.clip(16 * round(0.9 * box_px / 16), 32, min(m_cap, 512)))
    axis, flip, swap = _tex_params(eye_np, s2l_np, width, height)
    return axis, flip, swap, m


def raymarch_shearwarp(
    density: jnp.ndarray,
    light_vol: jnp.ndarray,
    screen_to_local,
    eye_local,
    clear_color,
    width: int,
    height: int,
    m: int | None = None,
    m_cap: int = 128,
    ss: int = 1,
) -> jnp.ndarray:
    """Render via the shear-warp path. Host wrapper: picks the static axis/
    flip/orientation and the intermediate resolution, then calls the jitted
    core. Intermediate resolution tracks the volume's screen footprint
    (magnification ~1). ``ss``: z-supersampling factor (the ``-hq``
    high-fidelity mode)."""
    n = density.shape[0]
    s2l_np = np.asarray(screen_to_local)
    eye_np = np.asarray(eye_local)
    axis, flip, swap, m = shearwarp_statics(
        s2l_np, eye_np, width, height, m_cap=m_cap, m=m
    )
    return _shearwarp_core(
        density, light_vol, jnp.asarray(s2l_np), jnp.asarray(eye_np),
        jnp.asarray(np.asarray(clear_color, np.float32)),
        n, m, width, height, axis, flip, swap, ss=ss,
    )
