"""Separable bilinear warp primitives (matmul-based).

The regular-access building block of the shear-warp renderer
(ops/raymarch_warp.py): resampling a 2D slab on a scaled/translated grid is
two small dense matmuls with 2-tap interpolation matrices — no gathers. Out-of-range taps get zero weight (outside the volume there is no
density), and the row-sum deficit is exposed so callers needing "outside
== 1" semantics (light transmittance) can add the complement.
"""

from __future__ import annotations

import jax.numpy as jnp


def interp_matrix(coords: jnp.ndarray, n_in: int) -> jnp.ndarray:
    """Rows of 2-tap linear-interpolation weights.

    ``coords``: [..., M] input texel coordinates for each output sample.
    Returns W [..., M, n_in] with W @ values == linear interpolation, zero
    weight for taps outside [0, n_in-1].
    """
    c0 = jnp.floor(coords)
    f = coords - c0
    i0 = c0.astype(jnp.int32)
    i1 = i0 + 1
    cols = jnp.arange(n_in, dtype=jnp.int32)
    shape = coords.shape + (n_in,)
    w = jnp.zeros(shape, dtype=jnp.float32)
    hit0 = (cols[None, :] == i0[..., None]) & (i0[..., None] >= 0) & (
        i0[..., None] <= n_in - 1
    )
    hit1 = (cols[None, :] == i1[..., None]) & (i1[..., None] >= 0) & (
        i1[..., None] <= n_in - 1
    )
    w = jnp.where(hit0, (1.0 - f)[..., None], w)
    w = w + jnp.where(hit1, f[..., None], 0.0)
    return w


def scale_offset_coords(m_out: int, scale: jnp.ndarray, offset: jnp.ndarray):
    """Input texel coords for output texel centers under x_in = scale*x_out+offset.

    ``scale``/``offset`` broadcast over leading dims (e.g. per slab).
    Output texel i has center i+0.5 in its own grid; returns [..., m_out].
    """
    i = jnp.arange(m_out, dtype=jnp.float32) + 0.5
    return scale[..., None] * i + offset[..., None]


def warp2d(images: jnp.ndarray, wx: jnp.ndarray, wy: jnp.ndarray) -> jnp.ndarray:
    """Batched separable resample: out[k] = wx[k] @ images[k] @ wy[k]^T.

    images [K, Nx, Ny]; wx [K, Mx, Nx]; wy [K, My, Ny] -> [K, Mx, My].
    """
    t = jnp.einsum("kmn,kny->kmy", wx, images, precision="highest")
    return jnp.einsum("kmy,kpy->kmp", t, wy, precision="highest")
