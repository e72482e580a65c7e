"""Trilinear texture sampling (the LINEAR_CLAMP sampler analog).

The reference samples its 3D grid with a linear-clamp sampler
(Content/Voxelizer.cpp:256, PSRayCast.hlsl:106-108). This is the explicit
8-tap gather with edge clamping used by the jax.numpy renderers (XLA lowers
the gathers).
"""

from __future__ import annotations

import jax.numpy as jnp


def sample_trilinear(volume: jnp.ndarray, tex: jnp.ndarray) -> jnp.ndarray:
    """Sample ``volume[Nx,Ny,Nz]`` at texture coords ``tex[...,3]`` in [0,1].

    D3D linear-clamp semantics: texel centers at (i+0.5)/N, coordinates
    clamped to the edge texels.
    """
    n = jnp.asarray(volume.shape, dtype=tex.dtype)
    c = tex * n - 0.5
    c0 = jnp.floor(c)
    f = c - c0
    i0 = jnp.clip(c0.astype(jnp.int32), 0, jnp.asarray(volume.shape, jnp.int32) - 1)
    i1 = jnp.clip(
        c0.astype(jnp.int32) + 1, 0, jnp.asarray(volume.shape, jnp.int32) - 1
    )

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    c000 = volume[x0, y0, z0]
    c100 = volume[x1, y0, z0]
    c010 = volume[x0, y1, z0]
    c110 = volume[x1, y1, z0]
    c001 = volume[x0, y0, z1]
    c101 = volume[x1, y0, z1]
    c011 = volume[x0, y1, z1]
    c111 = volume[x1, y1, z1]

    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0_ = c00 + (c10 - c00) * fy
    c1_ = c01 + (c11 - c01) * fy
    return c0_ + (c1_ - c0_) * fz
