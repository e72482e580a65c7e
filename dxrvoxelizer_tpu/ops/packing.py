"""Grid conventions, bit packing, and texture-format emulation.

Grid convention (shared by every op in this package):

- The voxel grid is an array ``grid[i, j, k]`` with ``i`` the x texel, ``j``
  the y texel, ``k`` the z texel — exactly the ``RWTexture3D`` indexing of the
  reference (DXRVoxelizer.hlsl:84 ``RenderTarget[index]``).
- Voxel (i, j, k) has normalized-grid-space center
  ``p = ((i,j,k) + 0.5) / N * 2 - 1`` with ``p.y`` negated
  (DXRVoxelizer.hlsl:44-53 ``generateRay``), and texture-space center
  ``((i,j,k) + 0.5) / N``; the two are consistent through the sampler's
  ``(0.5, -0.5, 0.5) * pos + 0.5`` mapping (PSRayCast.hlsl:137).

Packed occupancy: the production voxelizer stores one bit per voxel packed
along z into int32 words: ``occ_words[i, j, w]`` holds voxels
``k = 32w .. 32w+31`` (bit ``k & 31``). A 256^3 grid is 2 MB.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def voxel_centers_norm(n: int):
    """Normalized-space voxel center coordinate arrays (cx[i], cy[j], cz[k])."""
    t = (np.arange(n, dtype=np.float32) + 0.5) / n * 2.0 - 1.0
    return t, (-t).astype(np.float32), t


def norm_to_index_space(p, n: int):
    """Map normalized-space points [-1,1]^3 -> continuous voxel-index space
    where voxel centers sit at integer coordinates (y axis flipped)."""
    p = jnp.asarray(p)
    scale = jnp.asarray([0.5, -0.5, 0.5], dtype=p.dtype) * n
    return p * scale + (0.5 * n - 0.5)


def pack_bits_z(occ: jnp.ndarray) -> jnp.ndarray:
    """Pack a boolean grid [N,N,N] (z minor) into int32 words [N,N,N//32]."""
    n = occ.shape[-1]
    assert n % 32 == 0, "grid size must be a multiple of 32 for packing"
    b = occ.astype(jnp.uint32).reshape(*occ.shape[:-1], n // 32, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)
    return words.astype(jnp.int32)


def unpack_bits_z(words: jnp.ndarray, n: int) -> jnp.ndarray:
    """Inverse of :func:`pack_bits_z` -> bool grid [N,N,N]."""
    w = words.astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (w[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*words.shape[:-1], n).astype(bool)


def quantize_r10g10b10a2(rgba: jnp.ndarray) -> jnp.ndarray:
    """Emulate a ``R10G10B10A2_UNORM`` store+load round trip.

    The reference grid texture is R10G10B10A2_UNORM (Content/Voxelizer.cpp:65):
    RGB in 10 bits, alpha in 2 bits, all clamped to [0,1]. Normals written as
    ``float4(Normal, 1.0)`` therefore lose their negative components
    (DXRVoxelizer.hlsl:84) and alpha quantizes to {0, 1/3, 2/3, 1}.
    """
    rgb = jnp.clip(rgba[..., :3], 0.0, 1.0)
    a = jnp.clip(rgba[..., 3:], 0.0, 1.0)
    rgb_q = jnp.round(rgb * 1023.0) / 1023.0
    a_q = jnp.round(a * 3.0) / 3.0
    return jnp.concatenate([rgb_q, a_q], axis=-1)
