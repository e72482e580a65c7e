"""Device-resident mesh buffers.

The reference uploads interleaved VB/IB to GPU memory and builds a DXR
BLAS over them in *normalized grid space* via the instance transform
``inverse(S(bound.w) * T(bound.xyz))`` (reference: Content/Voxelizer.cpp:115-138,
304-310). The equivalent here: mesh arrays live in device memory as ``jax.Array``s,
and the "acceleration structure" input is the pre-transformed normalized-space
triangle soup (v0, e1, e2 and per-triangle plane/edge equations are derived
inside the voxelize ops).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.utils.objloader import ObjMesh


@jax.tree_util.register_pytree_node_class
@dataclass
class MeshBuffers:
    """HBM-resident mesh: ``positions``/``normals`` [V,3] f32, ``tris`` [T,3] i32.

    ``positions_norm`` are positions mapped to normalized grid space [-1,1]^3
    (the space in which the reference's acceleration structure lives).
    """

    positions: jax.Array
    normals: jax.Array
    tris: jax.Array
    positions_norm: jax.Array

    def tree_flatten(self):
        return (self.positions, self.normals, self.tris, self.positions_norm), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_triangles(self) -> int:
        return int(self.tris.shape[0])

    @classmethod
    def from_obj(cls, mesh: ObjMesh, bound: np.ndarray | None = None) -> "MeshBuffers":
        b = mesh.bound() if bound is None else np.asarray(bound, dtype=np.float32)
        center = b[:3]
        half = max(float(b[3]), np.finfo(np.float32).tiny)
        pos = jnp.asarray(mesh.positions)
        pos_norm = (pos - jnp.asarray(center)) / half
        return cls(
            positions=pos,
            normals=jnp.asarray(mesh.normals),
            tris=jnp.asarray(mesh.triangles.astype(np.int32)),
            positions_norm=pos_norm.astype(jnp.float32),
        )
