"""dxrvoxelizer_tpu — real-time solid voxelization engine in JAX.

A JAX/XLA/Pallas framework with the capabilities of StarsX/DXRVoxelizer:
load a Wavefront-OBJ mesh, solid-voxelize it every
frame into a dense 3D occupancy grid, and volume-ray-march that grid to screen.

Two API tiers, mirroring the reference's Core (explicit DX12-style) and EZ
(ergonomic DX11-style) paths (reference: DXRVoxelizer/Content/Voxelizer.cpp and
VoxelizerEZ.cpp):

- ``dxrvoxelizer_tpu.core`` — explicit pipeline: you own device buffers, pass
  configs, and call jitted pass functions.
- ``dxrvoxelizer_tpu.ez``   — stateful ``Engine`` that wires everything for you.

Subpackages:
- ``utils``    — OBJ loader, DirectXMath-convention matrices, timer, image IO.
- ``models``   — mesh / scene / camera state (the "model" of the workload).
- ``ops``      — compute kernels: oracles (jax.numpy), the production
                 voxelizers and renderers, and Pallas (Triton-route) GPU
                 kernels picked per platform by ``ops/route.py``.
- ``parallel`` — jax.sharding Mesh helpers, multi-card sharded passes,
                 batch data-generation.
- ``app``      — CLI application (same flags as the reference:
                 ``-mesh <file> [x y z scale]``).
"""

__version__ = "0.1.0"

from dxrvoxelizer_tpu.models.scene import Scene  # noqa: F401
from dxrvoxelizer_tpu.models.camera import OrbitCamera  # noqa: F401
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig  # noqa: F401
