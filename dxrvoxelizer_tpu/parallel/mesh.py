"""Device-mesh helpers.

The reference is single-GPU (SURVEY.md section 2c); scale-out here is a
1-D ``jax.sharding.Mesh`` whose axis carries both the voxel tile-group
sharding (voxelize) and the screen-row sharding (ray-march), with one
``all_gather`` of the packed occupancy words between the passes. Cards
joined all to all (NVLink) make a 1-D mesh the natural shape.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_device_mesh(n_devices: int | None = None, axis: str = "slab") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, found {len(devs)}; "
                "for tests set --xla_force_host_platform_device_count"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
