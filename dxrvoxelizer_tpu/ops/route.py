"""One place that picks each job's implementation for the platform.

Every job of the frame has one implementation per platform, chosen here
from ``jax.default_backend()`` and nowhere else:

- ``"gpu"``: the Triton-route kernel, or XLA's own code where the plain
  version won on the card (PERF.md, "Kernel choices on the H100");
- ``"cpu"``: the plain jnp path (tests and the ``-warp`` software path).

Any other platform raises. Kernels run in interpret mode only when a
caller passes ``interpret=True`` explicitly (the CPU tests do); nothing
here turns it on.
"""

from __future__ import annotations

import jax

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """The default backend's platform, checked against the supported set."""
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported platform {p!r}: dxrvoxelizer_tpu runs on "
            f"{' or '.join(PLATFORMS)}"
        )
    return p


def parity_voxelize():
    """Work-queue parity fold ``fold(coefs, tile_row0, tile_count,
    tile_off, n) -> occupancy tiles [tiles, n//32, 128]``."""
    from dxrvoxelizer_tpu.ops import voxelize_queue as vq

    return {"gpu": vq.queue_fold_triton, "cpu": vq.queue_fold_xla}[platform()]


def raystab_query():
    """Ray-stab closest-hit fold + winner extraction over candidate tables,
    ``fn(rays, coefs, ntab, k, t_count, threshold, rule=, shared=,
    bounds=) -> (t, id, rgba channels)``."""
    from dxrvoxelizer_tpu.ops import raystab_fast, raystab_pallas

    return {
        "gpu": raystab_pallas.stab_fold_extract,
        "cpu": raystab_fast.fold_extract_xla,
    }[platform()]


def march():
    """Shear-warp compositing march over the warped slabs (XLA on both
    platforms; PERF.md records why no fused march kernel)."""
    from dxrvoxelizer_tpu.ops import raymarch_warp

    platform()
    return raymarch_warp.march_xla


def resolve():
    """Screen resolve: bilinear read of the composited intermediate (XLA
    gathers on both platforms)."""
    from dxrvoxelizer_tpu.ops import raymarch_warp

    platform()
    return raymarch_warp.bilinear_take
