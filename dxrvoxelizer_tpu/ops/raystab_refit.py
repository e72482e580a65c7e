"""Per-frame ray-stab accel REFIT for deforming meshes — the DXR
acceleration-structure UPDATE analog.

The reference builds its BLAS/TLAS once for static geometry
(/root/reference/DXRVoxelizer/Content/Voxelizer.cpp:264-326); DXR's
general machinery also offers PERFORM_UPDATE refits for deforming,
fixed-topology meshes. The equivalent here splits the gen-2 accel
(ops/raystab_fast.py) into:

- a GEOMETRY-SHAPE half — per-class candidate id tables, ray strips,
  slot scatter streams, chunk-skip bounds, sort keys — built ONCE from
  the rest mesh with a deformation ``pad`` (see
  raystab_fast._cone_keys): the padded cone bins stay a conservative
  prefilter for any per-vertex displacement <= pad, so these tables are
  valid for EVERY frame; and
- a GEOMETRY-VALUE half — the radial coefficient and vertex-normal rows
  the kernels actually fold over — regathered on device each frame from
  the deformed vertices (one [T+1, 12] coefficient matrix + one XLA row
  gather per capacity class; static shapes, one compile per topology).

A refitted accel is bit-identical to a fresh
``build_raystab_accel2(deformed_verts, ...)`` in every kernel-visible
value except the candidate sets, which are a conservative superset —
the exact intersection test rejects the extras, so queries stay
bit-exact vs the radial oracle on the deformed mesh (pinned by
tests/test_raystab_refit.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.ops.raystab_fast import (
    LANE_MIN_K,
    RaystabAccel2,
    _normal_rows_matrix as _normal_rows,  # shared with the static assembly
    _radial_coef_matrix,
    assemble_raystab_accel2,
    build_raystab_compact2,
    table_k,
)


def _gather_rows_to_cols(mat, idx2d):
    """operand [R, W], indices [VC, K] -> output [VC, W, K]: the offset
    (W) axis placed at output dim 1 by the gather itself — the
    lane-aligned table layout comes straight out of the gather, no
    separate [VC, K, W] -> [VC, W, K] transpose op."""
    vc, k = idx2d.shape
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,),
        collapsed_slice_dims=(0,),
        start_index_map=(0,),
    )
    idx = idx2d.reshape(vc, k, 1)
    return jax.lax.gather(
        mat, idx, dn, slice_sizes=(1, mat.shape[1]),
        mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS,
    )


@partial(jax.jit, static_argnames=("lanes", "ov_lane"))
def _refit_tables(verts_norm, normals, tris, tabs, ov_ids,
                  lanes: tuple, ov_lane: bool):
    """Deformed geometry -> fresh (coefs, ntab) per class + overflow.

    ``tabs``: per-class candidate id tables [VC, K] int32 / -1 (device
    resident, static across frames). Gathers are value-identical to
    raystab_fast._assemble_class_dev, so refitted tables match a fresh
    assembly bit-for-bit (lane-aligned classes gather DIRECTLY into the
    [VC, 24, K] layout, _gather_rows_to_cols).

    The coefficient and normal matrices are fused into ONE [T+1, 24]
    matrix and gathered together — half the gather rows and half the
    padded intermediates; the split into the kernel operands is pure
    slicing."""
    t_count = tris.shape[0]
    coef = _radial_coef_matrix(
        verts_norm, tris, jnp.arange(t_count, dtype=jnp.int32)
    )
    ncoef = _normal_rows(normals, tris)
    fused = jnp.concatenate([coef, ncoef], axis=-1)  # [T+1, 24]
    outs = []
    for tab, lane_aligned in zip(tabs, lanes):
        ti = jnp.where(tab >= 0, tab, t_count)
        if lane_aligned:
            g = _gather_rows_to_cols(fused, ti)  # [VC, 24, K]
            outs.append((g[:, :12], g[:, 12:]))
        else:
            g = fused[ti]  # [VC, K, 24]
            outs.append((g[..., :12], g[..., 12:]))
    ov = None
    if ov_ids is not None:
        ti = jnp.where(ov_ids >= 0, ov_ids, t_count)
        g = fused[ti]  # [K, 24]
        if ov_lane:
            g = g.T
            ov = (g[:12], g[12:])
        else:
            ov = (g[:, :12], g[:, 12:])
    return tuple(outs), ov


@partial(jax.jit, static_argnames=("lanes", "ov_lane"))
def _refit_tables_coef(verts_norm, tris, tabs, ov_ids,
                       lanes: tuple, ov_lane: bool):
    """Coefficient-only refit gathers, for frames whose NORMALS are
    unchanged from the rest pose (the app's -deform wobble displaces
    vertices but keeps the authored normals): the rest build's normal
    tables are value-identical, so reusing them is trivially bit-exact
    and the gather row count halves again vs :func:`_refit_tables`."""
    t_count = tris.shape[0]
    coef = _radial_coef_matrix(
        verts_norm, tris, jnp.arange(t_count, dtype=jnp.int32)
    )
    outs = []
    for tab, lane_aligned in zip(tabs, lanes):
        ti = jnp.where(tab >= 0, tab, t_count)
        if lane_aligned:
            outs.append(_gather_rows_to_cols(coef, ti))  # [VC, 12, K]
        else:
            outs.append(coef[ti])
    ov = None
    if ov_ids is not None:
        ti = jnp.where(ov_ids >= 0, ov_ids, t_count)
        cf = coef[ti]
        if ov_lane:
            cf = cf.T
        ov = cf
    return tuple(outs), ov


class RaystabRefitter:
    """Build once from the rest mesh, refit per frame.

    ``pad``: per-vertex displacement bound (normalized space) every
    frame's vertices must respect relative to the REST vertices; the
    padded bins are conservative within it (raystab_fast._cone_keys).
    Exceeding it can silently drop hits — ``refit(..., check=True)``
    verifies the bound with one host sync.

    ``refit`` costs one coefficient-matrix build + one row gather per
    capacity class on device (static shapes, compiled once); the ray
    strips, scatter streams, chunk bounds and sort keys are reused from
    the rest build. Use exactly like a static accel:

        rf = RaystabRefitter(rest_verts, tris, rest_normals, n=64,
                             pad=0.035, pad_dirs=rest_normals)
        accel_t = rf.refit(verts_t, normals_t)   # per frame
        occ, rgba = raystab_query2(verts_t, normals_t, tris, accel_t)
    """

    def __init__(self, verts_rest, tris, normals_rest, n: int = 64,
                 pad: float = 0.035, gs: tuple | None = None, span: int = 8,
                 use_cache: bool = False, cache_dir: str | None = None,
                 pad_dirs=None):
        assert pad > 0.0, "a zero-pad refitter cannot absorb deformation"
        self.n = int(n)
        self.pad = float(pad)
        self.tris = jnp.asarray(tris)
        # directional (capsule) deformation bound: frames must move each
        # vertex ALONG pad_dirs[i] only (v' = v + s*pad_dirs[i],
        # |s| <= pad) — the app's -deform wobble displaces along vertex
        # normals, so it passes normals here and the padded candidate
        # tables shrink several-fold vs the any-direction ball bound
        # (raystab_fast._capsule_params). None keeps the isotropic
        # contract: any displacement with |v' - v| <= pad.
        self._pad_dirs = (
            None if pad_dirs is None
            else jnp.asarray(pad_dirs, jnp.float32)
        )
        if use_cache:
            from dxrvoxelizer_tpu.utils.accel_cache import cached_compact2

            compact = cached_compact2(
                verts_rest, tris, n, gs, span, pad=self.pad,
                cache_dir=cache_dir, pad_dirs=self._pad_dirs,
            )
        else:
            compact = build_raystab_compact2(
                verts_rest, tris, n, gs, span, pad=self.pad,
                pad_dirs=(
                    None if self._pad_dirs is None
                    else np.asarray(self._pad_dirs)
                ),
            )
        accel0 = assemble_raystab_accel2(
            compact, verts_rest, tris, normals_rest
        )
        self.stats = accel0.stats
        self.sort_keys = accel0.sort_keys
        self._verts_rest = jnp.asarray(verts_rest)
        self._normals_rest = normals_rest  # identity-checked by refit()
        # rest normal tables (position 4 of each class 5-tuple): reused
        # verbatim when a frame's normals are unchanged (coef-only refit)
        self._ntabs_rest = tuple(cls[4] for cls in accel0.levels[0])
        self._ov_ntab_rest = accel0.ov_dense[2] if accel0.ov_dense else None
        # static per-class halves from the rest assembly: rays, scatter,
        # bounds (positions 0, 2, 3 of each class 5-tuple)
        self._static_cls = tuple(
            (cls[0], cls[2], cls[3]) for cls in accel0.levels[0]
        )
        self._lanes = tuple(
            bool(table_k(cls[1]) >= LANE_MIN_K) for cls in accel0.levels[0]
        )
        # device-resident candidate id tables (the compact half's classes
        # line up 1:1 with the assembled classes)
        self._tabs = tuple(
            jnp.asarray(tab) for (_rt, tab, _b) in compact.classes
        )
        self._ov_ids = (
            jnp.asarray(compact.ov_ids) if compact.ov_ids is not None
            else None
        )
        self._ov_rays = accel0.ov_dense[0] if accel0.ov_dense else None
        self._ov_lane = (
            bool(table_k(accel0.ov_dense[1]) >= LANE_MIN_K)
            if accel0.ov_dense else False
        )
        self.rest_accel = accel0

    def device_state(self) -> tuple:
        """The device-buffer pytree :meth:`refit_with_state` consumes.

        Callers that trace a refit inside their own jit (e.g. a scan-
        timed frame loop) must pass this through the jit's ARGUMENTS —
        reaching for ``self``'s buffers from inside the traced function
        embeds them in the HLO as constants."""
        return (self.tris, self._tabs, self._ov_ids, self._static_cls,
                self._ov_rays, self.sort_keys, self._ntabs_rest,
                self._ov_ntab_rest)

    def refit_with_state(self, state, verts_norm,
                         normals=None) -> RaystabAccel2:
        """Traceable core of :meth:`refit`: ``state`` is
        :meth:`device_state` (or its traced passthrough).

        ``normals=None`` declares this frame's normals UNCHANGED from the
        rest pose: the rest build's normal tables are reused verbatim
        (value-identical, so trivially bit-exact) and only the coefficient
        tables are regathered — half the refit's gather rows. The app's
        -deform wobble (and any displacement-only deformation) qualifies.
        """
        (tris, tabs, ov_ids, static_cls, ov_rays, sort_keys, ntabs_rest,
         ov_ntab_rest) = state
        if normals is None:
            couts, cov = _refit_tables_coef(
                verts_norm, tris, tabs, ov_ids, self._lanes, self._ov_lane,
            )
            classes = tuple(
                (rays, cf, sc, bounds, nt)
                for (rays, sc, bounds), cf, nt in zip(
                    static_cls, couts, ntabs_rest
                )
            )
            ov_dense = (
                (ov_rays, cov, ov_ntab_rest) if cov is not None else None
            )
        else:
            outs, ov = _refit_tables(
                verts_norm, normals, tris,
                tabs, ov_ids, self._lanes, self._ov_lane,
            )
            classes = tuple(
                (rays, cf, sc, bounds, nf)
                for (rays, sc, bounds), (cf, nf) in zip(static_cls, outs)
            )
            ov_dense = (ov_rays, ov[0], ov[1]) if ov is not None else None
        return RaystabAccel2(
            n=self.n,
            levels=(classes,),
            ov_dense=ov_dense,
            stats=self.stats,
            sort_keys=sort_keys,
        )

    def refit(self, verts_norm, normals=None,
              check: bool = False) -> RaystabAccel2:
        """Deformed (verts, normals) -> a query-ready accel (async).

        ``normals=None`` (or passing the SAME array object as the rest
        normals, which the displacement-only app path does) selects the
        coefficient-only refit — the rest normal tables are reused, which
        is bit-exact because the values are unchanged.
        ``check=True`` host-syncs to verify the displacement bound."""
        if check:
            from dxrvoxelizer_tpu.ops.raystab_tiled import (
                check_deform_contract,
            )

            # shared validator (gen-6 + gen-7): magnitude for isotropic
            # pads; axis residual AND the PARAMETER bound max|s| <= pad
            # for directional pads — the capsule tables bound |s|, not
            # the displacement, so non-unit pad_dirs could otherwise
            # pass |disp| <= pad while |s| > pad (ADVICE r4)
            check_deform_contract(
                jnp.asarray(verts_norm), self._verts_rest, self.pad,
                self._pad_dirs,
            )
        if normals is self._normals_rest:
            normals = None  # same object -> same values -> reuse tables
        return self.refit_with_state(
            self.device_state(), jnp.asarray(verts_norm),
            None if normals is None else jnp.asarray(normals),
        )
