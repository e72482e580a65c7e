"""Ray-march renderer tests: shader-rule unit tests plus comparison against an
independent per-pixel scalar Python port of PSRayCast.hlsl."""

import math

import jax.numpy as jnp
import numpy as np

from dxrvoxelizer_tpu.models.camera import OrbitCamera
from dxrvoxelizer_tpu.models.scene import Scene
from dxrvoxelizer_tpu.ops.raymarch_ref import compute_start_point, raymarch_ref
from dxrvoxelizer_tpu.utils import dxmath as dxm
from meshes import box_mesh

CLEAR = np.array([0.0, 0.2, 0.4], dtype=np.float32)


def _frame_consts(w, h, bound=(0.0, 4.0, 0.0, 2.0)):
    cam = OrbitCamera(w, h)
    world = dxm.world_matrix(np.array(bound, np.float32), np.array([0, 0, 0, 1], np.float32))
    world_inv = dxm.inverse(world)
    s2l = dxm.screen_to_local(world, cam.view_proj, w, h)
    eye_l = dxm.transform_coord(cam.eye, world_inv)
    light_l = dxm.transform_coord(np.array([-10.0, 45.0, -75.0], np.float32), world_inv)
    return s2l, eye_l, light_l


def test_compute_start_point_inside_unchanged():
    pos = jnp.array([[0.2, -0.3, 0.9]], dtype=jnp.float32)
    d = jnp.array([[1.0, 0.0, 0.0]], dtype=jnp.float32)
    entry, hit = compute_start_point(pos, d)
    assert bool(hit[0])
    np.testing.assert_allclose(entry[0], pos[0])


def test_compute_start_point_entry_on_face():
    pos = jnp.array([[-3.0, 0.1, 0.2]], dtype=jnp.float32)
    d = jnp.array([[1.0, 0.0, 0.0]], dtype=jnp.float32)
    entry, hit = compute_start_point(pos, d)
    assert bool(hit[0])
    np.testing.assert_allclose(entry[0], [-1.0, 0.1, 0.2], atol=1e-6)


def test_compute_start_point_miss():
    pos = jnp.array([[-3.0, 2.5, 0.0]], dtype=jnp.float32)
    d = jnp.array([[1.0, 0.0, 0.0]], dtype=jnp.float32)
    _, hit = compute_start_point(pos, d)
    assert not bool(hit[0])


def test_empty_grid_renders_clear_color():
    w = h = 16
    s2l, eye_l, light_l = _frame_consts(w, h)
    density = jnp.zeros((8, 8, 8), dtype=jnp.float32)
    img = np.asarray(
        raymarch_ref(density, jnp.asarray(s2l), jnp.asarray(eye_l),
                     jnp.asarray(light_l), jnp.asarray(CLEAR), w, h,
                     n_samples=16, n_light=4)
    )
    np.testing.assert_allclose(img, np.broadcast_to(CLEAR, img.shape), atol=1e-5)


def test_full_grid_darkens_center():
    w = h = 16
    s2l, eye_l, light_l = _frame_consts(w, h)
    density = jnp.ones((8, 8, 8), dtype=jnp.float32)
    img = np.asarray(
        raymarch_ref(density, jnp.asarray(s2l), jnp.asarray(eye_l),
                     jnp.asarray(light_l), jnp.asarray(CLEAR), w, h,
                     n_samples=32, n_light=8)
    )
    center = img[h // 2, w // 2]
    assert not np.allclose(center, CLEAR, atol=1e-3)
    # fully absorbed: transmit ~ 0, scatter small but nonzero -> dark-ish gray
    assert center.max() <= 1.0 and center.min() >= 0.0


def _scalar_raymarch(density, s2l, eye_l, light_l, clear, w, h, ns, nl):
    """Independent per-pixel scalar port of PSRayCast.hlsl (float64 Python)."""
    n = density.shape[0]
    max_dist = 2.0 * math.sqrt(3.0)
    step_scale = max_dist / ns
    light_step_scale = max_dist / nl
    img = np.zeros((h, w, 3), dtype=np.float64)

    def sample(tex):
        c = [tex[i] * n - 0.5 for i in range(3)]
        c0 = [math.floor(x) for x in c]
        f = [c[i] - c0[i] for i in range(3)]
        def at(ix, iy, iz):
            ix = min(max(ix, 0), n - 1)
            iy = min(max(iy, 0), n - 1)
            iz = min(max(iz, 0), n - 1)
            return float(density[ix, iy, iz])
        acc = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    wgt = ((f[0] if dx else 1 - f[0])
                           * (f[1] if dy else 1 - f[1])
                           * (f[2] if dz else 1 - f[2]))
                    acc += wgt * at(c0[0] + dx, c0[1] + dy, c0[2] + dz)
        return min(acc * 8.0, 16.0)

    ld = light_l / np.linalg.norm(light_l)
    light_step = ld * light_step_scale

    for py in range(h):
        for px in range(w):
            sp = np.array([px + 0.5, py + 0.5, 0.0, 1.0])
            hpos = sp @ s2l
            pos = hpos[:3] / hpos[3]
            d = pos - eye_l
            d = d / np.linalg.norm(d)
            # ComputeStartPoint
            if np.all(np.abs(pos) <= 1.0):
                hit = True
            else:
                u_best = np.inf
                hit = False
                for i in range(3):
                    if d[i] == 0:
                        continue
                    u = (-np.sign(d[i]) - pos[i]) / d[i]
                    if u < 0:
                        continue
                    j, k = (i + 1) % 3, (i + 2) % 3
                    if abs(d[j] * u + pos[j]) > 1 or abs(d[k] * u + pos[k]) > 1:
                        continue
                    if u < u_best:
                        u_best = u
                        hit = True
                if hit:
                    pos = np.clip(d * u_best + pos, -1.0, 1.0)
            if not hit:
                img[py, px] = clear
                continue
            step = d * step_scale
            transmit, scatter = 1.0, 0.0
            for _ in range(ns):
                if np.any(np.abs(pos) > 1.0):
                    break
                tex = np.array([0.5, -0.5, 0.5]) * pos + 0.5
                dens = sample(tex)
                if dens > 0.01:
                    sd = dens * step_scale
                    transmit *= min(max(1.0 - sd, 0.0), 1.0)
                    if transmit < 0.01:
                        break
                    lt = 1.0
                    lp = pos + light_step
                    for _ in range(nl):
                        if np.any(np.abs(lp) > 1.0):
                            break
                        ltex = np.array([0.5, -0.5, 0.5]) * lp + 0.5
                        lt *= min(max(1.0 - light_step_scale * sample(ltex), 0.0), 1.0)
                        if lt < 0.01:
                            break
                        lp = lp + light_step
                    scatter += lt * transmit * sd
                pos = pos + step
            res = scatter * 0.8 + 0.2
            rgb = res + (clear.astype(np.float64) ** 2 - res) * transmit
            img[py, px] = np.sqrt(rgb)
    return img


def test_matches_scalar_port_on_voxelized_box():
    w = h = 12
    ns, nl = 24, 6
    s2l, eye_l, light_l = _frame_consts(w, h)
    # a box occupying part of the grid, voxelized on a coarse 8^3 grid
    from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref

    verts, _, tris = box_mesh([-0.7, -0.5, -0.6], [0.4, 0.66, 0.55])
    occ = voxelize_parity_ref(jnp.asarray(verts), jnp.asarray(tris), n=8)
    density = occ.astype(jnp.float32)

    img = np.asarray(
        raymarch_ref(density, jnp.asarray(s2l), jnp.asarray(eye_l),
                     jnp.asarray(light_l), jnp.asarray(CLEAR), w, h,
                     n_samples=ns, n_light=nl)
    )
    expect = _scalar_raymarch(
        np.asarray(density), s2l.astype(np.float64), eye_l.astype(np.float64),
        light_l.astype(np.float64), CLEAR, w, h, ns, nl,
    )
    np.testing.assert_allclose(img, expect, atol=2e-3)
    # the box is actually visible
    assert (np.abs(img - CLEAR).max(axis=-1) > 0.05).sum() > 5


def test_end_to_end_bunny_smoke(reference_assets_available):
    """Minimum end-to-end slice: OBJ -> voxelize -> raymarch -> image."""
    from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig

    cfg = VoxelizerConfig(mesh="bunny.obj", grid_size=32, width=48, height=32)
    scene = Scene.load(cfg)
    occ = voxelize_parity_ref(
        scene.buffers.positions_norm, scene.buffers.tris, n=cfg.grid_size,
        tri_chunk=4096,
    )
    cam = OrbitCamera(cfg.width, cfg.height)
    fc = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    img = np.asarray(
        raymarch_ref(
            occ.astype(jnp.float32),
            jnp.asarray(fc.screen_to_local),
            jnp.asarray(fc.local_space_eye_pt),
            jnp.asarray(fc.local_space_light_pt),
            jnp.asarray(CLEAR),
            cfg.width, cfg.height, n_samples=32, n_light=8,
        )
    )
    assert img.shape == (32, 48, 3)
    assert np.isfinite(img).all()
    # the bunny occupies a solid chunk of the frame
    nonclear = np.abs(img - CLEAR).max(axis=-1) > 0.05
    assert nonclear.mean() > 0.05
