"""Seeded procedural meshes: closed, watertight stand-ins for scanned OBJs.

The canonical scenes (bunny, dragon, TuringBowl) are not shipped with the
repository, so benchmarks, smoke runs and tests generate their input: a
subdivided icosahedron whose vertices are displaced radially by a seeded
low-frequency field. Radial displacement of a sphere keeps the surface
star-shaped around its center, so it stays closed and free of
self-intersections, while the bumps make triangle sizes and orientations
uneven, as on a scan. Sizes are 20 * 4**k triangles: 81,920 (k = 6) is the
scale of the reference's 69,666-triangle default bunny, 327,680 (k = 7) a
hi-res mesh.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PHI = (1 + 5**0.5) / 2
_ICO_VERTS = [
    (-1, _PHI, 0), (1, _PHI, 0), (-1, -_PHI, 0), (1, -_PHI, 0),
    (0, -1, _PHI), (0, 1, _PHI), (0, -1, -_PHI), (0, 1, -_PHI),
    (_PHI, 0, -1), (_PHI, 0, 1), (-_PHI, 0, -1), (-_PHI, 0, 1),
]
_ICO_FACES = [
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
    (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
    (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
]


def _subdivide_sphere(levels: int):
    """Unit icosphere after ``levels`` 4-way splits -> (verts f64, tris)."""
    verts = np.asarray(_ICO_VERTS, np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    tris = np.asarray(_ICO_FACES, np.int64)
    for _ in range(levels):
        edges = np.concatenate(
            [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]
        )
        edges.sort(axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        mid_idx = len(verts) + inv.reshape(3, -1)  # (ab, bc, ca) per face
        verts = np.concatenate([verts, mid])
        a, b, c = tris.T
        ab, bc, ca = mid_idx
        tris = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1),
        ])
    return verts, tris


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (unit length, float32)."""
    v = np.asarray(verts, np.float64)
    fn = np.cross(v[tris[:, 1]] - v[tris[:, 0]], v[tris[:, 2]] - v[tris[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-30)
    return vn.astype(np.float32)


def displaced_icosphere(n_tris: int, seed: int = 0, radius: float = 0.7,
                        amplitude: float = 0.18, bumps: int = 12):
    """Closed displaced icosphere with exactly ``n_tris`` triangles.

    ``n_tris`` must be 20 * 4**k. Each vertex moves radially by
    ``radius * amplitude * sum_j a_j sin(f_j . u + p_j)`` over ``bumps``
    random waves (|f_j| in [2, 7]) drawn from ``seed``; the displacement
    stays above -radius/2, so the surface remains star-shaped. Returns
    (verts [V,3] f32, normals [V,3] f32, tris [T,3] int32), centered just
    off the origin so no symmetry plane of the grid cuts it evenly.
    """
    levels = 0
    while 20 * 4**levels < n_tris:
        levels += 1
    if 20 * 4**levels != n_tris:
        raise ValueError(f"n_tris must be 20 * 4**k, got {n_tris}")
    rng = np.random.default_rng(seed)
    unit, tris = _subdivide_sphere(levels)
    dirs = rng.normal(size=(bumps, 3))
    freqs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    freqs *= rng.uniform(2.0, 7.0, size=(bumps, 1))
    amps = rng.uniform(-1.0, 1.0, size=bumps) / np.sqrt(bumps)
    phase = rng.uniform(0.0, 2 * np.pi, size=bumps)
    field = np.sin(unit @ freqs.T + phase) @ amps
    r = radius * (1.0 + amplitude * np.clip(field, -2.5, 2.5))
    center = np.array([0.013, -0.021, 0.008])
    verts = (unit * r[:, None] + center).astype(np.float32)
    return verts, vertex_normals(verts, tris), tris.astype(np.int32)


def write_obj(path: str | Path, verts: np.ndarray, normals: np.ndarray,
              tris: np.ndarray) -> Path:
    """Write an OBJ with ``v``/``vn`` lines and ``f a//a b//b c//c`` faces."""
    path = Path(path)
    f1 = np.asarray(tris, np.int64) + 1
    with open(path, "w") as f:
        f.write("\n".join(
            "v %.9g %.9g %.9g" % tuple(p) for p in np.asarray(verts)
        ))
        f.write("\n")
        f.write("\n".join(
            "vn %.7g %.7g %.7g" % tuple(p) for p in np.asarray(normals)
        ))
        f.write("\n")
        f.write("\n".join(
            f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in f1
        ))
        f.write("\n")
    return path
