"""Frozen numpy copies of the port's procedural scene builders
(``tpurt_torch/scene/procedural.py``: ``_cube``, ``box_field``,
``material_field``, ``ground_plane``), vectorized, with the same arrays.

Each builder returns a model as plain data: a list of primitives, each a
dict of ``positions`` (N, 3) f32, ``normals`` (N, 3) f32, ``tex_coords``
(N, 2) f32, ``indices`` (M, 3) int64 and ``textures``, a dict that maps
"albedo", "orm" and "normal" to (H, W, 4) u8 images (empty for an
untextured primitive), and the model's 3x4 matrix. The benchmark hands the
same data to the program and to the plain reference.
"""
from __future__ import annotations

import numpy as np

EYE = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], np.float32)

# (axis, sign) of each cube face, in the port's order
_CUBE_FACES = ((0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1))


def cube(center, half, subdiv: int):
    """An axis-aligned cube with subdiv x subdiv quads per face:
    (positions, normals, uvs, indices)."""
    lin = np.linspace(-1.0, 1.0, subdiv + 1, dtype=np.float32)
    ii, jj = np.meshgrid(np.arange(subdiv + 1), np.arange(subdiv + 1),
                         indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    uv = np.stack([ii / subdiv, jj / subdiv], axis=1).astype(np.float32)
    qi, qj = np.meshgrid(np.arange(subdiv), np.arange(subdiv), indexing="ij")
    a = (qi * (subdiv + 1) + qj).reshape(-1)
    b, c = a + 1, a + subdiv + 1
    d = c + 1
    verts, norms, uvs, idx = [], [], [], []
    n_face = (subdiv + 1) ** 2
    for f, (axis, sign) in enumerate(_CUBE_FACES):
        p = np.zeros((n_face, 3), np.float32)
        p[:, axis] = sign
        p[:, (axis + 1) % 3] = lin[ii]
        p[:, (axis + 2) % 3] = lin[jj]
        verts.append(center + half * p)
        n = np.zeros((n_face, 3), np.float32)
        n[:, axis] = sign
        norms.append(n)
        uvs.append(uv)
        base = f * n_face
        if sign > 0:
            tris = [(a, b, c), (b, d, c)]
        else:
            tris = [(a, c, b), (b, c, d)]
        quad = np.stack([np.stack(t, axis=1) for t in tris], axis=1)
        idx.append(quad.reshape(-1, 3) + base)
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(norms), np.concatenate(uvs),
            np.concatenate(idx).astype(np.int64))


def _prim(pos, nrm, uv, idx, textures=None):
    return dict(positions=pos, normals=nrm, tex_coords=uv,
                indices=idx.reshape(-1, 3), textures=textures or {})


def box_field(nx: int, nz: int, subdiv: int, seed: int,
              spacing: float = 1.2, half: float = 0.45):
    """A grid of subdivided boxes with seeded heights: one primitive per
    box, nx * nz * 12 * subdiv^2 triangles. Returns (prims, matrix)."""
    rng = np.random.default_rng(seed)
    prims = []
    for i in range(nx):
        for j in range(nz):
            h = 0.5 + rng.uniform(0.0, 1.5)
            center = np.array([(i - (nx - 1) / 2) * spacing, -h * half,
                               (j - (nz - 1) / 2) * spacing], np.float32)
            prims.append(_prim(*cube(center, half * np.array(
                [1, h, 1], np.float32), subdiv)))
    return prims, EYE.copy()


def checker(size: int, ca, cb, tiles: int) -> np.ndarray:
    """(size, size, 4) u8 checkerboard between colors ca and cb."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * tiles // max(size, 1)) + (xx * tiles // max(size, 1))) % 2
    out = np.empty((size, size, 4), np.uint8)
    out[..., :] = np.asarray(ca, np.uint8)
    out[mask == 1] = np.asarray(cb, np.uint8)
    return out


def material_field(nx: int, nz: int, subdiv: int, seed: int,
                   spacing: float = 1.2, half: float = 0.45,
                   extents=(16, 32, 64, 128)):
    """A grid of boxes, each its own primitive with distinct albedo
    (checker), ORM and flat normal-map textures at the cycled `extents`.
    Returns (prims, matrix)."""
    rng = np.random.default_rng(seed)
    extents = list(extents)
    prims = []
    for i in range(nx):
        for j in range(nz):
            k = i * nz + j
            h = 0.5 + rng.uniform(0.0, 1.5)
            center = np.array([(i - (nx - 1) / 2) * spacing, -h * half,
                               (j - (nz - 1) / 2) * spacing], np.float32)
            geo = cube(center, half * np.array([1, h, 1], np.float32),
                       subdiv)
            size = extents[k % len(extents)]
            hue = np.array([
                127 + 120 * np.sin(2.19 * k),
                127 + 120 * np.sin(2.19 * k + 2.09),
                127 + 120 * np.sin(2.19 * k + 4.19)]).clip(16, 255)
            albedo = checker(size, [*hue.astype(int), 255],
                             [250, 250, 250, 255], tiles=2 + k % 6)
            orm = np.full((size, size, 4), 255, np.uint8)
            orm[..., 1] = int(40 + (k * 13) % 200)
            orm[..., 2] = int((k * 29) % 255)
            normal = np.full((size, size, 4), 255, np.uint8)
            normal[..., 0] = 128
            normal[..., 1] = 128
            prims.append(_prim(*geo, dict(albedo=albedo, orm=orm,
                                          normal=normal)))
    return prims, EYE.copy()


def ground_plane(size: float = 20.0, y: float = 0.0):
    """Two triangles at height y spanning [-size, size]^2."""
    pos = np.array([[-size, y, -size], [size, y, -size],
                    [size, y, size], [-size, y, size]], np.float32)
    nrm = np.tile(np.array([[0, -1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return [_prim(pos, nrm, uv, idx)], EYE.copy()


BUILDERS = dict(box_field=box_field, material_field=material_field,
                ground_plane=ground_plane)
