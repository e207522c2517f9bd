"""Procedural test geometry.

The reference's showcase scene (Sponza.glb, ~260k triangles) is not shipped
(.MISSING_LARGE_BLOBS); these generators produce comparable triangle counts
so traversal and the SMEM-budget fallback can be exercised at scale.
"""
from __future__ import annotations

import numpy as np

from .model import Model

_CUBE_FACES = [
    # (axis, sign): quads per cube face
    (0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1),
]


def _cube(center, half, subdiv: int):
    """Axis-aligned cube with `subdiv`x`subdiv` quads per face.
    Returns (positions (N,3), normals (N,3), uvs (N,2), indices (M,3))."""
    verts, norms, uvs, idx = [], [], [], []
    for axis, sign in _CUBE_FACES:
        u_axis = (axis + 1) % 3
        v_axis = (axis + 2) % 3
        base = len(verts)
        lin = np.linspace(-1.0, 1.0, subdiv + 1, dtype=np.float32)
        for i in range(subdiv + 1):
            for j in range(subdiv + 1):
                p = np.zeros(3, np.float32)
                p[axis] = sign
                p[u_axis] = lin[i]
                p[v_axis] = lin[j]
                verts.append(center + half * p)
                n = np.zeros(3, np.float32)
                n[axis] = sign
                norms.append(n)
                uvs.append([i / subdiv, j / subdiv])
        for i in range(subdiv):
            for j in range(subdiv):
                a = base + i * (subdiv + 1) + j
                b = a + 1
                c = a + (subdiv + 1)
                d = c + 1
                if sign > 0:
                    idx += [[a, b, c], [b, d, c]]
                else:
                    idx += [[a, c, b], [b, c, d]]
    return (np.asarray(verts, np.float32), np.asarray(norms, np.float32),
            np.asarray(uvs, np.float32), np.asarray(idx, np.int64))


def box_field(nx: int = 8, nz: int = 8, subdiv: int = 4, seed: int = 0,
              spacing: float = 1.2, half: float = 0.45) -> Model:
    """A grid of subdivided boxes with jittered heights as a single
    multi-primitive model. Triangles = nx*nz*6*subdiv^2*2."""
    rng = np.random.default_rng(seed)
    prims = []
    for i in range(nx):
        for j in range(nz):
            h = 0.5 + rng.uniform(0.0, 1.5)
            center = np.array([(i - (nx - 1) / 2) * spacing, -h * half,
                               (j - (nz - 1) / 2) * spacing], np.float32)
            pos, nrm, uv, idx = _cube(center, half * np.array([1, h, 1],
                                                              np.float32),
                                      subdiv)
            prims.append(dict(positions=pos, normals=nrm, tex_coords=uv,
                              tangents=None, textures={},
                              indices=idx.reshape(-1, 3)))
    eye = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                   np.float32)
    return Model.from_arrays(prims, eye)


def _checker_texture(size: int, ca, cb, tiles: int = 4) -> np.ndarray:
    """(size, size, 4) u8 checkerboard between colors ca and cb."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * tiles // max(size, 1)) + (xx * tiles // max(size, 1))) % 2
    out = np.empty((size, size, 4), np.uint8)
    out[..., :] = np.asarray(ca, np.uint8)
    out[mask == 1] = np.asarray(cb, np.uint8)
    return out


def _image(arr: np.ndarray):
    from .gltf import ImageData

    h, w = arr.shape[:2]
    return ImageData(pixels=arr.reshape(-1).copy(), width=w, height=h,
                     format="R8G8B8A8_UNORM")


def material_field(nx: int = 6, nz: int = 6, subdiv: int = 3, seed: int = 7,
                   spacing: float = 1.2, half: float = 0.45,
                   extents=(16, 32, 64, 128)) -> Model:
    """A Sponza-class *material* workload: a grid of boxes where every box
    is its own primitive with DISTINCT albedo/ORM/normal textures at varied
    extents — the nx*nz-slot analogue of the reference's 256-slot bindless
    texture array (vk_rt_descriptor_set.rs:42-97). Materials sweep
    roughness/metallic and hue so wrong-primitive fetches are visually and
    numerically detectable. Pass bigger `extents` (e.g. (256,) — uniform,
    no stack padding waste) for texture-VOLUME stress at the reference
    asset's ~150 MB scale."""
    from .mesh import TextureType

    rng = np.random.default_rng(seed)
    extents = list(extents)
    prims = []
    for i in range(nx):
        for j in range(nz):
            k = i * nz + j
            h = 0.5 + rng.uniform(0.0, 1.5)
            center = np.array([(i - (nx - 1) / 2) * spacing, -h * half,
                               (j - (nz - 1) / 2) * spacing], np.float32)
            pos, nrm, uv, idx = _cube(
                center, half * np.array([1, h, 1], np.float32), subdiv)

            size = extents[k % len(extents)]
            hue = np.array([
                127 + 120 * np.sin(2.19 * k),
                127 + 120 * np.sin(2.19 * k + 2.09),
                127 + 120 * np.sin(2.19 * k + 4.19)]).clip(16, 255)
            albedo = _checker_texture(size, [*hue.astype(int), 255],
                                      [250, 250, 250, 255],
                                      tiles=2 + k % 6)
            rough = int(40 + (k * 13) % 200)
            metal = int((k * 29) % 255)
            orm = np.full((size, size, 4), 255, np.uint8)
            orm[..., 1] = rough
            orm[..., 2] = metal
            normal = np.full((size, size, 4), 255, np.uint8)
            normal[..., 0] = 128
            normal[..., 1] = 128
            prims.append(dict(
                positions=pos, normals=nrm, tex_coords=uv, tangents=None,
                textures={TextureType.ALBEDO: _image(albedo),
                          TextureType.ORM: _image(orm),
                          TextureType.NORMAL: _image(normal)},
                indices=idx.reshape(-1, 3)))
    eye = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                   np.float32)
    return Model.from_arrays(prims, eye)


def ground_plane(size: float = 20.0, y: float = 0.0) -> Model:
    pos = np.array([[-size, y, -size], [size, y, -size],
                    [size, y, size], [-size, y, size]], np.float32)
    nrm = np.tile(np.array([[0, -1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    prims = [dict(positions=pos, normals=nrm, tex_coords=uv, tangents=None,
                  textures={}, indices=idx)]
    eye = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                   np.float32)
    return Model.from_arrays(prims, eye)
