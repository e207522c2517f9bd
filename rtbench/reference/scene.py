"""The reference's scene tables, worked out from the benchmark's scene data
(``rtbench/scenes``): world-space triangles and per-vertex attributes
under each model's 3x4 matrix, or under per-frame instance transforms, and
the textures of each primitive as padded stacks and box-filtered mip
chains.

An untextured primitive reads a 1x1 image per layer: white albedo, ORM
(occlusion 1, roughness 1, metallic 0) and a flat +z normal map. A vertex
without a tangent takes (1, 0, 0) with handedness +1. Normals move by the
inverse transpose of the matrix, tangents by the matrix, both normalized.
"""
from __future__ import annotations

import numpy as np
import torch

LAYERS = ("albedo", "orm", "normal")
DEFAULT_TEXELS = ((255, 255, 255, 255), (255, 255, 0, 255),
                  (128, 128, 255, 255))


def box_mip(img: np.ndarray) -> np.ndarray:
    """The next mip level of an (H, W, C) u8 image: the rounded mean of
    each 2x2 block (an odd last row or column repeats; a side of 1
    averages along the other side only)."""
    h, w = img.shape[:2]
    if h == 1 and w == 1:
        return img
    a = img.astype(np.int64)
    if h > 1 and h % 2:
        a = np.concatenate([a, a[-1:]], 0)
    if w > 1 and w % 2:
        a = np.concatenate([a, a[:, -1:]], 1)
    fy, fx = (2 if h > 1 else 1), (2 if w > 1 else 1)
    hh, ww = a.shape[0] // fy, a.shape[1] // fx
    s = a.reshape(hh, fy, ww, fx, -1).sum((1, 3))
    n = fy * fx
    return ((s + n // 2) // n).astype(np.uint8)


class SceneTables:
    """Host-side tables of one scene (numpy), uploaded by ``to``."""

    def __init__(self, models, mipmaps: bool):
        pos, nrm, uv, inst, idx, prim_of_tri, images = ([] for _ in range(7))
        base = 0
        for m, (prims, _) in enumerate(models):
            for p in prims:
                n = len(p["positions"])
                pos.append(np.asarray(p["positions"], np.float32))
                nrm.append(np.asarray(p["normals"], np.float32))
                uv.append(np.asarray(p["tex_coords"], np.float32))
                inst.append(np.full(n, m, np.int64))
                idx.append(np.asarray(p["indices"], np.int64) + base)
                prim_of_tri.append(np.full(len(p["indices"]), len(images),
                                           np.int64))
                tex = p["textures"]
                images.append([tex[k] if k in tex else np.array(
                    [[DEFAULT_TEXELS[i]]], np.uint8)
                    for i, k in enumerate(LAYERS)])
                base += n
        self.pos = np.concatenate(pos)
        self.nrm = np.concatenate(nrm)
        self.uv = np.concatenate(uv)
        self.inst = np.concatenate(inst)
        self.idx = np.concatenate(idx)
        self.prim = np.concatenate(prim_of_tri)
        self.matrices = np.stack([np.asarray(mat, np.float32)
                                  for _, mat in models])
        sizes = np.array([[im[0].shape[0], im[0].shape[1]] for im in images],
                         np.int64)
        self.tex_size = sizes
        hmax, wmax = int(sizes[:, 0].max()), int(sizes[:, 1].max())
        stack = np.zeros((len(images) * 3, hmax, wmax, 4), np.uint8)
        for p, ims in enumerate(images):
            for layer, im in enumerate(ims):
                stack[p * 3 + layer, :im.shape[0], :im.shape[1]] = im
        self.tex_stack = stack
        self.mips = None
        if mipmaps:
            self.mips = self._mip_atlas(images)

    @staticmethod
    def _mip_atlas(images):
        """Every primitive's chains, each layer apart, in one texel atlas:
        (atlas (N, 4) u8, offsets (P*3, L), sizes (P, L, 2)). The chain
        length L reaches 1x1 of the largest image; a chain that reaches
        1x1 earlier repeats that level."""
        ext = max(max(im[0].shape[:2]) for im in images)
        levels = int(np.ceil(np.log2(max(ext, 1)))) + 1
        chunks, offsets = [], np.zeros((len(images) * 3, levels), np.int64)
        sizes = np.zeros((len(images), levels, 2), np.int64)
        total = 0
        for p, ims in enumerate(images):
            for layer, im in enumerate(ims):
                cur = im
                for lv in range(levels):
                    offsets[p * 3 + layer, lv] = total
                    sizes[p, lv] = cur.shape[:2]
                    chunks.append(cur.reshape(-1, 4))
                    total += cur.shape[0] * cur.shape[1]
                    cur = box_mip(cur)
        return np.concatenate(chunks), offsets, sizes

    def to(self, device, dtype=torch.float32) -> dict:
        """The device tables the reference frame reads (float ones in
        `dtype`)."""
        def f(x):
            return torch.as_tensor(x, device=device).to(dtype)

        def i(x):
            return torch.as_tensor(x, device=device)

        out = dict(pos=f(self.pos), nrm=f(self.nrm), uv=f(self.uv),
                   inst=i(self.inst), idx=i(self.idx), prim=i(self.prim),
                   matrices=f(self.matrices), tex_size=i(self.tex_size),
                   tex_stack=i(self.tex_stack))
        if self.mips is not None:
            atlas, off, sizes = self.mips
            out.update(mip_atlas=i(atlas), mip_offsets=i(off),
                       mip_sizes=i(sizes))
        return out


def _apply(m, v):
    """Rows of (V, 3, 3) matrices times (V, 3) vectors."""
    return torch.stack([m[:, r, 0] * v[:, 0] + m[:, r, 1] * v[:, 1]
                        + m[:, r, 2] * v[:, 2] for r in range(3)], -1)


def _normalize(v):
    n = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    return v / torch.clamp_min(n, 1e-20)[:, None]


def world_vertices(t: dict, transforms=None):
    """World positions, normals and tangents (xyz) of every vertex under
    the models' matrices or `transforms` (I, 3, 4), one per model."""
    mats = t["matrices"] if transforms is None else transforms
    m = mats[t["inst"]]
    lin = m[:, :, :3]
    pos = _apply(lin, t["pos"]) + m[:, :, 3]
    a = mats[:, :, :3].to(torch.float64)
    inv_t = torch.linalg.inv(a).transpose(1, 2).to(mats.dtype)
    nrm = _normalize(_apply(inv_t[t["inst"]], t["nrm"]))
    tangent = torch.zeros_like(pos)
    tangent[:, 0] = 1.0
    tan = _normalize(_apply(lin, tangent))
    return pos, nrm, tan
