"""Scene flattening without mips — the numpy path of
``tpurt/scene/scene.py:flatten_scene`` (``mipmaps=False``).

Models become global tables in world space: the traversal triangles
(``geom``), the binary SAH BVH with its BVH8 collapse (``bvh['nodes8']``),
one ``tri_attr`` row per triangle for the shade pass, and one 2x2-footprint
quad row per texel of every unique image (``tex_quad48``). The object-space
tables and the instance transforms are kept for the dynamic scene
(``as_object_pytree``). Every array equals the reference's bit for bit;
``engine/convert.py`` uploads them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..bvh import build_bvh_sah, collapse8
from ..bvh.flat import tri_aabbs
from .mesh import TextureType

MAX_LEAF = 4

_DEFAULT_TEXELS = {
    0: (255, 255, 255, 255),   # albedo: white
    1: (255, 255, 0, 255),     # ORM: occlusion 1, roughness 1, metallic 0
    2: (128, 128, 255, 255),   # normal map: +z
}
_LAYER_OF = {TextureType.ALBEDO: 0, TextureType.ORM: 1, TextureType.NORMAL: 2}


@dataclass
class FlatScene:
    """The scene tables (host numpy)."""

    bvh: dict         # binary FlatBVH arrays + nodes8 (M8, 128) f32
    geom: dict        # BVH-leaf-order triangles: v0, e1, e2, tri_id, uvp
    tri_attr: np.ndarray    # (T, 40) f32 3x[pos, uv, normal, tangent]
    #                         + [prim, tex_h, tex_w, unique-image id]
    tex_quad48: np.ndarray  # (U, Hmax, Wmax, 64) u8 2x2-footprint rows
    tex_size: np.ndarray    # (P, 2) i32 (h, w) per primitive
    num_prims: int
    builder: str            # the host SAH builder that ran: c++ or numpy
    # object-space tables for the dynamic scene (tpurt scene.py:87-91)
    tri_vertex: np.ndarray      # (T, 3) i32 global vertex ids
    tri_prim: np.ndarray        # (T,) i32 global primitive id
    vtx_uv: np.ndarray          # (V, 2) f32
    vtx_instance: np.ndarray    # (V,) i32 instance id per vertex
    obj_vtx_pos: np.ndarray     # (V, 3) f32 object space
    obj_vtx_normal: np.ndarray  # (V, 3) f32
    obj_vtx_tangent: np.ndarray  # (V, 4) f32 xyz + handedness w
    tex_img_of_prim: np.ndarray  # (P,) i32 prim -> unique-image slot
    transforms: np.ndarray      # (I, 3, 4) f32 instance transforms

    def as_pytree(self) -> dict:
        """The tables the frame reads — the same keys tpurt's
        ``FlatScene.as_pytree()`` ships on its non-mip fast path."""
        return dict(bvh=self.bvh, geom=self.geom, tex_size=self.tex_size,
                    tri_attr=self.tri_attr, tex_quad48=self.tex_quad48)

    def as_object_pytree(self) -> dict:
        """The dynamic scene's inputs — the keys tpurt's
        ``FlatScene.as_object_pytree()`` ships on its non-mip
        ``tri_attr`` + ``tex_quad48`` path (transforms come per frame)."""
        return dict(
            tri_vertex=self.tri_vertex, tri_prim=self.tri_prim,
            vtx_instance=self.vtx_instance, obj_vtx_pos=self.obj_vtx_pos,
            obj_vtx_normal=self.obj_vtx_normal,
            obj_vtx_tangent=self.obj_vtx_tangent, vtx_uv=self.vtx_uv,
            tex_size=self.tex_size, tex_img_of_prim=self.tex_img_of_prim,
            tex_quad48=self.tex_quad48)


def _transform_points(m3x4, pts):
    return pts @ m3x4[:, :3].T + m3x4[:, 3]


def _transform_normals(m3x4, normals):
    inv_t = np.linalg.inv(m3x4[:, :3]).T
    out = normals @ inv_t.T
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def _transform_directions(m3x4, dirs):
    out = dirs @ m3x4[:, :3].T
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def dedup_images(tex_stack12: np.ndarray, tex_size: np.ndarray):
    """Map each primitive to a unique-image slot by content."""
    seen = {}
    img_of_prim = np.zeros(tex_size.shape[0], np.int32)
    uniq = []
    for p in range(tex_size.shape[0]):
        key = (tex_stack12[p].tobytes(), int(tex_size[p, 0]),
               int(tex_size[p, 1]))
        if key not in seen:
            seen[key] = len(uniq)
            uniq.append(p)
        img_of_prim[p] = seen[key]
    return img_of_prim, uniq


def flatten_scene(models: List) -> FlatScene:
    """Flatten all device-resident models and build the world BVH + BVH8."""
    pos_l, uv_l, nrm_l, tan_l, inst_l = [], [], [], [], []
    tri_v_l, tri_p_l = [], []
    tex_entries = []
    tex_sizes = []
    transforms = []

    vtx_base = 0
    prim_idx = 0
    inst_idx = 0
    for model in models:
        if not model.is_device_resident():
            continue
        transforms.append(model.model_matrix)
        for prim in model.primitives():
            n_vtx = len(prim["positions"])
            pos_l.append(np.asarray(prim["positions"], np.float32))
            uv_l.append(prim["tex_coords"] if prim["tex_coords"] is not None
                        else np.zeros((n_vtx, 2), np.float32))
            nrm_l.append(np.asarray(prim["normals"], np.float32)
                         if prim["normals"] is not None
                         else np.zeros((n_vtx, 3), np.float32))
            if prim["tangents"] is not None:
                tan_l.append(np.asarray(prim["tangents"], np.float32))
            else:
                tan_l.append(np.tile(np.array([[1, 0, 0, 1]], np.float32),
                                     (n_vtx, 1)))
            inst_l.append(np.full(n_vtx, inst_idx, np.int32))
            tri_v_l.append(prim["indices"].astype(np.int64) + vtx_base)
            tri_p_l.append(np.full(len(prim["indices"]), prim_idx, np.int32))
            vtx_base += n_vtx

            size = None
            for ttype, layer in _LAYER_OF.items():
                img = prim["textures"].get(ttype)
                if img is not None:
                    tex_entries.append((prim_idx, layer, img))
                    size = (img.height, img.width)
            tex_sizes.append(size if size is not None else (1, 1))
            prim_idx += 1
        inst_idx += 1

    if prim_idx == 0:
        raise ValueError("no device-resident models to flatten")

    obj_vtx_pos = np.concatenate(pos_l)
    vtx_uv = np.concatenate(uv_l).astype(np.float32)
    obj_vtx_normal = np.concatenate(nrm_l)
    obj_vtx_tangent = np.concatenate(tan_l)
    vtx_instance = np.concatenate(inst_l)
    tri_vertex = np.concatenate(tri_v_l).astype(np.int32)
    tri_prim = np.concatenate(tri_p_l)
    transforms = np.asarray(transforms, np.float32)

    vtx_pos = np.empty_like(obj_vtx_pos)
    vtx_normal = np.empty_like(obj_vtx_normal)
    vtx_tangent = obj_vtx_tangent.copy()
    for i in range(inst_idx):
        sel = vtx_instance == i
        m = transforms[i]
        vtx_pos[sel] = _transform_points(m, obj_vtx_pos[sel]).astype(
            np.float32)
        vtx_normal[sel] = _transform_normals(m, obj_vtx_normal[sel])
        vtx_tangent[sel, :3] = _transform_directions(
            m, obj_vtx_tangent[sel, :3])

    hmax = max(max(h for h, w in tex_sizes), 1)
    wmax = max(max(w for h, w in tex_sizes), 1)
    tex_stack = np.zeros((prim_idx * 3, hmax, wmax, 4), np.uint8)
    for layer in range(3):
        tex_stack[layer::3, :, :] = _DEFAULT_TEXELS[layer]
    for p, layer, img in tex_entries:
        arr = img.as_array()
        if arr.shape[2] < 4:
            arr = np.concatenate(
                [arr, np.full((*arr.shape[:2], 4 - arr.shape[2]), 255,
                              np.uint8)], axis=2)
        tex_stack[p * 3 + layer, :img.height, :img.width] = arr
    tex_size = np.asarray(tex_sizes, np.int32)

    v0 = vtx_pos[tri_vertex[:, 0]]
    v1 = vtx_pos[tri_vertex[:, 1]]
    v2 = vtx_pos[tri_vertex[:, 2]]
    amin, amax = tri_aabbs(v0, v1, v2)
    sah = build_bvh_sah(amin, amax, max_leaf_size=MAX_LEAF)
    bvh_pt = sah.as_pytree()
    bvh_pt["nodes8"], _ = collapse8(bvh_pt)

    order = np.asarray(bvh_pt["tri_order"])
    v0o = v0[order]
    geom = dict(v0=v0o, e1=(v1[order] - v0o), e2=(v2[order] - v0o),
                tri_id=order.astype(np.int32))

    tex_stack12 = np.concatenate(
        [tex_stack[0::3], tex_stack[1::3], tex_stack[2::3]], axis=3)
    img_of_prim, uniq_prims = dedup_images(tex_stack12, tex_size)

    # the closest-hit uv payload (kernels/traverse_bvh8, uv_payload=True):
    # the three corner uvs + [unique-image slot, tex_h, tex_w] per triangle
    # in BVH leaf order, so the winning triangle's row is the one its
    # traversal row sits in
    geom["uvp"] = np.concatenate(
        [vtx_uv[tri_vertex[:, 0]], vtx_uv[tri_vertex[:, 1]],
         vtx_uv[tri_vertex[:, 2]],
         img_of_prim[tri_prim][:, None].astype(np.float32),
         tex_size[tri_prim].astype(np.float32)],
        axis=1).astype(np.float32)[order]

    corners = [np.concatenate([vtx_pos[tri_vertex[:, k]],
                               vtx_uv[tri_vertex[:, k]],
                               vtx_normal[tri_vertex[:, k]],
                               vtx_tangent[tri_vertex[:, k]]], axis=1)
               for k in range(3)]
    tri_attr = np.concatenate(
        corners + [tri_prim[:, None].astype(np.float32),
                   tex_size[tri_prim].astype(np.float32),
                   img_of_prim[tri_prim][:, None].astype(np.float32)],
        axis=1).astype(np.float32)

    tex_quad48 = np.zeros((len(uniq_prims), hmax, wmax, 64), np.uint8)
    for ui, p in enumerate(uniq_prims):
        h, w = int(tex_size[p, 0]), int(tex_size[p, 1])
        reg = tex_stack12[p, :h, :w]
        tex_quad48[ui, :h, :w, :48] = np.concatenate(
            [reg,
             np.roll(reg, -1, axis=1),            # (y,   x+1 mod w)
             np.roll(reg, -1, axis=0),            # (y+1 mod h, x)
             np.roll(np.roll(reg, -1, 0), -1, 1)  # (y+1, x+1)
             ], axis=2)

    return FlatScene(bvh=bvh_pt, geom=geom, tri_attr=tri_attr,
                     tex_quad48=tex_quad48, tex_size=tex_size,
                     num_prims=prim_idx, builder=sah.builder,
                     tri_vertex=tri_vertex, tri_prim=tri_prim, vtx_uv=vtx_uv,
                     vtx_instance=vtx_instance, obj_vtx_pos=obj_vtx_pos,
                     obj_vtx_normal=obj_vtx_normal,
                     obj_vtx_tangent=obj_vtx_tangent,
                     tex_img_of_prim=img_of_prim, transforms=transforms)
