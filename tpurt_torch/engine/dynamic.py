"""The dynamic-scene frame — port of ``tpurt/engine/dynamic.py``.

The reference destroys and rebuilds its TLAS every frame from the
instances' 3x4 transforms (vk_tlas_builder.rs:38-233, renderer.rs:637-651).
Here the object-space tables live on the device once; each frame takes
(I, 3, 4) transforms, moves the vertices to world space and then either

  * rebuilds: a fresh LBVH on the device (``bvh/lbvh.py``, leaves of one
    triangle), primary and shadow rays through K6 (``render_frame_dynamic``),
  * or refits: keeps the rest-pose BVH8 topology and recomputes its boxes
    (``bvh/wide.refit_bvh8``), primary and shadow rays through K1/K2 as in
    the static frame, and reports the tree's decay against the rest pose
    (``render_frame_dynamic_refit``, ``refit_sah_ratio``).

Both end in the static frame's pass tail (``frame.finish_frame``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bvh.lbvh import build_lbvh, depth_bound
from ..bvh.wide import (LEAF8_MAX, compact_bvh8, refit_bvh8, refit_plan,
                        refit_quality)
from ..kernels.traverse_bvh2 import trace_closest_bvh2
from ..kernels.traverse_bvh8 import trace_closest_bvh8
from ..passes.encodings import divide, sqrt
from ..passes.gtao import GtaoSettings
from ..passes.rays import T_MAX, T_MIN, camera_rays
from ..passes.shade import shade
from .convert import MIP_TABLES, compact_bvh2, pack_bvh2, pack_tris_device
from .frame import finish_frame

REBUILD_SAH_RATIO = 2.0   # refit decay threshold that flips to rebuild


def _rows_apply(m, v):
    """(V, 3, >=3) matrices times (V, 3) vectors, each row summed left to
    right (the same sum on every device)."""
    return torch.stack([m[:, i, 0] * v[:, 0] + m[:, i, 1] * v[:, 1]
                        + m[:, i, 2] * v[:, 2] for i in range(3)], dim=-1)


def _normalize(v):
    norm = sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    return v / torch.clamp_min(norm, 1e-20)[:, None]


def _inverse_transpose3(m):
    """inv(M)^T of (I, 3, 3) matrices: the cofactor matrix over the
    determinant, as elementwise ops (the same bits on every device)."""
    a = [[m[:, i, j] for j in range(3)] for i in range(3)]
    cof = [[a[(i + 1) % 3][(j + 1) % 3] * a[(i + 2) % 3][(j + 2) % 3]
            - a[(i + 1) % 3][(j + 2) % 3] * a[(i + 2) % 3][(j + 1) % 3]
            for j in range(3)] for i in range(3)]
    det = a[0][0] * cof[0][0] + a[0][1] * cof[0][1] + a[0][2] * cof[0][2]
    return torch.stack([torch.stack(row, dim=-1) for row in cof],
                       dim=1) / det[:, None, None]


def world_vertices(obj: dict, transforms):
    """World-space vertex positions, normals and tangents of the object
    tables under (I, 3, 4) instance transforms."""
    inst = obj["vtx_instance"]
    m = transforms[inst]                                   # (V, 3, 4)
    vtx_pos = _rows_apply(m, obj["obj_vtx_pos"]) + m[:, :, 3]
    vtx_normal = _normalize(_rows_apply(
        _inverse_transpose3(transforms[:, :, :3])[inst],
        obj["obj_vtx_normal"]))
    tan = obj["obj_vtx_tangent"]
    vtx_tangent = torch.cat([_normalize(_rows_apply(m, tan[:, :3])),
                             tan[:, 3:4]], dim=1)
    return vtx_pos, vtx_normal, vtx_tangent


def _tri_attr(obj, vtx_pos, vtx_normal, vtx_tangent):
    """The (T, 40) shading rows (scene.py tri_attr layout) rebuilt from the
    moved vertices: 3 x [pos, uv, normal, tangent] + [prim, tex_h, tex_w,
    unique-image id]."""
    tv = obj["tri_vertex"]
    prim = obj["tri_prim"]
    corners = [torch.cat([vtx_pos[tv[:, k]], obj["vtx_uv"][tv[:, k]],
                          vtx_normal[tv[:, k]], vtx_tangent[tv[:, k]]], dim=1)
               for k in range(3)]
    return torch.cat(corners + [
        prim[:, None].to(torch.float32), obj["tex_size"][prim],
        obj["tex_img_of_prim"][prim][:, None].to(torch.float32)],
        dim=1).contiguous()


# the texel tables do not depend on the transforms: the frames read the
# uploaded object tables' as they are (tpurt's _forward_mip_tables,
# dynamic.py:59-69, and its tex_quad48)
_TEXEL_KEYS = ("tex_quad", "tex_quad_shape") + MIP_TABLES


def _texel_tables(obj: dict) -> dict:
    return {k: obj[k] for k in _TEXEL_KEYS if k in obj}


def _transforms(transforms, device):
    t = torch.as_tensor(transforms, dtype=torch.float32, device=device)
    if t.ndim != 3 or t.shape[1:] != (3, 4):
        raise ValueError(f"transforms must be (I, 3, 4), got {tuple(t.shape)}")
    return t


def build_world_tables(obj: dict, transforms) -> dict:
    """Object tables + (I, 3, 4) transforms -> world tables and a fresh
    LBVH with K6's node rows, their compact table ``nodes2c`` and the
    triangle rows (the per-frame 'TLAS rebuild').
    Also returns the binary tree (``bvh``) and the leaf-order triangles
    (``geom``) as tpurt's build_world_tables does."""
    transforms = _transforms(transforms, obj["obj_vtx_pos"].device)
    vtx_pos, vtx_normal, vtx_tangent = world_vertices(obj, transforms)
    tv = obj["tri_vertex"]
    v0, v1, v2 = (vtx_pos[tv[:, k]] for k in range(3))
    bvh = build_lbvh(torch.minimum(torch.minimum(v0, v1), v2),
                     torch.maximum(torch.maximum(v0, v1), v2))
    order = bvh.tri_order.to(torch.int64)
    v0o = v0[order]
    geom = dict(v0=v0o, e1=v1[order] - v0o, e2=v2[order] - v0o,
                tri_id=bvh.tri_order)
    bvh_pt = bvh.as_pytree()
    nodes2 = pack_bvh2(bvh_pt)
    return dict(bvh=bvh_pt, geom=geom, nodes2=nodes2,
                nodes2c=compact_bvh2(nodes2), tris=pack_tris_device(geom),
                depth2=depth_bound(tv.shape[0]),
                num_tris=int(tv.shape[0]),
                tri_attr=_tri_attr(obj, vtx_pos, vtx_normal, vtx_tangent),
                **_texel_tables(obj))


def render_frame_dynamic(obj: dict, transforms, camera: dict, lights: dict,
                         gtao: dict, lpm: dict, noise, *,
                         width: int, height: int,
                         gtao_settings: GtaoSettings = GtaoSettings(),
                         enable_gtao: bool = True,
                         enable_tonemap: bool = True,
                         aniso_taps: int = 1) -> dict:
    """One frame with a per-frame LBVH rebuild: primary rays through K6
    closest hit and every light's shadow rays through K6 any hit (leaves
    of one triangle), then the static frame's pass tail."""
    scene = build_world_tables(obj, transforms)
    origin, direction = camera_rays(camera, width, height)
    hits = trace_closest_bvh2(scene, origin, direction, T_MIN, T_MAX,
                              max_leaf=1, height=height, width=width)
    g = shade(scene, camera, lights, hits, tables="bvh2", max_leaf=1,
              height=height, width=width, direction=direction,
              aniso_taps=aniso_taps)
    return finish_frame(g, gtao, lpm, noise, width=width,
                        height=height, gtao_settings=gtao_settings,
                        enable_gtao=enable_gtao,
                        enable_tonemap=enable_tonemap)


def make_refit_data(scene) -> dict:
    """Host-side refit metadata of a FlatScene, computed once: the
    rest-pose BVH8 rows, their BFS levels, the SAH triangle order and the
    rest pose's refit_quality (upload with convert.refit_tensors)."""
    nodes8 = np.asarray(scene.bvh["nodes8"], np.float32)
    v0 = np.asarray(scene.geom["v0"])
    v1 = v0 + np.asarray(scene.geom["e1"])
    v2 = v0 + np.asarray(scene.geom["e2"])
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    rest_q = float(refit_quality(torch.from_numpy(nodes8),
                                 torch.from_numpy(tri_min),
                                 torch.from_numpy(tri_max)))
    return dict(nodes8=nodes8, levels=refit_plan(nodes8),
                order=np.asarray(scene.geom["tri_id"], np.int32),
                rest_quality=rest_q)


def render_frame_dynamic_refit(obj: dict, refit: dict, transforms,
                               camera: dict, lights: dict, gtao: dict,
                               lpm: dict, noise, *, width: int,
                               height: int,
                               gtao_settings: GtaoSettings = GtaoSettings(),
                               enable_gtao: bool = True,
                               enable_tonemap: bool = True,
                               aniso_taps: int = 1) -> dict:
    """One frame with the rest-pose BVH8 refit to the moved triangles, then
    the static frame's path (K1, K2 over the compact table rebuilt from the
    refit rows, pass tail). `refit` is
    ``convert.refit_tensors(make_refit_data(scene), device)``. The output
    adds ``refit_sah_ratio``: refit_quality over the rest pose's, a 0-dim
    tensor on the device."""
    transforms = _transforms(transforms, obj["obj_vtx_pos"].device)
    vtx_pos, vtx_normal, vtx_tangent = world_vertices(obj, transforms)
    tvo = obj["tri_vertex"][refit["order"]]             # SAH-ordered corners
    v0, v1, v2 = (vtx_pos[tvo[:, k]] for k in range(3))
    tri_min = torch.minimum(torch.minimum(v0, v1), v2)
    tri_max = torch.maximum(torch.maximum(v0, v1), v2)
    nodes8 = refit_bvh8(refit["nodes8"], refit["levels"], tri_min, tri_max,
                        leaf_max=LEAF8_MAX)
    sah_ratio = divide(refit_quality(nodes8, tri_min, tri_max),
                       refit["rest_quality"])

    geom = dict(v0=v0, e1=v1 - v0, e2=v2 - v0, tri_id=refit["order"])
    scene = dict(nodes8=nodes8, nodes8c=compact_bvh8(nodes8),
                 tris=pack_tris_device(geom),
                 depth8=refit["depth8"],
                 tri_attr=_tri_attr(obj, vtx_pos, vtx_normal, vtx_tangent),
                 **_texel_tables(obj))
    origin, direction = camera_rays(camera, width, height)
    hits = trace_closest_bvh8(scene, origin, direction, T_MIN, T_MAX,
                              height=height, width=width)
    g = shade(scene, camera, lights, hits, tables="bvh8", height=height,
              width=width, direction=direction, aniso_taps=aniso_taps)
    out = finish_frame(g, gtao, lpm, noise, width=width,
                       height=height, gtao_settings=gtao_settings,
                       enable_gtao=enable_gtao,
                       enable_tonemap=enable_tonemap)
    out["refit_sah_ratio"] = sah_ratio
    return out
