"""Scene flattening — the numpy path of ``tpurt/scene/scene.py``.

Models become global tables in world space: the traversal triangles
(``geom``), the binary SAH BVH with its BVH8 collapse (``bvh['nodes8']``),
one ``tri_attr`` row per triangle for the shade pass and the texel tables.
Without mips that is one 2x2-footprint quad row per texel of every unique
image (``tex_quad48``). With ``mipmaps=True`` every unique image gets a box
-filtered mip chain, and exactly one texel table ships, by tpurt's budget
cutover: the quad tier (one 64-byte row per texel and level, the whole
2x2 footprint; one gather per bilinear fetch), the pair tier (one row per
x-aligned texel pair and its y+1 row; two gathers) or the block4 tier (one
row per aligned 2x2 block; four gathers). The padded per-primitive
stacks (``tex_stack``, ``tex_stack12``) stay on the host. tpurt also keeps
a per-layer atlas (``tex_atlas``) on the host, which no frame of the port
reads: ``build_mip_atlas`` builds it on demand, as the plain definition
the tiers are held to. The object-space tables and the instance
transforms are kept for the dynamic scene (``as_object_pytree``). Every
array equals the reference's bit for bit; ``engine/convert.py`` uploads
them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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
    # world-space vertex tables and the padded per-primitive texel stacks:
    # host only (as_full_pytree)
    vtx_pos: np.ndarray         # (V, 3) f32
    vtx_normal: np.ndarray      # (V, 3) f32, normalized
    vtx_tangent: np.ndarray     # (V, 4) f32 xyz + handedness w
    tex_stack: np.ndarray       # (P*3, Hmax, Wmax, 4) u8 albedo/orm/normal
    tex_stack12: np.ndarray     # (P, Hmax, Wmax, 12) u8 packed layers
    # without mips: (U, Hmax, Wmax, 64) u8 2x2-footprint rows per unique
    # image (48 data + 16 pad)
    tex_quad48: Optional[np.ndarray] = None
    # with mips: one of three tiers
    tex_mip_sizes: Optional[np.ndarray] = None    # (P, L, 2) i32 (h, w)
    tex_mip_quad: Optional[np.ndarray] = None     # (N, 64) u8
    tex_mip_quad_offsets: Optional[np.ndarray] = None   # (P, L) i32 rows
    tex_mip_pair: Optional[np.ndarray] = None     # (N2, 64) u8
    tex_mip_pair_offsets: Optional[np.ndarray] = None   # (P, L) i32 rows
    tex_mip_block4: Optional[np.ndarray] = None   # (N4, 64) u8
    tex_mip_block4_offsets: Optional[np.ndarray] = None  # (P, L) i32 rows

    def _texel_tables(self) -> dict:
        """The one texel table that ships, tpurt's rule
        (scene.py:107-128): a mip scene's tier (block4, pair or quad:
        ``flatten_scene`` builds one) with ``tex_mip_sizes``, or else
        ``tex_quad48``."""
        if self.tex_mip_sizes is None:
            return dict(tex_quad48=self.tex_quad48)
        out = dict(tex_mip_sizes=self.tex_mip_sizes)
        for tier in ("block4", "pair", "quad"):
            table = getattr(self, f"tex_mip_{tier}")
            if table is not None:
                out[f"tex_mip_{tier}"] = table
                out[f"tex_mip_{tier}_offsets"] = getattr(
                    self, f"tex_mip_{tier}_offsets")
                return out
        raise ValueError("a mip scene without a texel tier")

    def as_pytree(self) -> dict:
        """The tables the frame reads — the keys tpurt's
        ``FlatScene.as_pytree()`` ships when ``tri_attr`` and a texel tier
        exist, as ``flatten_scene`` always builds them."""
        return dict(bvh=self.bvh, geom=self.geom, tex_size=self.tex_size,
                    tri_attr=self.tri_attr, **self._texel_tables())

    def as_full_pytree(self) -> dict:
        """``as_pytree()`` and the host-only tables (the world vertex
        tables and the padded per-primitive stack), as tpurt's
        ``as_full_pytree``; never uploaded."""
        return dict(self.as_pytree(), tri_vertex=self.tri_vertex,
                    tri_prim=self.tri_prim, vtx_pos=self.vtx_pos,
                    vtx_uv=self.vtx_uv, vtx_normal=self.vtx_normal,
                    vtx_tangent=self.vtx_tangent, tex_stack=self.tex_stack)

    def as_object_pytree(self) -> dict:
        """The dynamic scene's inputs — the keys tpurt's
        ``FlatScene.as_object_pytree()`` ships on its ``tri_attr`` path
        (transforms come per frame), with the same texel table as
        ``as_pytree``."""
        return dict(
            tri_vertex=self.tri_vertex, tri_prim=self.tri_prim,
            vtx_instance=self.vtx_instance, obj_vtx_pos=self.obj_vtx_pos,
            obj_vtx_normal=self.obj_vtx_normal,
            obj_vtx_tangent=self.obj_vtx_tangent, vtx_uv=self.vtx_uv,
            tex_size=self.tex_size, tex_img_of_prim=self.tex_img_of_prim,
            **self._texel_tables())


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


def _box_mip(arr: np.ndarray) -> np.ndarray:
    """2x2 box-filter downsample of a (H, W, C) u8 image, rounded to
    nearest; an odd trailing row or column is duplicated, as GPU mip
    generation clamps it."""
    h, w = arr.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    if h % 2 and h > 1:
        arr = np.concatenate([arr, arr[-1:]], axis=0)
    if w % 2 and w > 1:
        arr = np.concatenate([arr, arr[:, -1:]], axis=1)
    if h == 1 and w == 1:
        return arr
    a = arr[:h2 * 2, :w2 * 2].astype(np.uint16)
    q = a.reshape(h2, 2 if h > 1 else 1, w2, 2 if w > 1 else 1, 4)
    s = q.sum(axis=(1, 3))
    n = q.shape[1] * q.shape[3]
    return ((s + n // 2) // n).astype(np.uint8)


def _mip_levels(tex_size: np.ndarray) -> int:
    """The global chain length: levels down to 1x1 of the largest
    extent."""
    hmax = int(tex_size[:, 0].max(initial=1))
    wmax = int(tex_size[:, 1].max(initial=1))
    return max(int(np.ceil(np.log2(max(hmax, wmax, 1)))) + 1, 1)


def _packed_mips(tex_stack, tex_size, prim, levels):
    """Yield each level of one primitive's chain as (h, w, 12) u8, the
    three layers packed; the 1x1 level repeats up to `levels`."""
    h, w = int(tex_size[prim, 0]), int(tex_size[prim, 1])
    mips = [tex_stack[prim * 3 + layer, :h, :w].copy() for layer in range(3)]
    for _ in range(levels):
        yield np.concatenate(mips, axis=2)
        if mips[0].shape[0] > 1 or mips[0].shape[1] > 1:
            mips = [_box_mip(m) for m in mips]


def _default_dedup(tex_size, img_of_prim, uniq_prims):
    if img_of_prim is None:
        n = tex_size.shape[0]
        return np.arange(n, dtype=np.int32), list(range(n))
    return img_of_prim, uniq_prims


def build_mip_atlas(tex_stack: np.ndarray, tex_size: np.ndarray,
                    img_of_prim: Optional[np.ndarray] = None,
                    uniq_prims=None):
    """Full mip chains of every image, each layer apart, in one flat texel
    atlas stored once per unique image (``dedup_images``); duplicates'
    offsets alias the shared texels. Returns (atlas (N, 4) u8, offsets
    (P*3, L) i32 texel offsets, sizes (P, L, 2) i32)."""
    levels = _mip_levels(tex_size)
    img_of_prim, uniq_prims = _default_dedup(tex_size, img_of_prim,
                                             uniq_prims)
    chunks = []
    offsets_u = np.zeros((len(uniq_prims) * 3, levels), np.int64)
    sizes_u = np.zeros((len(uniq_prims), levels, 2), np.int32)
    cursor = 0
    for ui, uprim in enumerate(uniq_prims):
        for layer in range(3):
            h, w = int(tex_size[uprim, 0]), int(tex_size[uprim, 1])
            cur = tex_stack[uprim * 3 + layer, :h, :w].copy()
            for lv in range(levels):
                offsets_u[ui * 3 + layer, lv] = cursor
                sizes_u[ui, lv] = cur.shape[:2]
                chunks.append(cur.reshape(-1, 4))
                cursor += cur.shape[0] * cur.shape[1]
                if cur.shape[0] > 1 or cur.shape[1] > 1:
                    cur = _box_mip(cur)
    atlas = np.concatenate(chunks, axis=0)
    layer_rows = (img_of_prim.astype(np.int64)[:, None] * 3
                  + np.arange(3)).reshape(-1)
    return (atlas, offsets_u[layer_rows].astype(np.int32),
            sizes_u[img_of_prim])


def _tier_atlas(tex_stack, tex_size, img_of_prim, uniq_prims, rows_of):
    """One row table of every unique image's chain: rows_of(level (h, w,
    12)) -> (n, 64) u8 rows. Returns (atlas, offsets (P, L) i32 row
    offsets, sizes (P, L, 2) i32)."""
    levels = _mip_levels(tex_size)
    img_of_prim, uniq_prims = _default_dedup(tex_size, img_of_prim,
                                             uniq_prims)
    chunks = []
    offsets_u = np.zeros((len(uniq_prims), levels), np.int64)
    sizes_u = np.zeros((len(uniq_prims), levels, 2), np.int32)
    cursor = 0
    for ui, prim in enumerate(uniq_prims):
        for lv, arr12 in enumerate(_packed_mips(tex_stack, tex_size, prim,
                                                levels)):
            rows = rows_of(arr12)
            offsets_u[ui, lv] = cursor
            sizes_u[ui, lv] = arr12.shape[:2]
            chunks.append(rows)
            cursor += rows.shape[0]
    atlas = np.concatenate(chunks, axis=0)
    return (atlas, offsets_u[img_of_prim].astype(np.int32),
            sizes_u[img_of_prim])


def _quad_rows(arr12):
    """One 64-byte row per texel: its 2x2 footprint (REPEAT wrap) across
    the three layers, 48 bytes + 16 pad."""
    quad = np.zeros(arr12.shape[:2] + (64,), np.uint8)
    quad[..., :48] = np.concatenate(
        [arr12,
         np.roll(arr12, -1, axis=1),
         np.roll(arr12, -1, axis=0),
         np.roll(np.roll(arr12, -1, 0), -1, 1)], axis=2)
    return quad.reshape(-1, 64)


def _pair_rows(arr12):
    """One 64-byte row per (y, x-pair): [t(y, 2xp) | t(y, 2xp+1) |
    t((y+1)%h, 2xp) | t((y+1)%h, 2xp+1)] x 12 bytes + 16 pad; an odd
    width's last slot 1 stays zero (never selected)."""
    hh, ww = arr12.shape[:2]
    bw = (ww + 1) // 2
    wrap = np.roll(arr12, -1, axis=0)
    both = np.concatenate([arr12, wrap], axis=2)
    pad = np.zeros((hh, bw * 2, 24), np.uint8)
    pad[:, :ww] = both
    blk = pad.reshape(hh, bw, 2, 24)
    rows = np.zeros((hh * bw, 64), np.uint8)
    rows[:, 0:12] = blk[:, :, 0, 0:12].reshape(-1, 12)
    rows[:, 12:24] = blk[:, :, 1, 0:12].reshape(-1, 12)
    rows[:, 24:36] = blk[:, :, 0, 12:24].reshape(-1, 12)
    rows[:, 36:48] = blk[:, :, 1, 12:24].reshape(-1, 12)
    return rows


def _block4_rows(arr12):
    """One 64-byte row per aligned 2x2 block: [t(2y, 2x) | t(2y, 2x+1) |
    t(2y+1, 2x) | t(2y+1, 2x+1)] x 12 bytes + 16 pad; odd extents pad with
    zero texels (never selected)."""
    hh, ww = arr12.shape[:2]
    bh, bw = (hh + 1) // 2, (ww + 1) // 2
    pad = np.zeros((bh * 2, bw * 2, 12), np.uint8)
    pad[:hh, :ww] = arr12
    blk = pad.reshape(bh, 2, bw, 2, 12).transpose(0, 2, 1, 3, 4)
    rows = np.zeros((bh * bw, 64), np.uint8)
    rows[:, :48] = blk.reshape(bh * bw, 48)
    return rows


def build_mip_quad_atlas(tex_stack: np.ndarray, tex_size: np.ndarray,
                         img_of_prim: Optional[np.ndarray] = None,
                         uniq_prims=None):
    """The quad tier: one 64-byte row per (image, level, y, x) texel with
    its whole 2x2 footprint in the three packed layers, so a bilinear fetch
    of all three is one row gather. Returns (atlas (N, 64) u8, offsets
    (P, L) i32 row offsets, sizes (P, L, 2) i32)."""
    return _tier_atlas(tex_stack, tex_size, img_of_prim, uniq_prims,
                       _quad_rows)


def build_mip_pair_atlas(tex_stack: np.ndarray, tex_size: np.ndarray,
                         img_of_prim: np.ndarray, uniq_prims):
    """The pair tier (2.67x the source bytes): one 64-byte row per (image,
    level, y, x-pair), the pair and its (y+1)%h row; a bilinear fetch reads
    the rows of columns x0 and (x0+1)%w. Returns (atlas (N2, 64) u8,
    offsets (P, L) i32 row offsets, sizes (P, L, 2) i32)."""
    return _tier_atlas(tex_stack, tex_size, img_of_prim, uniq_prims,
                       _pair_rows)


def build_mip_block4_atlas(tex_stack: np.ndarray, tex_size: np.ndarray,
                           img_of_prim: np.ndarray, uniq_prims):
    """The block4 tier (1.33x the source bytes): one 64-byte row per
    aligned 2x2 block and level; texel (y, x) sits in block (y//2, x//2),
    slot (y&1)*2 + (x&1), so a bilinear fetch reads four rows. Returns
    (atlas (N4, 64) u8, offsets (P, L) i32 row offsets, sizes (P, L, 2)
    i32)."""
    return _tier_atlas(tex_stack, tex_size, img_of_prim, uniq_prims,
                       _block4_rows)


# tpurt's tier cutover (scene.py:348-362): quad below the first budget,
# pair below the second, block4 above both
MIP_QUAD_BUDGET_BYTES = 256 * 1024 * 1024
MIP_PAIR_BUDGET_BYTES = 1024 * 1024 * 1024


def mip_quad_bytes(tex_size: np.ndarray, uniq_prims) -> int:
    """The quad tier's bytes for the cutover, as tpurt counts them: 64
    bytes per texel of each image's own chain down to 1x1 (the builder
    also repeats the 1x1 level up to the global chain length)."""
    total = 0
    for prim in uniq_prims:
        h, w = int(tex_size[prim, 0]), int(tex_size[prim, 1])
        levels = max(int(np.ceil(np.log2(max(h, w, 1)))) + 1, 1)
        for _ in range(levels):
            total += h * w * 64
            h, w = max(h // 2, 1), max(w // 2, 1)
    return total


def mip_pair_bytes(tex_size: np.ndarray, uniq_prims) -> int:
    """The pair tier's bytes, exactly as ``build_mip_pair_atlas`` builds
    it (the global chain length for every image)."""
    levels = _mip_levels(tex_size[list(uniq_prims)])
    total = 0
    for prim in uniq_prims:
        h, w = int(tex_size[prim, 0]), int(tex_size[prim, 1])
        for _ in range(levels):
            total += h * ((w + 1) // 2) * 64
            h, w = max(h // 2, 1), max(w // 2, 1)
    return total


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


def flatten_scene(models: List, mipmaps: bool = False) -> FlatScene:
    """Flatten all device-resident models and build the world BVH + BVH8.
    mipmaps=True builds the mip chains and one texel tier for trilinear
    sampling in place of ``tex_quad48``."""
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

    tiers = {}
    if mipmaps:
        # exactly one row tier ships, by tpurt's cutover
        # (scene.py:618-638)
        if mip_quad_bytes(tex_size, uniq_prims) <= MIP_QUAD_BUDGET_BYTES:
            tier, build = "quad", build_mip_quad_atlas
        elif mip_pair_bytes(tex_size, uniq_prims) <= MIP_PAIR_BUDGET_BYTES:
            tier, build = "pair", build_mip_pair_atlas
        else:
            tier, build = "block4", build_mip_block4_atlas
        table, offsets, sizes = build(tex_stack, tex_size, img_of_prim,
                                      uniq_prims)
        tiers[f"tex_mip_{tier}"] = table
        tiers[f"tex_mip_{tier}_offsets"] = offsets
        tiers["tex_mip_sizes"] = sizes
    else:
        # the mip tiers supersede these rows: built only without mips
        tex_quad48 = np.zeros((len(uniq_prims), hmax, wmax, 64), np.uint8)
        for ui, p in enumerate(uniq_prims):
            h, w = int(tex_size[p, 0]), int(tex_size[p, 1])
            tex_quad48[ui, :h, :w] = _quad_rows(
                tex_stack12[p, :h, :w]).reshape(h, w, 64)
        tiers["tex_quad48"] = tex_quad48

    return FlatScene(bvh=bvh_pt, geom=geom, tri_attr=tri_attr,
                     tex_size=tex_size, num_prims=prim_idx,
                     builder=sah.builder, tri_vertex=tri_vertex,
                     tri_prim=tri_prim, vtx_uv=vtx_uv,
                     vtx_instance=vtx_instance, obj_vtx_pos=obj_vtx_pos,
                     obj_vtx_normal=obj_vtx_normal,
                     obj_vtx_tangent=obj_vtx_tangent,
                     tex_img_of_prim=img_of_prim, transforms=transforms,
                     vtx_pos=vtx_pos, vtx_normal=vtx_normal,
                     vtx_tangent=vtx_tangent, tex_stack=tex_stack,
                     tex_stack12=tex_stack12, **tiers)
