"""Carry tpurt's host state across: numpy dicts -> the port's tensors.

Each function takes what the reference builds on the host (and feeds to its
jitted frame) and returns the port's tensors on an explicit device:

  scene_tensors   FlatScene.as_pytree()            (either package's; uvp too)
  object_tensors  FlatScene.as_object_pytree()     (the dynamic scene)
  refit_tensors   engine/dynamic.make_refit_data() (the refit frames)
  bvh2_tensors    a binary BVH + its triangles     (K6's tables)

and ``compact_bvh2`` builds K6's compact child-pair table from its rows.
  camera_tensors  Camera.uniform()
  light_tensors   Lights.shader_arrays()
  gtao_tensors    gtao_constants(...)              (f32 and fp16 vectors)
  lpm_tensors     lpm_setup(...)[1]

``InputBuffer`` holds the frame's camera, light and GTAO-constant arrays
(``camera_arrays``, ``Lights.shader_arrays()``, ``gtao_arrays``) in one
device buffer, updated in place by one non-blocking copy: the renderer's
frame inputs.

The tests use these to feed identical inputs to both packages. The texel
table that ships (``FlatScene.as_pytree``) uploads as it is: the quad slab
as one flat (rows, 64) u8 table with its shape, or a mip tier with its
offsets and ``tex_mip_sizes``. The renderer's streaming arena
(``engine/texture_arena.py``) takes the table out of the dict first and
supplies its own (the same values).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bvh.wide import EMPTY_CODE, LEAF8_MAX, LEAF_CODE_BASE, compact_bvh8
from ..kernels.gtao_main import GTAO_VEC
from ..kernels.traverse_bvh2 import MAX_LEAF, kernel_stack
from ..kernels.traverse_bvh8 import STACK_SIZE, stack_entries
from ..utils.spans import no_step

# K6 and K1/K2 carry node and triangle indices as exact f32 values
MAX_EXACT_INDEX = 1 << 24


def _t(x, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


def bvh8_depth(nodes8: np.ndarray) -> int:
    """Wide levels (root = 1) of packed BVH8 rows, from the child lanes."""
    child = np.asarray(nodes8)[:, 48:56].astype(np.int64)
    depth, cur = 0, np.array([0], np.int64)
    while cur.size:
        depth += 1
        nxt = child[cur].reshape(-1)
        cur = np.unique(nxt[nxt >= 0])
    return depth


def pack_tris(geom: dict) -> np.ndarray:
    """Traversal triangle rows [v0, e1, e2, tri_id, 0, 0] (T, 12) f32 in
    BVH leaf order; tri_id is an exact small float (< 2^24)."""
    t = geom["v0"].shape[0]
    if t >= MAX_EXACT_INDEX:
        raise ValueError(f"{t} triangles: ids must stay below 2^24")
    tris = np.zeros((max(t, 1), 12), np.float32)
    tris[:t, 0:3] = geom["v0"]
    tris[:t, 3:6] = geom["e1"]
    tris[:t, 6:9] = geom["e2"]
    tris[:t, 9] = np.asarray(geom["tri_id"]).astype(np.float32)
    return tris


def pack_tris_device(geom: dict):
    """``pack_tris`` for tensors on their own device: the tables the
    dynamic frames rebuild every frame never leave the card."""
    v0 = geom["v0"]
    t = v0.shape[0]
    if t >= MAX_EXACT_INDEX:
        raise ValueError(f"{t} triangles: ids must stay below 2^24")
    return torch.cat([v0, geom["e1"], geom["e2"],
                      geom["tri_id"].to(torch.float32)[:, None],
                      v0.new_zeros((t, 2))], dim=1).contiguous()


def pack_bvh2(bvh: dict):
    """K6's node rows (M, 8) f32 from a threaded binary BVH (tensors, on
    their device): min.xyz, max.xyz, then (left child, right child) for an
    internal node or (first triangle, -count) for a leaf, as exact small
    floats. The right child is ``skip[entry]``."""
    amin = bvh["aabb_min"]
    m = amin.shape[0]
    if m >= MAX_EXACT_INDEX:
        raise ValueError(f"{m} BVH nodes: indices must stay below 2^24")
    entry = bvh["entry"].to(torch.int64)
    count = bvh["tri_count"].to(torch.int64)
    right = bvh["skip"].to(torch.int64)[torch.clamp_min(entry, 0)]
    leaf = count > 0
    a = torch.where(leaf, bvh["first_tri"].to(torch.int64), entry)
    b = torch.where(leaf, -count, right)
    return torch.cat([amin, bvh["aabb_max"], a[:, None].to(torch.float32),
                      b[:, None].to(torch.float32)], dim=1).contiguous()


def compact_bvh2(nodes2):
    """K6's compact child-pair table ``nodes2c`` (R, 16) f32 of a full
    binary tree's (M, 8) rows (``pack_bvh2``; a tensor, on its device), R =
    1 + (M - 1) / 2. Row 0 is a header: the root's box (lanes 0-5) and code
    (lane 12; lanes 6-11 and 14-15 zero, lane 13 EMPTY_CODE). Row 1 + i is
    the i-th internal node in node order: its left child's box (lanes 0-5),
    its right child's (6-11), the same f32 bits as the rows, and the two
    children's codes (12, 13) as int32 bits; lanes 14-15 zero. Leaves have
    no row: a child's code is its row for an internal node and
    -(first * LEAF_CODE_BASE + count) - 1 for a leaf, so a pop reads one
    row and no meta row. Raises for a leaf of more than MAX_LEAF triangles
    or a tree that is not full (one read back from the device)."""
    m = nodes2.shape[0]
    leaf = nodes2[:, 7] < 0.0
    a = nodes2[:, 6].to(torch.int64)          # left child / first triangle
    b = nodes2[:, 7].to(torch.int64)          # right child / -count
    widest, leaves = torch.stack([torch.where(leaf, -b, 0).max(),
                                  leaf.sum()]).tolist()
    if widest > MAX_LEAF:
        raise ValueError(f"a binary BVH leaf holds {widest} triangles; K6 "
                         f"takes at most {MAX_LEAF}")
    if 2 * leaves != m + 1:
        raise ValueError(f"{m} nodes with {leaves} leaves: not a full "
                         f"binary tree")
    row = torch.cumsum(~leaf, 0)              # internal node -> its row
    code = torch.where(leaf, b - a * LEAF_CODE_BASE - 1, row).to(torch.int32)
    inner = torch.argsort(leaf.to(torch.int32), stable=True)[:(m - 1) // 2]
    kids = torch.stack([a[inner], b[inner]], dim=1)           # (R - 1, 2)
    header = torch.cat([nodes2[0, :6], nodes2.new_zeros(6),
                        torch.stack([code[0], code.new_tensor(EMPTY_CODE)])
                        .view(torch.float32), nodes2.new_zeros(2)])
    body = torch.cat([nodes2[kids, :6].reshape(-1, 12),
                      code[kids].view(torch.float32),
                      nodes2.new_zeros((kids.shape[0], 2))], dim=1)
    return torch.cat([header[None], body]).contiguous()


def bvh2_tensors(bvh: dict, geom: dict, depth: int, device) -> dict:
    """K6's tables for a binary BVH and its leaf-order triangles (numpy or
    tensors): the rows ``nodes2``, their compact table ``nodes2c`` (which
    K6 reads), ``tris`` and ``depth2``; `depth` bounds the tree's depth
    (root = 0). Raises when the kernel's stack could overflow."""
    kernel_stack(depth)

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.tensor(np.asarray(x), device=device)

    bvh = {k: tensor(bvh[k]) for k in ("aabb_min", "aabb_max", "entry",
                                       "skip", "first_tri", "tri_count")}
    geom = {k: tensor(geom[k]) for k in ("v0", "e1", "e2", "tri_id")}
    nodes2 = pack_bvh2(bvh)
    return dict(nodes2=nodes2, nodes2c=compact_bvh2(nodes2),
                tris=pack_tris_device(geom), depth2=int(depth))


def _check_bvh8(nodes8: np.ndarray) -> int:
    """The BVH8's depth; raises when it could overflow the traversal stack
    or a leaf is wider than the kernels' leaf loop."""
    depth8 = bvh8_depth(nodes8)
    if stack_entries(depth8) > STACK_SIZE:
        raise ValueError(f"BVH8 depth {depth8} needs {stack_entries(depth8)}"
                         f" stack entries; the kernels hold {STACK_SIZE}")
    if nodes8[:, 64:72].max(initial=0) > LEAF8_MAX:
        raise ValueError(f"a BVH8 leaf holds more than {LEAF8_MAX} tris")
    return depth8


# the mip texel tables a scene may ship (``FlatScene._texel_tables``)
MIP_TABLES = ("tex_mip_sizes", "tex_mip_quad", "tex_mip_quad_offsets",
              "tex_mip_pair", "tex_mip_pair_offsets", "tex_mip_block4",
              "tex_mip_block4_offsets")


def texel_tensors(pt: dict, device) -> dict:
    """The shipped texel table on `device`: ``tex_quad48`` as the flat
    ``tex_quad`` (rows, 64) u8 with ``tex_quad_shape`` (U, H, W, 64), and
    the mip tables under their own names (u8 rows, int32 offsets and
    sizes). Tables absent from `pt` are skipped."""
    out = {}
    if pt.get("tex_quad48") is not None:
        quad = np.asarray(pt["tex_quad48"], np.uint8)
        out.update(tex_quad=_t(quad.reshape(-1, quad.shape[-1]), device),
                   tex_quad_shape=tuple(int(s) for s in quad.shape))
    for k in MIP_TABLES:
        if pt.get(k) is not None:
            a = np.asarray(pt[k])
            out[k] = _t(a, device, torch.uint8 if a.dtype == np.uint8
                        else torch.int32)
    return out


def scene_tensors(pt: dict, device) -> dict:
    """Static scene tables on `device` (the texel table as
    ``texel_tensors`` uploads it). Raises when the BVH8 could overflow
    the one-pop traversal stack or a leaf is wider than the kernels' leaf
    loop (the two-pop kernels check their own bound when called). Beside
    the (M, 128) rows ``nodes8`` it carries their compact table ``nodes8c``
    (``bvh/wide.compact_bvh8``), which the any-hit kernel K2 reads. When the
    geometry carries the uv payload (``geom["uvp"]``, (T, 9) f32 in BVH
    leaf order), it is uploaded as its own table ``uvp`` beside the 48-byte
    ``tris`` rows; only the payload kernel reads it."""
    nodes8 = np.asarray(pt["bvh"]["nodes8"], np.float32)
    depth8 = _check_bvh8(nodes8)
    nodes8 = _t(nodes8, device)
    out = dict(
        nodes8=nodes8,
        nodes8c=compact_bvh8(nodes8),
        tris=_t(pack_tris(pt["geom"]), device),
        num_tris=int(pt["geom"]["v0"].shape[0]),
        depth8=depth8,
        tri_attr=_t(np.asarray(pt["tri_attr"], np.float32), device),
        **texel_tensors(pt, device),
    )
    if "uvp" in pt["geom"]:
        out["uvp"] = _t(np.asarray(pt["geom"]["uvp"], np.float32), device)
    return out


def object_tensors(pt: dict, device) -> dict:
    """The dynamic scene's object-space tables on `device`, uploaded once:
    index tables as int64 (gather indices), the rest as f32 (``tex_size``
    is read only as the f32 extent columns of ``tri_attr``), with the texel
    table as ``texel_tensors`` uploads it."""
    out = {k: _t(np.asarray(pt[k], np.int64), device)
           for k in ("tri_vertex", "tri_prim", "vtx_instance",
                     "tex_img_of_prim")}
    out.update({k: _t(np.asarray(pt[k], np.float32), device)
                for k in ("obj_vtx_pos", "obj_vtx_normal", "obj_vtx_tangent",
                          "vtx_uv", "tex_size")})
    out.update(texel_tensors(pt, device))
    return out


def refit_tensors(refit: dict, device) -> dict:
    """The refit frames' static metadata on `device`: the rest-pose BVH8
    rows (checked as scene_tensors checks them), the BFS levels as index
    tensors, the SAH triangle order and the rest-pose quality (a float)."""
    nodes8 = np.asarray(refit["nodes8"], np.float32)
    return dict(
        nodes8=_t(nodes8, device), depth8=_check_bvh8(nodes8),
        levels=[_t(np.asarray(lv, np.int64), device)
                for lv in refit["levels"]],
        order=_t(np.asarray(refit["order"], np.int64), device),
        rest_quality=float(refit["rest_quality"]))


def camera_arrays(uniform: dict) -> dict:
    """Camera.uniform()'s arrays as the f32 arrays the frame reads."""
    return {k: np.asarray(v, np.float32) for k, v in uniform.items()}


def camera_tensors(uniform: dict, device) -> dict:
    """Camera.uniform()'s arrays as f32 tensors."""
    return {k: _t(v, device) for k, v in camera_arrays(uniform).items()}


def light_tensors(arrays: dict, device) -> dict:
    """Lights.shader_arrays() as tensors."""
    return {k: _t(v, device) for k, v in arrays.items()}


def gtao_arrays(consts: dict) -> dict:
    """The GTAO constants as tpurt's main_pass uses them: the scalar block
    (effect radius, falloff) is derived in double precision from the Python
    floats and applied in f32, exactly as the jnp code does. Returns the
    (14,) f32 vector ``vec`` the main pass reads (kernel and plain version
    alike, laid out as GTAO_VEC) and ``vec16``, the same for the fp16 main
    pass (``gtao_vec16``)."""
    effect_radius = consts["effect_radius"] * consts["radius_multiplier"]
    falloff_range = consts["effect_falloff_range"] * effect_radius
    falloff_from = effect_radius * (1.0 - consts["effect_falloff_range"])
    falloff_mul = -1.0 / falloff_range
    falloff_add = falloff_from / falloff_range + 1.0
    vec = np.asarray([
        consts["viewport_pixel_size"][0], consts["viewport_pixel_size"][1],
        consts["ndc_to_view_mul"][0], consts["ndc_to_view_mul"][1],
        consts["ndc_to_view_add"][0], consts["ndc_to_view_add"][1],
        effect_radius, consts["sample_distribution_power"],
        1.0 + consts["thin_occluder_compensation"], falloff_mul, falloff_add,
        consts["final_value_power"], consts["depth_mip_sampling_offset"],
        consts["ndc_to_view_mul_x_pixel_size"][0]], np.float32)
    assert len(vec) == len(GTAO_VEC)
    return dict(vec=vec, vec16=gtao_vec16(consts))


def gtao_tensors(consts: dict, device) -> dict:
    """``gtao_arrays``' vectors as tensors, and the Python floats the
    prefilter needs under ``host``."""
    return dict({k: _t(v, device) for k, v in gtao_arrays(consts).items()},
                host=dict(consts))


def gtao_vec16(consts: dict) -> np.ndarray:
    """The constants vector of the fp16 main pass: tpurt's lpfloat scalar
    block (``lp(x)`` is ``jnp.asarray(x).astype(f16)``, an f32 rounded to
    f16; a bare literal meeting an f16 operand is its f16 nearest), each
    operation rounded to f16 as numpy's float16 arithmetic rounds. The view
    reconstruction's entries stay f32, as tpurt keeps them."""
    f16 = np.float16

    def lp(x):
        return f16(np.float32(x))

    effect_radius = lp(consts["effect_radius"]) * lp(
        consts["radius_multiplier"])
    falloff_k = lp(consts["effect_falloff_range"])
    falloff_range = falloff_k * effect_radius
    falloff_from = effect_radius * (f16(1.0) - falloff_k)
    falloff_mul = f16(-1.0) / falloff_range
    falloff_add = falloff_from / falloff_range + f16(1.0)
    vec = [lp(consts["viewport_pixel_size"][0]),
           lp(consts["viewport_pixel_size"][1]),
           consts["ndc_to_view_mul"][0], consts["ndc_to_view_mul"][1],
           consts["ndc_to_view_add"][0], consts["ndc_to_view_add"][1],
           effect_radius, lp(consts["sample_distribution_power"]),
           f16(1.0) + lp(consts["thin_occluder_compensation"]),
           falloff_mul, falloff_add, f16(consts["final_value_power"]),
           f16(consts["depth_mip_sampling_offset"]),
           consts["ndc_to_view_mul_x_pixel_size"][0]]
    return np.asarray([np.float32(v) for v in vec], np.float32)


def lpm_tensors(derived: dict, device) -> dict:
    return {k: _t(np.asarray(v, np.float32), device)
            for k, v in derived.items()}


class InputBuffer:
    """Groups of host arrays (name -> {key: array}) as tensors in one
    device buffer that persists across frames: ``Renderer``'s camera,
    light and GTAO-constant arrays.

    ``update`` uploads only when a host value changed, and then every
    array at once: packed into one staging buffer, pinned for a CUDA
    device (a fresh block of PyTorch's caching host allocator, which holds
    it until the copy has run), and copied into the buffer in place by one
    non-blocking transfer, inside step("upload"). The copy is ordered on
    the stream after the frames already queued, so it never synchronises
    the stream, and the tensors ``update`` returns stay the same tensors
    while the arrays keep their shapes and dtypes (a captured frame reads
    them: ``engine/frame_graph.py``). Another layout, such as another light
    count, allocates a new buffer."""

    # bytes each array's offset is a multiple of
    ALIGN = 64

    def __init__(self, device):
        self.device = torch.device(device)
        self.host = None      # the arrays last uploaded
        self.layout = None    # ((group, key, dtype, shape, offset), ...)
        self.buffer = None    # the device buffer, uint8
        self.tensors = None   # {group: {key: view of the buffer}}

    def update(self, groups: dict, step=no_step) -> dict:
        """The tensors of `groups` ({group: {key: array}}) on the device;
        copies them there when any value differs from the last upload."""
        groups = {g: {k: np.ascontiguousarray(v) for k, v in arrays.items()}
                  for g, arrays in groups.items()}
        if self.host is not None and _same_arrays(self.host, groups):
            return self.tensors
        layout, size = [], 0
        for g, arrays in groups.items():
            for k, v in arrays.items():
                layout.append((g, k, v.dtype, v.shape, size))
                size += -(-v.nbytes // self.ALIGN) * self.ALIGN
        layout = tuple(layout)
        if layout != self.layout:
            self.buffer = torch.empty(max(size, 1), dtype=torch.uint8,
                                      device=self.device)
            self.tensors = {g: {} for g in groups}
            for g, k, dtype, shape, off in layout:
                n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                self.tensors[g][k] = self.buffer[off:off + n].view(
                    torch.from_numpy(np.empty(0, dtype)).dtype).view(shape)
            self.layout = layout
        with step("upload"):
            pinned = self.device.type == "cuda"
            stage = torch.empty(self.buffer.shape[0], dtype=torch.uint8,
                                pin_memory=pinned)
            packed = stage.numpy()
            for g, k, _, _, off in layout:
                v = groups[g][k].reshape(-1).view(np.uint8)
                packed[off:off + v.shape[0]] = v
            self.buffer.copy_(stage, non_blocking=pinned)
        self.host = groups
        return self.tensors


def _same_arrays(a: dict, b: dict) -> bool:
    """Whether two {group: {key: array}} hold the same keys, dtypes, shapes
    and values."""
    return a.keys() == b.keys() and all(
        a[g].keys() == b[g].keys() and all(
            a[g][k].dtype == b[g][k].dtype and np.array_equal(a[g][k],
                                                              b[g][k])
            for k in a[g]) for g in a)
