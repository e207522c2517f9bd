"""BVH8 traversal: closest hit (K1), any hit (K2), their two-pop variants
(K7b), the closest hit with the uv payload (K7c), step counts and push
orders (K7a) and the fused multi-set any hit (K5, two-pop K5p).

``trace_closest_bvh8``, ``trace_any_bvh8`` and ``trace_any_bvh8_multi``
replace tpurt's entry points of the same names
(``tpurt/kernels/traverse_bvh8.py``). On CUDA tensors they launch
``csrc/bvh8_closest.cu`` (K1, K7c) / ``csrc/bvh8_any.cu`` (K2) /
``csrc/bvh8_variants.cu`` (K7a, K7b) / ``csrc/bvh8_multi.cu`` (K5, K5p); on
CPU tensors they run the plain PyTorch versions below, which visit stack
entries in the kernels' order and give bit-identical results. There is no
fallback between the two.

Every kernel reads the scene's compact node table ``nodes8c``
(``bvh/wide.compact_bvh8``; 224 bytes per node, child codes precomputed):
K1, the closest hit at tpurt's default push order "sort", and K7c, the
same kernel with the uv payload, K2, the any hit at its default "none",
K7a and K7b, their counted, reordered and two-pop variants, and K5/K5p,
the fused multi-set any hit. Only the refit reads the ``nodes8`` rows.
Their stacks (local memory) have ``STACK_SIZES[pops]`` entries, the least
that ``stack_entries(depth8, pops)`` fits: a closest hit's entries are a
code and an entry distance, an any hit's a code, K5's a code and a set
mask. Given the frame's shape, every kernel runs 16x8 pixel tiles per
block (``tile_rays``).

Contract (tpurt's): ``t = t_max``, ``tri = -1``, ``u = v = 0`` on a miss;
``tri`` is the global triangle id; a ray with ``t_max <= t_min`` is never
occluded. The payload planes are 0, 0, 0, 1, 1 on a miss.

Traversal order, shared by kernels and plain versions: the root is pushed
first; popping a node tests its 8 child boxes with the slab test (``tfar``
= the current hit distance, or ``t_max`` for any-hit) and pushes the hit
children far-to-near — sorted by (entry distance, slot) with the nearest on
top. Popping a leaf runs Moller-Trumbore on its triangles in order (strict
``t < tfar``, so the first of equal distances wins). A closest-hit entry
whose entry distance exceeds the current hit is dropped when popped.

Two pops (``pop2``, K7b/K5p): each iteration pops the top entry and the one
below it; leaf work for both, top first; then both nodes' children, tested
against the hit distance after the leaf work, the lower entry's pushed
first. Closest hits equal the one-pop trace up to equal-t ties, occlusion
exactly.

Multi-set any hit (K5/K5p): S ray sets with shared origins traverse one
stack whose entries carry the mask of the sets whose own slab tests reached
them, so each set's occlusion equals K2's bit for bit; pushes are in slot
order, slot 7 on top (K2's "none"). At most ``MULTI_SETS_MAX`` sets go into
one launch; the wrapper splits larger S.

Step counts and push orders (K7a, one pop): ``count_steps=True`` returns
each ray's node pops and leaf pops, the popped entries whose node row is
read or whose triangles are tested (an entry dropped by the entry-distance
test counts nothing); tpurt counts per 32x32 packet, the port per ray
(``csrc/bvh8_variants.cu``). ``push_order`` is ``"sort"`` (the order above),
``"nearlast"`` (slot order, the first nearest hit child pushed last, so it
pops first) or ``"none"`` (slot order, slot 7 on top). The closest hit's
``t`` and the occlusion do not depend on the order; ``tri`` may change on
equal-t ties. ``push_order=None`` is tpurt's default: ``"sort"`` for the
closest hit, ``"none"`` for the any hit (``"sort"``, the two-pop kernel's
fixed order, when ``pop2`` resolves on). The uncounted one-pop any hit at
"none" is K2; every other order or a counted any hit is K7a. Where the
counts equal tpurt's: a packet whose lanes all hold one ray counts that
ray's pops, and tpurt pops every pushed entry, reading the ones the port
drops; its "sort" and "nearlast" keys are the child boxes' centroids along
the packet's mean direction, not the entry distance (ROADMAP §3). So under
"none" tpurt's counts are the port's plus the dropped pops, and a closest
hit that misses, or an any hit that is not occluded, has tpurt's counts
under every order (tests/test_torch_steps.py).

``pop2=None`` and ``uv_payload=None`` resolve at call time to the module
constants ``POP2_DEFAULT`` and ``UVP_DEFAULT`` under tpurt's conditions
(``tpurt/kernels/traverse_bvh8.py:1209-1214, 1696-1711, 1757-1760``), so
flipping a constant here reaches ``Renderer.render()``; neither resolves
on for a counted trace or a push order other than ``"sort"``.
"""
from __future__ import annotations

import ctypes

import torch

from ..bvh.wide import EMPTY_CODE, LEAF8_MAX, LEAF_CODE_BASE
from . import build

# the two-pop kernels (K7b, K5p) when a caller passes pop2=None
POP2_DEFAULT = False
# the closest-hit uv payload (K7c) when a caller passes uv_payload=None and
# the scene carries "uvp"
UVP_DEFAULT = False

# ray sets per fused any-hit launch (MULTI_SETS_MAX in csrc/bvh8_multi.cu)
MULTI_SETS_MAX = 4
# the largest per-thread stack of the CUDA kernels; the wrappers refuse
# trees that could need more
STACK_SIZE = 192
# the stack instantiations of the kernels (K1, K7c, K2, K7a: one pop; K7b:
# two; K5 / K5p: one / two), by pops per iteration: the wrappers take the
# least that holds stack_entries(depth8, pops)
STACK_SIZES = {1: (48, STACK_SIZE), 2: (64, STACK_SIZE)}
# pixels of a kernel's block (a 16x8 tile) and of a warp (8x4)
# when the rays are a frame's pixels (csrc/bvh8_common.cuh tile_ray_index)
TILE = (16, 8)
WARP_TILE = (8, 4)
PAYLOAD_KEYS = ("texu", "texv", "img", "texh", "texw")
# K7a's push orders, by their code in csrc/bvh8_variants.cu
PUSH_ORDERS = ("sort", "nearlast", "none")


def call_time_switches() -> tuple:
    """Every module switch above that a trace reads when it is called. A
    frame recorded under other values is another frame: the renderer keys
    its CUDA graph by them (``engine/frame_graph.py``), so a switch added
    here reaches that key."""
    return POP2_DEFAULT, UVP_DEFAULT


def stack_entries(depth8: int, pops: int = 1) -> int:
    """Stack entries a BVH8 of `depth8` wide levels (root = 1) can need.

    One pop: a node pop pushes at most 8 entries (net +7), so 7 * D + 1.
    Two pops: the stack holds one level per depth; a level is filled by one
    iteration (up to 16 entries, two popped nodes' children) and loses two
    at its first pop, so it holds at most 14 while deeper levels exist, and
    the root's level at most 6: 6 + 14 * (D - 2) + 16 = 14 * D - 6 (8 for
    a lone root)."""
    if pops == 1:
        return 7 * depth8 + 1
    return max(8, 14 * depth8 - 6)


def _check_stack(name, scene, pops):
    need = stack_entries(scene["depth8"], pops)
    if need > STACK_SIZE:
        raise ValueError(f"{name}: BVH8 depth {scene['depth8']} needs {need} "
                         f"stack entries with {pops} pop(s) per iteration; "
                         f"the kernels hold {STACK_SIZE}")


def _t_max_tensor(t_max, n, like):
    if isinstance(t_max, torch.Tensor):
        return t_max.to(torch.float32).expand(n).contiguous()
    return torch.full((n,), float(t_max), dtype=torch.float32,
                      device=like.device)


def _check_compact(name, scene):
    """K1's and K2's table: (M, 56) f32, one row per nodes8 row."""
    nc = scene.get("nodes8c")
    if nc is None:
        raise ValueError(f"{name}: needs scene['nodes8c'] "
                         f"(bvh/wide.compact_bvh8; convert.scene_tensors "
                         f"builds it)")
    if nc.dtype != torch.float32 or nc.ndim != 2 or nc.shape[1] != 56 \
            or nc.shape[0] != scene["nodes8"].shape[0]:
        raise ValueError(f"{name}: nodes8c must be (M, 56) float32 beside "
                         f"(M, 128) nodes8")


def _check_tables(name, scene):
    nodes, tris = scene["nodes8"], scene["tris"]
    if nodes.dtype != torch.float32 or nodes.ndim != 2 \
            or nodes.shape[1] != 128:
        raise ValueError(f"{name}: nodes8 must be (M, 128) float32")
    if tris.dtype != torch.float32 or tris.ndim != 2 or tris.shape[1] != 12:
        raise ValueError(f"{name}: tris must be (T, 12) float32")


def _check_device(name, tensors, device):
    if device.type == "cuda":
        build.require_cuda(name, tensors, device)
        return
    for key, t in tensors.items():
        if t.device.type != "cpu":
            raise ValueError(f"{name}: {key} is on {t.device}; the plain "
                             f"version runs on CPU tensors only")


def _check_inputs(name, scene, origin, direction, t_max, uvp=False):
    if origin.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError(f"{name}: rays must be float32")
    if origin.shape != direction.shape or origin.ndim != 2 \
            or origin.shape[1] != 3:
        raise ValueError(f"{name}: rays must be (N, 3), got "
                         f"{tuple(origin.shape)} / {tuple(direction.shape)}")
    _check_tables(name, scene)
    tensors = dict(nodes8=scene["nodes8"], tris=scene["tris"], origin=origin,
                   direction=direction, t_max=t_max)
    if uvp:
        if scene["uvp"].shape != (scene["tris"].shape[0], 9) \
                or scene["uvp"].dtype != torch.float32:
            raise ValueError(f"{name}: uvp must be (T, 9) float32")
        tensors["uvp"] = scene["uvp"]
    _check_device(name, tensors, origin.device)


def _resolve_pop2(pop2):
    return POP2_DEFAULT if pop2 is None else bool(pop2)


def _resolve_k7a(name, pop2, count_steps, push_order, any_hit=False):
    """(pop2, push order) of a trace call, with tpurt's defaults and
    refusals: counting and push orders other than "sort" are one-pop only;
    push_order=None is "none" for a one-pop any hit (tpurt's
    traverse_bvh8.py:1744), else "sort"."""
    if push_order is not None and push_order not in PUSH_ORDERS:
        raise ValueError(f"{name}: unknown push_order {push_order!r}, not "
                         f"one of {PUSH_ORDERS}")
    if pop2 is None:
        pop2 = POP2_DEFAULT and not count_steps \
            and push_order in (None, "sort")
    pop2 = bool(pop2)
    order = push_order
    if order is None:
        order = "none" if any_hit and not pop2 else "sort"
    if pop2 and count_steps:
        raise ValueError(f"{name}: count_steps composes only with the "
                         f"one-pop trace (pop2=False)")
    if pop2 and order != "sort":
        raise ValueError(f"{name}: the two-pop trace has a fixed push "
                         f"order; push_order={order!r} needs pop2=False")
    return pop2, order


def trace_closest_bvh8(scene: dict, origin, direction, t_min: float, t_max,
                       pop2=None, uv_payload=None, count_steps=False,
                       push_order=None, *, height: int = 0, width: int = 0):
    """Closest hit for (N, 3) rays. Returns dict(t, tri, u, v), each (N,),
    plus texu, texv, img, texh, texw (N,) f32 with the uv payload.

    pop2 (default POP2_DEFAULT) takes the two-pop kernel K7b; uv_payload
    (default: UVP_DEFAULT when the scene carries "uvp" and the trace is
    one-pop) takes K7c. The two do not compose (tpurt's rule).
    count_steps=True returns each ray's node pops in u and leaf pops in v
    (f32; t and tri unchanged); it and push_order "nearlast" / "none" take
    K7a (module docstring). Otherwise the trace is K1's. All read the
    scene's nodes8c. height and width (0 when the rays are not a frame's
    pixels) say that the rays are an H x W frame in row order: the kernels
    then run 16x8 pixel tiles per block. The result does not change."""
    name = "trace_closest_bvh8"
    pop2, order = _resolve_k7a(name, pop2, count_steps, push_order)
    k7a = count_steps or order != "sort"
    if uv_payload is None:
        uv_payload = UVP_DEFAULT and "uvp" in scene and not pop2 \
            and not k7a
    if uv_payload and pop2:
        raise ValueError(f"{name}: uv_payload composes only with the "
                         f"one-pop closest-hit trace (pop2=False)")
    if uv_payload and k7a:
        raise ValueError(f"{name}: uv_payload composes with neither "
                         f"count_steps nor push_order={order!r}")
    if uv_payload and "uvp" not in scene:
        raise ValueError(f"{name}: uv_payload needs scene['uvp'] "
                         f"(flatten_scene builds it)")
    n = origin.shape[0]
    _check_frame(name, n, height, width)
    tmx = _t_max_tensor(t_max, n, origin)
    _check_inputs(name, scene, origin, direction, tmx, uvp=uv_payload)
    pops = 2 if pop2 else 1
    _check_stack(name, scene, pops)
    if not origin.is_cuda:
        return _trace_plain(scene, origin, direction, float(t_min), tmx,
                            any_hit=False, pops=pops, uv_payload=uv_payload,
                            count_steps=count_steps, order=order,
                            compact=True)
    if not pop2 and not k7a:
        return closest_kernel(scene, origin, direction, t_min, tmx,
                              tile_w=width, uv_payload=uv_payload)
    return closest_variant_kernel(scene, origin, direction, t_min, tmx,
                                  pop2, count_steps, order, tile_w=width)


def trace_any_bvh8(scene: dict, origin, direction, t_min: float, t_max,
                   pop2=None, count_steps=False, push_order=None, *,
                   height: int = 0, width: int = 0):
    """Any hit (occlusion) for (N, 3) rays. Returns a (N,) bool mask, or
    with count_steps=True (mask, node pops, leaf pops), the counts (N,) f32.
    pop2 (default POP2_DEFAULT) takes the two-pop kernel K7b; push_order
    (default "none", tpurt's) "none" without counting takes K2,
    count_steps or "sort" / "nearlast" take K7a; all read the scene's
    nodes8c. height and width (tpurt's frame shape; 0 when the rays are
    not a frame's pixels) say that the rays are an H x W frame in row
    order: the kernels then run 16x8 pixel tiles per block. The result does
    not change."""
    name = "trace_any_bvh8"
    pop2, order = _resolve_k7a(name, pop2, count_steps, push_order,
                               any_hit=True)
    n = origin.shape[0]
    _check_frame(name, n, height, width)
    tmx = _t_max_tensor(t_max, n, origin)
    _check_inputs(name, scene, origin, direction, tmx)
    pops = 2 if pop2 else 1
    _check_stack(name, scene, pops)
    if not origin.is_cuda:
        return _trace_plain(scene, origin, direction, float(t_min), tmx,
                            any_hit=True, pops=pops, count_steps=count_steps,
                            order=order, compact=True)
    if not pop2 and not count_steps and order == "none":
        return any_kernel(scene, origin, direction, t_min, tmx,
                          tile_w=width)
    return any_variant_kernel(scene, origin, direction, t_min, tmx, pop2,
                              count_steps, order, tile_w=width)


def _check_frame(name, n, height, width):
    if width and height * width != n:
        raise ValueError(f"{name}: {n} rays are not a {height} x {width} "
                         f"frame")


def compact_stack_size(depth8: int, pops: int = 1) -> int:
    """The stack instantiation of K1, K2 and K7a (pops 1) or K7b (pops 2)
    for a BVH8 of `depth8` wide levels."""
    return build.pick_stack(stack_entries(depth8, pops), STACK_SIZES[pops],
                            f"BVH8 depth {depth8}",
                            "K7b" if pops == 2 else "K1/K2/K7a")


def multi_stack_size(depth8: int, pops: int) -> int:
    """K5's (pops 1) or K5p's (pops 2) stack instantiation for a BVH8 of
    `depth8` wide levels."""
    return build.pick_stack(stack_entries(depth8, pops), STACK_SIZES[pops],
                            f"BVH8 depth {depth8}",
                            "K5p" if pops == 2 else "K5")


def tile_rays(width: int, height: int):
    """The ray of each thread of a K1/K2/K5/K7a/K7b launch over an H x W
    frame in pixel tiles, as csrc/bvh8_common.cuh's tile_ray_index maps it:
    (blocks, 128) int64, -1 where a thread has no pixel. Block b covers the
    16x8 tile b (row-major over the tiles), warp k of it the 8x4 pixels at
    ((k % 2) * 8, (k // 2) * 4) in the tile, lane l the pixel (l % 8,
    l // 8) in the warp's."""
    tiles_x = (width + TILE[0] - 1) // TILE[0]
    blocks = tiles_x * ((height + TILE[1] - 1) // TILE[1])
    b = torch.arange(blocks)[:, None]
    thread = torch.arange(TILE[0] * TILE[1])[None, :]
    lane, warp = thread % 32, thread // 32
    x = (b % tiles_x) * TILE[0] + (warp % 2) * WARP_TILE[0] \
        + lane % WARP_TILE[0]
    y = (b // tiles_x) * TILE[1] + (warp // 2) * WARP_TILE[1] \
        + lane // WARP_TILE[0]
    ray = y * width + x
    return torch.where((x < width) & (ray < width * height), ray,
                       torch.full_like(ray, -1))


def _compact_launch_inputs(name, scene, origin, t_max, tile_w):
    n = origin.shape[0]
    if tile_w < 0 or (tile_w and n % tile_w):
        raise ValueError(f"{name}: {n} rays are not rows of {tile_w}")
    _check_compact(name, scene)
    build.require_cuda(name, dict(nodes8c=scene["nodes8c"], t_max=t_max),
                       origin.device)
    return n


def closest_kernel(scene: dict, origin, direction, t_min: float, t_max,
                   tile_w: int = 0, uv_payload: bool = False):
    """K1 on CUDA tensors (trace_closest_bvh8's default path): dict(t,
    tri, u, v) over scene["nodes8c"], t_max an (N,) f32 tensor; tile_w > 0
    (the frame's width, N a multiple of it) runs 16x8 pixel tiles per
    block, as trace_closest_bvh8 does when given the frame's shape. With
    uv_payload it is K7c, the same kernel's payload instantiation, which
    also reads scene["uvp"] and returns texu, texv, img, texh, texw."""
    name = "trace_closest_bvh8"
    n = _compact_launch_inputs(name, scene, origin, t_max, tile_w)
    dev = origin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    out = dict(t=t, tri=tri, u=u, v=v)
    if uv_payload:
        build.require_cuda(name, dict(uvp=scene["uvp"]), dev)
        pay = torch.empty((5, n), dtype=torch.float32, device=dev)
        out.update(zip(PAYLOAD_KEYS, pay.unbind(0)))
    fn = build.function("tpurt_bvh8_closest_compact", [ctypes.c_void_p] * 5
                        + [ctypes.c_float, ctypes.c_void_p]
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
    p = build.ptr
    build.check(fn(p(scene["nodes8c"]), p(scene["tris"]),
                   p(scene["uvp"]) if uv_payload else None, p(origin),
                   p(direction),
                   float(t_min), p(t_max), n,
                   compact_stack_size(scene["depth8"]), tile_w, p(t), p(tri),
                   p(u), p(v), p(pay) if uv_payload else None,
                   build.stream_of(origin)), name)
    build.launch_counts["bvh8_closest_uvp" if uv_payload
                        else "bvh8_closest"] += 1
    return out


def any_kernel(scene: dict, origin, direction, t_min: float, t_max,
               tile_w: int = 0):
    """K2 on CUDA tensors (trace_any_bvh8's default path): the (N,) bool
    occlusion over scene["nodes8c"], t_max an (N,) f32 tensor; tile_w > 0
    (the frame's width, N a multiple of it) runs 16x8 pixel tiles per
    block, as trace_any_bvh8 does when given the frame's shape."""
    name = "trace_any_bvh8"
    n = _compact_launch_inputs(name, scene, origin, t_max, tile_w)
    occ = torch.empty(n, dtype=torch.uint8, device=origin.device)
    fn = build.function("tpurt_bvh8_any", [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2)
    p = build.ptr
    build.check(fn(p(scene["nodes8c"]), p(scene["tris"]), p(origin),
                   p(direction), float(t_min), p(t_max), n,
                   compact_stack_size(scene["depth8"]), tile_w, p(occ),
                   build.stream_of(origin)), name)
    build.launch_counts["bvh8_any"] += 1
    return occ.bool()


def closest_variant_kernel(scene: dict, origin, direction, t_min: float,
                           t_max, pop2: bool, count_steps: bool, order: str,
                           tile_w: int = 0):
    """K7a (one pop, counted or at push order "nearlast" / "none") or K7b
    (pop2: two pops, uncounted, "sort") closest hit on CUDA tensors over
    scene["nodes8c"], t_max an (N,) f32 tensor: dict(t, tri, u, v), with
    count_steps the node and leaf pops in u and v. tile_w > 0 (the frame's
    width, N a multiple of it) runs 16x8 pixel tiles per block, as
    trace_closest_bvh8 does when given the frame's shape. The C entry
    refuses any other trace (K1's among them), and build.check raises."""
    name = "trace_closest_bvh8"
    n = _compact_launch_inputs(name, scene, origin, t_max, tile_w)
    dev = origin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    fn = build.function("tpurt_bvh8_closest_variant", [ctypes.c_void_p] * 4
                        + [ctypes.c_float, ctypes.c_void_p]
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)
    p = build.ptr
    pops = 2 if pop2 else 1
    build.check(fn(p(scene["nodes8c"]), p(scene["tris"]), p(origin),
                   p(direction), float(t_min), p(t_max), n, int(pop2),
                   int(count_steps), PUSH_ORDERS.index(order),
                   compact_stack_size(scene["depth8"], pops), tile_w, p(t),
                   p(tri), p(u), p(v), build.stream_of(origin)), name)
    build.launch_counts["bvh8_closest_pop2" if pop2
                        else "bvh8_closest_steps"] += 1
    return dict(t=t, tri=tri, u=u, v=v)


def any_variant_kernel(scene: dict, origin, direction, t_min: float, t_max,
                       pop2: bool, count_steps: bool, order: str,
                       tile_w: int = 0):
    """K7a (one pop, counted or at push order "sort" / "nearlast") or K7b
    (pop2: two pops, uncounted, "sort") any hit on CUDA tensors over
    scene["nodes8c"], t_max an (N,) f32 tensor: what trace_any_bvh8
    returns. tile_w and the refusals as closest_variant_kernel's (an
    uncounted one-pop "none" trace is K2's)."""
    name = "trace_any_bvh8"
    n = _compact_launch_inputs(name, scene, origin, t_max, tile_w)
    dev = origin.device
    occ = torch.empty(n, dtype=torch.uint8, device=dev)
    fn = build.function("tpurt_bvh8_any_variant", [ctypes.c_void_p] * 4
                        + [ctypes.c_float, ctypes.c_void_p]
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
    counts = [torch.empty(n, dtype=torch.float32, device=dev)
              for _ in range(2)] if count_steps else [None, None]
    p = build.ptr
    pops = 2 if pop2 else 1
    build.check(fn(p(scene["nodes8c"]), p(scene["tris"]), p(origin),
                   p(direction), float(t_min), p(t_max), n, int(pop2),
                   int(count_steps), PUSH_ORDERS.index(order),
                   compact_stack_size(scene["depth8"], pops), tile_w,
                   p(occ), *(p(x) if count_steps else None for x in counts),
                   build.stream_of(origin)), name)
    build.launch_counts["bvh8_any_pop2" if pop2 else "bvh8_any_steps"] += 1
    return (occ.bool(), *counts) if count_steps else occ.bool()


def _multi_inputs(origin, dirs, t_maxs):
    """(S, N, 3) directions and (S, N) f32 t_max from a list of S (N, 3)
    arrays or a stack, and a list of S t_max values (tensors or floats) or
    an (S, N) stack."""
    n = origin.shape[0]
    d = dirs if isinstance(dirs, torch.Tensor) else torch.stack(list(dirs))
    if isinstance(t_maxs, torch.Tensor) and t_maxs.ndim == 2:
        tm = t_maxs.to(torch.float32)
    else:
        tm = torch.stack([_t_max_tensor(x, n, origin) for x in t_maxs])
    if d.ndim != 3 or d.shape[1:] != (n, 3) or tm.shape != (d.shape[0], n):
        raise ValueError(f"trace_any_bvh8_multi: dirs must be (S, {n}, 3) "
                         f"and t_maxs (S, {n}), got {tuple(d.shape)} / "
                         f"{tuple(tm.shape)}")
    if d.dtype != torch.float32 or origin.dtype != torch.float32:
        raise TypeError("trace_any_bvh8_multi: rays must be float32")
    return d.contiguous(), tm.contiguous()


def trace_any_bvh8_multi(scene: dict, origin, dirs, t_min: float, t_maxs,
                         pop2=None, *, height: int = 0, width: int = 0):
    """Occlusion of S ray sets sharing the (N, 3) origins: dirs a list of S
    (N, 3) directions or an (S, N, 3) stack, t_maxs S (N,) values or an
    (S, N) stack. Returns (S, N) bool, bit-equal to S trace_any_bvh8 calls.
    pop2 (default POP2_DEFAULT) takes the two-pop kernel K5p. More than
    MULTI_SETS_MAX sets run as several launches of at most that many. Both
    kernels read the scene's nodes8c. height and width (0 when the rays are
    not a frame's pixels) say that the rays are an H x W frame in row
    order: the kernels then run 16x8 pixel tiles per block. The result does
    not change."""
    name = "trace_any_bvh8_multi"
    pop2 = _resolve_pop2(pop2)
    if origin.ndim != 2 or origin.shape[1] != 3:
        raise ValueError(f"{name}: origin must be (N, 3)")
    d, tm = _multi_inputs(origin, dirs, t_maxs)
    s, n = tm.shape
    _check_frame(name, n, height, width)
    _check_tables(name, scene)
    _check_compact(name, scene)
    _check_device(name, dict(nodes8c=scene["nodes8c"], tris=scene["tris"],
                             origin=origin, dirs=d, t_maxs=tm),
                  origin.device)
    pops = 2 if pop2 else 1
    _check_stack(name, scene, pops)
    chunks = [(a, min(a + MULTI_SETS_MAX, s))
              for a in range(0, s, MULTI_SETS_MAX)]
    if not origin.is_cuda:
        return torch.cat([trace_any_multi_plain(scene, origin, d[a:b],
                                                t_min, tm[a:b], pop2=pop2)
                          for a, b in chunks])
    fn = build.function("tpurt_bvh8_any_multi", [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 2)
    occ = torch.empty((s, n), dtype=torch.uint8, device=origin.device)
    stack = multi_stack_size(scene["depth8"], pops)
    p = build.ptr
    kind = "bvh8_any_multi_pop2" if pop2 else "bvh8_any_multi"
    for a, b in chunks:
        build.check(fn(p(scene["nodes8c"]), p(scene["tris"]), p(origin),
                       p(d[a:b]), float(t_min), p(tm[a:b]), n, b - a,
                       int(pop2), stack, width, p(occ[a:b]),
                       build.stream_of(origin)), name)
        build.launch_counts[kind] += 1
    return occ.bool()


def _slab(boxes, o, inv, t_min, tfar):
    """Slab tests of 8 child boxes per ray, `boxes` the six (A, 8) planes
    min x, y, z, max x, y, z: (A, 8) entry distance and hit mask (tpurt
    _Rays.slab order, NaN-propagating min/max)."""
    mn = torch.minimum
    mx = torch.maximum
    t0 = [(boxes[a] - o[:, a:a + 1]) * inv[:, a:a + 1] for a in range(3)]
    t1 = [(boxes[a + 3] - o[:, a:a + 1]) * inv[:, a:a + 1]
          for a in range(3)]
    tnear = mx(mx(mn(t0[0], t1[0]), mn(t0[1], t1[1])),
               mx(mn(t0[2], t1[2]), t_min))
    tfar_ = mn(mn(mx(t0[0], t1[0]), mx(t0[1], t1[1])),
               mn(mx(t0[2], t1[2]), tfar[:, None]))
    return tnear, tnear <= tfar_


def _moller_trumbore(rows, o, d, t_min, tfar):
    """(A, K) hit, t, u, v of rows (A, K, 12) against (A, 3) rays
    (tpurt _Rays.mt order)."""
    v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    valid = det.abs() > 1e-12
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < tfar[:, None]))
    return hit, t, u, v


def trace_closest_plain(scene, origin, direction, t_min, t_max,
                        stats=None, pop2=False, uv_payload=False,
                        count_steps=False, push_order="sort"):
    """Plain PyTorch version of K1 (K7b with pop2, K7c with uv_payload, K7a
    with count_steps or another push_order) on any device. `stats`, a dict,
    gets the traversal work (see count_work), the entries dropped unread
    (see count_dropped) and the deepest stack (max_stack). It reads the
    compact table nodes8c as the kernels do."""
    n = origin.shape[0]
    return _trace_plain(scene, origin, direction, float(t_min),
                        _t_max_tensor(t_max, n, origin), any_hit=False,
                        pops=2 if pop2 else 1, uv_payload=uv_payload,
                        stats=stats, count_steps=count_steps,
                        order=push_order, compact=True)


def trace_any_plain(scene, origin, direction, t_min, t_max, stats=None,
                    pop2=False, count_steps=False, push_order=None):
    """Plain PyTorch version of K2 (K7b with pop2, K7a with count_steps or
    another push_order) on any device (`stats` as above). push_order=None
    is trace_any_bvh8's default ("none"; "sort" with pop2). It reads the
    compact table nodes8c as the kernels do."""
    n = origin.shape[0]
    order = push_order if push_order is not None else \
        "sort" if pop2 else "none"
    return _trace_plain(scene, origin, direction, float(t_min),
                        _t_max_tensor(t_max, n, origin), any_hit=True,
                        pops=2 if pop2 else 1, stats=stats,
                        count_steps=count_steps, order=order, compact=True)


def count_work(stats, node_pops, leaf_pops, tri_tests, node_tests=None):
    """Add one iteration's work to `stats` (device tensors; read them with
    int() after the traversal): node_pops and leaf_pops count popped
    entries that are visited, tri_tests the Moller-Trumbore tests the
    kernel runs (an any-hit leaf stops at its first hit), node_tests the
    8-child slab groups (one per node pop and ray set)."""
    if stats is None:
        return
    node_tests = node_pops if node_tests is None else node_tests
    for key, val in (("node_pops", node_pops), ("leaf_pops", leaf_pops),
                     ("tri_tests", tri_tests), ("node_tests", node_tests)):
        stats[key] = stats.get(key, 0) + val


def count_dropped(stats, codes):
    """Add the popped closest-hit entries (`codes`) that the entry-distance
    test drops unread to `stats`' dropped_node_pops / dropped_leaf_pops
    (tpurt's packet kernel reads and counts such entries)."""
    if stats is None:
        return
    for key, sel in (("dropped_node_pops", codes >= 0),
                     ("dropped_leaf_pops", codes < 0)):
        stats[key] = stats.get(key, 0) + sel.sum()


def _note_stack(stats, sp):
    if stats is not None and sp.numel():
        stats["max_stack"] = max(stats.get("max_stack", 0), int(sp.max()))


def leaf_tests(hit, count, any_hit: bool):
    """Moller-Trumbore tests of leaf pops with per-slot hits `hit` (A, K)
    and `count` triangles each: all of them, or up to the first hit."""
    if not any_hit:
        return count.sum()
    return _per_row_tests(hit, count).sum()


def _leaf_rows(tris, code):
    """Triangle rows (A, LEAF8_MAX, 12) of leaf codes, their first row and
    count, and the in-range mask of each slot."""
    dec = -(code.long() + 1)
    first = dec // LEAF_CODE_BASE
    count = dec - first * LEAF_CODE_BASE
    k = torch.arange(LEAF8_MAX, device=code.device)
    idx = torch.clamp(first[:, None] + k[None, :], max=tris.shape[0] - 1)
    return tris[idx], first, count, k[None, :] < count[:, None]


def _node_children(nodes, code, compact=False):
    """The child boxes of nodes `code` (six (A, 8) planes, as _slab takes
    them), each slot's validity and stack code: from the (M, 128) rows, or
    with `compact` from the (M, 56) table nodes8c (codes precomputed,
    EMPTY_CODE in empty slots)."""
    rows = nodes[code.long()]
    if compact:
        child_code = rows[:, 48:56].view(torch.int32)
        return ([rows[:, 8 * a:8 * a + 8] for a in range(6)],
                child_code != EMPTY_CODE, child_code)
    valid = (rows[:, 48:56] >= 0.0) | (rows[:, 64:72] > 0.0)
    child_code = torch.where(
        rows[:, 48:56] >= 0.0, rows[:, 48:56].to(torch.int32),
        -(rows[:, 56:64].to(torch.int32) * LEAF_CODE_BASE
          + rows[:, 64:72].to(torch.int32)) - 1)
    return [rows[:, a:48:6] for a in range(6)], valid, child_code


def _order_keys(order, tnear, hit):
    """(A, 8) push keys of a push order: the hit children sorted by them
    (stable) end on the stack with the first on top. "sort": the entry
    distance; "none": slot 7 first; "nearlast": the first nearest hit child,
    then slot 7 down."""
    slot = torch.arange(8, device=tnear.device, dtype=tnear.dtype)
    if order == "sort":
        return tnear
    keys = (-slot).expand_as(tnear)
    if order == "none":
        return keys
    inf = torch.full_like(tnear, float("inf"))
    best = torch.argmin(torch.where(hit, tnear, inf), dim=1, keepdim=True)
    return torch.where(slot.long()[None, :] == best,
                       torch.full_like(tnear, -8.0), keys)


def _push(stacks, sp, rows_of, hit, keys, values, sink):
    """Push each ray's hit children sorted by `keys` (stable, slot order on
    equal keys), the first on top. stacks/values: matching lists of (N, S+1)
    tables and (A, 8) entries."""
    keys = torch.where(hit, keys, torch.full_like(keys, float("inf")))
    _, perm = torch.sort(keys, dim=1, stable=True)
    nh = hit.sum(1)
    base = sp[rows_of]
    slot = torch.arange(8, device=hit.device)
    pos = base[:, None] + nh[:, None] - 1 - slot[None, :]
    pos = torch.where(slot[None, :] < nh[:, None], pos,
                      torch.full_like(pos, sink))
    rows_i = rows_of[:, None].expand(-1, 8)
    for table, val in zip(stacks, values):
        table[rows_i, pos] = torch.gather(val, 1, perm)
    sp[rows_of] = base + nh


def _pop(sp, a, pops, *tables):
    """Pop the top entry of rays `a` and, with two pops, the one below it:
    ((has1, entries of the top, entries below), ...) per table."""
    spa = sp[a]
    top0 = spa - 1
    if pops == 2:
        has1 = spa >= 2
    else:
        has1 = torch.zeros_like(spa, dtype=torch.bool)
    top1 = torch.clamp_min(spa - 2, 0)
    sp[a] = spa - 1 - has1.long()
    return has1, [(tb[a, top0], tb[a, top1]) for tb in tables]


def _trace_plain(scene, origin, direction, t_min, t_max, any_hit: bool,
                 pops: int = 1, uv_payload: bool = False, stats=None,
                 count_steps: bool = False, order: str = "sort",
                 compact: bool = False):
    """The plain PyTorch traversal: every live ray pops `pops` stack entries
    per iteration, over (N, S) stacks of codes and entry distances; with
    count_steps each ray counts its visited node and leaf entries; with
    `compact` it reads the node table nodes8c instead of the rows."""
    if order not in PUSH_ORDERS:
        raise ValueError(f"unknown push_order {order!r}")
    if count_steps and uv_payload:
        raise ValueError("count_steps and uv_payload do not compose")
    if compact:
        _check_compact("the plain trace", scene)
    nodes = scene["nodes8c"] if compact else scene["nodes8"]
    tris = scene["tris"]
    dev = origin.device
    n = origin.shape[0]
    # per-ray node and leaf pops (K7a)
    steps = torch.zeros((2, n), dtype=torch.int32, device=dev)
    s = stack_entries(scene["depth8"], pops)
    inv = 1.0 / direction
    tmin_t = torch.tensor(t_min, dtype=torch.float32, device=dev)

    t = t_max.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    row = torch.zeros(n, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    # column s is a sink for the pushes of invalid slots
    codes = torch.zeros((n, s + 1), dtype=torch.int32, device=dev)
    nears = torch.full((n, s + 1), -float("inf"), dtype=torch.float32,
                       device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    active = torch.arange(n, device=dev)
    if any_hit:
        active = active[t_max > t_min]

    def leaf(la, code):
        rows, first, count, in_range = _leaf_rows(tris, code)
        tfar = t_max[la] if any_hit else t[la]
        hit, tk, uk, vk = _moller_trumbore(rows, origin[la], direction[la],
                                           t_min, tfar)
        hit &= in_range
        count_work(stats, 0, la.numel(), leaf_tests(hit, count, any_hit))
        steps[1, la] += 1
        if any_hit:
            occ[la] |= hit.any(1)
            return
        # sequential strict-less updates == first minimum
        tk = torch.where(hit, tk, torch.full_like(tk, float("inf")))
        j = torch.argmin(tk, dim=1, keepdim=True)
        upd = hit.any(1)
        lu = la[upd]
        t[lu] = torch.gather(tk, 1, j)[upd, 0]
        u[lu] = torch.gather(uk, 1, j)[upd, 0]
        v[lu] = torch.gather(vk, 1, j)[upd, 0]
        tri[lu] = torch.gather(rows[..., 9], 1, j)[upd, 0].to(torch.int32)
        row[lu] = (first[:, None] + j)[upd, 0]

    def node(na, code):
        boxes, valid, child_code = _node_children(nodes, code, compact)
        tfar = t_max[na] if any_hit else t[na]
        tnear, hit = _slab(boxes, origin[na], inv[na], tmin_t, tfar)
        hit &= valid
        _push((nears, codes), sp, na, hit, _order_keys(order, tnear, hit),
              (tnear, child_code), s)
        count_work(stats, na.numel(), 0, 0)
        steps[0, na] += 1

    while active.numel():
        a = active
        has1, ((c0, c1), (n0, n1)) = _pop(sp, a, pops, codes, nears)
        if any_hit:
            live0 = torch.ones_like(has1)
            live1 = has1
        else:
            ta = t[a]
            live0 = n0 <= ta
            live1 = has1 & (n1 <= ta)
            count_dropped(stats, torch.cat([c0[~live0], c1[has1 & ~live1]]))
        # leaf phase, the top entry first; node phase, the lower entry's
        # children pushed first
        for live, code, want_leaf in ((live0, c0, True), (live1, c1, True),
                                      (live1, c1, False), (live0, c0, False)):
            sel = live & ((code < 0) if want_leaf else (code >= 0))
            if any_hit:
                sel &= ~occ[a]
            if bool(sel.any()):
                (leaf if want_leaf else node)(a[sel], code[sel])
        _note_stack(stats, sp[a])
        keep = sp[a] > 0
        if any_hit:
            keep &= ~occ[a]
        active = a[keep]

    node_pops, leaf_pops = steps.to(torch.float32)
    if any_hit:
        return (occ, node_pops, leaf_pops) if count_steps else occ
    if count_steps:
        u, v = node_pops, leaf_pops
    out = dict(t=t, tri=tri, u=u, v=v)
    if uv_payload:
        out.update(_payload(scene["uvp"], tri >= 0, row, u, v))
    return out


def _payload(uvp, hit, row, u, v):
    """The K7c planes from the winners' uvp rows: uv0 * w + uv1 * u +
    uv2 * v with w = 1 - u - v (the shade pass's association); 0, 0, 0, 1, 1
    on a miss."""
    p = uvp[row]
    w = 1.0 - u - v
    vals = (p[:, 0] * w + p[:, 2] * u + p[:, 4] * v,
            p[:, 1] * w + p[:, 3] * u + p[:, 5] * v,
            p[:, 6], p[:, 7], p[:, 8])
    return {k: torch.where(hit, val, torch.full_like(val, miss))
            for k, val, miss in zip(PAYLOAD_KEYS, vals, (0, 0, 0, 1, 1))}


def trace_any_multi_plain(scene, origin, dirs, t_min, t_maxs, stats=None,
                          pop2=False, compact=True):
    """Plain PyTorch version of K5 (K5p with pop2) on any device: dirs
    (S, N, 3), t_maxs (S, N) -> (S, N) bool. Every stack entry carries the
    bit mask of the sets that reached it (see csrc/bvh8_multi.cu); a node's
    hit children are pushed in slot order, slot 7 on top, as the kernels
    push them. It reads nodes8c as the kernels do; compact=False reads the
    nodes8 rows instead (the same visits, the tests' reference). `stats`
    as trace_closest_plain's, node_tests counting one 8-child slab group
    per node pop and set."""
    if compact:
        _check_compact("the plain multi-set trace", scene)
    nodes = scene["nodes8c"] if compact else scene["nodes8"]
    tris = scene["tris"]
    dev = origin.device
    n_sets, n = t_maxs.shape
    pops = 2 if pop2 else 1
    s = stack_entries(scene["depth8"], pops)
    inv = 1.0 / dirs
    tmin_t = torch.tensor(float(t_min), dtype=torch.float32, device=dev)
    bits = 1 << torch.arange(n_sets, device=dev, dtype=torch.int64)

    # sets not yet occluded with t_max > t_min, as a bit mask per ray
    live = ((t_maxs > t_min).long() * bits[:, None]).sum(0)
    occ = torch.zeros(n, dtype=torch.int64, device=dev)
    codes = torch.zeros((n, s + 1), dtype=torch.int32, device=dev)
    masks = torch.zeros((n, s + 1), dtype=torch.int64, device=dev)
    masks[:, 0] = live
    sp = (live != 0).long()
    active = torch.nonzero(live != 0)[:, 0]

    def set_of(m, i):
        return (m >> i) & 1 == 1

    def leaf(la, code, m):
        rows, _, count, in_range = _leaf_rows(tris, code)
        hit_sets = torch.zeros_like(m)
        tests = 0
        for i in range(n_sets):
            hit, _, _, _ = _moller_trumbore(rows, origin[la], dirs[i, la],
                                            t_min, t_maxs[i, la])
            hit &= in_range & set_of(m, i)[:, None]
            tests = tests + torch.where(set_of(m, i),
                                        _per_row_tests(hit, count),
                                        torch.zeros_like(count)).sum()
            hit_sets |= hit.any(1).long() << i
        count_work(stats, 0, la.numel(), tests, 0)
        occ[la] |= hit_sets
        live[la] &= ~hit_sets

    def node(na, code, m):
        boxes, valid, child_code = _node_children(nodes, code, compact)
        child_sets = torch.zeros_like(child_code, dtype=torch.int64)
        for i in range(n_sets):
            tnear, hit = _slab(boxes, origin[na], inv[i, na], tmin_t,
                               t_maxs[i, na])
            hit &= valid & set_of(m, i)[:, None]
            child_sets |= hit.long() << i
        hit = child_sets != 0
        _push((codes, masks), sp, na, hit, _order_keys("none", tnear, hit),
              (child_code, child_sets), s)
        count_work(stats, na.numel(), 0, 0,
                   sum(set_of(m, i).sum() for i in range(n_sets)))

    while active.numel():
        a = active
        has1, ((c0, c1), (m0, m1)) = _pop(sp, a, pops, codes, masks)
        m1 = torch.where(has1, m1, torch.zeros_like(m1))
        # leaf phase, the top entry first; node phase, the lower entry's
        # children pushed first
        for code, m, want_leaf in ((c0, m0, True), (c1, m1, True),
                                   (c1, m1, False), (c0, m0, False)):
            m = m & live[a]
            sel = (m != 0) & ((code < 0) if want_leaf else (code >= 0))
            if bool(sel.any()):
                (leaf if want_leaf else node)(a[sel], code[sel], m[sel])
        _note_stack(stats, sp[a])
        active = a[(sp[a] > 0) & (live[a] != 0)]

    return (occ[None, :] >> torch.arange(n_sets, device=dev)[:, None]) & 1 \
        == 1


def _per_row_tests(hit, count):
    """Per-row any-hit Moller-Trumbore tests: up to the first hit."""
    first = hit.to(torch.int8).argmax(dim=1) + 1
    return torch.where(hit.any(1), first, count)
