"""Binary-BVH closest-hit and any-hit traversal (K6).

``trace_closest_bvh2`` and ``trace_any_bvh2`` replace tpurt's
``trace_closest_packets`` / ``trace_any_packets``
(``tpurt/kernels/traverse_pallas.py``) over the threaded binary BVH, every
table tier of them. On CUDA tensors they launch ``csrc/bvh2_trace.cu`` over
the compact child-pair table ``nodes2c``; on CPU tensors they run the plain
PyTorch version below, which reads the same table, pops stack entries in
the kernel's order and gives bit-identical results. There is no fallback
between the two. Given the frame's shape (``height``, ``width``: the rays
are its pixels in row order) the kernel runs 16x8 pixel tiles per block
(``traverse_bvh8.tile_rays``); the result does not change.

Contract (tpurt's): ``t = t_max``, ``tri = -1``, ``u = v = 0`` on a miss;
``tri`` is the global triangle id; a ray with ``t_max <= t_min`` is never
occluded; a leaf tests its first ``min(count, max_leaf)`` triangles.

Traversal order, shared by kernel and plain version: the root's box is
slab-tested and pushed if hit. Popping an internal node slab-tests both
children (``tfar`` = the current hit distance, or ``t_max`` for any-hit)
and pushes the hit ones far first; the key is the child's slab entry
distance, the left child winning equal keys. A closest-hit entry whose
entry distance exceeds the current hit is dropped when popped. Popping a
leaf runs Moller-Trumbore on its triangles in order (strict ``t < tfar``,
so the first of equal distances wins).

tpurt orders a packet's children by the packet's mean direction, so where
two triangles give the same ``t`` the two packages may report different
ones; the hit distance and any-hit results do not depend on the order.

Scene keys: ``nodes2c`` (R, 16) f32 from ``engine/convert.compact_bvh2``
(what K6 reads), ``nodes2`` (M, 8) f32 from ``convert.pack_bvh2`` (the rows
it is built from, which the plain version's reference traversal reads with
``compact=False``), ``tris`` (T, 12) f32 from ``convert.pack_tris``, and
``depth2``, a bound on the tree's depth (root = 0) known on the host,
which sizes the stack.
"""
from __future__ import annotations

import ctypes

import torch

from ..bvh.wide import LEAF_CODE_BASE
from . import build

# the kernel's stack variants (csrc/bvh2_trace.cu): a popped node at depth
# d leaves at most d deferred siblings, then pushes two children
STACK_SIZES = (64, 192)
# lanes of a nodes2c row, and the widest leaf the kernel tests
COMPACT2_FLOATS = 16
MAX_LEAF = 32


def stack_entries(depth: int) -> int:
    """Stack entries a binary tree of `depth` levels below the root needs."""
    return depth + 1


def kernel_stack(depth: int) -> int:
    """The smallest kernel stack that holds a tree of `depth`; raises for a
    deeper tree (tpurt clamps its stack silently, the port refuses)."""
    return build.pick_stack(stack_entries(depth), STACK_SIZES,
                            f"binary BVH depth {depth}", "the K6 kernel")


def _t_max_tensor(t_max, n, like):
    if isinstance(t_max, torch.Tensor):
        return t_max.to(torch.float32).expand(n).contiguous()
    return torch.full((n,), float(t_max), dtype=torch.float32,
                      device=like.device)


def _check_inputs(name, scene, origin, direction, t_max, max_leaf, height,
                  width):
    from .traverse_bvh8 import _check_frame

    if origin.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError(f"{name}: rays must be float32")
    if origin.shape != direction.shape or origin.ndim != 2 \
            or origin.shape[1] != 3:
        raise ValueError(f"{name}: rays must be (N, 3), got "
                         f"{tuple(origin.shape)} / {tuple(direction.shape)}")
    _check_frame(name, origin.shape[0], height, width)
    nodes, tris = scene["nodes2c"], scene["tris"]
    if nodes.dtype != torch.float32 or nodes.ndim != 2 \
            or nodes.shape[1] != COMPACT2_FLOATS:
        raise ValueError(f"{name}: nodes2c must be (R, {COMPACT2_FLOATS}) "
                         f"float32 (engine/convert.compact_bvh2)")
    if tris.dtype != torch.float32 or tris.ndim != 2 or tris.shape[1] != 12:
        raise ValueError(f"{name}: tris must be (T, 12) float32")
    if not 1 <= max_leaf <= MAX_LEAF:
        raise ValueError(f"{name}: max_leaf {max_leaf} outside "
                         f"1..{MAX_LEAF}")
    kernel_stack(int(scene["depth2"]))
    tensors = dict(nodes2c=nodes, tris=tris, origin=origin,
                   direction=direction, t_max=t_max)
    if origin.is_cuda:
        build.require_cuda(name, tensors, origin.device)
    else:
        for key, t in tensors.items():
            if t.device.type != "cpu":
                raise ValueError(f"{name}: {key} is on {t.device}; the plain "
                                 f"version runs on CPU tensors only")


def _launch(entry, scene, origin, direction, t_min, t_max, max_leaf, width,
            outputs):
    """One K6 launch over nodes2c; `outputs` are the entry's output
    tensors in its order."""
    fn = build.function(entry, [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * (len(outputs) + 1))
    p = build.ptr
    build.check(fn(p(scene["nodes2c"]), p(scene["tris"]), p(origin),
                   p(direction), float(t_min), p(t_max), origin.shape[0],
                   max_leaf, kernel_stack(int(scene["depth2"])), width,
                   *(p(t) for t in outputs), build.stream_of(origin)), entry)


def trace_closest_bvh2(scene: dict, origin, direction, t_min: float, t_max,
                       max_leaf: int = 1, height: int = 0, width: int = 0):
    """Closest hit for (N, 3) rays. Returns dict(t, tri, u, v), each (N,).
    `height`, `width`: the frame's shape when the rays are its pixels in
    row order (N = height * width), for 16x8 pixel tiles; 0 for any rays."""
    name = "trace_closest_bvh2"
    n = origin.shape[0]
    tmx = _t_max_tensor(t_max, n, origin)
    _check_inputs(name, scene, origin, direction, tmx, max_leaf, height,
                  width)
    if not origin.is_cuda:
        return trace_closest_plain(scene, origin, direction, t_min, tmx,
                                   max_leaf)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    tri = torch.empty(n, dtype=torch.int32, device=origin.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    _launch("tpurt_bvh2_closest", scene, origin, direction, t_min, tmx,
            max_leaf, width, (t, tri, u, v))
    build.launch_counts["bvh2_closest"] += 1
    return dict(t=t, tri=tri, u=u, v=v)


def trace_any_bvh2(scene: dict, origin, direction, t_min: float, t_max,
                   max_leaf: int = 1, height: int = 0, width: int = 0):
    """Any hit (occlusion) for (N, 3) rays. Returns a (N,) bool mask.
    `height`, `width` as for trace_closest_bvh2."""
    name = "trace_any_bvh2"
    n = origin.shape[0]
    tmx = _t_max_tensor(t_max, n, origin)
    _check_inputs(name, scene, origin, direction, tmx, max_leaf, height,
                  width)
    if not origin.is_cuda:
        return trace_any_plain(scene, origin, direction, t_min, tmx,
                               max_leaf)
    occ = torch.empty(n, dtype=torch.uint8, device=origin.device)
    _launch("tpurt_bvh2_any", scene, origin, direction, t_min, tmx, max_leaf,
            width, (occ,))
    build.launch_counts["bvh2_any"] += 1
    return occ.bool()


def _slab(rows, o, inv, t_min, tfar):
    """Slab tests of boxes rows (A, K, >=6) for rays (A, 3): (A, K) entry
    distance and hit (tpurt _Rays.slab order, NaN-propagating min/max)."""
    mn = torch.minimum
    mx = torch.maximum
    t0 = [(rows[..., a] - o[:, a:a + 1]) * inv[:, a:a + 1] for a in range(3)]
    t1 = [(rows[..., a + 3] - o[:, a:a + 1]) * inv[:, a:a + 1]
          for a in range(3)]
    tnear = mx(mx(mn(t0[0], t1[0]), mn(t0[1], t1[1])),
               mx(mn(t0[2], t1[2]), t_min))
    tfar_ = mn(mn(mx(t0[0], t1[0]), mx(t0[1], t1[1])),
               mn(mx(t0[2], t1[2]), tfar[:, None]))
    return tnear, tnear <= tfar_


def trace_closest_plain(scene, origin, direction, t_min, t_max,
                        max_leaf: int = 1, stats=None, compact: bool = True):
    """Plain PyTorch version of K6 closest hit on any device, over nodes2c
    as the kernel reads it, or with `compact` False over the nodes2 rows
    (the reference the table is held to). `stats`, a dict, gets the
    traversal work (traverse_bvh8.count_work)."""
    n = origin.shape[0]
    return _trace_plain(scene, origin, direction, float(t_min),
                        _t_max_tensor(t_max, n, origin), max_leaf,
                        any_hit=False, stats=stats, compact=compact)


def trace_any_plain(scene, origin, direction, t_min, t_max,
                    max_leaf: int = 1, stats=None, compact: bool = True):
    """Plain PyTorch version of K6 any hit on any device (`stats`,
    `compact` as above)."""
    n = origin.shape[0]
    return _trace_plain(scene, origin, direction, float(t_min),
                        _t_max_tensor(t_max, n, origin), max_leaf,
                        any_hit=True, stats=stats, compact=compact)


def _row_tables(nodes2):
    """The rows-based traversal's reads: the root's box and code, a node
    pop's two children (boxes (k, 2, 6) and codes: node id, or -(node id)
    - 1 for a leaf; the meta row first, then the child rows) and a leaf
    pop's (first triangle, count) from its meta row."""
    def children(code):
        kid = nodes2[code, 6:8].to(torch.int64)
        rows = nodes2[kid]
        return rows[..., :6], torch.where(rows[..., 7] < 0.0, -kid - 1, kid)

    def leaf(code):
        meta = nodes2[-code - 1]
        return meta[:, 6].to(torch.int64), (-meta[:, 7]).to(torch.int64)

    root_code = -1 if float(nodes2[0, 7]) < 0.0 else 0
    return nodes2[0, :6], root_code, children, leaf


def _compact_tables(nodes2c):
    """The same reads from nodes2c (convert.compact_bvh2): one row per
    node pop, a leaf's range from its code."""
    codes = nodes2c[:, 12:14].contiguous().view(torch.int32)

    def children(code):
        return nodes2c[code, :12].reshape(-1, 2, 6), codes[code].to(
            torch.int64)

    def leaf(code):
        dec = -(code + 1)
        first = dec // LEAF_CODE_BASE
        return first, dec - first * LEAF_CODE_BASE

    return nodes2c[0, :6], int(codes[0, 0]), children, leaf


def _trace_plain(scene, origin, direction, t_min, t_max, max_leaf: int,
                 any_hit: bool, stats=None, compact: bool = True):
    """Every live ray pops one stack entry per iteration, over (N, S)
    stacks of codes and entry distances, in the kernel's order."""
    from .traverse_bvh8 import _moller_trumbore, count_work, leaf_tests

    root_box, root_code, children, leaf = (
        _compact_tables(scene["nodes2c"]) if compact
        else _row_tables(scene["nodes2"]))
    tris = scene["tris"]
    dev = origin.device
    n = origin.shape[0]
    s = stack_entries(int(scene["depth2"]))
    inv = 1.0 / direction
    tmin_t = torch.tensor(t_min, dtype=torch.float32, device=dev)

    t = t_max.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    # column s is a sink for the pushes of children that missed
    codes = torch.zeros((n, s + 1), dtype=torch.int64, device=dev)
    nears = torch.zeros((n, s + 1), dtype=torch.float32, device=dev)
    leaf_k = torch.arange(max_leaf, device=dev)
    rows_all = torch.arange(n, device=dev)

    tn, hit = _slab(root_box.expand(n, 1, 6), origin, inv, tmin_t, t_max)
    codes[:, 0] = root_code
    nears[:, 0] = tn[:, 0]
    sp = hit[:, 0].to(torch.int64)
    peak = sp.clone()
    active = rows_all[sp > 0]

    while active.numel():
        a = active
        top = sp[a] - 1
        sp[a] = top
        code = codes[a, top]
        live = torch.ones_like(code, dtype=torch.bool) if any_hit \
            else nears[a, top] <= t[a]

        # ---- internal pops: slab-test both children, push far first
        sel = live & (code >= 0)
        na = a[sel]
        if na.numel():
            boxes, kc = children(code[sel])
            tfar = t_max[na] if any_hit else t[na]
            key, hit = _slab(boxes, origin[na], inv[na], tmin_t, tfar)
            nr = (~(key[:, 0] <= key[:, 1])).to(torch.int64)[:, None]
            fr = 1 - nr
            hf = torch.gather(hit, 1, fr)[:, 0]
            hn = torch.gather(hit, 1, nr)[:, 0]
            base = sp[na]
            pos = torch.where(hf, base, torch.full_like(base, s))
            codes[na, pos] = torch.gather(kc, 1, fr)[:, 0]
            nears[na, pos] = torch.gather(key, 1, fr)[:, 0]
            pos = torch.where(hn, base + hf, torch.full_like(base, s))
            codes[na, pos] = torch.gather(kc, 1, nr)[:, 0]
            nears[na, pos] = torch.gather(key, 1, nr)[:, 0]
            sp[na] = base + hf + hn
            peak[na] = torch.maximum(peak[na], sp[na])
            count_work(stats, na.numel(), 0, 0)

        # ---- leaf pops: Moller-Trumbore over the leaf's triangles
        sel = live & (code < 0)
        la = a[sel]
        if la.numel():
            first, count = leaf(code[sel])
            count = torch.clamp_max(count, max_leaf)
            idx = torch.clamp(first[:, None] + leaf_k[None, :],
                              max=tris.shape[0] - 1)
            trows = tris[idx]
            tfar = t_max[la] if any_hit else t[la]
            hit, tk, uk, vk = _moller_trumbore(trows, origin[la],
                                               direction[la], t_min, tfar)
            hit &= leaf_k[None, :] < count[:, None]
            count_work(stats, 0, la.numel(), leaf_tests(hit, count, any_hit))
            if any_hit:
                occ[la] |= hit.any(1)
            else:
                # sequential strict-less updates == first minimum
                tk = torch.where(hit, tk, torch.full_like(tk, float("inf")))
                j = torch.argmin(tk, dim=1, keepdim=True)
                upd = hit.any(1)
                lu = la[upd]
                t[lu] = torch.gather(tk, 1, j)[upd, 0]
                u[lu] = torch.gather(uk, 1, j)[upd, 0]
                v[lu] = torch.gather(vk, 1, j)[upd, 0]
                tri[lu] = torch.gather(trows[..., 9], 1, j)[upd, 0].to(
                    torch.int32)

        keep = sp[a] > 0
        if any_hit:
            keep &= ~occ[a]
        active = a[keep]

    if peak.numel() and int(peak.max()) > s:
        raise ValueError(f"K6 plain: the tree is deeper than depth2 = "
                         f"{scene['depth2']} says")
    if any_hit:
        return occ
    return dict(t=t, tri=tri, u=u, v=v)
