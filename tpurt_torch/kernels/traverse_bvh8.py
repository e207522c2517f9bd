"""BVH8 closest-hit (K1) and any-hit (K2) traversal.

``trace_closest_bvh8`` and ``trace_any_bvh8`` replace tpurt's entry points
of the same names (``tpurt/kernels/traverse_bvh8.py``). On CUDA tensors they
launch ``csrc/bvh8_trace.cu``; on CPU tensors they run the plain PyTorch
version below, which visits stack entries in the kernel's order and gives
bit-identical results. There is no fallback between the two.

Contract (tpurt's): ``t = t_max``, ``tri = -1``, ``u = v = 0`` on a miss;
``tri`` is the global triangle id; a ray with ``t_max <= t_min`` is never
occluded.

Traversal order, shared by kernel and plain version: the root is pushed
first; popping a node tests its 8 child boxes with the slab test (``tfar``
= the current hit distance, or ``t_max`` for any-hit) and pushes the hit
children far-to-near — sorted by (entry distance, slot) with the nearest on
top. Popping a leaf runs Moller-Trumbore on its triangles in order (strict
``t < tfar``, so the first of equal distances wins). A closest-hit entry
whose entry distance exceeds the current hit is dropped when popped.
"""
from __future__ import annotations

import ctypes

import torch

from ..bvh.wide import LEAF8_MAX
from . import build

LEAF_CODE_BASE = 128
# the per-thread stack of csrc/bvh8_trace.cu (STACK_SIZE there). A node pop
# pushes at most 8 entries (net +7), so a tree of D wide levels needs
# 7 * D + 1 entries; engine/convert.scene_tensors refuses deeper trees.
STACK_SIZE = 192


def stack_entries(depth8: int) -> int:
    """Stack entries a BVH8 of `depth8` wide levels can need."""
    return 7 * depth8 + 1


def _t_max_tensor(t_max, n, like):
    if isinstance(t_max, torch.Tensor):
        return t_max.to(torch.float32).expand(n).contiguous()
    return torch.full((n,), float(t_max), dtype=torch.float32,
                      device=like.device)


def _check_inputs(name, scene, origin, direction, t_max):
    if origin.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError(f"{name}: rays must be float32")
    if origin.shape != direction.shape or origin.ndim != 2 \
            or origin.shape[1] != 3:
        raise ValueError(f"{name}: rays must be (N, 3), got "
                         f"{tuple(origin.shape)} / {tuple(direction.shape)}")
    nodes, tris = scene["nodes8"], scene["tris"]
    if nodes.dtype != torch.float32 or nodes.ndim != 2 \
            or nodes.shape[1] != 128:
        raise ValueError(f"{name}: nodes8 must be (M, 128) float32")
    if tris.dtype != torch.float32 or tris.ndim != 2 or tris.shape[1] != 12:
        raise ValueError(f"{name}: tris must be (T, 12) float32")
    tensors = dict(nodes8=nodes, tris=tris, origin=origin,
                   direction=direction, t_max=t_max)
    if origin.is_cuda:
        build.require_cuda(name, tensors, origin.device)
    else:
        for key, t in tensors.items():
            if t.device.type != "cpu":
                raise ValueError(f"{name}: {key} is on {t.device}; the plain "
                                 f"version runs on CPU tensors only")


def trace_closest_bvh8(scene: dict, origin, direction, t_min: float, t_max):
    """Closest hit for (N, 3) rays. Returns dict(t, tri, u, v), each (N,)."""
    n = origin.shape[0]
    tmx = _t_max_tensor(t_max, n, origin)
    _check_inputs("trace_closest_bvh8", scene, origin, direction, tmx)
    if not origin.is_cuda:
        return trace_closest_plain(scene, origin, direction, t_min, tmx)
    fn = build.function("tpurt_bvh8_closest", [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 5)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    tri = torch.empty(n, dtype=torch.int32, device=origin.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    p = build.ptr
    build.check(fn(p(scene["nodes8"]), p(scene["tris"]), p(origin),
                   p(direction), float(t_min), p(tmx), n, p(t), p(tri),
                   p(u), p(v), build.stream_of(origin)),
                "tpurt_bvh8_closest")
    build.launch_counts["bvh8_closest"] += 1
    return dict(t=t, tri=tri, u=u, v=v)


def trace_any_bvh8(scene: dict, origin, direction, t_min: float, t_max):
    """Any hit (occlusion) for (N, 3) rays. Returns a (N,) bool mask."""
    n = origin.shape[0]
    tmx = _t_max_tensor(t_max, n, origin)
    _check_inputs("trace_any_bvh8", scene, origin, direction, tmx)
    if not origin.is_cuda:
        return trace_any_plain(scene, origin, direction, t_min, tmx)
    fn = build.function("tpurt_bvh8_any", [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 2)
    occ = torch.empty(n, dtype=torch.uint8, device=origin.device)
    p = build.ptr
    build.check(fn(p(scene["nodes8"]), p(scene["tris"]), p(origin),
                   p(direction), float(t_min), p(tmx), n, p(occ),
                   build.stream_of(origin)), "tpurt_bvh8_any")
    build.launch_counts["bvh8_any"] += 1
    return occ.bool()


def _slab(nodes_rows, o, inv, t_min, tfar):
    """Slab tests of the 8 child boxes of each row: (A, 8) entry distance
    and hit mask (tpurt _Rays.slab order, NaN-propagating min/max)."""
    mn = torch.minimum
    mx = torch.maximum
    t0 = [(nodes_rows[:, a:48:6] - o[:, a:a + 1]) * inv[:, a:a + 1]
          for a in range(3)]
    t1 = [(nodes_rows[:, a + 3:48:6] - o[:, a:a + 1]) * inv[:, a:a + 1]
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
                        stats=None):
    """Plain PyTorch version of K1 on any device. `stats`, a dict, gets
    the traversal work (see count_work)."""
    n = origin.shape[0]
    return _trace_plain(scene, origin, direction, float(t_min),
                        _t_max_tensor(t_max, n, origin), any_hit=False,
                        stats=stats)


def trace_any_plain(scene, origin, direction, t_min, t_max, stats=None):
    """Plain PyTorch version of K2 on any device (`stats` as above)."""
    n = origin.shape[0]
    return _trace_plain(scene, origin, direction, float(t_min),
                        _t_max_tensor(t_max, n, origin), any_hit=True,
                        stats=stats)


def count_work(stats, node_pops, leaf_pops, tri_tests):
    """Add one iteration's work to `stats` (device tensors; read them with
    int() after the traversal): node_pops and leaf_pops count popped
    entries that are visited, tri_tests the Moller-Trumbore tests the
    kernel runs (an any-hit leaf stops at its first hit)."""
    if stats is None:
        return
    for key, val in (("node_pops", node_pops), ("leaf_pops", leaf_pops),
                     ("tri_tests", tri_tests)):
        stats[key] = stats.get(key, 0) + val


def leaf_tests(hit, count, any_hit: bool):
    """Moller-Trumbore tests of leaf pops with per-slot hits `hit` (A, K)
    and `count` triangles each: all of them, or up to the first hit."""
    if not any_hit:
        return count.sum()
    first = hit.to(torch.int8).argmax(dim=1) + 1
    return torch.where(hit.any(1), first, count).sum()


def _trace_plain(scene, origin, direction, t_min, t_max, any_hit: bool,
                 stats=None):
    """The plain PyTorch traversal: every live ray pops one stack entry per
    iteration, over (N, S) stacks of codes and entry distances."""
    nodes, tris = scene["nodes8"], scene["tris"]
    dev = origin.device
    n = origin.shape[0]
    s = stack_entries(scene["depth8"])
    inv = 1.0 / direction
    tmin_t = torch.tensor(t_min, dtype=torch.float32, device=dev)

    t = t_max.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
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
    slot = torch.arange(8, device=dev)
    leaf_k = torch.arange(LEAF8_MAX, device=dev)

    while active.numel():
        a = active
        top = sp[a] - 1
        sp[a] = top
        code = codes[a, top]
        live = torch.ones_like(code, dtype=torch.bool) if any_hit \
            else nears[a, top] <= t[a]

        # ---- node pops: slab-test 8 children, push hits far-to-near
        sel = live & (code >= 0)
        na = a[sel]
        if na.numel():
            rows = nodes[code[sel].long()]
            tfar = t_max[na] if any_hit else t[na]
            tnear, hit = _slab(rows, origin[na], inv[na], tmin_t, tfar)
            hit &= (rows[:, 48:56] >= 0.0) | (rows[:, 64:72] > 0.0)
            child_code = torch.where(
                rows[:, 48:56] >= 0.0, rows[:, 48:56].to(torch.int32),
                -(rows[:, 56:64].to(torch.int32) * LEAF_CODE_BASE
                  + rows[:, 64:72].to(torch.int32)) - 1)
            keys = torch.where(hit, tnear, torch.full_like(tnear,
                                                           float("inf")))
            keys, perm = torch.sort(keys, dim=1, stable=True)
            child_code = torch.gather(child_code, 1, perm)
            nh = hit.sum(1)
            base = sp[na]
            pos = base[:, None] + nh[:, None] - 1 - slot[None, :]
            pos = torch.where(slot[None, :] < nh[:, None], pos,
                              torch.full_like(pos, s))
            rows_i = na[:, None].expand(-1, 8)
            codes[rows_i, pos] = child_code
            nears[rows_i, pos] = keys
            sp[na] = base + nh
            count_work(stats, na.numel(), 0, 0)

        # ---- leaf pops: Moller-Trumbore over the leaf's triangles
        sel = live & (code < 0)
        la = a[sel]
        if la.numel():
            dec = -(code[sel].long() + 1)
            first = dec // LEAF_CODE_BASE
            count = dec - first * LEAF_CODE_BASE
            idx = torch.clamp(first[:, None] + leaf_k[None, :],
                              max=tris.shape[0] - 1)
            rows = tris[idx]
            tfar = t_max[la] if any_hit else t[la]
            hit, tk, uk, vk = _moller_trumbore(rows, origin[la],
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
                tri[lu] = torch.gather(rows[..., 9], 1, j)[upd, 0].to(
                    torch.int32)

        keep = sp[a] > 0
        if any_hit:
            keep &= ~occ[a]
        active = a[keep]

    if any_hit:
        return occ
    return dict(t=t, tri=tri, u=u, v=v)
