"""Binary-BVH closest-hit and any-hit traversal (K6).

``trace_closest_bvh2`` and ``trace_any_bvh2`` replace tpurt's
``trace_closest_packets`` / ``trace_any_packets``
(``tpurt/kernels/traverse_pallas.py``) over the threaded binary BVH, every
table tier of them. On CUDA tensors they launch ``csrc/bvh2_trace.cu``; on
CPU tensors they run the plain PyTorch version below, which pops stack
entries in the kernel's order and gives bit-identical results. There is no
fallback between the two.

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

Scene keys: ``nodes2`` (M, 8) f32 from ``engine/convert.pack_bvh2``,
``tris`` (T, 12) f32 from ``convert.pack_tris``, and ``depth2``, a bound on
the tree's depth (root = 0) known on the host, which sizes the stack.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# the kernel's stack variants (csrc/bvh2_trace.cu): a popped node at depth
# d leaves at most d deferred siblings, then pushes two children
STACK_SIZES = (64, 192)


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


def _check_inputs(name, scene, origin, direction, t_max, max_leaf):
    if origin.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError(f"{name}: rays must be float32")
    if origin.shape != direction.shape or origin.ndim != 2 \
            or origin.shape[1] != 3:
        raise ValueError(f"{name}: rays must be (N, 3), got "
                         f"{tuple(origin.shape)} / {tuple(direction.shape)}")
    nodes, tris = scene["nodes2"], scene["tris"]
    if nodes.dtype != torch.float32 or nodes.ndim != 2 \
            or nodes.shape[1] != 8:
        raise ValueError(f"{name}: nodes2 must be (M, 8) float32")
    if tris.dtype != torch.float32 or tris.ndim != 2 or tris.shape[1] != 12:
        raise ValueError(f"{name}: tris must be (T, 12) float32")
    if not 1 <= max_leaf <= 32:
        raise ValueError(f"{name}: max_leaf {max_leaf} outside 1..32")
    kernel_stack(int(scene["depth2"]))
    tensors = dict(nodes2=nodes, tris=tris, origin=origin,
                   direction=direction, t_max=t_max)
    if origin.is_cuda:
        build.require_cuda(name, tensors, origin.device)
    else:
        for key, t in tensors.items():
            if t.device.type != "cpu":
                raise ValueError(f"{name}: {key} is on {t.device}; the plain "
                                 f"version runs on CPU tensors only")


def trace_closest_bvh2(scene: dict, origin, direction, t_min: float, t_max,
                       max_leaf: int = 1):
    """Closest hit for (N, 3) rays. Returns dict(t, tri, u, v), each (N,)."""
    n = origin.shape[0]
    tmx = _t_max_tensor(t_max, n, origin)
    _check_inputs("trace_closest_bvh2", scene, origin, direction, tmx,
                  max_leaf)
    if not origin.is_cuda:
        return trace_closest_plain(scene, origin, direction, t_min, tmx,
                                   max_leaf)
    fn = build.function("tpurt_bvh2_closest", [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 5)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    tri = torch.empty(n, dtype=torch.int32, device=origin.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    p = build.ptr
    build.check(fn(p(scene["nodes2"]), p(scene["tris"]), p(origin),
                   p(direction), float(t_min), p(tmx), n, max_leaf,
                   kernel_stack(int(scene["depth2"])), p(t), p(tri), p(u),
                   p(v), build.stream_of(origin)), "tpurt_bvh2_closest")
    build.launch_counts["bvh2_closest"] += 1
    return dict(t=t, tri=tri, u=u, v=v)


def trace_any_bvh2(scene: dict, origin, direction, t_min: float, t_max,
                   max_leaf: int = 1):
    """Any hit (occlusion) for (N, 3) rays. Returns a (N,) bool mask."""
    n = origin.shape[0]
    tmx = _t_max_tensor(t_max, n, origin)
    _check_inputs("trace_any_bvh2", scene, origin, direction, tmx, max_leaf)
    if not origin.is_cuda:
        return trace_any_plain(scene, origin, direction, t_min, tmx,
                               max_leaf)
    fn = build.function("tpurt_bvh2_any", [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2)
    occ = torch.empty(n, dtype=torch.uint8, device=origin.device)
    p = build.ptr
    build.check(fn(p(scene["nodes2"]), p(scene["tris"]), p(origin),
                   p(direction), float(t_min), p(tmx), n, max_leaf,
                   kernel_stack(int(scene["depth2"])), p(occ),
                   build.stream_of(origin)), "tpurt_bvh2_any")
    build.launch_counts["bvh2_any"] += 1
    return occ.bool()


def _slab(rows, o, inv, t_min, tfar):
    """Slab tests of boxes rows (A, K, 8) for rays (A, 3): (A, K) entry
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
                        max_leaf: int = 1, stats=None):
    """Plain PyTorch version of K6 closest hit on any device. `stats`, a
    dict, gets the traversal work (traverse_bvh8.count_work)."""
    n = origin.shape[0]
    return _trace_plain(scene, origin, direction, float(t_min),
                        _t_max_tensor(t_max, n, origin), max_leaf,
                        any_hit=False, stats=stats)


def trace_any_plain(scene, origin, direction, t_min, t_max,
                    max_leaf: int = 1, stats=None):
    """Plain PyTorch version of K6 any hit on any device (`stats` as
    above)."""
    n = origin.shape[0]
    return _trace_plain(scene, origin, direction, float(t_min),
                        _t_max_tensor(t_max, n, origin), max_leaf,
                        any_hit=True, stats=stats)


def _trace_plain(scene, origin, direction, t_min, t_max, max_leaf: int,
                 any_hit: bool, stats=None):
    """Every live ray pops one stack entry per iteration, over (N, S)
    stacks of codes and entry distances, in the kernel's order."""
    from .traverse_bvh8 import _moller_trumbore, count_work, leaf_tests

    nodes, tris = scene["nodes2"], scene["tris"]
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

    root = nodes[0:1].expand(n, 1, 8)
    tn, hit = _slab(root, origin, inv, tmin_t, t_max)
    codes[:, 0] = -1 if float(nodes[0, 7]) < 0.0 else 0
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
            kid = nodes[code[sel], 6:8].to(torch.int64)          # (k, 2)
            rows = nodes[kid]                                     # (k, 2, 8)
            tfar = t_max[na] if any_hit else t[na]
            key, hit = _slab(rows, origin[na], inv[na], tmin_t, tfar)
            kc = torch.where(rows[..., 7] < 0.0, -kid - 1, kid)
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
            meta = nodes[-code[sel] - 1]
            first = meta[:, 6].to(torch.int64)
            count = torch.clamp_max((-meta[:, 7]).to(torch.int64), max_leaf)
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
