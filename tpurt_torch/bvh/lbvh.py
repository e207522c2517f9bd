"""LBVH construction as tensor ops — port of ``tpurt/bvh/lbvh.py``.

The per-frame acceleration-structure rebuild of the dynamic scene: the
reference destroys and rebuilds its TLAS every frame
(vk_tlas_builder.rs:38-233). Everything runs on the tensors' device with
the reference's static loop counts, so the tree equals tpurt's bit for bit:

  1. 30-bit Morton codes over item centroids (10 bits per axis),
  2. a stable argsort of the codes (equal codes keep their index order),
  3. the Karras 2012 hierarchy emit (binary searches per internal node),
  4. bottom-up box refit by fixed-point iteration (``depth_bound`` sweeps),
  5. skip-link threading by upward walks (``depth_bound`` steps),

giving the threaded binary tree that K6 (``kernels/traverse_bvh2``) traces.
Node layout: internal nodes ``[0, N-2]``, leaves ``[N-1, 2N-2]`` (leaf i
holds the i-th sorted item); the root is 0 (the single leaf when N == 1).
"""
from __future__ import annotations

import math

import torch

from .flat import FlatBVH

_M32 = 0xFFFFFFFF


def max_pow(n: int) -> int:
    """The reference's static trip count of the Karras searches."""
    return int(math.ceil(math.log2(max(n, 2)))) + 1


def depth_bound(n: int) -> int:
    """Bound on the depth of an N-item LBVH (root = 0): keys are 30 Morton
    bits plus the index tiebreak, and prefix lengths grow strictly along a
    root-to-leaf path. It is also the refit and skip-walk sweep count."""
    return 32 + max_pow(n)


def _expand_bits_10(v):
    """Spread the low 10 bits of v to every 3rd bit (u32 arithmetic in
    int64: every product stays below 2^63 and the masks keep 32 bits)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes_3d(points, lo, hi):
    """30-bit Morton codes (int64) for points normalized into [lo, hi]^3.
    ``extent`` is a tensor on the points' device, so the division rounds
    once on every device (the host-scalar trap of encodings.divide does not
    arise)."""
    extent = torch.clamp_min(hi - lo, 1e-12)
    p = torch.clamp((points - lo) / extent, 0.0, 1.0)
    q = torch.clamp_max(p * 1024.0, 1023.0).to(torch.int64)
    return ((_expand_bits_10(q[..., 0]) << 2)
            | (_expand_bits_10(q[..., 1]) << 1)
            | _expand_bits_10(q[..., 2]))


def _popcount32(x):
    x = x & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _clz32(x):
    x = x & _M32
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return _popcount32(~x)


def build_lbvh(aabb_min, aabb_max) -> FlatBVH:
    """Build a FlatBVH (int32 / float32 tensors on the inputs' device) over
    N item AABBs."""
    amin = aabb_min.to(torch.float32).reshape(-1, 3)
    amax = aabb_max.to(torch.float32).reshape(-1, 3)
    dev = amin.device
    n = amin.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    if n == 1:
        return FlatBVH(
            aabb_min=amin.clone(), aabb_max=amax.clone(),
            entry=torch.full((1,), -1, **i32),
            skip=torch.full((1,), -1, **i32),
            first_tri=torch.zeros((1,), **i32),
            tri_count=torch.ones((1,), **i32),
            tri_order=torch.zeros((1,), **i32), builder="lbvh")

    centroids = (amin + amax) * 0.5
    codes = morton_codes_3d(centroids, amin.amin(dim=0), amax.amax(dim=0))
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    amin_s = amin[order]
    amax_s = amax[order]

    def delta(i, j):
        """Common-prefix length of sorted keys i and j; -1 out of range.
        Equal Morton codes extend the key with the index (unique keys)."""
        valid = (j >= 0) & (j < n)
        j_c = torch.clamp(j, 0, n - 1)
        x = codes[i] ^ codes[j_c]
        d = torch.where(x == 0, 32 + _clz32(i ^ j_c), _clz32(x))
        return torch.where(valid, d, torch.full_like(d, -1))

    i = torch.arange(n - 1, dtype=torch.int64, device=dev)

    # direction of each node's range
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i, i - d)

    mp = max_pow(n)
    lmax = torch.full_like(i, 2)
    for _ in range(mp):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)

    # binary search for the exact range length
    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(mp + 1):
        cond = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(cond, l + t, l)
        t = t // 2
    j = i + l * d

    # split position: binary search on the node's own prefix, with the
    # reference's ceil-halving step sequence
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = (l + 1) // 2
    for _ in range(mp + 1):
        cond = (t >= 1) & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(cond, s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, torch.zeros_like(t))
    gamma = i + s * d + torch.clamp_max(d, 0)

    leaf_base = n - 1
    left = torch.where(torch.minimum(i, j) == gamma, leaf_base + gamma, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1,
                        leaf_base + gamma + 1, gamma + 1)

    m = 2 * n - 1
    parent = torch.zeros(m, dtype=torch.int64, device=dev)
    parent[left] = i
    parent[right] = i

    # bottom-up box refit by fixed-point iteration
    bound = depth_bound(n)
    node_min = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    node_max = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    node_min[leaf_base:] = amin_s
    node_max[leaf_base:] = amax_s
    for _ in range(bound):
        new_min = torch.minimum(node_min[left], node_min[right])
        new_max = torch.maximum(node_max[left], node_max[right])
        node_min[:leaf_base] = new_min
        node_max[:leaf_base] = new_max

    # skip[x] = right sibling of the lowest ancestor-or-self of x that is a
    # left child; -1 on the right spine
    cur = torch.arange(m, dtype=torch.int64, device=dev)
    skip = torch.full((m,), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    for _ in range(bound):
        par = parent[cur]
        newly = ~done & (cur != 0) & (left[par] == cur)
        skip = torch.where(newly, right[par], skip)
        done = done | (cur == 0) | newly
        cur = torch.where(done, cur, par)

    entry = torch.cat([left.to(torch.int32), torch.full((n,), -1, **i32)])
    first_tri = torch.cat([torch.full((n - 1,), -1, **i32),
                           torch.arange(n, **i32)])
    tri_count = torch.cat([torch.zeros((n - 1,), **i32),
                           torch.ones((n,), **i32)])
    return FlatBVH(
        aabb_min=node_min, aabb_max=node_max, entry=entry,
        skip=skip.to(torch.int32), first_tri=first_tri, tri_count=tri_count,
        tri_order=order.to(torch.int32), builder="lbvh")
