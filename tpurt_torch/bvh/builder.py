"""Binned-SAH BVH builder — a numpy copy of ``tpurt/bvh/builder.py``.

It calls the port's copy of tpurt's C++ builder
(``tpurt_torch.native.native_build_sah``, built with ``g++``) with the same
numpy fallback when the toolchain is missing, so each gives the tree that
the same builder gives in tpurt, bit for bit. The two builders partition
in other orders (the C++ ``std::partition`` and ``std::nth_element``, the
numpy stable order), so their trees differ from each other, in both
packages; ``FlatBVH.builder`` says which one ran.
"""
from __future__ import annotations

import sys

import numpy as np

from .flat import FlatBVH, check_traversal_depth

_N_BINS = 16


def build_bvh_sah(aabb_min: np.ndarray, aabb_max: np.ndarray,
                  max_leaf_size: int = 4) -> FlatBVH:
    """Binned-SAH top-down build over item AABBs (C++ when the host
    toolchain is there, else numpy, exactly as tpurt decides)."""
    bvh = None
    try:
        from ..native import native_build_sah

        out = native_build_sah(aabb_min, aabb_max, max_leaf_size)
        if out is not None:
            bvh = FlatBVH(**out, builder="c++")
    except Exception:  # noqa: BLE001 — tpurt falls back on any failure too
        pass
    if bvh is None:
        bvh = _build_numpy(aabb_min, aabb_max, max_leaf_size)
    check_traversal_depth(bvh)
    return bvh


def _build_numpy(aabb_min, aabb_max, max_leaf_size):
    amin = np.asarray(aabb_min, np.float32).reshape(-1, 3)
    amax = np.asarray(aabb_max, np.float32).reshape(-1, 3)
    n = len(amin)
    centroids = (amin + amax) * 0.5

    node_min, node_max = [], []
    entry, first_tri, tri_count = [], [], []
    subtree_end = []
    order = np.arange(n, dtype=np.int32)

    def emit_node(lo, hi):
        idx = len(node_min)
        items = order[lo:hi]
        node_min.append(amin[items].min(axis=0))
        node_max.append(amax[items].max(axis=0))
        entry.append(-1)
        first_tri.append(-1)
        tri_count.append(0)
        subtree_end.append(0)
        return idx

    def build(lo, hi):
        node = emit_node(lo, hi)
        count = hi - lo
        if count <= max_leaf_size:
            first_tri[node] = lo
            tri_count[node] = count
        else:
            items = order[lo:hi]
            c = centroids[items]
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            split = None
            if ext[axis] > 1e-12:
                split = _binned_sah_split(amin[items], amax[items], c, axis)
            if split is None:
                key = np.argsort(c[:, axis], kind="stable")
                order[lo:hi] = items[key]
                mid = lo + count // 2
            else:
                order[lo:hi] = np.concatenate([items[split], items[~split]])
                mid = lo + int(split.sum())
                if mid == lo or mid == hi:
                    key = np.argsort(c[:, axis], kind="stable")
                    order[lo:hi] = items[key]
                    mid = lo + count // 2
            entry[node] = len(node_min)
            build(lo, mid)
            build(mid, hi)
        subtree_end[node] = len(node_min)
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit,
                              4 * int(np.ceil(np.log2(max(n, 2)))) + 1000))
    try:
        build(0, n)
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(node_min)
    subtree_end = np.asarray(subtree_end, np.int64)
    return FlatBVH(
        aabb_min=np.asarray(node_min, np.float32),
        aabb_max=np.asarray(node_max, np.float32),
        entry=np.asarray(entry, np.int32),
        skip=np.where(subtree_end == m, -1, subtree_end).astype(np.int32),
        first_tri=np.asarray(first_tri, np.int32),
        tri_count=np.asarray(tri_count, np.int32),
        tri_order=order,
    )


def _binned_sah_split(amin, amax, centroids, axis):
    """Left-partition mask of the best binned SAH split, or None."""
    c = centroids[:, axis]
    lo, hi = c.min(), c.max()
    if hi - lo < 1e-12:
        return None
    bins = np.clip(((c - lo) / (hi - lo) * _N_BINS).astype(np.int32), 0,
                   _N_BINS - 1)

    bin_min = np.full((_N_BINS, 3), np.inf, np.float32)
    bin_max = np.full((_N_BINS, 3), -np.inf, np.float32)
    bin_cnt = np.zeros(_N_BINS, np.int64)
    for b in range(_N_BINS):
        m = bins == b
        if m.any():
            bin_min[b] = amin[m].min(axis=0)
            bin_max[b] = amax[m].max(axis=0)
            bin_cnt[b] = m.sum()

    def area(mn, mx):
        d = np.maximum(mx - mn, 0)
        return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                + d[..., 2] * d[..., 0])

    lmin = np.minimum.accumulate(bin_min, axis=0)
    lmax = np.maximum.accumulate(bin_max, axis=0)
    lcnt = np.cumsum(bin_cnt)
    rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
    rcnt = np.cumsum(bin_cnt[::-1])[::-1]

    costs = np.full(_N_BINS - 1, np.inf)
    for s in range(_N_BINS - 1):
        if lcnt[s] == 0 or rcnt[s + 1] == 0:
            continue
        costs[s] = (area(lmin[s], lmax[s]) * lcnt[s]
                    + area(rmin[s + 1], rmax[s + 1]) * rcnt[s + 1])
    best = int(np.argmin(costs))
    if not np.isfinite(costs[best]):
        return None
    return bins <= best
