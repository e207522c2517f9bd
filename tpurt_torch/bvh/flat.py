"""Threaded (skip-link) binary BVH in numpy — a copy of ``tpurt/bvh/flat.py``.

The port keeps its own copy: it imports nothing of tpurt. The static
scene's SAH tree is a build intermediate (the traversal kernels read the
BVH8 rows that ``bvh/wide.collapse8`` makes from it); the dynamic scene's
LBVH (``bvh/lbvh.py``) is traced as it is by K6 (``kernels/traverse_bvh2``).

  node entered & internal  -> go to ``entry[node]`` (left child)
  node missed / leaf done  -> go to ``skip[node]``  (next subtree or -1)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatBVH:
    """M nodes, T reordered triangles, all numpy.

    aabb_min / aabb_max : (M, 3) f32
    entry               : (M,)  i32   left child for internal nodes
    skip                : (M,)  i32   next node on miss / after leaf (-1 exits)
    first_tri           : (M,)  i32   leaf triangle range start (into order)
    tri_count           : (M,)  i32   0 for internal nodes
    tri_order           : (T,)  i32   reordered triangle -> original index
    builder             : which host builder made it ("c++" or "numpy")
    """

    aabb_min: np.ndarray
    aabb_max: np.ndarray
    entry: np.ndarray
    skip: np.ndarray
    first_tri: np.ndarray
    tri_count: np.ndarray
    tri_order: np.ndarray
    builder: str = "numpy"

    def as_pytree(self) -> dict:
        return dict(
            aabb_min=self.aabb_min, aabb_max=self.aabb_max, entry=self.entry,
            skip=self.skip, first_tri=self.first_tri, tri_count=self.tri_count,
            tri_order=self.tri_order,
        )


def bvh_max_depth(entry: np.ndarray, skip: np.ndarray,
                  tri_count: np.ndarray) -> int:
    """Max node depth (root = 0). Both children of internal node n are
    entry[n] and skip[entry[n]], and parents precede children."""
    depth = np.zeros(len(entry), np.int64)
    for n in range(len(entry)):
        if tri_count[n] == 0:
            left = entry[n]
            depth[left] = depth[n] + 1
            depth[skip[left]] = depth[n] + 1
    return int(depth.max(initial=0))


# tpurt's binary packet kernels keep a 192-entry stack; the same builder
# limit keeps the trees (and so the BVH8 rows) identical to tpurt's
MAX_SAFE_DEPTH = 192 - 2


def check_traversal_depth(bvh: FlatBVH) -> int:
    depth = bvh_max_depth(bvh.entry, bvh.skip, bvh.tri_count)
    if depth > MAX_SAFE_DEPTH:
        raise ValueError(
            f"BVH depth {depth} exceeds the traversal stack budget "
            f"({MAX_SAFE_DEPTH}). Increase max_leaf_size.")
    return depth


def tri_aabbs(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    amin = np.minimum(np.minimum(v0, v1), v2)
    amax = np.maximum(np.maximum(v0, v1), v2)
    return amin, amax
