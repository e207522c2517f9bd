"""Procedural closest-hit cases for K1 over the compact node table
(tests/test_torch_closest_compact.py on the host, tests/test_torch_cuda.py
on the card). Port-only: imports neither tpurt nor JAX.

Scenes are triangle soups in which every triangle appears twice, so every
hit is an equal-t tie between two triangles:

* "dup_leaves": binary leaves of one triangle, BVH8 leaf slots of one
  triangle (collapse8 with leaf_max=1), so a duplicate pair sits in two
  sibling slots with identical boxes: equal entry distances, where the
  stable (distance, slot) order decides which leaf is tested first;
* "dup_merged": the default collapse, duplicates inside one leaf (the
  first in leaf order wins the tie).

A third soup, "deep" (deep_soup), nests 80 triangles at geometrically
shrinking scales, so that its tree (leaf slots of one triangle) is 9 BVH8
levels deep and takes the kernels' largest stack instantiation.

Rays form a 12 x 20 frame (a multiple of neither 16x8 nor 32x32): rays
aimed at triangle centroids, at vertices (grazing the triangles' edges and
their boxes' faces), axis-aligned rays (direction components of 0, inverse
+-inf) and random ones; t_max is mostly 100, some lanes short, 0, equal to
t_min or negative (those retire with t = t_max, tri = -1). For the fused
multi-set any hit, shared_origin_sets adds sets of rays from the same
origins aimed at other triangles.
"""
from __future__ import annotations

import numpy as np

H, W = 12, 20
T_MIN = 1e-3
CASES = {"dup_leaves": 1, "dup_merged": None}


def soup(seed: int = 5, n: int = 120):
    """(v0, v1, v2) (2n, 3) f32: n random triangles, each twice in a row."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    v1 = base + rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    v2 = base + rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    return tuple(np.repeat(a, 2, axis=0) for a in (base, v1, v2))


def deep_soup(n: int = 80, scale: float = 0.7, seed: int = 3):
    """(v0, v1, v2) (n, 3) f32: triangle k of size ~0.4 * scale**k at
    8 * scale**k * (1, 0.3, 0.2), each nested beside the next smaller: a
    chain of boxes, so the tree is deep for few triangles."""
    rng = np.random.default_rng(seed)
    k = scale ** np.arange(n)[:, None]
    centre = k * np.array([[8.0, 2.4, 1.6]])
    return tuple((centre + rng.uniform(-1.0, 1.0, (n, 3)) * 0.4 * k)
                 .astype(np.float32) for _ in range(3))


def shared_origin_sets(v0, v1, v2, sets: int, seed: int = 11):
    """(origin (N, 3), dirs (sets, N, 3), t_max (sets, N)) f32 numpy:
    frame_rays' origins, set 0 its directions and t_max, each further set
    aimed at the centroids of other random triangles (t_max 100, 0 on
    every seventh lane, short on every eleventh)."""
    o, d, t_max = frame_rays(v0, v1, v2, seed)
    rng = np.random.default_rng(seed + 1)
    dirs, tms = [d], [t_max]
    for s in range(1, sets):
        tri = rng.integers(0, v0.shape[0], o.shape[0])
        target = (v0[tri] + v1[tri] + v2[tri]) / np.float32(3.0)
        ds = target - o
        dirs.append((ds / np.linalg.norm(ds, axis=1, keepdims=True))
                    .astype(np.float32))
        tm = np.full(o.shape[0], 100.0, np.float32)
        tm[s::7] = 0.0
        tm[s::11] = np.float32(rng.uniform(2.0, 12.0))
        tms.append(tm)
    return o, np.stack(dirs), np.stack(tms)


def frame_rays(v0, v1, v2, seed: int = 11):
    """(origin, direction, t_max) of an H x W frame, f32 numpy."""
    rng = np.random.default_rng(seed)
    n = H * W
    kind = np.arange(n) % 4
    tri = rng.integers(0, v0.shape[0], n)
    centroid = (v0[tri] + v1[tri] + v2[tri]) / np.float32(3.0)
    corner = np.stack([v0, v1, v2])[rng.integers(0, 3, n), tri]
    target = np.where((kind == 1)[:, None], corner, centroid)
    target[kind == 3] = rng.uniform(-4.0, 4.0, ((kind == 3).sum(), 3))
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 12.0)
    d = target - o
    # axis-aligned rays: through the centroid along one axis
    axis = rng.integers(0, 3, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    ax = np.zeros((n, 3))
    ax[np.arange(n), axis] = sign
    o = np.where((kind == 2)[:, None], centroid - 12.0 * ax, o)
    d = np.where((kind == 2)[:, None], ax, d)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 100.0)
    pick = rng.random(n)
    t_max[pick < 0.1] = rng.uniform(4.0, 12.0, (pick < 0.1).sum())
    t_max[(pick >= 0.1) & (pick < 0.13)] = 0.0
    t_max[(pick >= 0.13) & (pick < 0.16)] = T_MIN
    t_max[(pick >= 0.16) & (pick < 0.18)] = -1.0
    return (o.astype(np.float32), d.astype(np.float32),
            t_max.astype(np.float32))


def port_scene(v0, v1, v2, leaf_max, device="cpu"):
    """The port's scene dict (nodes8, nodes8c, tris, depth8) over the soup,
    built with the port's host SAH builder; leaf_max None is LEAF8_MAX."""
    import torch

    from tpurt_torch.bvh import build_bvh_sah, collapse8
    from tpurt_torch.bvh.flat import tri_aabbs
    from tpurt_torch.bvh.wide import LEAF8_MAX, compact_bvh8
    from tpurt_torch.engine import convert

    bvh = build_bvh_sah(*tri_aabbs(v0, v1, v2),
                        max_leaf_size=leaf_max or 4)
    nodes8, depth8 = collapse8(bvh.as_pytree(),
                               leaf_max=leaf_max or LEAF8_MAX)
    order = np.asarray(bvh.tri_order)
    geom = dict(v0=v0[order], e1=v1[order] - v0[order],
                e2=v2[order] - v0[order], tri_id=order.astype(np.int32))
    n8 = torch.tensor(nodes8, device=device)
    scene = dict(nodes8=n8, nodes8c=compact_bvh8(n8), depth8=depth8,
                 tris=torch.tensor(convert.pack_tris(geom), device=device))
    return scene, bvh, geom


def identical_sibling_boxes(nodes8c) -> int:
    """Pairs of valid slots of one node with bit-identical boxes."""
    from tpurt_torch.bvh.wide import EMPTY_CODE

    nc = nodes8c.cpu().numpy()
    codes = nc[:, 48:56].view(np.int32)
    pairs = 0
    for r in range(nc.shape[0]):
        boxes = [nc[r, [8 * a + k for a in range(6)]].tobytes()
                 for k in range(8) if codes[r, k] != EMPTY_CODE]
        pairs += len(boxes) - len(set(boxes))
    return pairs
