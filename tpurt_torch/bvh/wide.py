"""BVH8 collapse and refit — port of ``tpurt/bvh/wide.py``.

The collapse and the refit plan are numpy copies (host, once per scene);
the refit itself and its quality measure are tensor ops on the frame's
device (the dynamic scene's refit frames).

Collapses the threaded binary SAH BVH into 8-wide nodes with the same rules
as tpurt (greedy widening by surface area, subtree flattening into leaf
slots of <= LEAF8_MAX triangles, adjacent leaf-slot merging), so the rows
are identical to the reference's.

Row layout (f32 lanes; indices as exact small floats < 2^24):
  [k*6 .. k*6+5]  child k aabb_min.xyz, aabb_max.xyz   (k = 0..7)
  [48 + k]        wide index of internal child k, -1 if leaf/empty
  [56 + k]        leaf first-triangle index (0 if not leaf)
  [64 + k]        leaf triangle count (0 if internal/empty)
Empty slots carry an inverted box, so every slab test misses them.

The compact table ``nodes8c`` (:func:`compact_bvh8`, read by the any-hit
kernel K2) holds per node 56 f32 lanes: the 8 child boxes as structure of
arrays, [a*8 + k] = row lane [k*6 + a] (a = min x, y, z, max x, y, z; the
same bits), then [48 + k] child k's stack code as int32 bits: the internal
child's wide index, a leaf's -(first * LEAF_CODE_BASE + count) - 1, or
EMPTY_CODE (-1, which no leaf gives: a leaf holds at least one triangle)
for an empty slot. 224 bytes per node.
"""
from __future__ import annotations

import numpy as np

BRANCHING = 8
LEAF8_MAX = 32
_EMPTY_MIN = 3.0e37
_EMPTY_MAX = -3.0e37
# stack codes of leaves: -(first * LEAF_CODE_BASE + count) - 1
LEAF_CODE_BASE = 128
EMPTY_CODE = -1
COMPACT_LANES = 56


def _subtree_ranges(entry, skip, first, count, is_leaf):
    """Per-node (first, count, contiguous?) of the whole subtree's
    triangles; children sit at higher indices, so one reverse pass does."""
    n = len(entry)
    sub_first = np.where(is_leaf, first, 0).astype(np.int64)
    sub_count = np.where(is_leaf, count, 0).astype(np.int64)
    flat_ok = is_leaf.copy()
    for b in range(n - 1, -1, -1):
        if not is_leaf[b]:
            l = int(entry[b])
            r = int(skip[l])
            sub_first[b] = min(sub_first[l], sub_first[r])
            sub_count[b] = sub_count[l] + sub_count[r]
            ends_meet = (
                sub_first[l] + sub_count[l] == sub_first[r]
                or sub_first[r] + sub_count[r] == sub_first[l])
            flat_ok[b] = bool(flat_ok[l] and flat_ok[r] and ends_meet)
    return sub_first, sub_count, flat_ok


def collapse8(bvh: dict, leaf_max: int = LEAF8_MAX):
    """Binary FlatBVH arrays -> (nodes8 (M8, 128) f32, depth in wide levels,
    root = 1)."""
    amin = np.asarray(bvh["aabb_min"], np.float32)
    amax = np.asarray(bvh["aabb_max"], np.float32)
    entry = np.asarray(bvh["entry"], np.int64)
    skip = np.asarray(bvh["skip"], np.int64)
    first = np.asarray(bvh["first_tri"], np.int64)
    count = np.asarray(bvh["tri_count"], np.int64)
    is_leaf = count > 0

    sub_first, sub_count, flat_ok = _subtree_ranges(entry, skip, first,
                                                    count, is_leaf)
    d = amax - amin
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]

    def binary_children(b: int):
        l = int(entry[b])
        return l, int(skip[l])

    def slot_is_leaf(b: int) -> bool:
        return bool(is_leaf[b]
                    or (flat_ok[b] and sub_count[b] <= leaf_max))

    def slot_range(b: int):
        if is_leaf[b]:
            return int(first[b]), int(count[b])
        return int(sub_first[b]), int(sub_count[b])

    def kids_of(b: int):
        kids = list(binary_children(b))
        while len(kids) < BRANCHING:
            cand = [(area[k], j) for j, k in enumerate(kids)
                    if not is_leaf[k]]
            if not cand:
                break
            _, j = max(cand)
            k = kids.pop(j)
            kids.extend(binary_children(k))
        slots = []
        for k in kids:
            if slot_is_leaf(k):
                f, c = slot_range(k)
                slots.append((True, (f, c, amin[k].copy(), amax[k].copy())))
            else:
                slots.append((False, k))
        leaves = sorted((s[1] for s in slots if s[0]), key=lambda p: p[0])
        merged = []
        for f, c, mn, mx in leaves:
            if merged and merged[-1][0] + merged[-1][1] == f \
                    and merged[-1][1] + c <= leaf_max:
                pf, pc, pmn, pmx = merged[-1]
                merged[-1] = (pf, pc + c, np.minimum(pmn, mn),
                              np.maximum(pmx, mx))
            else:
                merged.append((f, c, mn, mx))
        return ([(False, s[1]) for s in slots if not s[0]]
                + [(True, m) for m in merged])

    if is_leaf[0]:
        slot_lists = [[(True, (int(first[0]), int(count[0]),
                               amin[0], amax[0]))]]
        wide_of = {}
        depth = 1
    elif flat_ok[0] and sub_count[0] <= leaf_max:
        slot_lists = [[(True, (int(sub_first[0]), int(sub_count[0]),
                               amin[0], amax[0]))]]
        wide_of = {}
        depth = 1
    else:
        wide_of = {0: 0}
        queue = [(0, 1)]
        slot_lists = []
        depth = 1
        while queue:
            b, dep = queue.pop(0)
            depth = max(depth, dep)
            slots = kids_of(b)
            slot_lists.append(slots)
            for lf, payload in slots:
                if not lf:
                    wide_of[payload] = len(wide_of)
                    queue.append((payload, dep + 1))

    nodes8 = np.zeros((len(slot_lists), 128), np.float32)
    for lane in range(3):
        nodes8[:, lane:48:6] = _EMPTY_MIN
        nodes8[:, lane + 3:48:6] = _EMPTY_MAX
    nodes8[:, 48:56] = -1.0
    for w, slots in enumerate(slot_lists):
        assert len(slots) <= BRANCHING
        for k_slot, (lf, payload) in enumerate(slots):
            base = k_slot * 6
            if lf:
                f, c, mn, mx = payload
                assert 0 < c <= leaf_max
                nodes8[w, base:base + 3] = mn
                nodes8[w, base + 3:base + 6] = mx
                nodes8[w, 56 + k_slot] = float(f)
                nodes8[w, 64 + k_slot] = float(c)
            else:
                nodes8[w, base:base + 3] = amin[payload]
                nodes8[w, base + 3:base + 6] = amax[payload]
                nodes8[w, 48 + k_slot] = float(wide_of[payload])
    return nodes8, depth


def compact_bvh8(nodes8):
    """The compact table (M, 56) f32 of (M, 128) BVH8 rows (a tensor, on
    its device; module docstring): the box lanes regrouped by coordinate
    and the child codes K2 pushes, each slot's code as the traversal
    kernels' child_code computes it."""
    import torch

    m = nodes8.shape[0]
    boxes = nodes8[:, :48].reshape(m, 8, 6).transpose(1, 2).reshape(m, 48)
    child, first, count = (nodes8[:, a:a + 8].to(torch.int32)
                           for a in (48, 56, 64))
    internal = nodes8[:, 48:56] >= 0.0
    leaf = nodes8[:, 64:72] > 0.0
    codes = torch.where(internal, child,
                        torch.where(leaf, -(first * LEAF_CODE_BASE + count)
                                    - 1, torch.full_like(child, EMPTY_CODE)))
    return torch.cat([boxes, codes.view(torch.float32)], dim=1).contiguous()


# ------------------------------------------------------------------ refit --

def refit_plan(nodes8: np.ndarray):
    """Static refit metadata from packed BVH8 rows (host, numpy): the BFS
    level partition, root level first. Children always sit at deeper
    levels, so a reverse-level sweep refits bottom-up."""
    child = np.asarray(nodes8)[:, 48:56].astype(np.int64)
    levels = []
    cur = np.array([0], np.int64)
    while cur.size:
        levels.append(cur.astype(np.int32))
        nxt = child[cur].reshape(-1)
        cur = np.unique(nxt[nxt >= 0])
    return levels


def refit_bvh8(nodes8, levels, tri_min_sah, tri_max_sah, leaf_max: int):
    """Recompute every slot box of (M, 128) BVH8 rows from the new per-
    triangle boxes (T, 3) in SAH triangle order, keeping the topology lanes
    — tensor ops on the rows' device (tpurt ``bvh/wide.py:refit_bvh8``).
    ``levels``: refit_plan's arrays as int64 tensors on that device."""
    import torch

    m = nodes8.shape[0]
    t = tri_min_sah.shape[0]
    firsts = nodes8[:, 56:64].to(torch.int64)
    counts = nodes8[:, 64:72].to(torch.int64)
    childs = nodes8[:, 48:56].to(torch.int64)

    # leaf slot boxes: masked reduction over <= leaf_max triangles
    slot_min = torch.full((m, 8, 3), _EMPTY_MIN, dtype=torch.float32,
                          device=nodes8.device)
    slot_max = torch.full_like(slot_min, _EMPTY_MAX)
    for k in range(leaf_max):
        idx = torch.clamp(firsts + k, 0, t - 1)
        valid = (k < counts)[..., None]
        slot_min = torch.where(valid,
                               torch.minimum(slot_min, tri_min_sah[idx]),
                               slot_min)
        slot_max = torch.where(valid,
                               torch.maximum(slot_max, tri_max_sah[idx]),
                               slot_max)

    # internal slots, deepest level first: child totals are ready before
    # any parent reads them
    total_min = torch.zeros((m, 3), dtype=torch.float32,
                            device=nodes8.device)
    total_max = torch.zeros_like(total_min)
    for ids in reversed(levels):
        ch = childs[ids]                                   # (L, 8)
        is_int = (ch >= 0)[..., None]
        smin = torch.where(is_int, total_min[torch.clamp_min(ch, 0)],
                           slot_min[ids])
        smax = torch.where(is_int, total_max[torch.clamp_min(ch, 0)],
                           slot_max[ids])
        slot_min[ids] = smin
        slot_max[ids] = smax
        total_min[ids] = smin.amin(dim=1)
        total_max[ids] = smax.amax(dim=1)

    out = nodes8.clone()
    out[:, :48] = torch.cat([slot_min, slot_max], dim=2).reshape(m, 48)
    return out


def _areas(mn, mx):
    import torch

    ext = torch.clamp_min(mx - mn, 0.0)
    return 2.0 * (ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2]
                  + ext[..., 0] * ext[..., 2])


def refit_quality(nodes8, tri_min, tri_max):
    """SAH-cost proxy of a (refit) BVH8: total slot-box surface area over
    the total per-triangle box area (0-dim tensor). Triangle boxes move
    rigidly with their instance, so the ratio of this value after a refit
    to its rest-pose value is ~1 near rest and grows as the rest-pose
    grouping decays; engine/dynamic uses it for the refit -> rebuild
    trigger."""
    import torch

    boxes = nodes8[:, :48].reshape(-1, 8, 6)
    slot_area = _areas(boxes[..., 0:3], boxes[..., 3:6]).sum()
    tri_area = _areas(tri_min, tri_max).sum()
    return slot_area / torch.clamp_min(tri_area, 1e-20)
