"""Brute-force Moeller-Trumbore ray casting in plain torch, sped up by a
two-level box hierarchy of the reference's own.

The triangles are sorted by the Morton code of their centroids and cut into
leaves of LEAF triangles, the leaves into groups of GROUP leaves. A ray is
slab-tested against every group box, then against the leaves of the groups
it enters, and then against every triangle of the leaves it enters, in two
rounds: first each ray's ROUND1 nearest leaves, then, for a closest hit,
the rest of the leaves that begin before its best hit so far, and for an
any hit, every other leaf of the rays still unoccluded. The triangle test
is tests/oracle.py's ``_moeller_trumbore``: det, u, v, t by cross and dot
products, a hit where |det| > 1e-12, u, v >= 0, u + v <= 1 and t_min < t <
t_max. Among hits at the same t the lowest triangle index wins.

Each trace also says which rays it cannot decide. A ray is undecided when
the answer changes within a tolerance EPS: with every triangle grown by
EPS in barycentric terms and the ray's t range widened by EPS of its ends
(the loose test) it finds a hit that, with every triangle shrunk and the
range narrowed alike (the strict test), it does not: an any hit whose only
occluder ends at t_max or touches an edge, a closest hit whose nearest
loose hit lies before its strict one. There the answer rests on the last
bits of the arithmetic, and two sound renderers may differ; the strict
answer is the reference's.

Nothing here reads the program's tables: the boxes come from the
triangles alone. They and the slab tests are float32 in every precision,
and each box is widened by PAD of its coordinates' magnitude (plus PAD), so
that no rounding in the slab test drops a triangle the triangle test
would hit; only the triangle test runs in the triangles' dtype. Work is
done in blocks so that no temporary grows past a few hundred MB.
"""
from __future__ import annotations

import torch

LEAF = 32
GROUP = 32
ROUND1 = 4
RAY_BLOCK = 1 << 16
PAIR_BLOCK = 1 << 20   # leaf pairs expanded to triangles at once
PAD = 1e-4
EPS = 1e-4


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _morton(c):
    """30-bit Morton codes of points c (T, 3) in their bounding box."""
    lo = c.amin(0)
    span = torch.clamp_min(c.amax(0) - lo, 1e-12)
    q = ((c - lo) / span * 1023.0).clamp(0, 1023).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class Triangles:
    """The triangles v0, v1, v2 (T, 3) with the reference's box
    hierarchy: the triangle tables in their dtype, the boxes in float32."""

    def __init__(self, v0, v1, v2):
        dev, dt = v0.device, v0.dtype
        n = v0.shape[0]
        cent = ((v0 + v1 + v2) / 3.0).to(torch.float32)
        order = torch.argsort(_morton(cent), stable=True)
        per_group = LEAF * GROUP
        padded = -(-n // per_group) * per_group
        pad = padded - n
        # padding: degenerate triangles far away (det = 0: never a hit)
        far = torch.full((pad, 3), 1e30, dtype=dt, device=dev)

        def sort(v):
            return torch.cat([v[order], far])

        self.tri_id = torch.cat([order, torch.full(
            (pad,), -1, dtype=torch.int64, device=dev)])
        self.v0 = sort(v0)
        self.e1 = sort(v1) - self.v0
        self.e2 = sort(v2) - self.v0
        corners = torch.stack([sort(v0), sort(v1), sort(v2)], 1).float()
        real = (self.tri_id >= 0)[:, None]
        big = torch.tensor(float("inf"), device=dev)
        lo = corners.amin(1)
        hi = corners.amax(1)
        lo = torch.where(real, lo - PAD * (1.0 + lo.abs()), big)
        hi = torch.where(real, hi + PAD * (1.0 + hi.abs()), -big)
        self.leaf_lo = lo.view(-1, LEAF, 3).amin(1)
        self.leaf_hi = hi.view(-1, LEAF, 3).amax(1)
        self.group_lo = self.leaf_lo.view(-1, GROUP, 3).amin(1)
        self.group_hi = self.leaf_hi.view(-1, GROUP, 3).amax(1)


def _slab(o, inv, lo, hi):
    """Entry and exit t of rays (o, inv) (..., 3) through boxes lo, hi."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return tn, tf


def _leaf_pairs(tris: Triangles, o, inv, t_min, t_max):
    """(ray, leaf, entry t) of every leaf box each ray enters within
    [t_min, t_max]."""
    tn, tf = _slab(o[:, None], inv[:, None], tris.group_lo[None],
                   tris.group_hi[None])
    hit = (tn <= tf) & (tf >= t_min) & (tn <= t_max[:, None])
    ray, grp = torch.nonzero(hit, as_tuple=True)
    leaf = (grp[:, None] * GROUP + torch.arange(
        GROUP, device=o.device)[None]).reshape(-1)
    ray = ray.repeat_interleave(GROUP)
    tn, tf = _slab(o[ray], inv[ray], tris.leaf_lo[leaf], tris.leaf_hi[leaf])
    keep = (tn <= tf) & (tf >= t_min) & (tn <= t_max[ray])
    return ray[keep], leaf[keep], torch.clamp_min(tn[keep], t_min)


def _first_rank(ray, tn):
    """Order pairs by (ray, entry t) and return (order, rank of each pair
    within its ray)."""
    order = torch.argsort(tn, stable=True)
    order = order[torch.argsort(ray[order], stable=True)]
    r = ray[order]
    idx = torch.arange(r.shape[0], device=r.device)
    start = torch.zeros_like(idx)
    if r.shape[0]:
        new = torch.ones_like(r, dtype=torch.bool)
        new[1:] = r[1:] != r[:-1]
        start = torch.cummax(torch.where(new, idx, torch.zeros_like(idx)),
                             0).values
    return order, idx - start


def _test(tris: Triangles, o, d, ray, leaf, t_min, t_max):
    """Moeller-Trumbore over every triangle of each (ray, leaf) pair:
    (ray, slot, t, strict hit, loose hit) per triangle."""
    slot = (leaf[:, None] * LEAF + torch.arange(
        LEAF, device=o.device)[None]).reshape(-1)
    ray = ray.repeat_interleave(LEAF)
    dd = d[ray]
    e1, e2 = tris.e1[slot], tris.e2[slot]
    p = _cross(dd, e2)
    det = _dot(e1, p)
    valid = torch.abs(det) > 1e-12
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det,
                                                   torch.ones_like(det)),
                          torch.zeros_like(det))
    tvec = o[ray] - tris.v0[slot]
    u = _dot(tvec, p) * inv_det
    q = _cross(tvec, e1)
    v = _dot(dd, q) * inv_det
    t = _dot(e2, q) * inv_det
    tm = t_max[ray]
    hit = (valid & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > t_min)
           & (t < tm))
    strict = (hit & (u >= EPS) & (v >= EPS) & (u + v <= 1.0 - EPS)
              & (t > t_min * (1 + EPS)) & (t < tm * (1 - EPS)))
    loose = (valid & (u >= -EPS) & (v >= -EPS) & (u + v <= 1.0 + EPS)
             & (t > t_min * (1 - EPS)) & (t < tm * (1 + EPS)))
    return ray, slot, t, hit, strict, loose


def _blocks(n, size):
    for s in range(0, n, size):
        yield s, min(s + size, n)


def _inverse(d):
    d = d.float()
    return 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)


def _pairs(tris, o, d, t_min, t_max):
    """The leaf pairs of a block of rays, ordered by (ray, entry t), and
    which are among each ray's ROUND1 nearest."""
    ray, leaf, tn = _leaf_pairs(tris, o.float(), _inverse(d), t_min,
                                t_max.float() * (1 + EPS))
    order, rank = _first_rank(ray, tn)
    return ray[order], leaf[order], tn[order], rank < ROUND1


def _closest_block(tris, o, d, t_min, t_max):
    n = o.shape[0]
    best = t_max.clone()
    loose_t = t_max.clone()
    strict_t = t_max.clone()
    ray, leaf, tn, first = _pairs(tris, o, d, t_min, t_max)
    hits = []
    for sel in (first, None):
        if sel is None:   # round 2: leaves that begin before the best hit
            reach = torch.maximum(best, strict_t)[ray].float()
            sel = (~first) & (tn <= reach * (1.0 + 2 * EPS) + PAD)
        r_sel, l_sel = ray[sel], leaf[sel]
        for s, e in _blocks(r_sel.shape[0], PAIR_BLOCK):
            rr, slot, t, hit, strict, loose = _test(
                tris, o, d, r_sel[s:e], l_sel[s:e], t_min, t_max)
            hits.append((rr[hit], slot[hit], t[hit]))
            best.scatter_reduce_(0, rr[hit], t[hit], "amin")
            strict_t.scatter_reduce_(0, rr[strict], t[strict], "amin")
            loose_t.scatter_reduce_(0, rr[loose], t[loose], "amin")
    best_slot = torch.full((n,), torch.iinfo(torch.int64).max,
                           dtype=torch.int64, device=o.device)
    for rr, slot, t in hits:
        win = t == best[rr]
        best_slot.scatter_reduce_(0, rr[win], tris.tri_id[slot[win]], "amin")
    undecided = loose_t < strict_t * (1 - EPS)
    return best, best_slot, undecided


def closest_hit(tris: Triangles, v0, v1, v2, o, d, t_min: float, t_max):
    """Per ray the closest hit: (t, tri (-1: none), u, v, undecided), with
    u and v recomputed on the original triangle tables v0, v1, v2."""
    ts, tri, und = [], [], []
    for s, e in _blocks(o.shape[0], RAY_BLOCK):
        t, slot, u = _closest_block(tris, o[s:e], d[s:e], t_min,
                                    t_max[s:e])
        ts.append(t)
        tri.append(slot)
        und.append(u)
    t = torch.cat(ts)
    tri = torch.cat(tri)
    found = tri != torch.iinfo(torch.int64).max
    tri = torch.where(found, tri, torch.full_like(tri, -1))
    k = torch.clamp_min(tri, 0)
    a = v0[k]
    e1, e2 = v1[k] - a, v2[k] - a
    p = _cross(d, e2)
    det = _dot(e1, p)
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tvec = o - a
    u = _dot(tvec, p) * inv_det
    v = _dot(d, _cross(tvec, e1)) * inv_det
    zero = torch.zeros_like(u)
    return (torch.where(found, t, t_max), tri, torch.where(found, u, zero),
            torch.where(found, v, zero), torch.cat(und))


def any_hit(tris: Triangles, o, d, t_min: float, t_max):
    """Per ray (occluded, undecided): whether a triangle lies within
    (t_min, t_max), and whether the loose and strict tests disagree."""
    occ_all, und_all = [], []
    for s, e in _blocks(o.shape[0], RAY_BLOCK):
        ob, db, tm = o[s:e], d[s:e], t_max[s:e]
        occ = torch.zeros(ob.shape[0], dtype=torch.bool, device=o.device)
        strict_occ = torch.zeros_like(occ)
        loose_occ = torch.zeros_like(occ)
        ray, leaf, _, first = _pairs(tris, ob, db, t_min, tm)
        for sel in (first, None):
            if sel is None:   # round 2: rays with no strict occluder yet
                sel = (~first) & ~strict_occ[ray]
            r_sel, l_sel = ray[sel], leaf[sel]
            for s2, e2 in _blocks(r_sel.shape[0], PAIR_BLOCK):
                rr, _, _, hit, strict, loose = _test(
                    tris, ob, db, r_sel[s2:e2], l_sel[s2:e2], t_min, tm)
                occ[rr[hit]] = True
                strict_occ[rr[strict]] = True
                loose_occ[rr[loose]] = True
        occ_all.append(occ)
        und_all.append(loose_occ & ~strict_occ)
    return torch.cat(occ_all), torch.cat(und_all)
