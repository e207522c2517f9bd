"""K7a (step counts and push orders): the port's plain version against
tpurt's ``count_steps=True`` kernels (Pallas in interpret mode, ``fat=1``,
``when_push=False``), against the port's own K1/K2, and the refusals.

tpurt counts node and leaf pops per 32x32 packet, the port per ray. An
image whose every 32x32 tile holds one ray makes tpurt's count of each
packet that ray's, and there the counts are held to tpurt's where the two
are defined alike (traverse_bvh8's module docstring): exactly under
"none", plus the entries the port drops unread for a closest hit; under
every order for closest hits that miss and any hits that are not occluded.
The per-ray counts add up to the plain version's ``stats``. "nearlast"
holds back the first nearest child, tpurt's ``taken`` rule, checked on tied
keys against tpurt's push sequence.
Tolerances: against tpurt, ``t``, ``tri`` and the occlusion bit-equal on
these rays (a differing ray would have to be a tie or a grazing ray, as in
tests/test_torch_trace.py); against the port's K1, each push order's ``t``
bit-equal and ``tri`` equal except on equal-t ties; occlusion equal to K2's
for every order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_occlusion import _ray_sets
from test_torch_trace import T_MIN, _rays
from torch_parity import resident_models

ORDERS = ["sort", "nearlast", "none"]
# the per-packet images: 2 x 4 tiles of 32x32, each holding one ray
TILE, TILES = 32, (2, 4)
# the closest hit's per-packet rays: a scene where "none" drops node and
# leaf entries
PACKET_CLOSEST = ("box_field", (64, 64))
PH, PW = TILE * TILES[0], TILE * TILES[1]
# tpurt compiles its interpret-mode kernel per scene and shape: its closest
# hit runs on "ground", its any hit on "material_field"'s shadow rays
CLOSEST = ("ground", (64, 64))
ANY = ("material_field", (40, 48))


@pytest.fixture(scope="module")
def results():
    from tpurt.kernels.traverse_bvh8 import trace_any_bvh8 as ref_any
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8 as ref_closest
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.engine import convert

    out = {}
    name, (h, w) = CLOSEST
    pt = ref_flatten(resident_models(name)).as_pytree()
    o, d, t_max = _rays(h, w, seed=3)
    ref = ref_closest(pt["bvh"], pt["geom"], jnp.asarray(o), jnp.asarray(d),
                      T_MIN, jnp.asarray(t_max), height=h, width=w,
                      max_leaf=32, interpret=True, count_steps=True, fat=1,
                      when_push=False)
    out["closest"] = dict(pt=pt, scene=convert.scene_tensors(pt, "cpu"),
                          rays=(torch.tensor(o), torch.tensor(d), T_MIN,
                                torch.tensor(t_max)),
                          t_max=t_max,
                          ref={k: np.asarray(v) for k, v in ref.items()})
    name, (h, w) = ANY
    pt = ref_flatten(resident_models(name)).as_pytree()
    scene = convert.scene_tensors(pt, "cpu")
    so, sd, st_min, st_max = _ray_sets(scene, h, w)["shadow"]
    occ, node, leaf = ref_any(pt["bvh"], pt["geom"], jnp.asarray(so),
                              jnp.asarray(sd), st_min, jnp.asarray(st_max),
                              height=h, width=w, max_leaf=32, interpret=True,
                              count_steps=True, fat=1, when_push=False)
    out["any"] = dict(pt=pt, scene=scene,
                      rays=(torch.tensor(so), torch.tensor(sd), st_min,
                            torch.tensor(st_max)),
                      t_max=st_max, ref=np.asarray(occ),
                      ref_pops=(np.asarray(node), np.asarray(leaf)))
    return out


def _tile_of_pixel():
    y, x = np.divmod(np.arange(PH * PW), PW)
    return (y // TILE) * TILES[1] + x // TILE


def _pick(pops, groups):
    """For each (mask, n) of `groups`, the n rays of the mask with the most
    pops (ties by index)."""
    picks = []
    for mask, n in groups:
        cand = np.flatnonzero(mask)
        picks += list(cand[np.argsort(-pops[cand], kind="stable")[:n]])
    return np.asarray(picks)


def _per_packet(ref, key):
    """tpurt's output `key` per tile, after checking it is uniform there."""
    x = np.asarray(ref[key])
    per_tile = x.reshape(PH, PW)[::TILE, ::TILE].reshape(-1)
    np.testing.assert_array_equal(x, per_tile[_tile_of_pixel()])
    return per_tile


def _dropped(scene, rays, order):
    """Each ray's (dropped node pops, dropped leaf pops) under `order`, from
    one plain closest-hit trace per ray."""
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_plain

    o, d, t_min, t_max = rays
    out = []
    for i in range(o.shape[0]):
        stats = {}
        trace_closest_plain(scene, o[i:i + 1], d[i:i + 1], t_min,
                            t_max[i:i + 1], stats=stats, push_order=order)
        out.append((int(stats.get("dropped_node_pops", 0)),
                    int(stats.get("dropped_leaf_pops", 0))))
    return np.asarray(out, np.float32).reshape(-1, 2)


def _pools(results):
    """Per kind: the port's scene, tpurt's pytree, a pool of rays and the
    picked ones. Closest, on PACKET_CLOSEST's camera rays: the 3 and 2 hits
    of the most dropped node and leaf pops under "none" (of the 100 hits
    with the most pops), the 2 misses with the most pops and a ray with
    t_max = 0. Any, on results' shadow rays: the 4 occluded and 3 clear
    rays with the most pops and a ray with t_max = 0."""
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_plain,
                                                   trace_closest_plain)

    name, (h, w) = PACKET_CLOSEST
    pt = ref_flatten(resident_models(name)).as_pytree()
    scene = convert.scene_tensors(pt, "cpu")
    o, d, t_max = _rays(h, w, seed=3)
    rays = (torch.tensor(o), torch.tensor(d), T_MIN, torch.tensor(t_max))
    hits = trace_closest_plain(scene, *rays, count_steps=True,
                               push_order="none")
    pops = (hits["u"] + hits["v"]).numpy()
    hit, dead = hits["tri"].numpy() >= 0, t_max == 0.0
    cand = _pick(pops, [(hit, 100)])
    sel = torch.tensor(cand)
    dropped = _dropped(scene, (rays[0][sel], rays[1][sel], T_MIN,
                               rays[3][sel]), "none")
    by_node = cand[np.argsort(-dropped[:, 0], kind="stable")[:3]]
    rest = ~np.isin(cand, by_node)
    by_leaf = cand[rest][np.argsort(-dropped[rest, 1], kind="stable")[:2]]
    closest = dict(pt=pt, scene=scene, rays=rays, picks=np.concatenate([
        by_node, by_leaf, _pick(pops, [(~hit & ~dead, 2), (dead, 1)])]))

    r = results["any"]
    occ, node, leaf = trace_any_plain(r["scene"], *r["rays"],
                                      count_steps=True, push_order="none")
    occ, pops, dead = occ.numpy(), (node + leaf).numpy(), r["t_max"] == 0.0
    any_ = dict(pt=r["pt"], scene=r["scene"], rays=r["rays"], picks=_pick(
        pops, [(occ, 4), (~occ & ~dead, 3), (dead, 1)]))
    return dict(closest=closest, any=any_)


@pytest.fixture(scope="module")
def packets(results):
    """tpurt's counted traces of images whose tiles each repeat one picked
    ray (_pools), for every order, beside the port's plain version on the
    picked rays and, for the closest hit, each ray's dropped pops."""
    from tpurt.kernels.traverse_bvh8 import trace_any_bvh8 as ref_any
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8 as ref_closest
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_plain,
                                                   trace_closest_plain)

    out = {}
    for kind, pool in _pools(results).items():
        assert len(set(pool["picks"])) == TILES[0] * TILES[1]
        sel = torch.tensor(pool["picks"])
        o, d, t_min, t_max = pool["rays"]
        rays = (o[sel], d[sel], t_min, t_max[sel])
        img = _tile_of_pixel()
        o_img, d_img = jnp.asarray(rays[0][img].numpy()), \
            jnp.asarray(rays[1][img].numpy())
        tmax_img = jnp.asarray(rays[3][img].numpy())
        bvh, geom = pool["pt"]["bvh"], pool["pt"]["geom"]
        per_order = {}
        for order in ORDERS:
            kw = dict(height=PH, width=PW, max_leaf=32, interpret=True,
                      count_steps=True, fat=1, when_push=False,
                      push_order=order)
            if kind == "closest":
                ref = ref_closest(bvh, geom, o_img, d_img, t_min, tmax_img,
                                  **kw)
                ref = dict(t=ref["t"], tri=ref["tri"], node=ref["u"],
                           leaf=ref["v"])
                got = trace_closest_plain(pool["scene"], *rays,
                                          count_steps=True, push_order=order)
                got = dict(t=got["t"], tri=got["tri"], node=got["u"],
                           leaf=got["v"])
            else:
                ref = dict(zip(("occ", "node", "leaf"), ref_any(
                    bvh, geom, o_img, d_img, t_min, tmax_img, **kw)))
                got = dict(zip(("occ", "node", "leaf"), trace_any_plain(
                    pool["scene"], *rays, count_steps=True,
                    push_order=order)))
            p = {k: v.numpy() for k, v in got.items()}
            p.update({"ref_" + k: _per_packet(ref, k) for k in got})
            if kind == "closest":
                p["dropped_node"], p["dropped_leaf"] = \
                    _dropped(pool["scene"], rays, order).T
            per_order[order] = p
        out[kind] = per_order
    return out


@pytest.mark.parametrize("order", ORDERS)
def test_closest_counts_equal_tpurt_per_packet(packets, order):
    """t and tri equal tpurt's for every order. tpurt pops every pushed
    entry; the port drops the ones beyond the current hit unread. Under
    "none" (slot order in both) tpurt's counts are the port's plus the
    dropped pops; a ray that misses drops nothing and visits every box it
    enters in any order, so its counts are tpurt's under every order."""
    p = packets["closest"][order]
    np.testing.assert_array_equal(p["t"].view(np.int32),
                                  p["ref_t"].view(np.int32))
    np.testing.assert_array_equal(p["tri"], p["ref_tri"])
    miss = p["tri"] < 0
    assert miss.sum() == 3 and (p["node"][miss] >= 1).all()
    for k in ("node", "leaf"):
        np.testing.assert_array_equal(p[k][miss], p["ref_" + k][miss])
        assert not p["dropped_" + k][miss].any()
        if order == "none":
            np.testing.assert_array_equal(p[k] + p["dropped_" + k],
                                          p["ref_" + k])
    if order == "none":
        assert p["dropped_node"].sum() > 0 and p["dropped_leaf"].sum() > 0


@pytest.mark.parametrize("order", ORDERS)
def test_any_counts_equal_tpurt_per_packet(packets, order):
    """Occlusion equal to tpurt's for every order; counts equal under
    "none" (slot order in both), and under every order for the rays that
    are not occluded, which visit every box they enter."""
    p = packets["any"][order]
    np.testing.assert_array_equal(p["occ"], p["ref_occ"])
    clear = ~p["occ"]
    assert p["occ"].sum() == 4 and clear.sum() == 4
    for k in ("node", "leaf"):
        np.testing.assert_array_equal(p[k][clear], p["ref_" + k][clear])
        if order == "none":
            np.testing.assert_array_equal(p[k], p["ref_" + k])
    assert (p["node"] + p["leaf"] > 0).sum() == 7


def _tpurt_nearlast(keys, codes):
    """tpurt's push_nearlast (tpurt/kernels/traverse_bvh8.py:275-298) on
    host lists: the codes it leaves on the stack, bottom first."""
    neg = -3.0e38
    bk, bc = keys[0], codes[0]
    for k in range(1, 8):
        if keys[k] > bk:
            bk, bc = keys[k], codes[k]
    stack, taken = [], False
    for k in range(8):
        is_best = keys[k] == bk and codes[k] == bc and not taken
        taken = taken or is_best
        if keys[k] > neg / 2 and not is_best:
            stack.append(codes[k])
    if bk > neg / 2:
        stack.append(bc)
    return stack


def test_nearlast_holds_back_the_first_nearest():
    """The port's "nearlast" pushes equal tpurt's push sequence with the
    entry distance as key (nearer = larger key): on tied distances the
    first such slot is held back and pushed last."""
    from tpurt_torch.kernels.traverse_bvh8 import _order_keys, _push

    rng = np.random.default_rng(7)
    n = 300
    tnear = torch.tensor(rng.choice([0.5, 1.0, 1.0, 2.0, 3.0], (n, 8)),
                         dtype=torch.float32)
    hit = torch.tensor(rng.random((n, 8)) < 0.6)
    codes = torch.arange(8, dtype=torch.int32).repeat(n, 1) + 10
    table = torch.zeros((n, 9), dtype=torch.int32)
    sp = torch.zeros(n, dtype=torch.int64)
    _push((table,), sp, torch.arange(n), hit,
          _order_keys("nearlast", tnear, hit), (codes,), 8)
    ties = 0
    for i in range(n):
        keys = [-float(x) if h else -3.0e38
                for x, h in zip(tnear[i], hit[i])]
        want = _tpurt_nearlast(keys, codes[i].tolist())
        assert table[i, :int(sp[i])].tolist() == want, i
        near = [x for x, h in zip(tnear[i].tolist(), hit[i]) if h]
        ties += bool(near) and near.count(min(near)) > 1
    assert ties >= 20


def _closest(r, **kw):
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8

    return {k: v.numpy() for k, v in trace_closest_bvh8(
        r["scene"], *r["rays"], **kw).items()}


def _any(r, **kw):
    from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8

    out = trace_any_bvh8(r["scene"], *r["rays"], **kw)
    return [x.numpy() for x in out] if isinstance(out, tuple) else out.numpy()


def test_counted_closest_equals_tpurt(results):
    r = results["closest"]
    got, ref = _closest(r, count_steps=True), r["ref"]
    np.testing.assert_array_equal(got["t"].view(np.int32),
                                  ref["t"].view(np.int32))
    np.testing.assert_array_equal(got["tri"], ref["tri"])
    # both return counts in u and v: whole numbers, no barycentrics
    for k in ("u", "v"):
        assert (got[k] == np.round(got[k])).all() and got[k].max() >= 1
        assert (ref[k] == np.round(ref[k])).all() and ref[k].max() >= 1
    assert (got["tri"] >= 0).sum() >= 50 and (got["tri"] < 0).any()


def test_counted_any_equals_tpurt(results):
    r = results["any"]
    occ, node, leaf = _any(r, count_steps=True)
    np.testing.assert_array_equal(occ, r["ref"])
    assert occ.any() and not occ[r["t_max"] == 0.0].any()
    assert all((p == np.round(p)).all() for p in r["ref_pops"])


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("order", ORDERS)
def test_count_sums_equal_stats(results, kind, order):
    """Per-ray counts that add up to the plain traversal's work counters;
    counting changes no hit."""
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_plain,
                                                   trace_closest_plain)

    r = results[kind]
    stats = {}
    if kind == "closest":
        h = trace_closest_plain(r["scene"], *r["rays"], stats=stats,
                                count_steps=True, push_order=order)
        node, leaf = h["u"], h["v"]
        same = _closest(r, push_order=order)
        assert torch.equal(h["t"], torch.tensor(same["t"]))
        assert torch.equal(h["tri"], torch.tensor(same["tri"]))
    else:
        occ, node, leaf = trace_any_plain(r["scene"], *r["rays"], stats=stats,
                                          count_steps=True, push_order=order)
        np.testing.assert_array_equal(occ.numpy(),
                                      _any(r, push_order=order))
    assert node.dtype == leaf.dtype == torch.float32
    assert int(node.sum()) == int(stats["node_pops"]) > 0
    assert int(leaf.sum()) == int(stats["leaf_pops"]) > 0
    # a ray with t_max = 0: the any hit retires it at once; the closest hit
    # reads the root's row, whose children all lie beyond t = 0
    dead = torch.tensor(r["t_max"] == 0.0)
    assert bool(dead.any()) and not bool(leaf[dead].any())
    assert bool((node[dead] == (1 if kind == "closest" else 0)).all())
    assert bool((node[~dead] >= 1).all())


@pytest.mark.parametrize("order", ORDERS)
def test_push_order_keeps_hits(results, order):
    """t bit-equal to K1's and tri off only on equal-t ties (none for
    "sort", K1's own order); occlusion equal to K2's."""
    r = results["closest"]
    k1, got = _closest(r), _closest(r, push_order=order)
    np.testing.assert_array_equal(got["t"].view(np.int32),
                                  k1["t"].view(np.int32))
    differ = got["tri"] != k1["tri"]
    # a differing tri hits at the same t (bit-equal above): a tie
    assert ((got["tri"][differ] >= 0) & (k1["tri"][differ] >= 0)).all()
    if order == "sort":
        assert not differ.any()
    assert differ.mean() <= 1e-3
    a = results["any"]
    np.testing.assert_array_equal(_any(a, push_order=order), _any(a))


def test_orders_change_the_visit(results):
    """The three orders are different traversals: their counts differ."""
    r = results["closest"]
    leaf = {o: _closest(r, count_steps=True, push_order=o)["v"].sum()
            for o in ORDERS}
    assert len(set(leaf.values())) >= 2, leaf


def test_refusals(results, monkeypatch):
    """tpurt's: counting composes with neither the two-pop trace nor the
    uv payload; the two-pop trace has one push order; no unknown order.
    pop2=None and uv_payload=None resolve off for a counted trace."""
    from tpurt_torch.kernels import traverse_bvh8 as tb

    r = results["closest"]
    sc, rays = r["scene"], r["rays"]
    for fn in (tb.trace_closest_bvh8, tb.trace_any_bvh8):
        with pytest.raises(ValueError, match="count_steps"):
            fn(sc, *rays, pop2=True, count_steps=True)
        with pytest.raises(ValueError, match="push_order"):
            fn(sc, *rays, pop2=True, push_order="none")
        with pytest.raises(ValueError, match="push_order"):
            fn(sc, *rays, push_order="random")
    assert "uvp" in sc
    with pytest.raises(ValueError, match="count_steps"):
        tb.trace_closest_bvh8(sc, *rays, uv_payload=True, count_steps=True)
    with pytest.raises(ValueError, match="push_order"):
        tb.trace_closest_bvh8(sc, *rays, uv_payload=True,
                              push_order="nearlast")
    monkeypatch.setattr(tb, "POP2_DEFAULT", True)
    monkeypatch.setattr(tb, "UVP_DEFAULT", True)
    hits = tb.trace_closest_bvh8(sc, *rays, count_steps=True)
    assert "texu" not in hits
    np.testing.assert_array_equal(hits["u"].numpy(),
                                  _closest(r, count_steps=True, pop2=False,
                                           uv_payload=False)["u"])
    assert len(tb.trace_any_bvh8(sc, *rays, count_steps=True)) == 3
