"""K7b (two pops per iteration): the port's plain version against the
port's one-pop K1/K2 and against tpurt's ``pop2=True`` kernels (Pallas in
interpret mode, ``fat=1``); the two-pop stack bound; tpurt's composition
refusals; the call-time resolution of ``POP2_DEFAULT`` / ``UVP_DEFAULT``.

Tolerances: against the port's K1, ``t`` bit-equal and ``tri`` equal except
on equal-t ties (the visit order differs; t is order-free); against K2,
occlusion equal. Against tpurt, as tests/test_torch_trace.py and
tests/test_torch_occlusion.py hold K1 and K2: ``tri``/``occ`` equal on
>= 99.9% of rays with every difference a tie or grazing, and where ``tri``
agrees ``t`` within 2 ULP and ``u``/``v`` within 1e-5 (XLA:CPU contracts
tpurt's Moller-Trumbore into FMAs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_occlusion import _ray_sets
from test_torch_trace import T_MAX, T_MIN, _rays
from torch_parity import (HitClassifier, classify_closest,
                          classify_occlusion, resident_models, ulp_diff)

# (scene, (height, width)): 40x48 is not a multiple of tpurt's 32x32 tile.
# tpurt compiles each interpret-mode kernel per scene and shape: its
# closest hit runs on "ground", its any hit on "material_field"'s shadow
# rays.
CASES = [("ground", (64, 64)), ("material_field", (40, 48))]


@pytest.fixture(scope="module")
def results():
    from tpurt.kernels.traverse_bvh8 import trace_any_bvh8 as ref_any
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8 as ref_closest
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_closest_bvh8)

    out = {}
    for i, (name, (h, w)) in enumerate(CASES):
        pt = ref_flatten(resident_models(name)).as_pytree()
        scene = convert.scene_tensors(pt, "cpu")
        o, d, t_max = _rays(h, w, seed=i)
        rays = [torch.tensor(x) for x in (o, d)] + [torch.tensor(t_max)]
        r = dict(scene=scene, o=o, d=d, t_max=t_max,
                 cls=HitClassifier(pt["bvh"]["nodes8"], pt["geom"]))
        r["k1"] = trace_closest_bvh8(scene, *rays[:2], T_MIN, rays[2],
                                     pop2=False)
        r["pop2"] = trace_closest_bvh8(scene, *rays[:2], T_MIN, rays[2],
                                       pop2=True)
        if name == "ground":
            ref = ref_closest(pt["bvh"], pt["geom"], jnp.asarray(o),
                              jnp.asarray(d), T_MIN, jnp.asarray(t_max),
                              height=h, width=w, max_leaf=32,
                              interpret=True, pop2=True, fat=1)
            r["ref"] = {k: np.asarray(v) for k, v in ref.items()}
        else:
            so, sd, st_min, st_max = _ray_sets(scene, h, w)["shadow"]
            sr = [torch.tensor(x) for x in (so, sd, st_max)]
            r["shadow"] = dict(
                o=so, d=sd, t_min=st_min, t_max=st_max,
                k2=trace_any_bvh8(scene, sr[0], sr[1], st_min, sr[2],
                                  pop2=False).numpy(),
                pop2=trace_any_bvh8(scene, sr[0], sr[1], st_min, sr[2],
                                    pop2=True).numpy(),
                ref=np.asarray(ref_any(
                    pt["bvh"], pt["geom"], jnp.asarray(so), jnp.asarray(sd),
                    st_min, jnp.asarray(st_max), height=h, width=w,
                    max_leaf=32, interpret=True, pop2=True, fat=1)))
        out[name] = r
    return out


def _np(hits):
    return {k: v.numpy() for k, v in hits.items()}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pop2_closest_equals_k1(name, results):
    r = results[name]
    k1, p2 = _np(r["k1"]), _np(r["pop2"])
    np.testing.assert_array_equal(p2["t"].view(np.int32),
                                  k1["t"].view(np.int32))
    same = p2["tri"] == k1["tri"]
    # a differing tri is an equal-t tie (t is bit-equal above)
    assert same.mean() >= 0.999
    for k in ("u", "v"):
        np.testing.assert_array_equal(p2[k][same], k1[k][same])
    assert (p2["tri"] >= 0).sum() >= 50 and (p2["tri"] < 0).any()


def test_pop2_any_equals_k2(results):
    s = results["material_field"]["shadow"]
    np.testing.assert_array_equal(s["pop2"], s["k2"])
    assert s["pop2"].any() and not s["pop2"][s["t_max"] == 0.0].any()


def test_pop2_closest_agrees_with_tpurt(results):
    r = results["ground"]
    ref, got = r["ref"], _np(r["pop2"])
    same = ref["tri"] == got["tri"]
    assert same.mean() >= 0.999, f"tri agrees on {same.mean():.5f}"
    assert ulp_diff(ref["t"][same], got["t"][same]).max() <= 2
    assert np.abs(ref["u"][same] - got["u"][same]).max() <= 1e-5
    assert np.abs(ref["v"][same] - got["v"][same]).max() <= 1e-5
    kinds = classify_closest(r["cls"], ref, got, r["o"], r["d"], T_MIN,
                             np.float32(T_MAX))
    assert kinds["other"] == 0, kinds


def test_pop2_any_agrees_with_tpurt(results):
    r = results["material_field"]
    s = r["shadow"]
    assert (s["ref"] == s["pop2"]).mean() >= 0.999
    kinds = classify_occlusion(r["cls"], s["ref"], s["pop2"], s["o"], s["d"],
                               s["t_min"], s["t_max"])
    assert kinds["other"] == 0, kinds


def test_stack_bounds():
    """One pop: 7 D + 1 entries; two pops: 14 D - 6 (8 for a lone root),
    so the kernels' 192 entries take two-pop trees up to D = 14. The plain
    traversals' deepest stacks stay within the bounds on random scenes of
    several depths."""
    from test_bvh import random_tris
    from tpurt_torch.bvh import build_bvh_sah, collapse8
    from tpurt_torch.bvh.flat import tri_aabbs
    from tpurt_torch.bvh.wide import compact_bvh8
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh8 import (STACK_SIZE,
                                                   stack_entries,
                                                   trace_any_plain,
                                                   trace_closest_plain)

    assert [stack_entries(d, 2) for d in (1, 2, 3, 5)] == [8, 22, 36, 64]
    assert [stack_entries(d) for d in (1, 5)] == [8, 36]
    assert stack_entries(14, 2) <= STACK_SIZE < stack_entries(15, 2)
    rng = np.random.default_rng(3)
    depths = set()
    for n_tris, leaf in ((60, 1), (400, 1), (2000, 4)):
        v0, v1, v2 = random_tris(n_tris, seed=n_tris, spread=4.0, size=0.6)
        bvh = build_bvh_sah(*tri_aabbs(v0, v1, v2), max_leaf_size=leaf)
        nodes8, depth8 = collapse8(bvh.as_pytree())
        order = np.asarray(bvh.tri_order)
        geom = dict(v0=v0[order], e1=v1[order] - v0[order],
                    e2=v2[order] - v0[order], tri_id=order.astype(np.int32))
        scene = dict(nodes8=torch.tensor(nodes8), depth8=depth8,
                     nodes8c=compact_bvh8(torch.tensor(nodes8)),
                     tris=torch.tensor(convert.pack_tris(geom)))
        depths.add(depth8)
        o = torch.tensor(rng.uniform(-6, 6, (2000, 3)), dtype=torch.float32)
        d = torch.nn.functional.normalize(
            torch.tensor(rng.normal(size=(2000, 3)), dtype=torch.float32),
            dim=1)
        for pop2 in (False, True):
            bound = stack_entries(depth8, 2 if pop2 else 1)
            for fn in (trace_closest_plain, trace_any_plain):
                stats = {}
                fn(scene, o, d, 1e-3, 100.0, stats=stats, pop2=pop2)
                assert 1 <= stats["max_stack"] <= bound
    assert len(depths) >= 2


def test_pop2_refuses_a_tree_too_deep(results):
    """The two-pop wrappers refuse a tree whose stack could overflow; the
    one-pop ones take it (nothing is clamped)."""
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_any_bvh8_multi,
                                                   trace_closest_bvh8)

    r = results["material_field"]
    deep = dict(r["scene"], depth8=15)
    o, d = torch.tensor(r["o"]), torch.tensor(r["d"])
    for fn in (trace_closest_bvh8, trace_any_bvh8):
        with pytest.raises(ValueError, match="stack"):
            fn(deep, o, d, T_MIN, T_MAX, pop2=True)
        fn(deep, o, d, T_MIN, T_MAX, pop2=False)
    with pytest.raises(ValueError, match="stack"):
        trace_any_bvh8_multi(deep, o, [d, d], T_MIN, [T_MAX, T_MAX],
                             pop2=True)
    too_deep = dict(r["scene"], depth8=28)  # 7 * 28 + 1 > 192
    with pytest.raises(ValueError, match="stack"):
        trace_closest_bvh8(too_deep, o, d, T_MIN, T_MAX, pop2=False)


def test_composition_refusals(results):
    """tpurt's rules: the uv payload rides only the one-pop closest trace,
    and needs the scene's uvp table."""
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8

    r = results["material_field"]
    o, d = torch.tensor(r["o"]), torch.tensor(r["d"])
    assert "uvp" in r["scene"]
    with pytest.raises(ValueError, match="one-pop"):
        trace_closest_bvh8(r["scene"], o, d, T_MIN, T_MAX, pop2=True,
                           uv_payload=True)
    bare = {k: v for k, v in r["scene"].items() if k != "uvp"}
    with pytest.raises(ValueError, match="uvp"):
        trace_closest_bvh8(bare, o, d, T_MIN, T_MAX, uv_payload=True)


def test_defaults_resolve_at_call_time(results, monkeypatch):
    """POP2_DEFAULT and UVP_DEFAULT are read when a trace is called, under
    tpurt's conditions: the payload only where the scene has uvp and the
    trace is one-pop."""
    from tpurt_torch.kernels import traverse_bvh8 as tb

    r = results["material_field"]
    o, d = torch.tensor(r["o"]), torch.tensor(r["d"])
    t_max = torch.tensor(r["t_max"])
    deep = dict(r["scene"], depth8=15)
    bare = {k: v for k, v in r["scene"].items() if k != "uvp"}
    assert "texu" not in tb.trace_closest_bvh8(r["scene"], o, d, T_MIN, T_MAX)
    tb.trace_closest_bvh8(deep, o, d, T_MIN, T_MAX)
    monkeypatch.setattr(tb, "UVP_DEFAULT", True)
    assert "texu" in tb.trace_closest_bvh8(r["scene"], o, d, T_MIN, T_MAX)
    assert "texu" not in tb.trace_closest_bvh8(bare, o, d, T_MIN, T_MAX)
    monkeypatch.setattr(tb, "POP2_DEFAULT", True)
    # pop2 now resolves on: the deep tree is refused, and no payload
    for fn in (tb.trace_closest_bvh8, tb.trace_any_bvh8):
        with pytest.raises(ValueError, match="stack"):
            fn(deep, o, d, T_MIN, T_MAX)
    hits = tb.trace_closest_bvh8(r["scene"], o, d, T_MIN, t_max)
    assert "texu" not in hits
    np.testing.assert_array_equal(hits["t"].numpy(),
                                  r["pop2"]["t"].numpy())
