"""K7a (step counts, push orders) and K7b (two pops) over the compact node
table: the port's plain versions, which read ``nodes8c`` as
``csrc/bvh8_variants.cu`` does, against the same traversals over the
``nodes8`` rows and against tpurt's ``_kernel_bvh8`` / ``_kernel_bvh8_pop2``
(Pallas in interpret mode, ``fat=1, when_push=False`` pinned: ROADMAP F5);
the frame's shape as a layout only (``tile_rays``); the two-pop stack
instantiation; the steps probe's warps of 8x4 pixels.

Cases: the triangle soups of tests/torch_closest_cases.py ("dup_leaves",
"dup_merged": every triangle twice, so equal-t ties and, in
"dup_leaves", sibling slots with identical boxes; "deep": a 9-level tree)
on a ragged 12 x 20 frame of centroid, vertex (grazing), axis-aligned and
random rays with t_max 100, short, 0, equal to t_min and negative; and
"material_field" on tpurt's camera rays of the same frame, with t_max 1e4,
3 and 0. Every variant: the closest hit counted at "sort", at "nearlast"
and "none" counted and not, and two-pop; the any hit at every order,
counted and not, and two-pop.

Tolerances: against the rows, every output (t, tri, u, v, occlusion,
counts) bit for bit and the same work (pops, triangle tests, dropped
entries, deepest stack); t bit-equal to K1's and tri off only on equal-t
ties, occlusion equal to K2's. Against tpurt (the camera case), as
tests/test_torch_closest_compact.py and tests/test_torch_any_compact.py
hold K1 and K2: tri equal on >= 99% of the 240 rays and every difference a
tie or grazing (tests/torch_parity.py; ROADMAP F9), where tri agrees t
within 2 ULP (and u, v within 1e-5 uncounted); occlusion equal on >= 99.9%
with every differing lane grazing. tpurt counts per packet and keys
"nearlast" by centroids (F15), so its counts are not compared here
(tests/test_torch_steps.py does that where they are defined alike); the
soups are not traced by tpurt (F16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_closest_compact import _camera_case
from torch_closest_cases import (CASES, H, T_MIN, W, deep_soup, frame_rays,
                                 port_scene, soup)
from torch_parity import (HitClassifier, classify_closest,
                          classify_occlusion, same_host_builder,  # noqa: F401
                          ulp_diff)

CAMERA = "material_field"
NAMES = [*CASES, "deep", CAMERA]
# (any hit, pop2, count_steps, push order): every trace K7a and K7b take
CLOSEST = [(False, False, True, "sort"), (False, False, False, "nearlast"),
           (False, False, True, "nearlast"), (False, False, False, "none"),
           (False, False, True, "none"), (False, True, False, "sort")]
ANY = [(True, False, c, o) for o in ("sort", "nearlast", "none")
       for c in (False, True)] + [(True, True, False, "sort")]
VARIANTS = CLOSEST + ANY
# the variants traced by tpurt too, on the camera case
REF_VARIANTS = [(False, True, False, "sort"), (True, True, False, "sort"),
                (False, False, True, "nearlast"), (True, False, True, "sort")]
KEYS = ("t", "tri", "u", "v")
WORK = ("node_pops", "leaf_pops", "tri_tests", "max_stack",
        "dropped_node_pops", "dropped_leaf_pops")


def _vid(v):
    any_hit, pop2, count, order = v
    return "-".join(["any" if any_hit else "closest",
                     "pop2" if pop2 else order] + (["counted"] if count
                                                   else []))


def _case(name):
    """(port scene, tpurt bvh or None, tpurt geom or None, rays)."""
    if name == CAMERA:
        return _camera_case(name)
    tris, leaf_max = (deep_soup(), 1) if name == "deep" else \
        (soup(), CASES[name])
    scene, _, _ = port_scene(*tris, leaf_max)
    return scene, None, None, frame_rays(*tris)


def _plain(scene, rays, variant, compact, stats=None):
    """The plain trace of a variant as numpy: dict(t, tri, u, v) or
    dict(occ[, node, leaf])."""
    from tpurt_torch.kernels.traverse_bvh8 import _trace_plain

    any_hit, pop2, count, order = variant
    got = _trace_plain(scene, *rays[:3], rays[3], any_hit=any_hit,
                       pops=2 if pop2 else 1, stats=stats,
                       count_steps=count, order=order, compact=compact)
    return _named(got, any_hit)


def _named(got, any_hit):
    if not any_hit:
        return {k: got[k].numpy() for k in KEYS}
    got = got if isinstance(got, tuple) else (got,)
    return dict(zip(("occ", "node", "leaf"), (x.numpy() for x in got)))


def _wrapped(scene, rays, variant, **frame):
    """The same trace through trace_closest_bvh8 / trace_any_bvh8."""
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_closest_bvh8)

    any_hit, pop2, count, order = variant
    fn = trace_any_bvh8 if any_hit else trace_closest_bvh8
    return _named(fn(scene, *rays, pop2=pop2, count_steps=count,
                     push_order=order, **frame), any_hit)


def _ref(bvh, geom, o, d, t_max, variant):
    """tpurt's trace of a variant, as numpy in _named's keys."""
    from tpurt.kernels.traverse_bvh8 import trace_any_bvh8 as ref_any
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8 as ref_closest

    any_hit, pop2, count, order = variant
    kw = dict(height=H, width=W, max_leaf=32, interpret=True, fat=1,
              when_push=False, pop2=pop2, count_steps=count,
              push_order=order)
    args = (dict(nodes8=jnp.asarray(bvh["nodes8"])),
            {k: jnp.asarray(v) for k, v in geom.items()}, jnp.asarray(o),
            jnp.asarray(d), T_MIN, jnp.asarray(t_max))
    if any_hit:
        out = ref_any(*args, **kw)
        out = out if isinstance(out, tuple) else (out,)
        return dict(zip(("occ", "node", "leaf"),
                        (np.asarray(x) for x in out)))
    return {k: np.asarray(v) for k, v in ref_closest(*args, **kw).items()}


@pytest.fixture(scope="module")
def results():
    out = {}
    for name in NAMES:
        scene, bvh, geom, (o, d, t_max) = _case(name)
        rays = (torch.tensor(o), torch.tensor(d), T_MIN, torch.tensor(t_max))
        r = dict(scene=scene, rays=rays, o=o, d=d, t_max=t_max, runs={},
                 k1=_plain(scene, rays, (False, False, False, "sort"), True),
                 k2=_plain(scene, rays, (True, False, False, "none"), True))
        for v in VARIANTS:
            stats = dict(compact={}, rows={})
            r["runs"][v] = dict(
                stats=stats,
                compact=_plain(scene, rays, v, True, stats["compact"]),
                rows=_plain(scene, rays, v, False, stats["rows"]),
                default=_wrapped(scene, rays, v, height=H, width=W))
        if name == CAMERA:
            r["cls"] = HitClassifier(bvh["nodes8"], geom)
            r["ref"] = {v: _ref(bvh, geom, o, d, t_max, v)
                        for v in REF_VARIANTS}
        out[name] = r
    return out


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("variant", VARIANTS, ids=_vid)
@pytest.mark.parametrize("name", NAMES)
def test_compact_equals_rows(name, variant, results):
    """The plain variant over nodes8c equals the same traversal over the
    rows bit for bit and does the same work; the wrappers' default route
    with the frame's shape gives the same bits; t and occlusion are K1's
    and K2's."""
    r = results[name]
    run = r["runs"][variant]
    assert run["compact"].keys() == run["rows"].keys()
    for k, x in run["compact"].items():
        np.testing.assert_array_equal(_bits(x), _bits(run["rows"][k]),
                                      err_msg=k)
        np.testing.assert_array_equal(_bits(run["default"][k]), _bits(x),
                                      err_msg=k)
    for k in WORK:
        assert int(run["stats"]["compact"].get(k, 0)) == \
            int(run["stats"]["rows"].get(k, 0)), k
    got = run["compact"]
    if variant[0]:
        np.testing.assert_array_equal(got["occ"], r["k2"]["occ"])
        assert got["occ"].any() and not got["occ"].all()
        assert not got["occ"][r["t_max"] <= T_MIN].any()
        return
    np.testing.assert_array_equal(_bits(got["t"]), _bits(r["k1"]["t"]))
    differ = got["tri"] != r["k1"]["tri"]
    # a differing tri hits at the same t (bit-equal above): a tie
    assert ((got["tri"][differ] >= 0) & (r["k1"]["tri"][differ] >= 0)).all()
    if variant[3] == "sort" and not variant[1]:
        assert not differ.any()
    assert (got["tri"] >= 0).sum() >= 10 and (got["tri"] < 0).any()


@pytest.mark.parametrize("name", NAMES)
def test_counts_add_up_to_the_work(name, results):
    """Each counted variant's per-ray counts add up to its traversal's
    node and leaf pops."""
    runs = results[name]["runs"]
    for v in VARIANTS:
        if not v[2]:
            continue
        got, stats = runs[v]["compact"], runs[v]["stats"]["compact"]
        node, leaf = (got["u"], got["v"]) if not v[0] else \
            (got["node"], got["leaf"])
        assert int(node.sum()) == int(stats["node_pops"]) > 0, _vid(v)
        assert int(leaf.sum()) == int(stats["leaf_pops"]) > 0, _vid(v)


@pytest.mark.parametrize("variant", REF_VARIANTS, ids=_vid)
def test_camera_case_agrees_with_tpurt(variant, results):
    r = results[CAMERA]
    ref, got = r["ref"][variant], r["runs"][variant]["compact"]
    if variant[0]:
        same = ref["occ"] == got["occ"]
        assert same.mean() >= 0.999, f"occ agrees on {same.mean():.5f}"
        kinds = classify_occlusion(r["cls"], ref["occ"], got["occ"], r["o"],
                                   r["d"], T_MIN, r["t_max"])
        assert kinds["other"] == 0, kinds
        return
    same = ref["tri"] == got["tri"]
    assert same.mean() >= 0.99, f"tri agrees on {same.mean():.5f}"
    assert ulp_diff(ref["t"][same], got["t"][same]).max() <= 2
    if not variant[2]:
        for k in ("u", "v"):
            assert np.abs(ref[k][same] - got[k][same]).max() <= 1e-5
    kinds = classify_closest(r["cls"], ref, got, r["o"], r["d"], T_MIN,
                             np.float32(1e4))
    assert kinds["other"] == 0, kinds


@pytest.mark.parametrize("variant", VARIANTS, ids=_vid)
def test_frame_shape_is_a_layout_only(variant, results):
    """Each ray's outputs do not depend on the others: the rays traced in
    the kernels' pixel-tile order (tile_rays) and put back give the same
    bits; a shape that does not describe the rays is refused."""
    from tpurt_torch.kernels.traverse_bvh8 import tile_rays

    r = results[CAMERA]
    order = tile_rays(W, H).reshape(-1)
    order = order[order >= 0]
    o, d, t_min, t_max = r["rays"]
    tiled = _plain(r["scene"], (o[order], d[order], t_min, t_max[order]),
                   variant, True)
    for k, x in r["runs"][variant]["compact"].items():
        back = np.empty_like(x)
        back[order.numpy()] = tiled[k]
        np.testing.assert_array_equal(_bits(back), _bits(x), err_msg=k)
    with pytest.raises(ValueError, match="frame"):
        _wrapped(r["scene"], r["rays"], variant, height=H - 1, width=W)


def test_two_pop_stack_instantiations(results):
    """stack_entries(5, 2) = 64 fits K7b's 64-entry instantiation (the
    bench tree's depth); deeper trees take 192, and trees that need more
    are refused. The plain traversals' deepest stacks stay within the
    instantiation their tree gets."""
    from tpurt_torch.kernels.traverse_bvh8 import (compact_stack_size,
                                                   stack_entries)

    assert stack_entries(5, 2) == 64 == compact_stack_size(5, 2)
    assert compact_stack_size(6, 2) == compact_stack_size(14, 2) == 192
    assert compact_stack_size(5) == 48 and compact_stack_size(27) == 192
    with pytest.raises(ValueError, match="stack"):
        compact_stack_size(15, 2)
    depths = set()
    for name in NAMES:
        depth = results[name]["scene"]["depth8"]
        depths.add(depth)
        for v in VARIANTS:
            pops = 2 if v[1] else 1
            deepest = int(results[name]["runs"][v]["stats"]["compact"]
                          ["max_stack"])
            assert 1 <= deepest <= stack_entries(depth, pops) \
                <= compact_stack_size(depth, pops), (name, _vid(v))
    assert max(depths) >= 6  # the deep soup takes the 192-entry stack


def test_steps_probe_groups_warps_as_the_kernels():
    """The steps probe's warps are the kernels' 8x4-pixel warps of 16x8
    tiles: a warp's steps are the most of its pixels' (idle lanes past the
    frame's edge count 0, warps without a pixel are left out), and its
    SIMT efficiency is set beside that of warps of 32 consecutive rays."""
    from tpurt_torch.tools.steps_probe import (step_report, warp_steps,
                                               warp_steps_rows)

    rng = np.random.default_rng(4)
    w, h = 20, 12
    node = torch.tensor(rng.integers(0, 9, h * w), dtype=torch.float32)
    leaf = torch.tensor(rng.integers(0, 5, h * w), dtype=torch.float32)
    steps = (node + leaf).numpy().reshape(h, w)
    want = []
    for ty in range(0, h, 8):
        for tx in range(0, w, 16):
            for k in range(4):
                x0, y0 = tx + (k % 2) * 8, ty + (k // 2) * 4
                block = steps[y0:y0 + 4, x0:x0 + 8]
                if block.size:
                    want.append(int(block.max()))
    np.testing.assert_array_equal(warp_steps(node, leaf, w, h).numpy(),
                                  want)
    rows = warp_steps_rows(node, leaf).numpy()
    flat = np.concatenate([steps.reshape(-1), np.zeros(16)])
    np.testing.assert_array_equal(rows, flat.reshape(-1, 32).max(1))
    rep = step_report(node, leaf, w, h)
    lanes = int((node + leaf).sum())
    assert rep["warps"] == len(want)
    assert rep["simt_efficiency"] == lanes / (32 * sum(want))
    assert rep["simt_efficiency_rows"] == lanes / (32 * int(rows.sum()))
