"""K5 and K5p over the compact node table: the port's plain fused
multi-set any hit (``trace_any_multi_plain``, reading ``nodes8c`` as
``csrc/bvh8_multi.cu`` does) against the same traversal over the ``nodes8``
rows (``compact=False``) and against the port's K2 once per set; the
frame-shape arguments of ``trace_any_bvh8_multi`` (16x8 pixel tiles on the
card); ``shade(fuse_shadows=True)`` with the frame's shape.

Cases: every case of tests/torch_multi_cases.py ("random", "bench",
"ragged_s1", "ragged_s4"; built with tpurt's and the port's builders, no
tpurt kernel runs here) and tests/torch_closest_cases.py's soups as 3 sets
sharing their origins ("dup_leaves": identical sibling boxes, "dup_merged":
equal-t ties inside a leaf, "deep": a 9-level tree), one pop and two.

Tolerances: bit for bit everywhere. Against the rows, the same work (node
pops, leaf pops, triangle tests, slab groups, deepest stack). Against K2
per set with one pop, each set visits what it visits alone in K2's order,
so the slab groups are K2's node pops summed over the sets, the triangle
tests K2's summed, and with one set every count is K2's.
"""
import pytest
import torch

import torch_closest_cases as soups
import torch_multi_cases as mc

WORK = ("node_pops", "leaf_pops", "tri_tests", "node_tests", "max_stack")
SOUPS = {"dup_leaves": (soups.soup, 1), "dup_merged": (soups.soup, None),
         "deep": (soups.deep_soup, 1)}
CASES = list(mc.CASES) + list(SOUPS)
KEYS = [(c, p) for c in CASES for p in (False, True)]


def _inputs(name):
    """(port scene, origin, dirs, t_maxs, t_min) tensors of a case."""
    if name in SOUPS:
        make, leaf_max = SOUPS[name]
        tris = make()
        scene, _, _ = soups.port_scene(*tris, leaf_max)
        o, d, tm = soups.shared_origin_sets(*tris, 3)
        return scene, *map(torch.tensor, (o, d, tm)), soups.T_MIN
    _, port, o, d, tm, t_min, _ = mc.inputs(name)
    return port, *map(torch.tensor, (o, d, tm)), t_min


@pytest.fixture(scope="module")
def results():
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_any_multi_plain,
                                                   trace_any_plain)

    out = {}
    for name in CASES:
        scene, o, d, tm, t_min = _inputs(name)
        k2_stats = [{} for _ in range(d.shape[0])]
        k2 = torch.stack([trace_any_bvh8(scene, o, d[i], t_min, tm[i])
                          for i in range(d.shape[0])])
        for i, st in enumerate(k2_stats):
            trace_any_plain(scene, o, d[i], t_min, tm[i], stats=st)
        for pop2 in (False, True):
            stats = {k: {} for k in ("compact", "rows")}
            out[name, pop2] = dict(
                scene=scene, rays=(o, d, tm, t_min), k2=k2,
                k2_stats=k2_stats, stats=stats,
                compact=trace_any_multi_plain(scene, o, d, t_min, tm,
                                              stats=stats["compact"],
                                              pop2=pop2),
                rows=trace_any_multi_plain(scene, o, d, t_min, tm,
                                           stats=stats["rows"], pop2=pop2,
                                           compact=False))
    return out


def _ids(key):
    return f"{key[0]}-{'pop2' if key[1] else 'pop1'}"


@pytest.mark.parametrize("key", KEYS, ids=_ids)
def test_compact_equals_rows(key, results):
    """The plain K5/K5p over nodes8c equals the traversal over the rows bit
    for bit and does the same work; the deepest stack stays within the
    kernels' bound."""
    from tpurt_torch.kernels.traverse_bvh8 import stack_entries

    r = results[key]
    assert r["compact"].dtype == torch.bool
    assert torch.equal(r["compact"], r["rows"])
    for k in WORK:
        assert int(r["stats"]["compact"][k]) == int(r["stats"]["rows"][k]), k
    bound = stack_entries(r["scene"]["depth8"], 2 if key[1] else 1)
    assert 1 <= int(r["stats"]["compact"]["max_stack"]) <= bound


@pytest.mark.parametrize("key", KEYS, ids=_ids)
def test_equals_k2_per_set(key, results):
    """Each set's occlusion is K2's bit for bit; t_max <= t_min lanes are
    never occluded and every case shadows something. With one pop each set
    does K2's work: the slab groups and triangle tests are K2's summed over
    the sets, and a single set's every count is K2's."""
    r = results[key]
    o, d, tm, t_min = r["rays"]
    assert torch.equal(r["compact"], r["k2"])
    assert not bool(r["compact"][tm <= t_min].any())
    assert bool(r["compact"].any())
    if key[1]:
        return
    work, k2 = r["stats"]["compact"], r["k2_stats"]
    assert int(work["node_tests"]) == sum(int(s["node_pops"]) for s in k2)
    assert int(work["tri_tests"]) == sum(int(s["tri_tests"]) for s in k2)
    if d.shape[0] == 1:
        for k in ("node_pops", "leaf_pops", "tri_tests", "max_stack"):
            assert int(work[k]) == int(k2[0][k]), k


def test_cases_cover_what_they_claim(results):
    """The soups hold identical sibling boxes (dup_leaves), the deep soup
    takes the kernels' 192-entry stack with one pop and two, the bench
    tree the 48 / 64-entry ones, ragged_s4 fills a launch."""
    from tpurt_torch.kernels.traverse_bvh8 import (MULTI_SETS_MAX,
                                                   multi_stack_size)

    assert soups.identical_sibling_boxes(
        results["dup_leaves", False]["scene"]["nodes8c"]) > 0
    deep = results["deep", False]["scene"]["depth8"]
    assert multi_stack_size(deep, 1) == multi_stack_size(deep, 2) == 192
    bench = results["bench", False]["scene"]["depth8"]
    assert (multi_stack_size(bench, 1), multi_stack_size(bench, 2)) == \
        (48, 64)
    assert results["ragged_s4", False]["rays"][1].shape[0] == MULTI_SETS_MAX


def test_multi_stack_size_refuses_deeper_trees():
    """The least instantiation that holds stack_entries(depth8, pops), and
    a refusal past 192 entries."""
    from tpurt_torch.kernels.traverse_bvh8 import (multi_stack_size,
                                                   stack_entries)

    for depth in range(1, 8):
        for pops, small in ((1, 48), (2, 64)):
            want = small if stack_entries(depth, pops) <= small else 192
            assert multi_stack_size(depth, pops) == want
    with pytest.raises(ValueError, match="stack entries"):
        multi_stack_size(28, 1)
    with pytest.raises(ValueError, match="stack entries"):
        multi_stack_size(15, 2)


@pytest.mark.parametrize("pop2", [False, True], ids=["pop1", "pop2"])
def test_frame_shape_gives_the_same_mask(pop2, results):
    """height/width (the ragged 40x72 frame, not a multiple of the 16x8
    tile) give the mask of the call without them; a shape that is not the
    rays' is refused, and so is a scene without nodes8c."""
    from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8_multi

    r = results["ragged_s4", pop2]
    o, d, tm, t_min = r["rays"]
    got = trace_any_bvh8_multi(r["scene"], o, d, t_min, tm, pop2=pop2,
                               height=40, width=72)
    assert torch.equal(got, r["compact"])
    with pytest.raises(ValueError, match="not a 41 x 72 frame"):
        trace_any_bvh8_multi(r["scene"], o, d, t_min, tm, pop2=pop2,
                             height=41, width=72)
    bare = {k: v for k, v in r["scene"].items() if k != "nodes8c"}
    with pytest.raises(ValueError, match="nodes8c"):
        trace_any_bvh8_multi(bare, o, d, t_min, tm, pop2=pop2)


@pytest.mark.parametrize("w,h", [(800, 800), (1920, 1080), (72, 40)],
                         ids=["800x800", "1920x1080", "72x40"])
def test_tile_rays_at_k5_shapes(w, h):
    """The 16x8 / 8x4 pixel tiles K5 shares with K1 and K2, at the fused
    frame's shapes and the ragged 40x72 frame: every pixel once, a warp an
    8x4 block and a block a 16x8 tile (K1's checks)."""
    import test_torch_closest_compact as k1

    k1.test_tile_rays_cover_the_frame(w, h)


def test_fused_shade_with_frame_shape(monkeypatch):
    """shade(fuse_shadows=True) hands the frame's shape to the fused trace
    and gives the per-light shade's bits (the port's cut bench scene at
    40x48, plain versions)."""
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig, convert
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes import shade as shade_mod
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays

    h, w = 40, 48
    r = build_bench_scene(Renderer(RendererConfig(width=w, height=h,
                                                  device="cpu")),
                          field=dict(nx=3, nz=3, subdiv=2), cubes=2)
    scene = r.scene_device
    cam = convert.camera_tensors(r.camera.uniform(), "cpu")
    lights = convert.light_tensors(r.lights.shader_arrays(), "cpu")
    o, d = camera_rays(cam, w, h)
    hits = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX)
    loop = shade_mod.shade(scene, cam, lights, hits, height=h, width=w)
    shapes = []
    fused_trace = shade_mod.trace_any_bvh8_multi

    def recorded(*args, **kwargs):
        shapes.append((kwargs.get("height"), kwargs.get("width")))
        return fused_trace(*args, **kwargs)

    monkeypatch.setattr(shade_mod, "trace_any_bvh8_multi", recorded)
    fused = shade_mod.shade(scene, cam, lights, hits, fuse_shadows=True,
                            height=h, width=w)
    assert shapes == [(h, w)]
    for k, v in loop.items():
        assert torch.equal(fused[k].view(torch.int32), v.view(torch.int32)), k
    lit = float((loop["color"].sum(-1) > 0).float().mean())
    assert 0.05 < lit < 1.0
