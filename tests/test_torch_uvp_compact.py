"""K7c (the closest hit with the uv payload) over the compact node table:
the port's plain version, which reads ``nodes8c`` as ``csrc/bvh8_closest.cu``
does, against the same traversal over the ``nodes8`` rows; the payload
against its definition; the frame's shape as a layout only
(``tile_rays``); the stack instantiation; the wrapper's refusals. Port-only:
tests/test_torch_uv_payload.py holds the payload against tpurt's kernel.

Cases: the triangle soups of tests/torch_closest_cases.py ("dup_leaves",
"dup_merged": every triangle twice, so equal-t ties and, in "dup_leaves",
sibling slots with identical boxes; "deep": a 9-level tree) on a ragged
12 x 20 frame of centroid, vertex (grazing), axis-aligned and random rays
with t_max 100, short, 0, equal to t_min and negative, each soup with a
random (T, 9) uvp table from a seed; and "bench", the cut bench scene
(its own uvp table) on its camera's rays of the same frame, t_max 1e4, 3
and 0.

Tolerances: against the rows, all nine outputs bit for bit and the same
work (pops, triangle tests, dropped entries, deepest stack); t, tri, u and
v bit-equal to K1's plain version; the payload bit-equal to uv0 * w +
uv1 * u + uv2 * v (w = 1 - u - v) of the winner's uvp row, and 0, 0, 0, 1,
1 on a miss.
"""
import numpy as np
import pytest
import torch

from torch_closest_cases import (CASES, H, T_MIN, W, deep_soup, frame_rays,
                                 port_scene, soup)

NAMES = [*CASES, "deep", "bench"]
KEYS = ("t", "tri", "u", "v")
PAYLOAD = ("texu", "texv", "img", "texh", "texw")
WORK = ("node_pops", "leaf_pops", "tri_tests", "max_stack",
        "dropped_node_pops", "dropped_leaf_pops")


def _bench_case():
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig, convert
    from tpurt_torch.passes.rays import camera_rays

    r = build_bench_scene(Renderer(RendererConfig(width=W, height=H,
                                                  device="cpu")),
                          field=dict(nx=3, nz=3, subdiv=2), cubes=2)
    o, d = camera_rays(convert.camera_tensors(r.camera.uniform(), "cpu"),
                       W, H)
    t_max = torch.full((H * W,), 1e4)
    t_max[::7] = 0.0
    t_max[3::11] = 3.0
    return r.scene_device, (o, d, t_max)


def _case(name):
    """(scene with nodes8, nodes8c, tris, depth8 and uvp; (o, d, t_max))."""
    if name == "bench":
        return _bench_case()
    tris, leaf_max = (deep_soup(), 1) if name == "deep" else \
        (soup(), CASES[name])
    scene, _, _ = port_scene(*tris, leaf_max)
    rng = np.random.default_rng(7)
    scene["uvp"] = torch.tensor(rng.uniform(-2.0, 2.0, (tris[0].shape[0], 9)),
                                dtype=torch.float32)
    return scene, tuple(torch.tensor(x) for x in frame_rays(*tris))


@pytest.fixture(scope="module")
def results():
    from tpurt_torch.kernels.traverse_bvh8 import (_trace_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)

    out = {}
    for name in NAMES:
        scene, (o, d, t_max) = _case(name)
        stats = dict(compact={}, rows={})
        out[name] = dict(
            scene=scene, rays=(o, d, T_MIN, t_max), stats=stats,
            compact=trace_closest_plain(scene, o, d, T_MIN, t_max,
                                        stats=stats["compact"],
                                        uv_payload=True),
            rows=_trace_plain(scene, o, d, T_MIN, t_max, any_hit=False,
                              uv_payload=True, stats=stats["rows"]),
            k1=trace_closest_plain(scene, o, d, T_MIN, t_max),
            default=trace_closest_bvh8(scene, o, d, T_MIN, t_max,
                                       uv_payload=True, height=H, width=W))
    return out


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("name", NAMES)
def test_compact_equals_rows(name, results):
    """The plain K7c over nodes8c equals the same traversal over the rows
    in all nine outputs and does the same work; the wrapper's default route
    with the frame's shape gives the same bits; t, tri, u and v are K1's."""
    r = results[name]
    got = r["compact"]
    assert set(got) == set(r["rows"]) == set(KEYS + PAYLOAD)
    for k, x in got.items():
        assert torch.equal(_bits(x), _bits(r["rows"][k])), k
        assert torch.equal(_bits(r["default"][k]), _bits(x)), k
    for k in KEYS:
        assert torch.equal(_bits(got[k]), _bits(r["k1"][k])), k
    for k in WORK:
        assert int(r["stats"]["compact"].get(k, 0)) == \
            int(r["stats"]["rows"].get(k, 0)), k
    assert int((got["tri"] >= 0).sum()) >= 10 and bool((got["tri"] < 0).any())


@pytest.mark.parametrize("name", NAMES)
def test_payload_is_the_winners_uvp_row(name, results):
    """On a hit the planes are the winner's uvp row (its position in BVH
    leaf order, found by its triangle id) interpolated at (u, v) in the
    shade pass's association, img/texh/texw copied; 0, 0, 0, 1, 1 on a
    miss."""
    r = results[name]
    got, scene = r["compact"], r["scene"]
    hit = got["tri"] >= 0
    row_of = torch.empty(scene["tris"].shape[0], dtype=torch.long)
    row_of[scene["tris"][:, 9].long()] = torch.arange(row_of.numel())
    p = scene["uvp"][row_of[got["tri"][hit].long()]]
    u, v = got["u"][hit], got["v"][hit]
    w = 1.0 - u - v
    want = (p[:, 0] * w + p[:, 2] * u + p[:, 4] * v,
            p[:, 1] * w + p[:, 3] * u + p[:, 5] * v, p[:, 6], p[:, 7],
            p[:, 8])
    for k, x in zip(PAYLOAD, want):
        assert torch.equal(_bits(got[k][hit]), _bits(x.contiguous())), k
    for k, miss in zip(PAYLOAD, (0.0, 0.0, 0.0, 1.0, 1.0)):
        assert bool((got[k][~hit] == miss).all()), k


@pytest.mark.parametrize("name", NAMES)
def test_frame_shape_is_a_layout_only(name, results):
    """Each ray's outputs do not depend on the others: the rays traced in
    the kernel's pixel-tile order (tile_rays) and put back give the same
    bits; a shape that does not describe the rays is refused."""
    from tpurt_torch.kernels.traverse_bvh8 import (tile_rays,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)

    r = results[name]
    order = tile_rays(W, H).reshape(-1)
    order = order[order >= 0]
    o, d, t_min, t_max = r["rays"]
    tiled = trace_closest_plain(r["scene"], o[order], d[order], t_min,
                                t_max[order], uv_payload=True)
    for k, x in r["compact"].items():
        back = torch.empty_like(x)
        back[order] = tiled[k]
        assert torch.equal(_bits(back), _bits(x)), k
    with pytest.raises(ValueError, match="frame"):
        trace_closest_bvh8(r["scene"], *r["rays"], uv_payload=True,
                           height=H - 1, width=W)


def test_stack_instantiation_from_depth8(results):
    """K7c takes K1's one-pop stack instantiation, picked from depth8: 48
    entries for the soups and the bench scene, 192 for the deep soup; the
    plain traversal's deepest stack stays within it."""
    from tpurt_torch.kernels.traverse_bvh8 import (compact_stack_size,
                                                   stack_entries)

    sizes = {}
    for name in NAMES:
        depth = results[name]["scene"]["depth8"]
        sizes[name] = compact_stack_size(depth)
        deepest = int(results[name]["stats"]["compact"]["max_stack"])
        assert 1 <= deepest <= stack_entries(depth) <= sizes[name], name
    assert sizes == dict(dup_leaves=48, dup_merged=48, deep=192, bench=48)


@pytest.mark.parametrize("refusal", ["pop2", "count_steps", "nearlast",
                                     "no_uvp", "uvp_shape"])
def test_wrapper_refusals(refusal, results):
    """uv_payload composes with neither two pops, nor counting, nor a push
    order other than "sort"; it needs a (T, 9) f32 uvp table."""
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8

    r = results["dup_merged"]
    scene, kw = dict(r["scene"]), dict(uv_payload=True)
    if refusal == "pop2":
        kw["pop2"] = True
    elif refusal == "count_steps":
        kw["count_steps"] = True
    elif refusal == "nearlast":
        kw["push_order"] = "nearlast"
    elif refusal == "no_uvp":
        del scene["uvp"]
    else:
        scene["uvp"] = scene["uvp"][:, :8].contiguous()
    with pytest.raises(ValueError, match="uv_payload|uvp"):
        trace_closest_bvh8(scene, *r["rays"], **kw)
