"""K1 over the compact node table: the port's plain closest hit at its
default push order ("sort", reading ``nodes8c`` as ``csrc/bvh8_closest.cu``
does) against the plain closest hit over the ``nodes8`` rows, and against
tpurt's ``trace_closest_bvh8`` (Pallas in interpret mode) with ``fat=1,
when_push=False`` pinned (ROADMAP F5); the 16x8 / 8x4 pixel-tile mapping of
K1 and K2 (``tile_rays``); the denoise pass's division tables (K4).

Cases: two triangle soups (tests/torch_closest_cases.py) in which every
triangle appears twice (equal-t ties; one with duplicate pairs in sibling
leaf slots of identical boxes, so equal entry distances, one with the
pairs inside one leaf) on a ragged 12 x 20 frame of centroid, vertex
(grazing), axis-aligned and random rays with t_max 100, short, 0, equal
to t_min and negative; and "material_field" and "box_field" on tpurt's camera
rays of the same frame, with t_max 1e4, 3 and 0.

Tolerances: against the rows, t, tri, u and v bit for bit and the same
work (pops, triangle tests, dropped entries, deepest stack). Against tpurt
(the camera cases), as tests/test_torch_trace.py: tri equal on >= 99% of
the 240 rays and every difference a tie (t within 2 ULP) or grazing
(tests/torch_parity.py); where tri agrees t within 2 ULP and u, v within
1e-5 (XLA:CPU may contract tpurt's products into FMAs). The soups are not
traced by tpurt: under that contraction their vertex-aimed and
axis-aligned rays' t moves by up to 20 ULP, beyond the tie test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_closest_cases import (CASES, H, T_MIN, W, frame_rays,
                                 identical_sibling_boxes, port_scene, soup)
from torch_parity import (HitClassifier, camera, classify_closest,
                          resident_models, same_host_builder,  # noqa: F401
                          ulp_diff)

KEYS = ("t", "tri", "u", "v")
# the cases traced by tpurt too: its camera rays on resident scenes
CAMERA = ["material_field", "box_field"]
WORK = ("node_pops", "leaf_pops", "tri_tests", "max_stack",
        "dropped_node_pops", "dropped_leaf_pops")


def _soup_case(leaf_max):
    from tpurt.bvh import build_bvh_sah as ref_build
    from tpurt.bvh.wide import LEAF8_MAX
    from tpurt.bvh.wide import collapse8 as ref_collapse8
    from tpurt.kernels.traverse import make_traversal_geom
    from tpurt_torch.bvh.flat import tri_aabbs

    v0, v1, v2 = soup()
    scene, _, _ = port_scene(v0, v1, v2, leaf_max)
    ref_bvh = ref_build(*tri_aabbs(v0, v1, v2), max_leaf_size=leaf_max or 4)
    nodes8 = ref_collapse8(ref_bvh.as_pytree(),
                           leaf_max=leaf_max or LEAF8_MAX)[0]
    np.testing.assert_array_equal(scene["nodes8"].numpy(), nodes8)
    geom = {k: np.asarray(x) for k, x in make_traversal_geom(
        v0, v1, v2, ref_bvh.tri_order).items()}
    return scene, dict(nodes8=nodes8), geom, frame_rays(v0, v1, v2)


def _camera_case(name):
    from tpurt.passes.rays import camera_rays
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.engine import convert

    pt = ref_flatten(resident_models(name)).as_pytree()
    uni = camera(W, H).uniform()
    o, d = camera_rays({k: jnp.asarray(v) for k, v in uni.items()}, W, H)
    t_max = np.full(H * W, 1e4, np.float32)
    t_max[::7] = 0.0
    t_max[3::11] = 3.0
    return (convert.scene_tensors(pt, "cpu"), pt["bvh"], pt["geom"],
            (np.asarray(o), np.asarray(d), t_max))


@pytest.fixture(scope="module")
def results():
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8 as ref_trace
    from tpurt_torch.kernels.traverse_bvh8 import (_trace_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)

    out = {}
    for name in (*CASES, *CAMERA):
        scene, bvh, geom, (o, d, t_max) = (
            _camera_case(name) if name in CAMERA
            else _soup_case(CASES[name]))
        rays = (torch.tensor(o), torch.tensor(d), T_MIN, torch.tensor(t_max))
        ref = ref_trace(
            dict(nodes8=jnp.asarray(bvh["nodes8"])),
            {k: jnp.asarray(v) for k, v in geom.items()}, jnp.asarray(o),
            jnp.asarray(d), T_MIN, jnp.asarray(t_max), height=H, width=W,
            max_leaf=32, interpret=True, fat=1,
            when_push=False) if name in CAMERA else None
        stats = dict(compact={}, rows={})
        compact = trace_closest_plain(scene, *rays, stats=stats["compact"])
        rows = _trace_plain(scene, *rays[:3], rays[3], any_hit=False,
                            order="sort", stats=stats["rows"])
        out[name] = dict(
            scene=scene, o=o, d=d, t_max=t_max, stats=stats,
            cls=HitClassifier(bvh["nodes8"], geom),
            ref=ref and {k: np.asarray(ref[k]) for k in KEYS},
            compact={k: v.numpy() for k, v in compact.items()},
            rows={k: v.numpy() for k, v in rows.items()},
            default={k: v.numpy() for k, v in trace_closest_bvh8(
                scene, *rays, height=H, width=W).items()})
    return out


NAMES = [*CASES, *CAMERA]


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", NAMES)
def test_compact_equals_rows(name, results):
    """The default closest hit reads nodes8c and equals the traversal over
    the rows bit for bit, doing the same work; the frame's shape changes no
    bit."""
    r = results[name]
    for k in KEYS:
        np.testing.assert_array_equal(_bits(r["compact"][k]),
                                      _bits(r["rows"][k]), err_msg=k)
        np.testing.assert_array_equal(_bits(r["default"][k]),
                                      _bits(r["compact"][k]), err_msg=k)
    for k in WORK:
        assert int(r["stats"]["compact"][k]) == int(r["stats"]["rows"][k]), k


@pytest.mark.parametrize("name", NAMES)
def test_cases_cover_what_they_claim(name, results):
    """Hits and misses; lanes with t_max <= t_min miss with t = t_max; the
    soups have axis-aligned rays, and "dup_leaves" sibling slots with
    identical boxes (every soup hit is a tie: each triangle twice)."""
    r = results[name]
    got, t_max = r["compact"], r["t_max"]
    assert (got["tri"] >= 0).sum() >= 10 and (got["tri"] < 0).any()
    dead = t_max <= T_MIN
    assert dead.any()
    assert (got["tri"][dead] == -1).all()
    np.testing.assert_array_equal(got["t"][dead], t_max[dead])
    if name in CAMERA:
        return
    assert (r["d"] == 0.0).any()
    pairs = identical_sibling_boxes(r["scene"]["nodes8c"])
    assert (pairs > 0) == (name == "dup_leaves")


@pytest.mark.parametrize("name", CAMERA)
def test_compact_agrees_with_tpurt(name, results):
    r = results[name]
    ref, got = r["ref"], r["compact"]
    same = ref["tri"] == got["tri"]
    assert same.mean() >= 0.99, f"tri agrees on {same.mean():.5f}"
    assert ulp_diff(ref["t"][same], got["t"][same]).max() <= 2
    assert np.abs(ref["u"][same] - got["u"][same]).max() <= 1e-5
    assert np.abs(ref["v"][same] - got["v"][same]).max() <= 1e-5
    kinds = classify_closest(r["cls"], ref, got, r["o"], r["d"], T_MIN,
                             np.float32(1e4))
    assert kinds["other"] == 0, kinds


@pytest.mark.parametrize("w,h", [(800, 800), (1920, 1080), (20, 12)],
                         ids=["800x800", "1920x1080", "20x12"])
def test_tile_rays_cover_the_frame(w, h):
    """K1's and K2's pixel tiles: every pixel exactly once; a warp's lanes
    an 8x4 block and a block's threads a 16x8 tile, clipped at the frame's
    edge."""
    from tpurt_torch.kernels.traverse_bvh8 import tile_rays

    rays = tile_rays(w, h)
    assert rays.shape[1] == 128
    got = rays[rays >= 0]
    assert torch.equal(torch.sort(got).values, torch.arange(w * h))
    x, y = rays % w, rays // w
    for span, (cols, rows) in ((32, (8, 4)), (128, (16, 8))):
        grp = rays.reshape(-1, span)
        live = grp >= 0
        gx, gy = x.reshape(-1, span), y.reshape(-1, span)
        big = torch.full_like(gx, 1 << 30)
        x0 = torch.where(live, gx, big).amin(1)
        y0 = torch.where(live, gy, big).amin(1)
        x1 = torch.where(live, gx, -big).amax(1)
        y1 = torch.where(live, gy, -big).amax(1)
        any_live = live.any(1)
        assert bool(((x1 - x0 < cols) & (y1 - y0 < rows))[any_live].all())
        if w % 16 == 0 and h % 8 == 0:
            assert bool(live.all())


def test_denoise_tables_equal_the_divisions():
    """K4's lookups: for every u8 AO value the /255 table entry, and for
    every packed edge byte the four /3 values picked by selects, as the
    kernel computes them (IEEE f32 division, numpy here), equal the plain
    version's torch division."""
    from tpurt_torch.kernels.gtao_denoise import _unpack_edges
    from tpurt_torch.passes.encodings import divide

    k = np.arange(256)
    tab = np.float32(k) / np.float32(255.0)
    third = np.arange(4, dtype=np.float32) / np.float32(3.0)
    vis = divide(torch.arange(256, dtype=torch.uint8).to(torch.float32),
                 255.0).numpy()
    np.testing.assert_array_equal(tab.view(np.int32), vis.view(np.int32))
    planes = _unpack_edges(torch.arange(256, dtype=torch.uint8))
    for s, plane in zip((6, 4, 2, 0), planes):
        q = (k >> s) & 3
        sel = np.where(q == 0, third[0], np.where(
            q == 1, third[1], np.where(q == 2, third[2], third[3])))
        np.testing.assert_array_equal(sel.view(np.int32),
                                      plane.numpy().view(np.int32))
    assert third[0] == 0.0 and third[3] == 1.0
