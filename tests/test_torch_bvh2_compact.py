"""K6 over the compact child-pair table ``nodes2c``: the port's plain
closest and any hit on K6's route (reading ``nodes2c`` as
``csrc/bvh2_trace.cu`` does) against the same traversal over the ``nodes2``
rows; ``compact_bvh2`` against a numpy re-derivation and its refusals; the
default route (``trace_*_bvh2`` with the frame's shape) against tpurt's
``trace_closest_packets`` / ``trace_any_packets`` (Pallas in interpret
mode); the 16x8 pixel tiles at K6's frame shapes.

Cases: the rotated LBVH (one triangle per leaf) and the binned-SAH trees
(leaves of up to 4) of tests/test_torch_bvh2.py on its 44x60 camera rays
with t_max far, short and 0, the 2-triangle scene among them (its SAH root
is a leaf); and the triangle soups of tests/torch_closest_cases.py built
as binary SAH trees with leaves of 1 (every triangle twice, the pair in
sibling leaves with identical boxes: equal entry distances and equal-t
ties) and of 4 (the pair inside one leaf), on centroid, vertex (grazing),
axis-aligned and random rays with t_max 100, short, 0, t_min and negative.

Tolerances: against the rows, t, tri, u, v and occlusion bit for bit and
the same work (node pops, leaf pops, triangle tests). Against tpurt, as
tests/test_torch_bvh2.py states them: occlusion equal on every ray; tri
equal except on ties (both t within the tier's ULP bound, 2 for smem and
4 for hbm), t within that bound and u, v within 1e-5 where tri agrees.
"""
import numpy as np
import pytest
import torch

from torch_closest_cases import T_MIN as SOUP_T_MIN
from torch_closest_cases import frame_rays, port_scene, soup
from torch_parity import ulp_diff

KEYS = ("t", "tri", "u", "v")
WORK = ("node_pops", "leaf_pops", "tri_tests", "node_tests")
TREES = ("lbvh", "sah", "tiny_lbvh", "tiny_sah")
SOUPS = {"soup_leaf1": 1, "soup_leaf4": 4}


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


def _soup_case(leaf_max):
    from tpurt_torch.bvh.flat import bvh_max_depth
    from tpurt_torch.engine import convert

    v0, v1, v2 = soup()
    _, bvh, geom = port_scene(v0, v1, v2, leaf_max)
    pt = {k: np.asarray(v) for k, v in bvh.as_pytree().items()}
    depth = bvh_max_depth(pt["entry"], pt["skip"], pt["tri_count"])
    scene = convert.bvh2_tensors(pt, geom, depth, "cpu")
    o, d, t_max = frame_rays(v0, v1, v2)
    return scene, leaf_max, (o, d, SOUP_T_MIN, t_max)


def _tree_case(name):
    from test_torch_bvh2 import CASES, T_MIN, _rays, _trees
    from tpurt_torch.engine import convert

    scene_name, tree, _, max_leaf = CASES[name]
    bvh, geom, depth = _trees(scene_name, tree)
    o, d, t_max = _rays(seed=TREES.index(name))
    return (convert.bvh2_tensors(bvh, geom, depth, "cpu"), max_leaf,
            (o, d, T_MIN, t_max))


@pytest.fixture(scope="module")
def results():
    from tpurt_torch.kernels.traverse_bvh2 import (trace_any_plain,
                                                   trace_closest_plain)

    out = {}
    for name in (*TREES, *SOUPS):
        scene, max_leaf, (o, d, t_min, t_max) = (
            _soup_case(SOUPS[name]) if name in SOUPS else _tree_case(name))
        rays = (torch.tensor(o), torch.tensor(d), t_min, torch.tensor(t_max))
        res = dict(scene=scene, d=d, t_max=t_max, t_min=t_min)
        for table in ("compact", "rows"):
            kw = dict(compact=table == "compact")
            stats, stats_any = {}, {}
            hits = trace_closest_plain(scene, *rays, max_leaf, stats=stats,
                                       **kw)
            occ = trace_any_plain(scene, *rays, max_leaf, stats=stats_any,
                                  **kw)
            res[table] = dict(
                hits={k: v.numpy() for k, v in hits.items()},
                occ=occ.numpy(),
                work={k: int(stats[k]) for k in WORK},
                work_any={k: int(stats_any[k]) for k in WORK})
        out[name] = res
    return out


@pytest.mark.parametrize("name", [*TREES, *SOUPS])
def test_compact_equals_rows(name, results):
    """The plain K6 over nodes2c equals the traversal over the nodes2 rows
    bit for bit (closest hits and occlusion) and does the same work."""
    r = results[name]
    for k in KEYS:
        np.testing.assert_array_equal(_bits(r["compact"]["hits"][k]),
                                      _bits(r["rows"]["hits"][k]),
                                      err_msg=k)
    np.testing.assert_array_equal(r["compact"]["occ"], r["rows"]["occ"])
    assert r["compact"]["work"] == r["rows"]["work"]
    assert r["compact"]["work_any"] == r["rows"]["work_any"]


@pytest.mark.parametrize("name", [*TREES, *SOUPS])
def test_cases_cover_what_they_claim(name, results):
    """Hits, misses and occlusion; lanes with t_max <= t_min miss with t =
    t_max and are never occluded; the tiny SAH tree's root is a leaf (a
    header row only); the soups have axis-aligned rays, and with leaves of
    one triangle sibling leaves with bit-identical boxes."""
    r = results[name]
    got, occ, t_max = r["compact"]["hits"], r["compact"]["occ"], r["t_max"]
    assert (got["tri"] >= 0).sum() >= 10 and (got["tri"] < 0).any()
    assert occ.any() and not occ.all()
    dead = t_max <= r["t_min"]
    assert dead.any() and not occ[dead].any()
    assert (got["tri"][dead] == -1).all()
    np.testing.assert_array_equal(got["t"][dead], t_max[dead])
    nc = r["scene"]["nodes2c"].numpy()
    root_is_leaf = nc[0, 12].view(np.int32) < 0
    assert root_is_leaf == (name == "tiny_sah")
    assert root_is_leaf == (nc.shape[0] == 1)
    if name in SOUPS:
        assert (r["d"] == 0.0).any()
        twins = (_bits(nc[1:, 0:6]) == _bits(nc[1:, 6:12])).all(1).sum()
        assert (twins > 0) == (name == "soup_leaf1")


def _compact_numpy(nodes2):
    """nodes2c re-derived row by row from its definition (module docstring
    of csrc/bvh2_trace.cu): a header, then each internal node's two child
    boxes and codes."""
    from tpurt_torch.bvh.wide import EMPTY_CODE, LEAF_CODE_BASE

    internal = [i for i in range(len(nodes2)) if nodes2[i, 7] >= 0]
    row_of = {node: row for row, node in enumerate(internal, start=1)}

    def code(j):
        if nodes2[j, 7] < 0:
            return -(int(nodes2[j, 6]) * LEAF_CODE_BASE
                     + int(-nodes2[j, 7])) - 1
        return row_of[j]

    out = np.zeros((1 + len(internal), 16), np.float32)
    out[0, :6] = nodes2[0, :6]
    out[0, 12:14] = np.array([code(0), EMPTY_CODE], np.int32).view(
        np.float32)
    for row, node in enumerate(internal, start=1):
        left, right = int(nodes2[node, 6]), int(nodes2[node, 7])
        out[row, :6] = nodes2[left, :6]
        out[row, 6:12] = nodes2[right, :6]
        out[row, 12:14] = np.array([code(left), code(right)],
                                   np.int32).view(np.float32)
    return out


@pytest.mark.parametrize("name", [*TREES, *SOUPS])
def test_compact_table_equals_numpy(name, results):
    scene = results[name]["scene"]
    want = _compact_numpy(scene["nodes2"].numpy())
    np.testing.assert_array_equal(_bits(scene["nodes2c"].numpy()),
                                  _bits(want))


def test_compact_table_refusals():
    """compact_bvh2 refuses a leaf wider than the kernel's 32 triangles
    and rows that are not a full binary tree; the traces refuse a table
    of the wrong width and max_leaf above 32."""
    from tpurt_torch.engine.convert import compact_bvh2
    from tpurt_torch.kernels.traverse_bvh2 import trace_closest_bvh2

    box = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    tree = torch.tensor([box + [1.0, 2.0], box + [0.0, -32.0],
                         box + [32.0, -1.0]])
    assert compact_bvh2(tree).shape == (2, 16)
    wide = tree.clone()
    wide[1, 7] = -33.0
    with pytest.raises(ValueError, match="33 triangles"):
        compact_bvh2(wide)
    with pytest.raises(ValueError, match="full binary tree"):
        compact_bvh2(tree[:2])
    scene = dict(nodes2=tree, nodes2c=compact_bvh2(tree),
                 tris=torch.zeros((33, 12)), depth2=1)
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    with pytest.raises(ValueError, match="max_leaf 33"):
        trace_closest_bvh2(scene, o, d, 0.0, 1.0, max_leaf=33)
    with pytest.raises(ValueError, match="nodes2c must be"):
        trace_closest_bvh2(dict(scene, nodes2c=tree), o, d, 0.0, 1.0)
    with pytest.raises(ValueError, match="not a 3 x 2 frame"):
        trace_closest_bvh2(scene, o, d, 0.0, 1.0, height=3, width=2)


@pytest.mark.parametrize("w,h", [(800, 800), (1920, 1080), (60, 44)],
                         ids=["800x800", "1920x1080", "60x44"])
def test_tile_rays_at_k6_shapes(w, h):
    """The 16x8 / 8x4 pixel tiles K6 shares with K1 and K2, at the
    rebuild frame's shapes and the tests' 44x60 frame: every pixel once, a
    warp an 8x4 block and a block a 16x8 tile (K1's checks)."""
    import test_torch_closest_compact as k1

    k1.test_tile_rays_cover_the_frame(w, h)


@pytest.fixture(scope="module")
def tpurt_results():
    """The default route (the frame's shape given, nodes2c) and tpurt's
    packet tracers on new rays of the LBVH (hbm tier, max_leaf 1) and of
    the SAH tree (smem tier, max_leaf 4)."""
    import jax.numpy as jnp

    from test_torch_bvh2 import CASES, H, T_MIN, ULP_BOUND, W, _rays, _trees
    from tpurt.kernels.traverse_pallas import (trace_any_packets,
                                               trace_closest_packets)
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh2 import (trace_any_bvh2,
                                                   trace_closest_bvh2)

    out = {}
    for name in ("lbvh", "sah"):
        scene_name, tree, tier, max_leaf = CASES[name]
        bvh, geom, depth = _trees(scene_name, tree)
        o, d, t_max = _rays(seed=17)
        args = ({k: jnp.asarray(v) for k, v in bvh.items()},
                {k: jnp.asarray(v) for k, v in geom.items()},
                jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(t_max))
        kw = dict(height=H, width=W, max_leaf=max_leaf, tables=tier,
                  interpret=True)
        scene = convert.bvh2_tensors(bvh, geom, depth, "cpu")
        rays = (torch.tensor(o), torch.tensor(d), T_MIN, torch.tensor(t_max))
        shape = dict(height=H, width=W, max_leaf=max_leaf)
        out[name] = dict(
            ref={k: np.asarray(v)
                 for k, v in trace_closest_packets(*args, **kw).items()},
            ref_occ=np.asarray(trace_any_packets(*args, **kw)),
            got={k: v.numpy()
                 for k, v in trace_closest_bvh2(scene, *rays,
                                                **shape).items()},
            got_occ=trace_any_bvh2(scene, *rays, **shape).numpy(),
            ulp=ULP_BOUND[tier])
    return out


@pytest.mark.parametrize("name", ["lbvh", "sah"])
def test_default_route_agrees_with_tpurt(name, tpurt_results):
    r = tpurt_results[name]
    np.testing.assert_array_equal(r["got_occ"], r["ref_occ"])
    assert r["got_occ"].any() and not r["got_occ"].all()
    ref, got = r["ref"], r["got"]
    same = ref["tri"] == got["tri"]
    assert (ref["tri"][~same] >= 0).all() and (got["tri"][~same] >= 0).all()
    assert (ulp_diff(ref["t"][~same], got["t"][~same]) <= r["ulp"]).all(), \
        "a differing hit is not a tie"
    assert ulp_diff(ref["t"][same], got["t"][same]).max() <= r["ulp"]
    assert np.abs(ref["u"][same] - got["u"][same]).max() <= 1e-5
    assert np.abs(ref["v"][same] - got["v"][same]).max() <= 1e-5
    assert (got["tri"] >= 0).sum() >= 20
