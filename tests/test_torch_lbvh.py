"""The dynamic scene's acceleration structures: the port's LBVH builder and
BVH8 refit against tpurt's, on the same inputs.

Tolerances: the LBVH is integer work plus min/max and one division per
axis (tensor by tensor, rounded once on both sides), so every table is
held equal bit for bit: entry, skip, first_tri, tri_count, tri_order and
the boxes. The refit plan is the same numpy code and the refit is min/max
of the same boxes: equal bit for bit. refit_quality sums ~10^4 areas in
another order than XLA does: relative 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import resident_models

# name -> (N, share of centroids collapsed onto one point)
BOX_SETS = {"one": (1, 0.0), "two": (2, 0.0), "three": (3, 0.0),
            "duplicates": (40, 0.5), "all_same": (9, 1.0),
            "few_hundred": (300, 0.0), "few_hundred_dup": (357, 0.2)}


def _boxes(n, dup, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    c[rng.random(n) < dup] = c[0]
    e = rng.uniform(0.0, 0.3, (n, 3)).astype(np.float32)
    return c - e, c + e


@pytest.mark.parametrize("name", sorted(BOX_SETS))
def test_lbvh_equals_reference(name):
    from tpurt.bvh.lbvh import build_lbvh as ref_build
    from tpurt_torch.bvh.lbvh import build_lbvh, depth_bound

    n, dup = BOX_SETS[name]
    lo, hi = _boxes(n, dup, seed=n)
    ref = ref_build(jnp.asarray(lo), jnp.asarray(hi)).as_pytree()
    got = build_lbvh(torch.tensor(lo), torch.tensor(hi))
    assert got.builder == "lbvh"
    got = got.as_pytree()
    for k, v in ref.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        if v.dtype == np.float32:
            g, v = g.view(np.int32), v.view(np.int32)
        np.testing.assert_array_equal(g, v, err_msg=k)
    # the traversal stack bound holds: every node within depth_bound
    from tpurt_torch.bvh.flat import bvh_max_depth

    assert bvh_max_depth(got["entry"].numpy(), got["skip"].numpy(),
                         got["tri_count"].numpy()) <= depth_bound(n)


def test_morton_codes_equal_reference():
    from tpurt.bvh.lbvh import morton_codes_3d as ref_morton
    from tpurt_torch.bvh.lbvh import morton_codes_3d

    rng = np.random.default_rng(5)
    pts = rng.uniform(-2.0, 7.0, (1000, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    ref = np.asarray(ref_morton(jnp.asarray(pts), jnp.asarray(lo),
                                jnp.asarray(hi))).astype(np.int64)
    got = morton_codes_3d(torch.tensor(pts), torch.tensor(lo),
                          torch.tensor(hi)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def refit_case():
    """A scene's rest-pose BVH8 and its triangles moved by a rotation and a
    per-instance shift, in SAH order."""
    from tpurt.scene.scene import flatten_scene

    flat = flatten_scene(resident_models("ground"))
    nodes8 = np.asarray(flat.bvh["nodes8"], np.float32)
    rng = np.random.default_rng(3)
    v0 = np.asarray(flat.geom["v0"])
    v1 = v0 + np.asarray(flat.geom["e1"])
    v2 = v0 + np.asarray(flat.geom["e2"])
    a = 0.7
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    shift = rng.uniform(-1, 1, (v0.shape[0], 3)).astype(np.float32)
    vs = [(v @ rot.T + shift).astype(np.float32) for v in (v0, v1, v2)]
    tri_min = np.minimum(np.minimum(vs[0], vs[1]), vs[2])
    tri_max = np.maximum(np.maximum(vs[0], vs[1]), vs[2])
    return nodes8, tri_min, tri_max


def test_refit_plan_equals_reference(refit_case):
    from tpurt.bvh.wide import refit_plan as ref_plan
    from tpurt_torch.bvh.wide import refit_plan

    nodes8 = refit_case[0]
    ref, got = ref_plan(nodes8), refit_plan(nodes8)
    assert len(got) == len(ref) >= 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_refit_bvh8_equals_reference(refit_case):
    from tpurt.bvh.wide import LEAF8_MAX
    from tpurt.bvh.wide import refit_bvh8 as ref_refit
    from tpurt.bvh.wide import refit_plan as ref_plan
    from tpurt_torch.bvh.wide import refit_bvh8, refit_plan

    nodes8, tri_min, tri_max = refit_case
    ref = np.asarray(ref_refit(
        jnp.asarray(nodes8), [jnp.asarray(l) for l in ref_plan(nodes8)],
        jnp.asarray(tri_min), jnp.asarray(tri_max), leaf_max=LEAF8_MAX))
    got = refit_bvh8(torch.tensor(nodes8),
                     [torch.tensor(l, dtype=torch.int64)
                      for l in refit_plan(nodes8)],
                     torch.tensor(tri_min), torch.tensor(tri_max),
                     leaf_max=LEAF8_MAX).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert not np.array_equal(got[:, :48], nodes8[:, :48])  # boxes moved


def test_refit_quality_close_to_reference(refit_case):
    from tpurt.bvh.wide import refit_quality as ref_quality
    from tpurt_torch.bvh.wide import refit_quality

    nodes8, tri_min, tri_max = refit_case
    ref = float(ref_quality(jnp.asarray(nodes8), jnp.asarray(tri_min),
                            jnp.asarray(tri_max)))
    got = float(refit_quality(torch.tensor(nodes8), torch.tensor(tri_min),
                              torch.tensor(tri_max)))
    assert abs(got - ref) <= 1e-5 * abs(ref) and ref > 0
