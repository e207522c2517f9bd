"""K6 (binary-BVH closest and any hit): the port's plain version against
tpurt's ``trace_closest_packets`` / ``trace_any_packets`` (Pallas in
interpret mode), on the same trees and rays, in two table tiers:

  * ``tables="hbm"`` on an LBVH (``max_leaf=1``), the dynamic rebuild
    frame's tracer, built by tpurt's ``build_world_tables`` under a
    rotation;
  * ``tables="smem"`` on the static scene's binned-SAH tree
    (``max_leaf=4``).

Rays: a 44x60 camera frame (not a multiple of tpurt's 32x32 tile) with
per-ray t_max mostly far, some short and some 0 (inactive lanes), plus a
scene of 2 triangles (fewer than a leaf's 4; the SAH root is a leaf).

Tolerances: occlusion equal on 100% of rays — any-hit does not depend on
the visiting order, and a lane that hits a leaf box hits every ancestor box
(boxes nest and rounding is monotone), so the packet's any-lane descent
and the port's per-ray descent test the same triangles. Closest ``tri``
equal except on ties: tpurt orders children by its packet's mean
direction, the port by each ray's own entry distance, so of two triangles
at the same distance (shared LBVH edges) each may keep another; a tie is
both ``t`` within the tier's ULP bound. Where ``tri`` agrees, ``t`` within
that bound and ``u``/``v`` within 1e-5: tpurt's interpret run is compiled
by XLA:CPU, which may contract Moller-Trumbore's products into FMAs. The
port's ``t`` equals a separately rounded numpy Moller-Trumbore; tpurt's
smem tier does too, its hbm tier differs by up to 3 ULP (measured), so the
bound is 2 ULP for smem and 4 for hbm.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import camera, resident_models, ulp_diff

T_MIN, T_MAX = 0.001, 10000.0
H, W = 44, 60
ANGLE = 0.3
ULP_BOUND = {"smem": 2, "hbm": 4}
# name -> (scene, tree, tpurt tier, max_leaf)
CASES = {
    "lbvh": ("ground", "lbvh", "hbm", 1),
    "sah": ("box_field", "sah", "smem", 4),
    "tiny_lbvh": ("plane", "lbvh", "hbm", 1),
    "tiny_sah": ("plane", "sah", "smem", 4),
}


def _models(name):
    if name != "plane":
        return resident_models(name)
    from tpurt.scene.procedural import ground_plane

    m = ground_plane()
    m.update_model_status(np.zeros(3, np.float32))
    return [m]


def _trees(scene_name, tree):
    """(bvh, geom, depth bound) of one tree as numpy arrays."""
    from tpurt.engine.dynamic import build_world_tables
    from tpurt.scene.scene import flatten_scene
    from tpurt_torch.bvh.flat import bvh_max_depth
    from tpurt_torch.bvh.lbvh import depth_bound

    flat = flatten_scene(_models(scene_name))
    if tree == "sah":
        bvh = {k: np.asarray(v) for k, v in flat.bvh.items()}
        geom = {k: np.asarray(v) for k, v in flat.geom.items()}
        return bvh, geom, bvh_max_depth(bvh["entry"], bvh["skip"],
                                        bvh["tri_count"])
    c, s = np.cos(ANGLE), np.sin(ANGLE)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t = np.asarray(flat.transforms).copy()
    t[:, :, :3] = np.einsum("ij,njk->nik", rot, t[:, :, :3])
    world = build_world_tables(
        {k: jnp.asarray(v) for k, v in flat.as_object_pytree().items()},
        jnp.asarray(t))
    bvh = {k: np.asarray(v) for k, v in world["bvh"].items()}
    geom = {k: np.asarray(v) for k, v in world["geom"].items()}
    return bvh, geom, depth_bound(geom["v0"].shape[0])


def _rays(seed):
    from tpurt.passes.rays import camera_rays

    uni = camera(W, H).uniform()
    o, d = camera_rays({k: jnp.asarray(v) for k, v in uni.items()}, W, H)
    rng = np.random.default_rng(seed)
    t_max = np.full(H * W, T_MAX, np.float32)
    pick = rng.random(H * W)
    t_max[pick < 0.1] = rng.uniform(2.0, 6.0, (pick < 0.1).sum())
    t_max[pick > 0.95] = 0.0
    return np.asarray(o), np.asarray(d), t_max


@pytest.fixture(scope="module")
def results():
    from tpurt.kernels.traverse_pallas import (trace_any_packets,
                                               trace_closest_packets)
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh2 import (trace_any_bvh2,
                                                   trace_closest_bvh2)

    out = {}
    for i, (name, (scene_name, tree, tier, max_leaf)) in enumerate(
            CASES.items()):
        bvh, geom, depth = _trees(scene_name, tree)
        o, d, t_max = _rays(seed=i)
        kw = dict(height=H, width=W, max_leaf=max_leaf, tables=tier,
                  interpret=True)
        args = ({k: jnp.asarray(v) for k, v in bvh.items()},
                {k: jnp.asarray(v) for k, v in geom.items()},
                jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(t_max))
        ref = trace_closest_packets(*args, **kw)
        ref_occ = trace_any_packets(*args, **kw)
        scene = convert.bvh2_tensors(bvh, geom, depth, "cpu")
        rays = (torch.tensor(o), torch.tensor(d), T_MIN, torch.tensor(t_max))
        got = trace_closest_bvh2(scene, *rays, max_leaf=max_leaf)
        got_occ = trace_any_bvh2(scene, *rays, max_leaf=max_leaf)
        out[name] = dict(
            ref={k: np.asarray(v) for k, v in ref.items()},
            got={k: v.numpy() for k, v in got.items()},
            ref_occ=np.asarray(ref_occ), got_occ=got_occ.numpy(),
            t_max=t_max, num_tris=geom["v0"].shape[0], ulp=ULP_BOUND[tier])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_occlusion_equal(name, results):
    r = results[name]
    np.testing.assert_array_equal(r["got_occ"], r["ref_occ"])
    dead = r["t_max"] == 0.0
    assert not r["got_occ"][dead].any()
    assert r["got_occ"].any() and not r["got_occ"].all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_closest_equal_except_ties(name, results):
    r = results[name]
    ref, got = r["ref"], r["got"]
    same = ref["tri"] == got["tri"]
    diff = ~same
    assert (ref["tri"][diff] >= 0).all() and (got["tri"][diff] >= 0).all()
    assert (ulp_diff(ref["t"][diff], got["t"][diff]) <= r["ulp"]).all(), \
        "a differing hit is not a tie"
    assert ulp_diff(ref["t"][same], got["t"][same]).max() <= r["ulp"]
    assert np.abs(ref["u"][same] - got["u"][same]).max() <= 1e-5
    assert np.abs(ref["v"][same] - got["v"][same]).max() <= 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_closest_contract(name, results):
    r = results[name]
    got, t_max = r["got"], r["t_max"]
    miss = got["tri"] < 0
    np.testing.assert_array_equal(got["t"][miss], t_max[miss])
    assert (got["u"][miss] == 0).all() and (got["v"][miss] == 0).all()
    dead = t_max == 0.0
    assert (got["tri"][dead] == -1).all()
    assert miss.any() and (~miss).sum() >= 20
    assert got["tri"].dtype == np.int32 and got["tri"].max() < r["num_tris"]


def test_stack_bound_refuses_deep_trees():
    """The port sizes K6's stack from the tree's depth bound and refuses a
    tree that could overflow it (tpurt clamps its stack silently)."""
    from tpurt_torch.bvh.lbvh import depth_bound
    from tpurt_torch.kernels.traverse_bvh2 import STACK_SIZES, kernel_stack

    assert depth_bound(43_274) == 49 and kernel_stack(49) == 64
    assert kernel_stack(depth_bound((1 << 24) - 1)) == 64
    assert kernel_stack(100) == 192
    with pytest.raises(ValueError):
        kernel_stack(STACK_SIZES[-1])
