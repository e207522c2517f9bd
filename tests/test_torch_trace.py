"""K1 (BVH8 closest hit): the port's plain version against tpurt's
``trace_closest_bvh8`` (Pallas in interpret mode), on the same rays.

Tolerances: ``tri`` equal on >= 99.9% of rays, and every differing ray is a
tie or a grazing ray (tests/torch_parity.py). Where ``tri`` agrees, ``t``
is within 2 ULP and ``u``/``v`` within 1e-5: tpurt's interpret run is
compiled by XLA:CPU, which may contract Moller-Trumbore's products into
FMAs; the port's f32 ops are separately rounded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HitClassifier, camera, classify_closest,
                          resident_models, ulp_diff)

T_MIN, T_MAX = 0.001, 10000.0
# (scene, (height, width)): 40x48 is not a multiple of tpurt's 32x32 tile
CASES = [("box_field", (64, 64)), ("material_field", (40, 48)),
         ("tiny", (40, 48)), ("ground", (64, 64))]


def _rays(h, w, seed):
    """tpurt's camera rays plus per-ray t_max: mostly T_MAX, some short
    (hits beyond them become misses) and some 0 (retired at once)."""
    from tpurt.passes.rays import camera_rays

    uni = camera(w, h).uniform()
    o, d = camera_rays({k: jnp.asarray(v) for k, v in uni.items()}, w, h)
    rng = np.random.default_rng(seed)
    t_max = np.full(h * w, T_MAX, np.float32)
    pick = rng.random(h * w)
    t_max[pick < 0.1] = rng.uniform(2.0, 6.0, (pick < 0.1).sum())
    t_max[pick > 0.95] = 0.0
    return np.asarray(o), np.asarray(d), t_max


@pytest.fixture(scope="module")
def results():
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8 as ref_trace
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8

    out = {}
    for i, (name, (h, w)) in enumerate(CASES):
        pt = ref_flatten(resident_models(name)).as_pytree()
        o, d, t_max = _rays(h, w, seed=i)
        ref = ref_trace(pt["bvh"], pt["geom"], jnp.asarray(o), jnp.asarray(d),
                        T_MIN, jnp.asarray(t_max), height=h, width=w,
                        max_leaf=32, interpret=True)
        scene = convert.scene_tensors(pt, "cpu")
        got = trace_closest_bvh8(scene, torch.tensor(o), torch.tensor(d),
                                 T_MIN, torch.tensor(t_max))
        out[name] = dict(
            ref={k: np.asarray(v) for k, v in ref.items()},
            got={k: v.numpy() for k, v in got.items()},
            cls=HitClassifier(pt["bvh"]["nodes8"], pt["geom"]),
            o=o, d=d, t_max=t_max)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_closest_tri_and_t(name, results):
    r = results[name]
    ref, got = r["ref"], r["got"]
    same = ref["tri"] == got["tri"]
    assert same.mean() >= 0.999, f"tri agrees on {same.mean():.5f}"
    assert ulp_diff(ref["t"][same], got["t"][same]).max() <= 2
    assert np.abs(ref["u"][same] - got["u"][same]).max() <= 1e-5
    assert np.abs(ref["v"][same] - got["v"][same]).max() <= 1e-5
    # the slice really covers hits, misses and t_max = 0 lanes
    assert (got["tri"] >= 0).sum() >= 50
    assert (got["tri"] < 0).any()
    dead = r["t_max"] == 0.0
    assert (got["tri"][dead] == -1).all() and (got["t"][dead] == 0.0).all()


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_closest_differences_classified(name, results):
    r = results[name]
    kinds = classify_closest(r["cls"], r["ref"], r["got"], r["o"], r["d"],
                             T_MIN, np.float32(T_MAX))
    assert kinds["other"] == 0, kinds


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_closest_miss_contract(name, results):
    got = results[name]["got"]
    t_max = results[name]["t_max"]
    miss = got["tri"] < 0
    np.testing.assert_array_equal(got["t"][miss], t_max[miss])
    assert (got["u"][miss] == 0).all() and (got["v"][miss] == 0).all()
    assert got["tri"].dtype == np.int32


def test_classifier_spots_grazing_rays():
    """The grazing test: a ray that misses a leaf box by a hair is grazing
    for a triangle inside it, and a ray through the box is not."""
    pt_models = resident_models("tiny")
    from tpurt_torch.scene.scene import flatten_scene

    pt = flatten_scene(pt_models).as_pytree()
    cls = HitClassifier(pt["bvh"]["nodes8"], pt["geom"])
    box = cls.path_boxes(0)[0]
    lo, hi = box[0:3], box[3:6]
    centre = (lo + hi) / 2
    d = np.array([0.0, 0.0, 1.0], np.float32)
    inside = np.array([centre[0], centre[1], lo[2] - 1.0], np.float32)
    outside = np.array([hi[0] + 1e-3, centre[1], lo[2] - 1.0], np.float32)
    assert not cls.grazing(0, inside, d, T_MIN, np.float32(T_MAX))
    assert cls.grazing(0, outside, d, T_MIN, np.float32(T_MAX))
