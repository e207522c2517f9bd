"""K2 (BVH8 any hit): the port's plain version against tpurt's
``trace_any_bvh8`` (Pallas in interpret mode), on the same rays.

Two ray sets per scene: shadow rays from the primary hits toward a point
light (t_max = the light distance, 0 on lanes without a hit, as the shade
pass builds them), and the primary rays themselves (occlusion = hit).
Tolerance: ``occ`` equal on >= 99.9% of rays, and every differing lane is
grazing (tests/torch_parity.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HitClassifier, camera, classify_occlusion,
                          resident_models)

T_MIN, T_MAX = 0.001, 10000.0
SHADOW_T_MIN = 0.01
LIGHT = np.array([1.5, -3.5, -1.0], np.float32)
CASES = [("box_field", (64, 64)), ("material_field", (40, 48)),
         ("tiny", (40, 48)), ("ground", (64, 64))]


def _ray_sets(scene, h, w):
    from tpurt.passes.rays import camera_rays
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8

    uni = camera(w, h).uniform()
    o, d = camera_rays({k: jnp.asarray(v) for k, v in uni.items()}, w, h)
    o, d = np.asarray(o), np.asarray(d)
    hits = trace_closest_bvh8(scene, torch.tensor(o), torch.tensor(d),
                              T_MIN, T_MAX)
    t = hits["t"].numpy()
    hit = hits["tri"].numpy() >= 0
    pos = (o + t[:, None] * d).astype(np.float32)
    to_light = LIGHT[None] - pos
    dist = np.sqrt((to_light * to_light).sum(1)).astype(np.float32)
    shadow_d = (to_light / dist[:, None]).astype(np.float32)
    shadow_tmax = np.where(hit, dist, np.float32(0.0)).astype(np.float32)
    return {
        "shadow": (pos, shadow_d, SHADOW_T_MIN, shadow_tmax),
        "primary": (o, d, T_MIN, np.full(h * w, T_MAX, np.float32)),
    }


@pytest.fixture(scope="module")
def results():
    from tpurt.kernels.traverse_bvh8 import trace_any_bvh8 as ref_trace
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8

    out = {}
    for name, (h, w) in CASES:
        pt = ref_flatten(resident_models(name)).as_pytree()
        scene = convert.scene_tensors(pt, "cpu")
        cls = HitClassifier(pt["bvh"]["nodes8"], pt["geom"])
        for kind, (o, d, t_min, t_max) in _ray_sets(scene, h, w).items():
            ref = ref_trace(pt["bvh"], pt["geom"], jnp.asarray(o),
                            jnp.asarray(d), t_min, jnp.asarray(t_max),
                            height=h, width=w, max_leaf=32, interpret=True)
            got = trace_any_bvh8(scene, torch.tensor(o), torch.tensor(d),
                                 t_min, torch.tensor(t_max))
            out[name, kind] = dict(ref=np.asarray(ref), got=got.numpy(),
                                   cls=cls, o=o, d=d, t_min=t_min,
                                   t_max=t_max)
    return out


KEYS = [(n, k) for n, _ in CASES for k in ("shadow", "primary")]


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "-".join(k))
def test_occlusion_agrees(key, results):
    r = results[key]
    same = r["ref"] == r["got"]
    assert same.mean() >= 0.999, f"occ agrees on {same.mean():.5f}"
    assert r["got"].dtype == np.bool_
    # t_max = 0 lanes are never occluded
    assert not r["got"][r["t_max"] == 0.0].any()
    if key[1] == "shadow":
        assert (r["t_max"] == 0.0).any()
        # one lone box cannot shadow its own lit side
        assert r["got"].any() == (key[0] != "tiny")


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "-".join(k))
def test_occlusion_differences_classified(key, results):
    r = results[key]
    kinds = classify_occlusion(r["cls"], r["ref"], r["got"], r["o"], r["d"],
                               r["t_min"], r["t_max"])
    assert kinds["other"] == 0, kinds
