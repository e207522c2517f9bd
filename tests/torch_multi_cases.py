"""Cases for the K5/K5p parity tests (tests/test_torch_multi*.py): the
port's fused multi-set any hit against tpurt's ``trace_any_bvh8_multi``
(Pallas in interpret mode, ``fat=1`` pinned) and against the port's own K2
per set.

Fixtures:

* ``random``: tpurt's ``tests/test_bvh8_multi.py`` setup (200 seeded random
  triangles, 64x64 rays from a fake hit surface, 3 light sets), with the
  port's BVH built by the port's own builders from the same numpy arrays;
* ``bench``: the real shadow rays of the cut bench scene's three lights
  (``tpurt_torch.passes.shade.shadow_rays``) at 64x64, on tpurt's tables;
* ``ragged_s1`` / ``ragged_s4``: a 40x72 frame of the random scene with
  t_max = 0 lanes, one set and four sets (the per-launch cap).

tpurt compiles its interpret-mode kernel once per scene, frame shape, set
count and pop mode (13-38 s each on an 8-core x86 CPU), so the files split
the tpurt side by pop mode and case: tests/test_torch_multi.py holds the
one-pop side, and each tests/test_torch_multi_pop2*.py module is one line
of ``pop2_tests`` over its cases, to keep each file short.

Tolerances: the port equals its own K2 per set bit for bit (every stack
entry carries the mask of the sets that reached it, so each set visits
what it would visit alone); against tpurt, occlusion equal on >= 99.9% of
lanes and every differing lane grazing (tests/torch_parity.py).
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import HitClassifier, classify_occlusion

T_MIN = 1e-2
LIGHTS = np.array([[4.0, 3.0, -2.0],
                   [-5.0, 1.0, 2.5],
                   [0.0, -6.0, 1.0],
                   [2.0, 5.0, -4.0]], np.float32)
CASES = ("random", "bench", "ragged_s1", "ragged_s4")


@functools.lru_cache(maxsize=None)
def random_scenes():
    """tpurt's tables and the port's, each from its own builders, over the
    same 200 random triangles."""
    from test_bvh import random_tris
    from tpurt.bvh import build_bvh_sah as ref_build
    from tpurt.bvh.wide import collapse8 as ref_collapse8
    from tpurt.kernels.traverse import make_traversal_geom
    from tpurt_torch.bvh import build_bvh_sah, collapse8
    from tpurt_torch.bvh.flat import tri_aabbs
    from tpurt_torch.bvh.wide import compact_bvh8
    from tpurt_torch.engine import convert

    v0, v1, v2 = random_tris(200, seed=7, spread=3.0, size=1.5)
    amin, amax = tri_aabbs(v0, v1, v2)
    ref_bvh = ref_build(amin, amax)
    ref = dict(bvh=dict(ref_bvh.as_pytree(),
                        nodes8=ref_collapse8(ref_bvh.as_pytree())[0]),
               geom={k: np.asarray(x) for k, x in make_traversal_geom(
                   v0, v1, v2, ref_bvh.tri_order).items()})
    bvh = build_bvh_sah(amin, amax)
    nodes8, depth8 = collapse8(bvh.as_pytree())
    order = np.asarray(bvh.tri_order)
    geom = dict(v0=v0[order], e1=v1[order] - v0[order],
                e2=v2[order] - v0[order], tri_id=order.astype(np.int32))
    port = dict(nodes8=torch.tensor(nodes8),
                nodes8c=compact_bvh8(torch.tensor(nodes8)),
                tris=torch.tensor(convert.pack_tris(geom)),
                depth8=depth8, num_tris=len(order))
    assert depth8 == convert.bvh8_depth(nodes8)
    return ref, port


def light_sets(org, lights):
    dirs, tmaxs = [], []
    for lp in lights:
        nn = lp[None, :] - org
        ln = np.linalg.norm(nn, axis=-1)
        dirs.append((nn / np.maximum(ln, 1e-20)[:, None]).astype(np.float32))
        tmaxs.append(ln.astype(np.float32))
    return np.stack(dirs), np.stack(tmaxs)


def surface_points(h, w):
    """Origins on a fake hit surface along tpurt's camera rays."""
    from tpurt.passes.rays import camera_rays
    from tpurt.scene.camera import Camera

    cam = Camera(aspect=w / h)
    cam.set_pos([0.0, 0.0, -10.0])
    cam.set_dir([0.0, 0.0, 1.0])
    o, d = camera_rays({k: jnp.asarray(v) for k, v in cam.uniform().items()},
                       w, h)
    return (np.asarray(o) + np.asarray(d) * 6.0).astype(np.float32)


def _bench():
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes.rays import T_MAX
    from tpurt_torch.passes.rays import T_MIN as PRIMARY_T_MIN
    from tpurt_torch.passes.rays import camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    h = w = 64
    r = build_bench_scene(RefRenderer(RefConfig(width=w, height=h,
                                                tracer="bvh8")),
                          field=dict(nx=3, nz=3, subdiv=2), cubes=2)
    pt = r.scene.as_pytree()
    scene = convert.scene_tensors(pt, "cpu")
    cam = convert.camera_tensors(r.camera.uniform(), "cpu")
    lights = convert.light_tensors(r.lights.shader_arrays(), "cpu")
    o, d = camera_rays(cam, w, h)
    hits = trace_closest_bvh8(scene, o, d, PRIMARY_T_MIN, T_MAX)
    rays = shadow_rays(scene, cam, lights, hits)
    dirs = np.stack([sd.numpy() for _, sd, _ in rays])
    tmaxs = np.stack([st.numpy() for _, _, st in rays])
    ref = dict(bvh=pt["bvh"], geom=pt["geom"])
    return ref, scene, rays[0][0].numpy(), dirs, tmaxs, SHADOW_T_MIN, (h, w)


def inputs(name):
    """(tpurt tables, port tables, origins, dirs (S, N, 3), t_max (S, N),
    t_min, (height, width)) of a case."""
    if name == "bench":
        return _bench()
    ref, port = random_scenes()
    if name == "random":
        org = surface_points(64, 64)
        dirs, tmaxs = light_sets(org, LIGHTS[:3])
        return ref, port, org, dirs, tmaxs, T_MIN, (64, 64)
    # the ragged frame: t_max = 0 on every fifth lane and on a whole band
    org = surface_points(40, 72)
    dirs, tmaxs = light_sets(org, LIGHTS)
    tmaxs[:, ::5] = 0.0
    tmaxs[1, :720] = 0.0
    sets = 1 if name == "ragged_s1" else 4
    return ref, port, org, dirs[:sets], tmaxs[:sets], T_MIN, (40, 72)


def run(name, pop2, with_ref=True):
    """The port's fused result, its K2 per set, and tpurt's fused result
    (when `with_ref`) on one case."""
    from tpurt.kernels.traverse_bvh8 import trace_any_bvh8_multi as ref_multi
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_any_bvh8_multi)

    ref, port, o, d, tm, t_min, (h, w) = inputs(name)
    solo = np.stack([trace_any_bvh8(port, torch.tensor(o),
                                    torch.tensor(d[s]), t_min,
                                    torch.tensor(tm[s])).numpy()
                     for s in range(len(d))])
    got = trace_any_bvh8_multi(port, torch.tensor(o), torch.tensor(d), t_min,
                               torch.tensor(tm), pop2=pop2).numpy()
    out = dict(got=got, solo=solo, o=o, d=d, tm=tm, t_min=t_min)
    if with_ref:
        kw = dict(fat=1) if pop2 else dict(fat=1, when_push=False)
        want = ref_multi(ref["bvh"], ref["geom"], jnp.asarray(o),
                         [jnp.asarray(x) for x in d], t_min,
                         [jnp.asarray(x) for x in tm], height=h, width=w,
                         interpret=True, pop2=pop2, **kw)
        out.update(ref=np.asarray(want),
                   cls=HitClassifier(ref["bvh"]["nodes8"], ref["geom"]))
    return out


def check_equals_k2(c):
    """The fused result equals K2 per set, bit for bit; t_max = 0 lanes are
    never occluded, and the sets do shadow something."""
    assert c["got"].shape == c["solo"].shape and c["got"].dtype == np.bool_
    np.testing.assert_array_equal(c["got"], c["solo"])
    assert not c["got"][c["tm"] <= c["t_min"]].any()
    assert c["got"].any()


def check_agrees_with_tpurt(c):
    assert c["ref"].shape == c["got"].shape
    assert (c["ref"] == c["got"]).mean() >= 0.999
    for s in range(c["got"].shape[0]):
        kinds = classify_occlusion(c["cls"], c["ref"][s], c["got"][s],
                                   c["o"], c["d"][s], c["t_min"], c["tm"][s])
        assert kinds["other"] == 0, (s, kinds)


def pop2_tests(names):
    """The K5p tests of the cases `names` (the port's plain version against
    tpurt's ``pop2=True`` and against the port's K2 per set): a module
    fixture and two parametrized tests, for a test module to bind as
    ``cases, test_..., test_... = pop2_tests(...)``."""

    @pytest.fixture(scope="module")
    def cases():
        return {name: run(name, pop2=True) for name in names}

    @pytest.mark.parametrize("name", names)
    def test_multi_pop2_equals_k2_per_set(name, cases):
        check_equals_k2(cases[name])

    @pytest.mark.parametrize("name", names)
    def test_multi_pop2_agrees_with_tpurt(name, cases):
        check_agrees_with_tpurt(cases[name])

    return (cases, test_multi_pop2_equals_k2_per_set,
            test_multi_pop2_agrees_with_tpurt)
