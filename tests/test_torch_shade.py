"""The shade pass: the same hits through tpurt's ``shade`` (shadow rays on
its BVH8 any-hit kernel, Pallas in interpret mode) and the port's (plain
K2), on the cut bench scene at 40x48 (not a multiple of tpurt's 32x32
tile).

Tolerance: color within rtol 2e-4 / atol 1e-6 (pow and acos come from
different math libraries; measured 4.4e-5 relative at most); depth and the
encoded normal equal (measured equal: they take no transcendental).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

H, W = 40, 48


@pytest.fixture(scope="module")
def shaded():
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt.passes.rays import camera_rays
    from tpurt.passes.shade import shade as ref_shade
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import convert
    from tpurt_torch.passes.shade import shade

    r = build_bench_scene(RefRenderer(RefConfig(width=W, height=H,
                                                tracer="bvh8")),
                          field=dict(nx=3, nz=3, subdiv=2), cubes=2)
    cam = r.camera.uniform()
    lights = r.lights.shader_arrays()
    scene = r.scene_device
    o, d = camera_rays({k: jnp.asarray(v) for k, v in cam.items()}, W, H)
    hits = trace_closest_bvh8(scene["bvh"], scene["geom"], o, d, 0.001,
                              10000.0, height=H, width=W, max_leaf=32,
                              interpret=True)
    ref = ref_shade(scene, {k: jnp.asarray(v) for k, v in cam.items()},
                    {k: jnp.asarray(v) for k, v in lights.items()}, hits, o,
                    d, pallas_tables="bvh8", height=H, width=W, max_leaf=4)
    got = shade(convert.scene_tensors(r.scene.as_pytree(), "cpu"),
                convert.camera_tensors(cam, "cpu"),
                convert.light_tensors(lights, "cpu"),
                {k: torch.tensor(np.asarray(v)) for k, v in hits.items()})
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


def test_color(shaded):
    ref, got = shaded
    assert got["color"].shape == (H * W, 3)
    np.testing.assert_allclose(got["color"], ref["color"], rtol=2e-4,
                               atol=1e-6)
    assert (got["color"].max(-1) > 0).mean() > 0.3


@pytest.mark.parametrize("key", ["depth", "normal_enc"])
def test_depth_and_normal(key, shaded):
    ref, got = shaded
    np.testing.assert_array_equal(got[key], ref[key])
