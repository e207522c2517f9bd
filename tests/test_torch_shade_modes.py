"""The shade pass's fused shadows: ``fuse_shadows=True`` (one K5 trace for
every light) through tpurt's ``shade(..., pallas_tables="bvh8")`` with the
same arguments (its shadow kernels in interpret mode) and the port's (plain
versions), on the cut bench scene at 40x48 as tests/test_torch_shade.py
runs the per-light loop.

Tolerances: against tpurt, color within rtol 2e-4 / atol 1e-6 (pow and
acos come from different math libraries), depth and the encoded normal
equal (tests/test_torch_shade.py's bars). tpurt's fused kernel pushes a
child when any lane of any set hits it and has no per-set box mask, so on
grazing lanes it can find an occluder that its per-light trace (and the
port) does not reach: the comparison records tpurt's shadow rays,
classifies every lane whose occlusion differs (tests/torch_parity.py; 2 of
the 1,920 pixels here, both grazing, bar 0.5%) and holds the color of the
other pixels. Within the port the fused shade equals the per-light loop bit
for bit, since the fused occlusion equals the per-light traces.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HitClassifier, fused_grazing_lanes,
                          recording_ref_multi)

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
    port = dict(scene=convert.scene_tensors(r.scene.as_pytree(), "cpu"),
                camera=convert.camera_tensors(cam, "cpu"),
                lights=convert.light_tensors(lights, "cpu"),
                hits={k: torch.tensor(np.asarray(v))
                      for k, v in hits.items()})
    with recording_ref_multi() as calls:
        out = ref_shade(scene, {k: jnp.asarray(v) for k, v in cam.items()},
                        {k: jnp.asarray(v) for k, v in lights.items()},
                        hits, o, d, pallas_tables="bvh8", height=H, width=W,
                        max_leaf=4, fuse_shadows=True)
    assert len(calls) == 1  # the one fused trace
    got = {mode: shade(port["scene"], port["camera"], port["lights"],
                       port["hits"], fuse_shadows=mode == "fused")
           for mode in ("fused", "loop")}
    return dict(ref={k: np.asarray(v) for k, v in out.items()}, got=got,
                port=port, fused_rays=calls[0],
                cls=HitClassifier(scene["bvh"]["nodes8"], scene["geom"]))


def test_fused_agrees_with_tpurt(shaded):
    ref, got = shaded["ref"], shaded["got"]["fused"]
    keep = ~fused_grazing_lanes(shaded["cls"], shaded["fused_rays"],
                                shaded["port"]["scene"])
    assert keep.mean() >= 0.995
    np.testing.assert_allclose(got["color"].numpy()[keep], ref["color"][keep],
                               rtol=2e-4, atol=1e-6)
    for k in ("depth", "normal_enc"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert (got["color"].numpy().max(-1) > 0).mean() > 0.3


def test_fused_equals_loop_bitwise(shaded):
    loop, got = shaded["got"]["loop"], shaded["got"]["fused"]
    for k in loop:
        assert torch.equal(got[k].view(torch.int32),
                           loop[k].view(torch.int32)), k


@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (1, 2)])
def test_fused_pair_equals_loop_bitwise(pair, shaded, monkeypatch):
    """Two lights still fuse (one K5 trace of two sets) and give the
    loop's bits."""
    from tpurt_torch.passes import shade as shade_mod

    p = shaded["port"]
    two = {k: v[list(pair)] for k, v in p["lights"].items()}
    loop = shade_mod.shade(p["scene"], p["camera"], two, p["hits"])
    calls = []
    fused_trace = shade_mod.trace_any_bvh8_multi

    def counted(*args, **kwargs):
        calls.append(1)
        return fused_trace(*args, **kwargs)

    monkeypatch.setattr(shade_mod, "trace_any_bvh8_multi", counted)
    out = shade_mod.shade(p["scene"], p["camera"], two, p["hits"],
                          fuse_shadows=True)
    assert calls == [1]
    for k, v in loop.items():
        assert torch.equal(out[k].view(torch.int32), v.view(torch.int32)), k


@pytest.mark.parametrize("light", [0, 1, 2])
def test_one_light_falls_back_to_the_loop(light, shaded, monkeypatch):
    """With one light, fuse_shadows takes the loop, as in tpurt
    (``shade.py:772-773``): no fused trace, the loop's bits."""
    from tpurt_torch.passes import shade as shade_mod

    p = shaded["port"]
    one = {k: v[light:light + 1] for k, v in p["lights"].items()}
    loop = shade_mod.shade(p["scene"], p["camera"], one, p["hits"])

    def no_fused(*args, **kwargs):
        raise AssertionError("one light must not take the fused trace")

    monkeypatch.setattr(shade_mod, "trace_any_bvh8_multi", no_fused)
    out = shade_mod.shade(p["scene"], p["camera"], one, p["hits"],
                          fuse_shadows=True)
    for k, v in loop.items():
        assert torch.equal(out[k].view(torch.int32), v.view(torch.int32))


def test_rebuild_tables_never_fuse(shaded, monkeypatch):
    """fuse_shadows is taken only with the BVH8 tables (tpurt's
    ``pallas_tables == "bvh8"``): the binary-BVH tables trace per light."""
    from tpurt_torch.passes import shade as shade_mod

    calls = []
    monkeypatch.setattr(shade_mod, "trace_any_bvh8_multi",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(shade_mod, "shadow_tracer",
                        lambda tables, max_leaf=1: shade_mod.trace_any_bvh8)
    p = shaded["port"]
    out = shade_mod.shade(p["scene"], p["camera"], p["lights"], p["hits"],
                          tables="bvh2", fuse_shadows=True)
    assert not calls
    for k, v in shaded["got"]["loop"].items():
        assert torch.equal(out[k].view(torch.int32), v.view(torch.int32))
