"""The traversal-variant frames of the port and of tpurt at 64x64 on
tests/test_torch_frame.py's cut bench scene (tests/test_torch_frame_*.py).

tpurt's jitted frame cannot take the switches (its shade passes no ``pop2``
to its shadow traces, and ``fuse_shadows`` is not a frame option), so its
variant frames are composed from its passes, as its
``tools/shadow_fusion_probe.py`` composes them: camera rays ->
``trace_closest_bvh8`` with ``pop2`` / ``uv_payload`` passed explicitly
(interpret mode, ``fat=1``) -> ``shade(pallas_tables="bvh8",
fuse_shadows=...)`` -> its frame tail (G-buffer quantization, its Pallas
GTAO, LPM). Its shadow traces keep their defaults, which is sound because
any-hit occlusion does not depend on the visit order. The port's variants
run as a user runs them: ``Renderer.render()`` with ``POP2_DEFAULT`` or
``UVP_DEFAULT`` set, or ``engine/frame.render_frame_fused``.

Bars (tests/test_torch_frame.py's): the image u8 equal on >= 99.9% of
pixels and never off by more than 2, except on the pixels where tpurt's
fused kernel finds a grazing occluder that its per-light trace and the
port do not (``torch_parity.fused_grazing_lanes``; one pixel of 4,096 on
this scene).
"""
from __future__ import annotations

import functools

import jax
import numpy as np

from torch_parity import (HitClassifier, fused_grazing_lanes,
                          recording_ref_multi)

SIZE = 64
FIELD = dict(nx=3, nz=3, subdiv=2)
CUBES = 2


def renderers():
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    ref_r = build_bench_scene(
        RefRenderer(RefConfig(width=SIZE, height=SIZE, tracer="bvh8")),
        field=FIELD, cubes=CUBES)
    port_r = build_bench_scene(
        Renderer(RendererConfig(width=SIZE, height=SIZE, device="cpu")),
        field=FIELD, cubes=CUBES)
    return ref_r, port_r


def ref_frame(ref_r, *, pop2=False, uv_payload=False, fuse_shadows=False):
    """tpurt's frame (noise index 0) from its passes: its image, and the
    pixels where its fused occlusion differs (grazing) from the port's."""
    import jax.numpy as jnp

    from tpurt.bvh.wide import LEAF8_MAX
    from tpurt.engine.frame import MAX_LEAF
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt.passes.gtao import gtao_constants
    from tpurt.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt.passes.shade import shade
    from tpurt_torch.engine import convert

    c = ref_r.config
    h = w = SIZE
    cam = {k: jnp.asarray(v) for k, v in ref_r.camera.uniform().items()}
    lights = {k: jnp.asarray(v)
              for k, v in ref_r.lights.shader_arrays().items()}
    scene = ref_r.scene_device
    o, d = camera_rays(cam, w, h)
    pins = dict(fat=1) if pop2 else dict(fat=1, when_push=False)
    hits = trace_closest_bvh8(scene["bvh"], scene["geom"], o, d, T_MIN, T_MAX,
                              height=h, width=w, max_leaf=LEAF8_MAX,
                              interpret=True, pop2=pop2,
                              uv_payload=uv_payload, **pins)
    with recording_ref_multi() as calls:
        g = shade(scene, cam, lights, hits, o, d, pallas_tables="bvh8",
                  height=h, width=w, max_leaf=MAX_LEAF,
                  fuse_shadows=fuse_shadows)
    grazing = np.zeros(h * w, bool)
    if calls:
        grazing = fused_grazing_lanes(
            HitClassifier(scene["bvh"]["nodes8"], scene["geom"]), calls[0],
            convert.scene_tensors(ref_r.scene.as_pytree(), "cpu"))
    consts = gtao_constants(w, h, ref_r.camera.znear, ref_r.camera.zfar,
                            ref_r.camera.fovy, ref_r.camera.aspect)
    assert c.enable_gtao and c.enable_tonemap
    image = _ref_tail(g, consts, ref_r._lpm_derived, np.int32(0),
                      gtao=ref_r._effective_gtao())
    return np.asarray(image), grazing.reshape(h, w)


@functools.partial(jax.jit, static_argnames=("gtao",))
def _ref_tail(g, consts, lpm, noise_index, *, gtao):
    """tpurt's frame tail after the shade pass (tpurt/engine/frame.py:
    render_frame), compiled as one program."""
    from tpurt.passes.encodings import (pack_unorm8, quantize_r11g11b10f,
                                        quantize_r16f)
    from tpurt.passes.gtao import ao_visibility_u8, compute_ao
    from tpurt.passes.tonemap import tonemap_frame

    h = w = SIZE
    color = quantize_r11g11b10f(g["color"]).reshape(h, w, 3)
    depth = quantize_r16f(g["depth"]).reshape(h, w)
    normal = quantize_r11g11b10f(g["normal_enc"]).reshape(h, w, 3)
    ao = ao_visibility_u8(compute_ao(depth, normal, consts, gtao,
                                     noise_index), gtao)
    return pack_unorm8(tonemap_frame(color, ao, lpm))


def port_fused_frame(port_r):
    """The port's fused-shadow frame (noise index 0)."""
    from tpurt_torch.engine.frame import render_frame_fused
    from tpurt_torch.passes.gtao import noise_maps_64

    c = port_r.config
    cam, lights, gtao = port_r._frame_inputs()
    return render_frame_fused(
        port_r.scene_device, cam, lights, gtao, port_r._lpm,
        noise_maps_64(0, "cpu"),
        width=c.width, height=c.height, gtao_settings=c.gtao,
        enable_gtao=c.enable_gtao,
        enable_tonemap=c.enable_tonemap)["image"].numpy()


def port_render(port_r, monkeypatch, **flags):
    """Renderer.render() at noise index 0 with traverse_bvh8's module
    switches set (POP2_DEFAULT, UVP_DEFAULT), restored afterwards."""
    from tpurt_torch.kernels import traverse_bvh8 as tb

    with monkeypatch.context() as m:
        for key, val in flags.items():
            m.setattr(tb, key, val)
        port_r._frame_idx = 0
        return port_r.render()["image"].numpy()


def check_image(got, ref, grazing=None):
    """`got` against `ref` at the bars above; `grazing` (H, W) masks the
    pixels of classified grazing lanes out of the max-difference bar."""
    assert got.shape == ref.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int)).max(-1)
    assert (d == 0).mean() >= 0.999, (d == 0).mean()
    if grazing is not None:
        assert grazing.mean() <= 1e-3
        d = d[~grazing]
    assert d.max() <= 2, d.max()
    assert (got.max(-1) > 0).mean() > 0.3  # not a black frame
