"""The frame's spans (``engine/frame.py``'s step hook, ``utils/spans.py``'s
default step) on a cut bench scene at 32x32 on the CPU, port only.

Held: a recording hook sees every name of ``SPANS`` in its order, each
under its parent (``shade.*`` inside ``shade``, ``sync.noise`` inside
``gtao``, the uploads' ``sync.*`` outside every step; ``shade.lights``
twice per shade call, ``shade.shadow`` once per light or fused trace), in
the plain frame, the fused-shadow frame and at spp 2, with the outputs of
the frame without a hook bit for bit; ``shade.texels`` (the texel fetch,
inside ``shade.surface``) once per shade call on a mip scene (the cut
textures workload, 1 and 4 taps, spp 1 and 2) and never on the bench
scene; a moved camera uploads its five
tensors each inside ``sync.camera`` and a still one none; the sharded
hooks' shadow traces run inside ``shade.shadow``; with the profiler off
the default step is one shared null context, and under ``torch.profiler``
the frame's Chrome trace holds the spans as user annotations.
"""
import collections
import contextlib
import json

import numpy as np
import pytest
import torch

SIZE = 32
LIGHTS = 3
PARENT = {"shade.surface": "shade", "shade.texels": "shade.surface",
          "shade.lights": "shade", "shade.shadow": "shade",
          "sync.noise": "gtao"}
# the cut textures workload (tests/test_torch_mip_frame.py's)
FIELD = dict(nx=3, nz=3, subdiv=2, spacing=1.0, extents=(16, 32, 64))
KEYS = ("image", "color", "depth", "normal", "ao")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _renderer(spp=1):
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    return build_bench_scene(Renderer(RendererConfig(
        width=SIZE, height=SIZE, spp=spp, device="cpu")),
        field=dict(nx=2, nz=2, subdiv=1), cubes=2)


class Recorder:
    """A step hook that records (name, parent) of every span entered."""

    def __init__(self):
        self.entered = []
        self._open = []

    @contextlib.contextmanager
    def step(self, name):
        self.entered.append((name, self._open[-1] if self._open else None))
        self._open.append(name)
        try:
            yield
        finally:
            self._open.pop()

    def names(self):
        return [n for n, _ in self.entered]

    def counts(self):
        return collections.Counter(self.names())


def _first_seen(names):
    return list(dict.fromkeys(names))


def _fused_frame(r, noise, step):
    """render_passes with every light's shadow rays in one fused trace."""
    from tpurt_torch.engine.frame import render_frame_fused

    c = r.config
    cam, lights, gtao = r._frame_inputs(step)
    return render_frame_fused(r.scene_device, cam, lights, gtao, r._lpm,
                              noise, width=c.width, height=c.height,
                              gtao_settings=c.gtao, spp=c.spp, step=step)


@pytest.mark.parametrize("frame", ["plain", "fused", "spp2"])
def test_spans_in_order_under_their_parents(frame):
    from tpurt_torch.engine.frame import SPANS, STEPS

    r = _renderer(spp=2 if frame == "spp2" else 1)
    spp = r.config.spp
    run = _fused_frame if frame == "fused" else (
        lambda r, noise, step: r.render_passes(noise, step))
    rec = Recorder()
    got = run(r, 3, rec.step)
    names = rec.names()
    # the bench scene has no mips: no texel fetch
    assert _first_seen(names) == [n for n in SPANS if n != "shade.texels"]
    assert [n for n in names if n in STEPS] == list(STEPS)
    for name, parent in rec.entered:
        assert parent == PARENT.get(name), (name, parent)
    counts = rec.counts()
    assert counts["shade"] == 1 and counts["shade.surface"] == spp
    assert counts["shade.texels"] == 0
    assert counts["shade.lights"] == spp * 2
    assert counts["shade.shadow"] == spp * (1 if frame == "fused"
                                            else LIGHTS)
    assert counts["sync.camera"] == 5 and counts["sync.noise"] == 1
    assert counts["sync.gtao"] == 2
    out = run(r, 3, lambda name: contextlib.nullcontext())
    for key in KEYS:
        assert torch.equal(got[key], out[key]), key


@pytest.mark.parametrize("spp,taps", [(1, 1), (2, 4)])
def test_texel_span_once_per_shade_call_on_a_mip_scene(spp, taps):
    """On a mip scene the texel fetch runs inside shade.texels, a child
    of shade.surface, once per shade() call, and every span keeps SPANS'
    order."""
    from tpurt_torch.app.textures_scene import build_textures_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.engine.frame import SPANS

    r = build_textures_scene(Renderer(RendererConfig(
        width=SIZE, height=SIZE, spp=spp, mipmaps=True, aniso_taps=taps,
        device="cpu")), field=FIELD)
    assert "tex_mip_sizes" in r.scene_device
    rec = Recorder()
    got = r.render_passes(2, rec.step)
    assert _first_seen(rec.names()) == list(SPANS)
    for name, parent in rec.entered:
        assert parent == PARENT.get(name), (name, parent)
    counts = rec.counts()
    assert counts["shade.texels"] == counts["shade.surface"] == spp
    out = r.render_passes(2)
    for key in KEYS:
        assert torch.equal(got[key], out[key]), key


def test_moved_camera_uploads_its_five_tensors():
    r = _renderer()
    r.render_passes(0)
    for move, camera_spans in ((True, 5), (False, 0)):
        if move:
            r.camera_mut().set_pos(r.camera.pos
                                   + np.float32([0.05, 0.0, 0.0]))
        rec = Recorder()
        r.render_passes(1, rec.step)
        counts = rec.counts()
        assert counts["sync.camera"] == camera_spans, counts
        assert counts["sync.lights"] == counts["sync.gtao"] == 0
        assert counts["sync.noise"] == 1


@pytest.mark.parametrize("hook", ["per_light", "multi"])
def test_sharded_shadow_hooks_run_inside_shade_shadow(hook):
    """shade's sharded-table hooks (dist/geometry.py's ring tours) are
    shadow traces: each call inside shade.shadow, the same colors as the
    frame's own traces."""
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_closest_bvh8)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import shade

    r = _renderer()
    cam, lights, _ = r._frame_inputs()
    scene = r.scene_device
    o, d = camera_rays(cam, SIZE, SIZE)
    hits = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX)

    def one(orig, dirs, t_min, t_max):
        return trace_any_bvh8(scene, orig, dirs, t_min, t_max)

    def multi(orig, dirs, t_min, t_maxs):
        return torch.stack([one(orig, dd, t_min, tm)
                            for dd, tm in zip(dirs, t_maxs)])

    kw = (dict(shadow_trace_fn=one) if hook == "per_light"
          else dict(shadow_trace_multi_fn=multi))
    rec = Recorder()
    got = shade(scene, cam, lights, hits, step=rec.step, **kw)
    assert rec.counts()["shade.shadow"] == (
        LIGHTS if hook == "per_light" else 1)
    assert all(p is None for _, p in rec.entered)
    want = shade(scene, cam, lights, hits)
    assert torch.equal(got["color"], want["color"])


def test_default_step_is_one_null_context_while_the_profiler_is_off():
    from torch.profiler import ProfilerActivity, profile

    from tpurt_torch.engine.frame import no_step

    a, b = no_step("shade"), no_step("sync.noise")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(no_step("shade"),
                          torch.autograd.profiler.record_function)
    assert no_step("shade") is a


def test_profiled_frame_holds_the_spans(tmp_path):
    """A frame with no hook under torch.profiler: its Chrome trace holds
    every step and the shade.* and sync.noise spans as user annotations,
    and the frame equals the unprofiled one."""
    from torch.profiler import ProfilerActivity, profile

    from tpurt_torch.engine.frame import STEPS

    r = _renderer()
    want = r.render_passes(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = r.render_passes(4)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    for name in ("shade.surface", "shade.lights", "shade.shadow",
                 "sync.noise", *STEPS):
        assert spans[name] >= 1, (name, spans)
    assert spans["shade.shadow"] == LIGHTS
    for key in KEYS:
        assert torch.equal(got[key], want[key]), key
