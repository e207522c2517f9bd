"""The frame's spans (``engine/frame.py``'s step hook, ``utils/spans.py``'s
default step) on a cut bench scene at 32x32 on the CPU, port only.

Held: a recording hook sees every name of ``SPANS`` in its order, each
under its parent (``shade.*`` inside ``shade``, the inputs' ``upload``
outside every step; ``shade.lights`` twice per shade call,
``shade.shadow`` once per light or fused trace), in the plain frame, the
fused-shadow frame and at spp 2, with the outputs of the frame without a
hook bit for bit; ``shade.texels`` (the texel fetch, inside
``shade.surface``) once per shade call on a mip scene (the cut textures
workload, 1 and 4 taps, spp 1 and 2) and never on the bench scene; no
span is a ``sync.*`` span, and a moved camera, a changed light or a
resize uploads its inputs in one ``upload`` (the same tensors while the
shapes stay) and a still camera none; the sharded
hooks' shadow traces run inside ``shade.shadow``; with the profiler off
the default step is one shared null context, and under ``torch.profiler``
the frame's Chrome trace holds the spans as user annotations. On the card
(marked ``gpu``, skipped without one), by the launch counter inside each
span: ``shade.surface`` holds K10 alone on the bench scene, and K10, K9
(inside ``shade.texels``) and K10's epilogue on a mip scene.
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
          "shade.lights": "shade", "shade.shadow": "shade"}
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
    from tpurt_torch.passes.gtao import noise_maps_64

    c = r.config
    cam, lights, gtao = r._frame_inputs(step)
    return render_frame_fused(r.scene_device, cam, lights, gtao, r._lpm,
                              noise_maps_64(noise, r.device),
                              width=c.width, height=c.height,
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
    assert counts["upload"] == 1
    assert not [n for n in names if n.startswith("sync.")]
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


def _moved_camera(r):
    r.camera_mut().set_pos(r.camera.pos + np.float32([0.05, 0.0, 0.0]))


def _recoloured_light(r):
    light = r.lights_mut().all_lights()[0]
    light.color = np.asarray(light.color, np.float32) * 0.5


def _resized(r):
    r.resize(SIZE + 8, SIZE)


@pytest.mark.parametrize("change,uploads", [
    ("moved", 1), ("still", 0), ("light", 1), ("resize", 1)])
def test_moved_camera_uploads_its_five_tensors(change, uploads):
    """A frame whose camera moved (or whose light changed colour, or that
    was resized) copies its inputs once, inside ``upload``, into the same
    tensors, and makes no blocking host-to-device copy: no ``sync.*`` span,
    and every host-to-device transfer of the frame's inputs goes through
    the one packed copy; a still camera copies nothing. The frame equals a
    fresh renderer's frame with the same camera, lights and size."""
    r = _renderer()
    r.render_passes(0)
    before = r._frame_inputs()
    {"moved": _moved_camera, "still": lambda r: None,
     "light": _recoloured_light, "resize": _resized}[change](r)
    rec = Recorder()
    got = r.render_passes(1, rec.step)
    counts = rec.counts()
    assert counts["upload"] == uploads, counts
    assert not [n for n in counts if n.startswith("sync.")], counts
    after = r._frame_inputs()
    for a, b in zip(before, after):
        assert all(a[k] is b[k] for k in a if k != "host")
    fresh = _renderer()
    fresh.camera_mut().set_pos(r.camera.pos)
    fresh.lights = r.lights
    fresh.resize(r.config.width, r.config.height)
    want = fresh.render_passes(1)
    for key in KEYS:
        assert torch.equal(got[key], want[key]), key


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

    a, b = no_step("shade"), no_step("upload")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(no_step("shade"),
                          torch.autograd.profiler.record_function)
    assert no_step("shade") is a


def test_profiled_frame_holds_the_spans(tmp_path):
    """A frame with no hook under torch.profiler: its Chrome trace holds
    every step and the shade.* and upload spans as user annotations,
    and the frame equals the unprofiled one."""
    from torch.profiler import ProfilerActivity, profile

    from tpurt_torch.engine.frame import STEPS

    r = _renderer()
    want = _renderer().render_passes(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = r.render_passes(4)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    for name in ("shade.surface", "shade.lights", "shade.shadow",
                 "upload", *STEPS):
        assert spans[name] >= 1, (name, spans)
    assert spans["shade.shadow"] == LIGHTS
    for key in KEYS:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["bench", "mip"])
def test_surface_span_launches_on_the_card(scene):
    """On the card, by the launch counter inside each span of one
    render_passes frame: shade.surface holds K10 alone on the bench scene
    (no child span) and K10, K9 and K10's epilogue on a mip scene, K9
    inside its child shade.texels; one shade() call each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.app.textures_scene import build_textures_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.kernels import build

    if scene == "bench":
        r = build_bench_scene(Renderer(RendererConfig(
            width=96, height=80, device="cuda")),
            field=dict(nx=2, nz=2, subdiv=1), cubes=2)
    else:
        r = build_textures_scene(Renderer(RendererConfig(
            width=96, height=80, mipmaps=True, aniso_taps=4,
            device="cuda")), field=FIELD)
    r.render_passes(0)
    inside = collections.defaultdict(collections.Counter)

    @contextlib.contextmanager
    def step(name):
        before = dict(build.launch_counts)
        yield
        inside[name].update({k: v - before[k] for k, v in
                             build.launch_counts.items() if v != before[k]})

    r.render_passes(1, step)
    torch.cuda.synchronize()
    if scene == "bench":
        assert inside["shade.surface"] == dict(shade_surface=1)
        assert "shade.texels" not in inside
    else:
        assert inside["shade.surface"] == dict(
            shade_surface=1, mip_texels=1, shade_surface_nmap=1)
        assert inside["shade.texels"] == dict(mip_texels=1)
    assert inside["shade"]["shade_surface"] == 1
