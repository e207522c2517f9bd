"""The profiler path: ``engine/profiler.py``, ``FrameTimer`` and
``Renderer.render_stream`` against tpurt's on a cut bench scene (2x2 box
field, ground plane, 2 cubes, the bench's three lights) at 32x32.

Held exactly: tpurt's pass names and ray counts for ``profile_frame`` and
``device_profile`` (tpurt's own run on the same scene), ``FrameStats``'s
text, ``FrameTimer``'s lines under the same fake clock; the frame the
profilers wrap (``Renderer.render_passes``) equal to
``Renderer.render()``'s bit for bit at the same noise index;
``render_stream`` at depth 1 and 3 equal to successive ``render()``
frames. Times are the host clock's here (a CPU
renderer); the card's are chip_smoke.py's.
"""
from types import SimpleNamespace

import pytest
import torch

FIELD = dict(nx=2, nz=2, subdiv=1)
CUBES = 2
SIZE = 32


def _port_renderer():
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    return build_bench_scene(Renderer(RendererConfig(
        width=SIZE, height=SIZE, device="cpu")), field=FIELD, cubes=CUBES)


@pytest.fixture(scope="module")
def ref_stats():
    from tpurt.engine import Renderer, RendererConfig
    from tpurt.engine import profiler
    from tpurt_torch.app.bench_scene import build_bench_scene

    r = build_bench_scene(Renderer(RendererConfig(width=SIZE, height=SIZE)),
                          field=FIELD, cubes=CUBES)
    return dict(frame=profiler.profile_frame(r, 1),
                device=profiler.device_profile(r, reps=1, k=1))


@pytest.fixture(scope="module")
def port():
    return _port_renderer()


def test_profile_frame_names_and_rays(ref_stats, port):
    from tpurt_torch.engine import profiler

    got = profiler.profile_frame(port, 2)
    ref = ref_stats["frame"]
    assert list(got.ms_per_pass) == list(ref.ms_per_pass)
    assert got.rays_traced == ref.rays_traced == SIZE * SIZE * (1 + 3)
    assert all(v > 0 for v in got.ms_per_pass.values())


def test_device_profile_names_and_rays(ref_stats, port):
    from tpurt_torch.engine import profiler

    got = profiler.device_profile(port, reps=2, k=2)
    ref = ref_stats["device"]
    assert list(got.ms_per_pass) == list(ref.ms_per_pass)
    assert got.rays_traced == ref.rays_traced
    assert all(v > 0 for v in got.ms_per_pass.values())


def test_device_profile_follows_the_enables():
    """tpurt's stages: no gtao or tonemap pass when the config turns it
    off; the steps still run, inside the pass before."""
    from tpurt_torch.engine.profiler import _device_passes

    cfg = SimpleNamespace(enable_gtao=False, enable_tonemap=True)
    passes = dict(_device_passes(cfg))
    assert list(passes) == ["trace", "shade", "tonemap"]
    assert passes["shade"] == ("shade", "quantize_depth_normal", "gtao")
    cfg = SimpleNamespace(enable_gtao=True, enable_tonemap=False)
    assert list(dict(_device_passes(cfg))) == ["trace", "shade", "gtao"]


def test_frame_stats_text_equals_tpurt():
    from tpurt.engine.profiler import FrameStats as RefStats
    from tpurt_torch.engine.profiler import FrameStats

    for ms, rays in (({"rays": 0.5, "trace": 1.25, "gtao": 3.0}, 12345),
                     ({"trace": 2.0}, 0), ({}, 7)):
        got, ref = FrameStats(dict(ms), rays), RefStats(dict(ms), rays)
        assert got.pretty() == ref.pretty()
        assert got.ms_total == ref.ms_total
        assert got.mrays_per_s() == ref.mrays_per_s()


@pytest.mark.parametrize("noise", [0, 5])
def test_profiled_passes_give_the_rendered_image(port, noise):
    """The profilers run render()'s own frame (Renderer.render_passes) with
    a step wrapper: its steps, in frame order among the frame's other spans
    (SPANS' order of first entry), are the ones each profile splits into
    passes, and the wrapped frame's outputs equal render()'s bit for bit
    at the same noise index, which it leaves where it was."""
    import contextlib

    from tpurt_torch.engine.frame import SPANS, STEPS
    from tpurt_torch.engine.profiler import DEVICE_PASSES, PROFILE_PASSES

    entered = []

    @contextlib.contextmanager
    def step(name):
        entered.append(name)
        yield

    port._frame_idx = noise
    assert port.noise_index == noise
    got = port.render_passes(noise, step)
    assert tuple(n for n in entered if n in STEPS) == STEPS
    assert list(dict.fromkeys(entered)) == [n for n in SPANS if n in entered]
    assert port._frame_idx == noise
    assert tuple(s for _, steps in PROFILE_PASSES for s in steps) == STEPS
    assert sorted(s for _, steps in DEVICE_PASSES for s in steps) \
        == sorted(STEPS)
    out = port.render()
    for key in ("image", "color", "depth", "normal", "ao"):
        assert torch.equal(got[key], out[key]), key
    assert port._frame_idx == noise + 1


def test_pass_timer_accumulates(monkeypatch):
    """A pass timed in every repeat adds up (tpurt's overwrites: ROADMAP
    §3); the CPU device times on the host clock."""
    from tpurt_torch.engine import profiler

    clock = iter([0.0, 0.002, 1.0, 1.003])
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(clock))
    timer = profiler.PassTimer("cpu")
    for _ in range(2):
        with timer.time_pass("trace", count_rays=10):
            pass
    assert timer.stats.ms_per_pass["trace"] == pytest.approx(5.0)
    assert timer.stats.rays_traced == 20


def test_device_ms_by_range():
    """Device events go to the range whose host interval holds their start;
    the ranges' own device-side annotations are not counted twice."""
    from torch.autograd import DeviceType

    from tpurt_torch.engine.profiler import device_ms_by_range

    def ev(name, dev, a, b):
        return SimpleNamespace(
            name=name, device_type=dev,
            time_range=SimpleNamespace(start=a, end=b,
                                       elapsed_us=lambda: b - a))

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [ev("trace", cpu, 0, 100), ev("shade", cpu, 100, 300),
              ev("trace", gpu, 5, 90), ev("k1", gpu, 10, 60),
              ev("k2", gpu, 120, 150), ev("Memcpy HtoD", gpu, 150, 160),
              ev("aten::add", cpu, 120, 130)]
    got = device_ms_by_range(events, ["trace", "shade"])
    assert got == pytest.approx(dict(trace=0.05, shade=0.04))
    with pytest.raises(RuntimeError, match="no device"):
        device_ms_by_range(events[:2], ["trace", "shade"])


@pytest.mark.parametrize("name, kernel", [
    ("void (anonymous namespace)::gtao_main_kernel<9, 3, false, false, "
     "false>((anonymous namespace)::Mips, float const*)", "gtao_main_kernel"),
    ("bvh8_any_kernel<48>", "bvh8_any_kernel"),
    ("(anonymous namespace)::light_sum_kernel(float const*, int)",
     "light_sum_kernel"),
    ("shade_surface_nmap_kernel", "shade_surface_nmap_kernel"),
    ("at::native::elementwise_kernel<128, 2>(int)", None),
    ("mip_texels_kernel_copy<1>(int)", None)])
def test_kernel_launches_by_function(name, kernel):
    """The port's kernels among profiler events counted by CUDA function,
    from the name a trace gives (return type, namespaces, template
    arguments and parameters dropped): device events only, and no other
    kernel."""
    from torch.autograd import DeviceType

    from tpurt_torch.engine.profiler import kernel_launches
    from tpurt_torch.kernels.build import KERNEL_OF

    events = [SimpleNamespace(name=name, device_type=DeviceType.CUDA),
              SimpleNamespace(name=name, device_type=DeviceType.CUDA),
              SimpleNamespace(name=name, device_type=DeviceType.CPU)]
    assert kernel_launches(events) == ({} if kernel is None
                                       else {kernel: 2})
    assert kernel is None or kernel in KERNEL_OF.values()


def test_by_kernel_sums_counters_of_one_function():
    from tpurt_torch.kernels import build

    assert build.by_kernel(dict(gtao_main=2, gtao_main_bent=1, bvh8_any=3,
                                bvh8_closest=0, frame_graph=5)) == {
        "gtao_main_kernel": 3, "bvh8_any_kernel": 3}
    assert set(build.KERNEL_OF) == set(build.launch_counts) - {
        "frame_graph"}


def test_frame_timer_equals_tpurt(monkeypatch):
    import tpurt.engine.frame_timer as ref_mod
    import tpurt_torch.engine.frame_timer as mod
    from tpurt_torch.engine import FrameTimer

    assert FrameTimer is mod.FrameTimer
    ticks = [0.0, 0.3, 0.7, 1.2, 1.5, 2.25, 2.3]
    lines = {}
    for name, m in (("ref", ref_mod), ("port", mod)):
        clock = iter(ticks)
        monkeypatch.setattr(m.time, "monotonic", lambda: next(clock))
        out = []
        timer = m.FrameTimer(print_fn=out.append)
        for _ in range(len(ticks) - 1):
            timer.frame_end()
        lines[name] = out
    assert lines["port"] == lines["ref"]
    assert lines["port"] == ["Msec/frame: 400.000, FPS: 2",
                             "Msec/frame: 525.000, FPS: 2"]


@pytest.mark.parametrize("depth", [1, 3])
def test_render_stream_equals_render(depth):
    a, b = _port_renderer(), _port_renderer()
    seq = [a.render() for _ in range(4)]
    got = list(b.render_stream(4, depth=depth))
    assert len(got) == 4 and b._frame_idx == 4
    for x, y in zip(seq, got):
        for key in ("image", "ao"):
            assert torch.equal(x[key], y[key])


def test_trace_writes_a_chrome_trace(port, tmp_path):
    """trace(log_dir): a torch.profiler capture around the block, written
    as log_dir/trace.json with the frame's operations in it."""
    import json

    from tpurt_torch.engine.profiler import trace

    with trace(str(tmp_path / "prof")):
        port.render()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
