"""What a traced run reads besides the window's stamps: CUDA events around
each pass of the frame (``Renderer.render_passes``'s ``step`` hook), and a
``torch.profiler`` trace of a few frames after the window, from which the
device's busy intervals, the kernels' times, the idle gaps and the
breakdown come.

Passes, by the frame's steps (``tpurt_torch/engine/frame.py``): trace =
rays + trace, shade = shade (with its shadow traces), gtao = gtao, tonemap
= tonemap. The G-buffer's quantization steps are in no pass.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path

import torch

from .stats import idle_gaps, union_length

PASS_OF_STEP = {"rays": "trace", "trace": "trace", "shade": "shade",
                "gtao": "gtao", "tonemap": "tonemap"}
FRAME_RANGE = "rtbench.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class _HostEvent:
    """A CUDA event's interface on the host clock (a run on the CPU)."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class PassEvents:
    """step(name) for one frame: a CUDA event pair per pass (host stamps
    on the CPU)."""

    def __init__(self, device):
        self.device = device
        self.events = []

    @contextlib.contextmanager
    def step(self, name):
        group = PASS_OF_STEP.get(name)
        if group is None:
            yield
            return
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        else:
            stream, start, end = None, _HostEvent(), _HostEvent()
        start.record(stream)
        yield
        end.record(stream)
        self.events.append((group, start, end))

    def ms(self) -> dict:
        """Milliseconds per pass of this frame (after it completed)."""
        out = {}
        for group, start, end in self.events:
            out[group] = out.get(group, 0.0) + start.elapsed_time(end)
        return out


def profile_frames(run, trace_dir: Path) -> dict:
    """Run `run()` (a few frames, each inside a record_function range
    named FRAME_RANGE) under torch.profiler and read its Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / f"trace_{os.getpid()}.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return read_trace(events)


def _short(name: str) -> str:
    """A kernel's or host operation's name without its argument list, its
    return type and anonymous namespaces, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:96] or "(unnamed)"


def read_trace(events) -> dict:
    """The profiled frames' device activity from Chrome-trace events (ts,
    dur in microseconds): busy and window seconds, every kernel's (name,
    seconds), the top device operations and the longest idle gaps, each
    named by the innermost host operation running at its middle."""
    dev, host, frames = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            dev.append((span, e.get("name", ""), cat))
        elif cat in HOST_CATS:
            host.append((span, e.get("name", "")))
            if cat == "user_annotation" and e.get("name") == FRAME_RANGE:
                frames.append(span)
    if not dev or not frames:
        return {}
    start = min(s for s, _ in frames)
    end = max(max(sp[1] for sp, _, _ in dev), max(e for _, e in frames))
    spans = [sp for sp, _, _ in dev if sp[1] > start]
    busy = union_length([(max(s, start), e) for s, e in spans])
    by_name = {}
    for (s, e), name, _ in dev:
        by_name[_short(name)] = by_name.get(_short(name), 0.0) + (e - s)
    gaps = idle_gaps(spans, start, end)
    gaps.sort(key=lambda g: g[0] - g[1])

    def doing(t):
        inner = [(e - s, name) for (s, e), name in host
                 if s <= t <= e and name != FRAME_RANGE]
        return min(inner)[1] if inner else "(Python between host ops)"

    return dict(
        busy_s=busy * 1e-6, window_s=(end - start) * 1e-6,
        kernels=[(name, (e - s) * 1e-6) for (s, e), name, cat in dev
                 if cat == "kernel"],
        breakdown=dict(
            device_ops=[[n, t * 1e-6] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            idle_gaps=[[_short(doing((s + e) / 2)), (e - s) * 1e-6]
                       for s, e in gaps[:10]]))
