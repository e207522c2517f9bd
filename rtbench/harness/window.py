"""The measured window: frames called one after another with up to
`depth` in flight, tracked by CUDA events (``Renderer.render_stream``'s
loop, the reference's 3-deep FrameData pipeline, renderer.rs:300-318).

Each frame is stamped on the host clock at its call, before its pose is
set, and at the moment its event is seen complete: when the queue is full
the host waits on the oldest frame's event, so a frame's completion is
what the host sees. The window calls frames for `seconds` and then drains
the queue; every frame it called is counted.

``Sample`` keeps the outputs of a uniform sample of the window's frames,
drawn from the seed (reservoir sampling), for the check after the
window.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

KEPT = ("image", "depth", "normal", "ao")


class Sample:
    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 3])
        self.items = []   # (frame index within the window, outputs)

    def offer(self, j: int, out: dict):
        item = (j, {key: out[key] for key in KEPT})
        if len(self.items) < self.k:
            self.items.append(item)
            return
        r = int(self.rng.integers(0, j + 1))
        if r < self.k:
            self.items[r] = item


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def run_frames(call, count_or_seconds, depth: int, device, *, timed: bool,
               on_done=None):
    """Call frames j = 0, 1, ... through call(j) -> outputs, with up to
    `depth` in flight: `count_or_seconds` frames, or with `timed` as many
    as start within that many seconds. Returns (start, calls, done, host
    seconds of each call); on_done(j, outputs) sees each frame once it is
    complete."""
    q = deque()
    calls, done, enqueue = [], [], []

    def retire():
        j, out, ev = q.popleft()
        if ev is not None:
            ev.synchronize()
        done.append(time.perf_counter())
        if on_done is not None:
            on_done(j, out)

    start = time.perf_counter()
    j = 0
    while True:
        t0 = time.perf_counter()
        if (t0 - start >= count_or_seconds) if timed else \
                (j >= count_or_seconds):
            break
        out = call(j)
        t1 = time.perf_counter()
        calls.append(t0)
        enqueue.append(t1 - t0)
        q.append((j, out, _event(device)))
        if len(q) >= max(depth, 1):
            retire()
        j += 1
    while q:
        retire()
    return start, calls, done, enqueue
