"""Frame timer — the reference's only performance instrumentation
(frame_timer.rs:16-28): once per second prints mean ms/frame and FPS.
Port of ``tpurt/engine/frame_timer.py``; ``engine/profiler.py`` has the
per-pass timing.
"""
from __future__ import annotations

import time


class FrameTimer:
    def __init__(self, print_fn=print):
        self._print = print_fn
        self._frames = 0
        self._window_start = time.monotonic()

    def frame_end(self):
        self._frames += 1
        now = time.monotonic()
        elapsed = now - self._window_start
        if elapsed >= 1.0:
            msec = elapsed * 1000.0 / self._frames
            self._print(f"Msec/frame: {msec:.3f}, FPS: {self._frames / elapsed:.0f}")
            self._frames = 0
            self._window_start = now
