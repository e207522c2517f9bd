"""The arithmetic of the metrics, on host stamps and device intervals."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window_metrics(start: float, calls, done) -> dict:
    """frame_ms, frame_ms_p95 and latency_ms_p95 of a window that began at
    `start`, its frames called at `calls` and seen complete at `done`
    (host seconds, in frame order).

    frame_ms is the window's wall time (start to the last completion) over
    the frames; the intervals are those between consecutive completions,
    the first from the window's start; the latency of a frame runs from
    its call to its completion."""
    if not done:
        raise ValueError("no frame completed")
    wall = done[-1] - start
    gaps = [done[0] - start] + [b - a for a, b in zip(done, done[1:])]
    lat = [d - c for c, d in zip(calls, done)]
    return dict(frame_ms=wall / len(done) * 1e3,
                frame_ms_p95=percentile(gaps, 95) * 1e3,
                latency_ms_p95=percentile(lat, 95) * 1e3)


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """The gaps (start, end) within [start, end] that no interval
    covers."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]

