"""The transcendental probe's kernel (P1) and its plain version.

``trans_equiv`` replaces tpurt's probe kernel ``mosaic_side``
(``tools/trans_equiv_probe.py:104``): the GTAO main pass's noise-only
expressions, the cos and sin of each slice angle and the
sample-distribution pow of each step, on two noise planes. On CUDA tensors
it launches ``csrc/trans_equiv.cu`` (CUDA's libm) on a grid of one thread
per noise element and output row, each making one libm call; on CPU
tensors it runs ``trans_equiv_plain``, which makes the same f32 arguments
and calls torch's cos/sin/pow on them. ``tools/trans_equiv_probe.py``
holds the two against each other and against float64.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..passes.encodings import divide
from . import build

PI = 3.1415926535897932384626433832795
GOLDEN = 0.6180339887498948482
# the kernel against its plain version (both f32, other math libraries):
# cos and sin within ATOL_TRIG, pow within RTOL_POW of the plain value
ATOL_TRIG = 2e-6
RTOL_POW = 2e-6


def row_ops(slice_count: int, steps_per_slice: int):
    """The op of each output row: per slice cos, sin, then pow per step."""
    return [op for _ in range(slice_count)
            for op in ("cos", "sin", *("pow",) * steps_per_slice)]


def _check(name, planes):
    if planes.dtype != torch.float32 or planes.ndim < 2 \
            or planes.shape[0] != 2:
        raise ValueError(f"{name}: planes must be (2, ...) float32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")


def arguments(planes, sdp: float, slice_count: int = 9,
              steps_per_slice: int = 3):
    """The f32 arguments of every row: the slice angle phi (cos and sin
    rows) and the step position s0 (pow rows), tpurt's expressions:
    phi = (s + noise_slice) / slices * pi, s0 = (k + mod(noise_sample +
    (s + k * steps) * 0.618..., 1)) / steps. (rows, ...) f32."""
    _check("arguments", planes)
    nsl, nsm = planes[0], planes[1]
    rows = []
    for s in range(slice_count):
        phi = divide(nsl + float(s), float(slice_count)) * PI
        rows += [phi, phi]
        for k in range(steps_per_slice):
            # (s + k * steps) * 0.618... rounded to f32, as in the kernel
            base = float(np.float32(s + k * steps_per_slice)
                         * np.float32(GOLDEN))
            rows.append(divide(torch.fmod(nsm + base, 1.0) + float(k),
                               float(steps_per_slice)))
    return torch.stack(rows)


def trans_equiv_plain(planes, sdp: float, slice_count: int = 9,
                      steps_per_slice: int = 3):
    """Plain PyTorch version of P1 on any device."""
    args = arguments(planes, sdp, slice_count, steps_per_slice)
    ops = row_ops(slice_count, steps_per_slice)
    fns = dict(cos=torch.cos, sin=torch.sin,
               pow=lambda x: torch.pow(x, x.new_full((), float(sdp))))
    return torch.stack([fns[op](a) for op, a in zip(ops, args)])


def trans_equiv(planes, sdp: float, slice_count: int = 9,
                steps_per_slice: int = 3):
    """(2, ...) f32 noise planes (slice noise, sample noise) and the
    sample-distribution power -> (slice_count * (2 + steps_per_slice), ...)
    f32, per slice cos, sin and pow per step (tpurt's layout)."""
    name = "trans_equiv"
    _check(name, planes)
    if not planes.is_cuda:
        return trans_equiv_plain(planes, sdp, slice_count, steps_per_slice)
    build.require_cuda(name, dict(planes=planes), planes.device)
    n = planes[0].numel()
    out = torch.empty((slice_count * (2 + steps_per_slice),
                       *planes.shape[1:]), dtype=torch.float32,
                      device=planes.device)
    fn = build.function("tpurt_trans_equiv", [ctypes.c_void_p] * 2 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    p = build.ptr
    build.check(fn(p(planes[0]), p(planes[1]), float(sdp), n, slice_count,
                   steps_per_slice, p(out), build.stream_of(planes)), name)
    build.launch_counts["trans_equiv"] += 1
    return out
