"""Primary camera rays — port of ``tpurt/passes/rays.py``.

Pixel centers through the inverse projection, rotated to world by the
inverse view; row 0 is the top of the frame. Every multiply and add is its
own f32 operation, summed left to right, and the norm's square root is
correctly rounded (``encodings.sqrt``), so the rays are the same on every
device. (tpurt's values on XLA:CPU differ from these in the last bits:
XLA folds the division into a reciprocal multiply and contracts parts of
the small matrix products and the norm into fused multiply-adds, in ways
that depend on its fusion decisions.)
"""
from __future__ import annotations

import torch

from .encodings import divide, sqrt

T_MIN = 0.001
T_MAX = 10000.0


def camera_rays(camera: dict, width: int, height: int, row_start: int = 0,
                num_rows=None, jitter=None):
    """Returns (origin (R*W, 3), direction (R*W, 3)) world-space rays for
    the band of `num_rows` rows from `row_start` (the whole image by
    default); `height` stays the whole image's.

    jitter: a sub-pixel offset (jx, jy) in [-0.5, 0.5] pixels, a pair of
    Python floats or a 2-element tensor (a CPU tensor serves a CUDA frame as
    two host scalars, so a sample costs no device sync); None = the pixel
    centers. It is added as tpurt adds it: ``(i + 0.5 + jx) / width``."""
    view_inv = camera["view_inv"]
    proj_inv = camera["proj_inv"]
    dev = view_inv.device
    num_rows = height if num_rows is None else num_rows
    x = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    y = (torch.arange(num_rows, dtype=torch.float32, device=dev)
         + float(row_start)) + 0.5
    if jitter is not None:
        x = x + jitter[0]
        y = y + jitter[1]
    x = divide(x, width) * 2.0 - 1.0
    y = divide(y, height) * 2.0 - 1.0
    dy, dx = torch.meshgrid(y, x, indexing="ij")   # (R, W)
    ndc = (dx, dy, 1.0, 1.0)

    def dot(m, row, v):
        acc = m[row, 0] * v[0]
        for j in range(1, len(v)):
            acc = acc + m[row, j] * v[j]
        return acc

    target = [dot(proj_inv, i, ndc) for i in range(3)]
    norm = sqrt(target[0] * target[0] + target[1] * target[1]
                + target[2] * target[2])
    target = [c / norm for c in target]
    direction = torch.stack([dot(view_inv, i, target) for i in range(3)], -1)
    origin = view_inv[:3, 3].expand(num_rows, width, 3)
    return (origin.reshape(-1, 3).contiguous(),
            direction.reshape(-1, 3).contiguous())
