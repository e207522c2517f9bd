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


def camera_rays(camera: dict, width: int, height: int):
    """Returns (origin (H*W, 3), direction (H*W, 3)) world-space rays."""
    view_inv = camera["view_inv"]
    proj_inv = camera["proj_inv"]
    dev = view_inv.device
    x = divide(torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
               width) * 2.0 - 1.0
    y = divide(torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
               height) * 2.0 - 1.0
    dy, dx = torch.meshgrid(y, x, indexing="ij")   # (H, W)
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
    origin = view_inv[:3, 3].expand(height, width, 3)
    return (origin.reshape(-1, 3).contiguous(),
            direction.reshape(-1, 3).contiguous())
