"""Ray-traced AO ground truth — port of ``tpurt/passes/rtao.py``.

The reference ships a development-only ray-traced AO reference to tune
XeGTAO against (XeGTAO.h:85-99 ReferenceRTAOConstants: TotalRaysLength as
the radius, one bounce, frame accumulation). Per frame, each primary hit
shoots cosine-weighted hemisphere occlusion rays bounded by
`total_rays_length`; the visibilities accumulate across frames into a
converged AO image to compare with the GTAO pass.

The primary hit runs K1 and each sample's occlusion rays one K2 launch,
both in the frame's 16x8 pixel tiles; lanes that missed get ``t_max = 0``.
tpurt traces its binary BVH with its XLA tracer (ROADMAP F19), so a hit
triangle may differ on ties. The uniforms come from ``_uniform_planes``:
drawn on the generator's own device and moved to the frame's, so one CPU
generator gives the card and the host the same directions; without a
generator, from the frame device's default generator.
"""
from __future__ import annotations

import math

import torch

from ..kernels.traverse_bvh8 import trace_any_bvh8, trace_closest_bvh8
from .encodings import divide, rdivide, sqrt
from .rays import T_MAX, T_MIN, camera_rays
from .shade import _dot, _normalize

RTAO_T_MIN = 1e-3


def _onb(n):
    """An orthonormal basis (t, bt) around normals (..., 3) (Frisvad)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = rdivide(-1.0, sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * (nx * nx) * a, sign * b, -sign * nx], -1)
    bt = torch.stack([b, sign + (ny * ny) * a, -ny], -1)
    return t, bt


def _uniform_planes(generator, shape, device):
    """The two uniform [0, 1) f32 planes (u1, u2) of one sample, each of
    `shape`, drawn on the generator's device and moved to `device`."""
    draw_on = generator.device if generator is not None else device
    u = torch.rand((2,) + tuple(shape), generator=generator,
                   dtype=torch.float32, device=draw_on).to(device)
    return u[0], u[1]


def _cosine_dirs(generator, n, shape):
    """Cosine-weighted directions in the hemispheres around normals n."""
    u1, u2 = _uniform_planes(generator, shape, n.device)
    r = sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = sqrt(torch.clamp_min(1.0 - u1, 0.0))
    t, bt = _onb(n)
    return x[..., None] * t + y[..., None] * bt + z[..., None] * n


def rtao_frame(scene: dict, camera: dict, generator=None, *, width: int,
               height: int, samples_per_frame: int = 4,
               total_rays_length: float = 0.2):
    """One accumulation step: (visibility (H, W) f32, hit mask (H, W)
    bool); the visibility is 1 off the geometry. The mean over frames is
    the converged AO."""
    origin, direction = camera_rays(camera, width, height)
    hits = trace_closest_bvh8(scene, origin, direction, T_MIN, T_MAX,
                              height=height, width=width)
    valid = hits["tri"] >= 0
    tidx = torch.clamp_min(hits["tri"], 0).long()

    u = hits["u"][:, None]
    v = hits["v"][:, None]
    w = 1.0 - u - v
    attr = scene["tri_attr"][tidx]
    p0, p1, p2 = attr[:, 0:3], attr[:, 12:15], attr[:, 24:27]
    n0, n1, n2 = attr[:, 5:8], attr[:, 17:20], attr[:, 29:32]
    world_pos = (p0 * w + p1 * u + p2 * v).contiguous()
    normal = _normalize(n0 * w + n1 * u + n2 * v)
    # face the ray origin (double-sided geometry)
    flip = _dot(normal, direction) > 0.0
    normal = torch.where(flip[:, None], -normal, normal)

    t_max = torch.where(valid, torch.full_like(hits["t"], total_rays_length),
                        torch.zeros_like(hits["t"]))
    vis_sum = torch.zeros_like(hits["t"])
    for _ in range(samples_per_frame):
        d = _cosine_dirs(generator, normal, normal.shape[:-1]).contiguous()
        occluded = trace_any_bvh8(scene, world_pos, d, RTAO_T_MIN, t_max,
                                  height=height, width=width)
        vis_sum = vis_sum + torch.where(occluded, 0.0, 1.0)

    vis = divide(vis_sum, samples_per_frame).reshape(height, width)
    valid = valid.reshape(height, width)
    return torch.where(valid, vis, torch.ones_like(vis)), valid
