"""Light evaluation — port of ``tpurt/passes/light.py``: radiance with the
spot/area penumbra->umbra falloff and the squared distance window, the area
light as the closest point on its rectangle, directional L = -dir * 10.

Each function takes one light as a dict of 0-d/(3,) tensors (one entry of
``engine/convert.light_tensors``) and a batch of world positions (..., 3).
"""
from __future__ import annotations

import torch

from .encodings import sqrt

LIGHT_TYPE_POINT = 0
LIGHT_TYPE_SPOT = 1
LIGHT_TYPE_DIRECTIONAL = 2
LIGHT_TYPE_AREA = 3


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def compute_barycentric(a, b, c, p):
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = _dot(v0, v0)
    d01 = _dot(v0, v1)
    d11 = _dot(v1, v1)
    d20 = _dot(v2, v0)
    d21 = _dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    bx = (d11 * d20 - d01 * d21) / denom
    by = (d00 * d21 - d01 * d20) / denom
    bz = 1.0 - bx - by
    return torch.stack([bx, by, bz], dim=-1)


def closest_point_to_segment(pos0, pos1, p):
    v01 = pos1 - pos0
    t = _dot(p - pos0, v01) / _dot(v01, v01)
    t = torch.clamp(t, 0.0, 1.0)
    return pos0 + t[..., None] * v01


def closest_point_to_triangle(pos0, pos1, pos2, point):
    bary = compute_barycentric(pos0, pos1, pos2, point)
    seg20 = closest_point_to_segment(pos2, pos0, point)
    seg12 = closest_point_to_segment(pos1, pos2, point)
    out = torch.where((bary[..., 2] < 0.0)[..., None], seg12, point)
    return torch.where((bary[..., 0] < 0.0)[..., None], seg20, out)


def get_unnormalized_L_vec(light: dict, pos):
    """Unnormalized vector from `pos` (..., 3) to the light."""
    ltype = light["light_type"]
    lpos = light["pos"].expand(pos.shape)
    ldir = light["dir"].expand(pos.shape)

    point_spot = lpos - pos
    directional = (-light["dir"] * 10.0).expand(pos.shape)

    # area light: project onto the light plane, clamp to the rectangle
    area_pos2 = light["area_pos2"].expand(pos.shape)
    area_pos3 = light["area_pos3"].expand(pos.shape)
    distance = _dot(ldir, area_pos2) - _dot(ldir, pos)
    cp_on_plane = pos + distance[..., None] * ldir
    bary = compute_barycentric(lpos, area_pos2, area_pos3, cp_on_plane)

    pos4 = lpos - area_pos2 + area_pos3
    tri_branch = closest_point_to_triangle(lpos, area_pos3, pos4, cp_on_plane)
    seg_a = closest_point_to_segment(lpos, area_pos2, cp_on_plane)
    seg_b = closest_point_to_segment(area_pos2, area_pos3, cp_on_plane)

    clamped = torch.where((bary[..., 2] < 0.0)[..., None], seg_b, cp_on_plane)
    clamped = torch.where((bary[..., 1] < 0.0)[..., None], seg_a, clamped)
    clamped = torch.where((bary[..., 0] < 0.0)[..., None], tri_branch,
                          clamped)
    area = clamped - pos

    is_ps = (ltype == LIGHT_TYPE_POINT) | (ltype == LIGHT_TYPE_SPOT)
    return torch.where(
        is_ps, point_spot,
        torch.where(ltype == LIGHT_TYPE_DIRECTIONAL, directional,
                    torch.where(ltype == LIGHT_TYPE_AREA, area,
                                torch.ones_like(pos))))


def get_light_radiance(light: dict, pos, L):
    """Radiance arriving at `pos` from direction L (normalized)."""
    radiance = light["color"].expand(pos.shape)
    ltype = light["light_type"]

    is_cone = (ltype == LIGHT_TYPE_SPOT) | (ltype == LIGHT_TYPE_AREA)
    cos_theta = _dot(light["dir"].expand(L.shape), -L)
    theta_s = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    denom = light["penumbra_angle"] - light["umbra_angle"]
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    t = torch.clamp((theta_s - light["umbra_angle"]) / denom, 0.0, 1.0)
    radiance = torch.where(is_cone, radiance * (t * t)[..., None], radiance)

    has_falloff = light["falloff_distance"] > 0.0
    dl = light["pos"].expand(pos.shape) - pos
    dist = sqrt(_dot(dl, dl))
    r = dist / light["falloff_distance"]
    w = torch.clamp_min(1.0 - r * r, 0.0)
    w = w * w
    return torch.where(has_falloff, radiance * w[..., None], radiance)
