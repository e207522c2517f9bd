"""FidelityFX-LPM tonemapper — port of ``tpurt/passes/tonemap.py``.

``lpm_setup`` (the host control block) stays numpy and is copied as is;
``lpm_filter``, ``tonemap_frame`` and the HDR10 output
(``tonemap_frame_hdr10``: LpmFilter with HDR10RAW_709 into scaled Rec.2020,
then the PQ transfer) run on tensors, as do ffx_a.h's transfer functions
``a_to_*`` / ``a_from_*``. The renderer runs the LPM_CONFIG_709_709 path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .encodings import divide, sqrt, srgb_approx


def _col_xy_to_z(s):
    return np.array([s[0], s[1], 1.0 - s[0] + s[1]], np.float32)


def _col_rgb_to_xyz(r, g, b, w):
    rgb3 = np.stack([_col_xy_to_z(r), _col_xy_to_z(g), _col_xy_to_z(b)],
                    axis=1)
    w3 = _col_xy_to_z(w) / np.float32(w[1])
    rgbv = np.linalg.inv(rgb3)
    s = rgbv @ w3
    return rgb3 * s[None, :]


LPM_COL_709_R = (0.64, 0.33)
LPM_COL_709_G = (0.30, 0.60)
LPM_COL_709_B = (0.15, 0.06)
LPM_COL_P3_R = (0.680, 0.320)
LPM_COL_P3_G = (0.265, 0.690)
LPM_COL_P3_B = (0.150, 0.060)
LPM_COL_2020_R = (0.708, 0.292)
LPM_COL_2020_G = (0.170, 0.797)
LPM_COL_2020_B = (0.131, 0.046)
LPM_COL_D65 = (0.3127, 0.3290)

_709 = (LPM_COL_709_R, LPM_COL_709_G, LPM_COL_709_B, LPM_COL_D65)
_P3 = (LPM_COL_P3_R, LPM_COL_P3_G, LPM_COL_P3_B, LPM_COL_D65)
_2020 = (LPM_COL_2020_R, LPM_COL_2020_G, LPM_COL_2020_B, LPM_COL_D65)

# (con, soft, con2, clip, scaleOnly) and (working, output, container)
# gamuts: the prefabs of ffx_lpm.h that tpurt carries
LPM_CONFIG_709_709 = (False, False, False, False, False)
LPM_COLORS_709_709 = (_709, _709, _709)
LPM_CONFIG_HDR10RAW_709 = (False, False, True, True, False)
LPM_COLORS_HDR10RAW_709 = (_709, _709, _2020)
LPM_CONFIG_709_P3 = (True, True, False, False, False)
LPM_COLORS_709_P3 = (_P3, _709, _709)
LPM_CONFIG_HDR10RAW_2020 = (False, False, False, False, True)
LPM_COLORS_HDR10RAW_2020 = (_2020, _2020, _2020)


def lpm_hdr10_raw_scalar(display_max_nits: float = 1000.0) -> float:
    """LpmHdr10RawScalar: PQ-space output scale for HDR10 (nits / 10000)."""
    return display_max_nits / 10000.0


def _f32_bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def _pack_2f16(f1, f2) -> int:
    h1 = int(np.float16(f1).view(np.uint16))
    h2 = int(np.float16(f2).view(np.uint16))
    return (h1 << 16) | h2


@dataclass
class LpmParams:
    shoulder: bool = False
    soft_gap: float = 0.0
    hdr_max: float = 256.0
    exposure: float = 8.0
    contrast: float = 0.25
    shoulder_contrast: float = 1.0
    saturation: tuple = (0.0, 0.0, 0.0)
    crosstalk: tuple = (1.0, 1.0 / 2.0, 1.0 / 32.0)


def lpm_setup(params: LpmParams = LpmParams(), config=LPM_CONFIG_709_709,
              colors=LPM_COLORS_709_709, scale_c: float = 1.0):
    """The 24xuvec4 control block and the unpacked float dict that
    lpm_filter reads. Returns (ctl (24, 4) u32, derived)."""
    con, soft, con2, clip, scale_only = config
    colors = [*colors[0], *colors[1], *colors[2]]

    contrast = params.contrast + 1.0
    saturation = np.array(params.saturation, np.float32) + np.float32(contrast)
    soft_gap = max(params.soft_gap, 1.0 / 1024.032)
    hdr_max = params.hdr_max
    exposure = params.exposure
    shoulder_contrast = params.shoulder_contrast
    crosstalk = np.array(params.crosstalk, np.float32)

    mid_in = hdr_max * 0.18 * math.exp2(-exposure)
    mid_out = 0.18

    cs = contrast * shoulder_contrast
    z0 = -(mid_in ** contrast)
    z1 = (hdr_max ** cs) * (mid_in ** contrast)
    z2 = (hdr_max ** contrast) * (mid_in ** cs) * mid_out
    z3 = (hdr_max ** cs) * mid_out
    z4 = (mid_in ** cs) * mid_out
    tone_scale_bias_x = -((z0 + (mid_out * (z1 - z2)) / (z3 - z4)) / z4)

    w0 = (hdr_max ** cs) * (mid_in ** contrast)
    w1 = (hdr_max ** contrast) * (mid_in ** cs) * mid_out
    w2 = (hdr_max ** cs) * mid_out
    w3 = (mid_in ** cs) * mid_out
    tone_scale_bias_y = (w0 - w1) / (w2 - w3)
    tone_scale_bias = np.array([tone_scale_bias_x, tone_scale_bias_y],
                               np.float32)

    xy_w = colors[0:4]
    xy_o = colors[4:8]
    xy_c = colors[8:12]

    rgb_to_xyz_w = _col_rgb_to_xyz(*xy_w)
    luma_w = rgb_to_xyz_w[1] / rgb_to_xyz_w[1].sum()

    rgb_to_xyz_o = _col_rgb_to_xyz(*xy_o)
    luma_t = (rgb_to_xyz_o[1] if soft else rgb_to_xyz_w[1]).copy()
    luma_t = luma_t / luma_t.sum()
    rcp_luma_t = 1.0 / luma_t

    if soft:
        soft_gap2 = np.array(
            [soft_gap, (1.0 - soft_gap) / (soft_gap * math.log(2.0))],
            np.float32)
    else:
        soft_gap2 = np.zeros(2, np.float32)

    con_m = (np.linalg.inv(rgb_to_xyz_o) @ rgb_to_xyz_w if con
             else np.zeros((3, 3), np.float32))
    if con2:
        con2_m = np.linalg.inv(_col_rgb_to_xyz(*xy_c)) @ rgb_to_xyz_o * scale_c
    else:
        con2_m = np.zeros((3, 3), np.float32)
    if scale_only:
        con2_m[0, 0] = scale_c

    ctl = np.zeros((24, 4), np.uint32)
    f = _f32_bits
    ctl[0] = [f(saturation[0]), f(saturation[1]), f(saturation[2]),
              f(contrast)]
    ctl[1] = [f(tone_scale_bias[0]), f(tone_scale_bias[1]), f(luma_t[0]),
              f(luma_t[1])]
    ctl[2] = [f(luma_t[2]), f(crosstalk[0]), f(crosstalk[1]), f(crosstalk[2])]
    ctl[3] = [f(rcp_luma_t[0]), f(rcp_luma_t[1]), f(rcp_luma_t[2]),
              f(con2_m[0, 0])]
    ctl[4] = [f(con2_m[0, 1]), f(con2_m[0, 2]), f(con2_m[1, 0]),
              f(con2_m[1, 1])]
    ctl[5] = [f(con2_m[1, 2]), f(con2_m[2, 0]), f(con2_m[2, 1]),
              f(con2_m[2, 2])]
    ctl[6] = [f(shoulder_contrast), f(luma_w[0]), f(luma_w[1]), f(luma_w[2])]
    ctl[7] = [f(soft_gap2[0]), f(soft_gap2[1]), f(con_m[0, 0]),
              f(con_m[0, 1])]
    ctl[8] = [f(con_m[0, 2]), f(con_m[1, 0]), f(con_m[1, 1]), f(con_m[1, 2])]
    ctl[9] = [f(con_m[2, 0]), f(con_m[2, 1]), f(con_m[2, 2]), 0]
    p = _pack_2f16
    ctl[16] = [p(saturation[0], saturation[1]), p(saturation[2], contrast),
               p(tone_scale_bias[0], tone_scale_bias[1]),
               p(luma_t[0], luma_t[1])]
    ctl[17] = [p(luma_t[2], crosstalk[0]), p(crosstalk[1], crosstalk[2]),
               p(rcp_luma_t[0], rcp_luma_t[1]), p(rcp_luma_t[2],
                                                  con2_m[0, 0])]
    ctl[18] = [p(con2_m[0, 1], con2_m[0, 2]), p(con2_m[1, 0], con2_m[1, 1]),
               p(con2_m[1, 2], con2_m[2, 0]), p(con2_m[2, 1], con2_m[2, 2])]
    ctl[19] = [p(shoulder_contrast, luma_w[0]), p(luma_w[1], luma_w[2]),
               p(soft_gap2[0], soft_gap2[1]), p(con_m[0, 0], con_m[0, 1])]
    ctl[20] = [p(con_m[0, 2], con_m[1, 0]), p(con_m[1, 1], con_m[1, 2]),
               p(con_m[2, 0], con_m[2, 1]), p(con_m[2, 2], 0.0)]

    derived = dict(
        saturation=saturation.astype(np.float32),
        contrast=np.float32(contrast),
        shoulder_contrast=np.float32(shoulder_contrast),
        tone_scale_bias=tone_scale_bias,
        luma_w=luma_w.astype(np.float32),
        luma_t=luma_t.astype(np.float32),
        rcp_luma_t=rcp_luma_t.astype(np.float32),
        crosstalk=crosstalk,
        soft_gap=soft_gap2,
        con=con_m.astype(np.float32),
        con2=con2_m.astype(np.float32),
    )
    return ctl, derived


def _dot3(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _mat3(m, v):
    return torch.stack([_dot3(m[i], v) for i in range(3)], dim=-1)


def lpm_filter(color, derived: dict, shoulder: bool = False,
               config=LPM_CONFIG_709_709):
    """LpmMap over (..., 3) linear color; `derived` holds tensors
    (engine/convert.lpm_tensors)."""
    con, soft, con2, clip, scale_only = config
    sat = derived["saturation"]
    tsb = derived["tone_scale_bias"]
    luma_t = derived["luma_t"]
    rcp_luma_t = derived["rcp_luma_t"]
    crosstalk = derived["crosstalk"]

    def sat01(x):
        return torch.clamp(x, 0.0, 1.0)

    color = torch.clamp_min(color, 0.0)
    max3 = color.amax(dim=-1, keepdim=True)
    rcp_max = 1.0 / torch.clamp_min(max3, 1e-30)
    ratio = color * rcp_max
    ratio = torch.pow(ratio, sat)

    luma = _dot3(color, derived["luma_w"] if soft else luma_t)
    luma = torch.pow(luma, derived["contrast"])
    luma_shoulder = torch.pow(luma, derived["shoulder_contrast"]) \
        if shoulder else luma
    luma = luma / torch.clamp_min(luma_shoulder * tsb[0] + tsb[1], 1e-30)

    if soft:
        if con:
            ratio = _mat3(derived["con"], ratio)
            rm = 1.0 / torch.clamp_min(ratio.amax(dim=-1, keepdim=True),
                                       1e-30)
            ratio = ratio * rm
        sg = derived["soft_gap"]
        ratio = torch.minimum(torch.maximum(sg[0], sat01(ratio * -sg[0]
                                                         + ratio)),
                              sat01(sg[0] * torch.exp2(ratio * sg[1])))

    luma_ratio = _dot3(ratio, luma_t)
    ratio_scale = sat01(luma / torch.clamp_min(luma_ratio, 1e-30))
    out = sat01(ratio * ratio_scale[..., None])

    cap = -crosstalk * out + crosstalk
    luma_add = sat01(luma - _dot3(out, luma_t))
    t = luma_add / torch.clamp_min(_dot3(cap, luma_t), 1e-30)
    out = sat01(t[..., None] * cap + out)
    luma_add = sat01(luma - _dot3(out, luma_t))
    out = sat01(luma_add[..., None] * rcp_luma_t + out)

    if con2:
        out = _mat3(derived["con2"], out)
        if clip:
            out = sat01(out)
    if scale_only:
        out = out * derived["con2"][0, 0]
    return out


def tonemap_frame(color, ao, derived: dict):
    """The composite pass: color *= AO/255, LpmFilter, sRGB encode.
    Returns float [0, 1] rgb; the engine packs u8."""
    color = color * divide(ao.to(torch.float32), 255.0)[..., None]
    color = lpm_filter(color, derived)
    return srgb_approx(color)


# ---- ffx_a.h output transfer functions (ffx_a.h:1869-1894) ----------------
# Divisions by a constant go through encodings.divide, so they round once
# on the card too.

def a_to_709(c):
    """ATo709F1."""
    c = torch.clamp_min(c, 0.0)
    return torch.maximum(torch.clamp_max(c * 4.5, 0.018),
                         1.099 * torch.pow(c, 0.45) - 0.099)


def a_from_709(c):
    """AFrom709F1."""
    c = torch.clamp_min(c, 0.0)
    return torch.maximum(torch.clamp_max(c * (1.0 / 4.5), 0.081),
                         torch.pow(divide(c + 0.099, 1.099), 1.0 / 0.45))


def a_to_gamma(c, rcp_x):
    """AToGammaF1."""
    return torch.pow(torch.clamp_min(c, 0.0), rcp_x)


def a_from_gamma(c, x):
    """AFromGammaF1."""
    return torch.pow(torch.clamp_min(c, 0.0), x)


def a_to_pq(x):
    """AToPqF1: linear {0..1, 1.0 = 10000 nits} -> PQ."""
    p = torch.pow(torch.clamp_min(x, 0.0), 0.159302)
    return torch.pow((0.835938 + 18.8516 * p) / (1.0 + 18.6875 * p),
                     78.8438)


def a_from_pq(x):
    """AFromPqF1."""
    p = torch.pow(torch.clamp_min(x, 0.0), 0.0126833)
    return torch.pow(torch.clamp(p - 0.835938, 0.0, 1.0)
                     / (18.8516 - 18.6875 * p), 6.27739)


def a_to_srgb(c):
    """AToSrgbF1."""
    c = torch.clamp_min(c, 0.0)
    return torch.maximum(torch.clamp_max(c * 12.92, 0.0031308),
                         1.055 * torch.pow(c, 0.41666) - 0.055)


def a_from_srgb(c):
    """AFromSrgbF1."""
    c = torch.clamp_min(c, 0.0)
    return torch.maximum(torch.clamp_max(divide(c, 12.92), 0.04045),
                         torch.pow(divide(c + 0.055, 1.055), 2.4))


def a_to_two(c):
    """AToTwoF1."""
    return sqrt(torch.clamp_min(c, 0.0))


def a_from_two(c):
    """AFromTwoF1."""
    return c * c


def lpm_setup_hdr10(params: LpmParams = LpmParams(),
                    display_max_nits: float = 1000.0):
    """Control block for the HDR10RAW_709 output path: 709 working gamut,
    2020 container scaled by LpmHdr10RawScalar. Returns (ctl, derived) as
    lpm_setup does; ``engine/convert.lpm_tensors`` carries ``derived``."""
    return lpm_setup(params, config=LPM_CONFIG_HDR10RAW_709,
                     colors=LPM_COLORS_HDR10RAW_709,
                     scale_c=lpm_hdr10_raw_scalar(display_max_nits))


def tonemap_frame_hdr10(color, ao, derived_hdr10: dict):
    """The HDR10 composite: color *= AO/255, LpmFilter with HDR10RAW_709
    (con2 + clip into scaled Rec.2020), then the PQ transfer. Returns
    PQ-coded [0, 1] rgb for a 10-bit HDR10 surface."""
    color = color * divide(ao.to(torch.float32), 255.0)[..., None]
    color = lpm_filter(color, derived_hdr10, config=LPM_CONFIG_HDR10RAW_709)
    return a_to_pq(color)
