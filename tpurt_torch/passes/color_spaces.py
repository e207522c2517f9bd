"""Color-space conversion library — port of ``tpurt/passes/color_spaces.py``
(the reference's color_spaces.glsl, tobspr's GLSL utility collection, MIT).

The frame calls only rgb_to_srgb_approx (``passes/encodings.srgb_approx``);
the rest is the reference's app-facing color toolbox. Every function takes
(..., 3) tensors (the hue helpers (...,)) and follows tpurt's formula for
formula, its epsilons and the reference's ``ycbcr_to_hcv`` quirk included.
The matrices and weights are Python constants; each function builds them
as tensors on its argument's device (``LUMA_COEFFS`` and the HCY weights
too), so the library runs wherever its input lies. Divisions by a constant
go through ``encodings.divide`` (rounded once on every device).
"""
from __future__ import annotations

import torch

from .encodings import divide

HCV_EPSILON = 1e-10
HSL_EPSILON = 1e-10
HCY_EPSILON = 1e-10

SRGB_GAMMA = 1.0 / 2.2
SRGB_INVERSE_GAMMA = 2.2
SRGB_ALPHA = 0.055

# row-major matrices of the GLSL column-major constructors
RGB_2_XYZ = ((0.4124564, 0.3575761, 0.1804375),
             (0.2126729, 0.7151522, 0.0721750),
             (0.0193339, 0.1191920, 0.9503041))
XYZ_2_RGB = ((3.2404542, -1.5371385, -0.4985314),
             (-0.9692660, 1.8760108, 0.0415560),
             (0.0556434, -0.2040259, 1.0572252))

LUMA_COEFFS = (0.2126, 0.7152, 0.0722)
_HCY_WTS = (0.299, 0.587, 0.114)


def _const(values, like):
    """`values` as an f32 tensor on `like`'s device."""
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _dot3(x, weights):
    """sum(x * weights, -1), summed left to right."""
    p = x * _const(weights, x)
    return p[..., 0] + p[..., 1] + p[..., 2]


def _mat3(m, v):
    """m @ v over (..., 3)."""
    return torch.stack([_dot3(v, row) for row in m], dim=-1)


def _sat(v):
    return torch.clamp(v, 0.0, 1.0)


def get_luminance(rgb):
    """Luminance of a LINEAR rgb color."""
    return _dot3(rgb, LUMA_COEFFS)


def rgb_to_srgb_approx(rgb):
    return torch.pow(torch.clamp_min(rgb, 0.0), SRGB_GAMMA)


def srgb_to_rgb_approx(srgb):
    return torch.pow(torch.clamp_min(srgb, 0.0), SRGB_INVERSE_GAMMA)


def linear_to_srgb(channel):
    """The exact piecewise transfer."""
    lo = 12.92 * channel
    hi = (1.0 + SRGB_ALPHA) * torch.pow(
        torch.clamp_min(channel, 1e-20), 1.0 / 2.4) - SRGB_ALPHA
    return torch.where(channel <= 0.0031308, lo, hi)


def srgb_to_linear(channel):
    lo = divide(channel, 12.92)
    hi = torch.pow(torch.clamp_min(
        divide(channel + SRGB_ALPHA, 1.0 + SRGB_ALPHA), 1e-20), 2.4)
    return torch.where(channel <= 0.04045, lo, hi)


def rgb_to_srgb(rgb):
    """Exact, per channel."""
    return linear_to_srgb(rgb)


def srgb_to_rgb(srgb):
    return srgb_to_linear(srgb)


def rgb_to_xyz(rgb):
    return _mat3(RGB_2_XYZ, rgb)


def xyz_to_rgb(xyz):
    return _mat3(XYZ_2_RGB, xyz)


def xyz_to_xyY(xyz):
    s = xyz[..., 0] + xyz[..., 1] + xyz[..., 2]
    return torch.stack([xyz[..., 0] / s, xyz[..., 1] / s, xyz[..., 1]],
                       dim=-1)


def xyY_to_xyz(xyY):
    y_lum = xyY[..., 2]
    x = y_lum * xyY[..., 0] / xyY[..., 1]
    z = y_lum * (1.0 - xyY[..., 0] - xyY[..., 1]) / xyY[..., 1]
    return torch.stack([x, y_lum, z], dim=-1)


def rgb_to_xyY(rgb):
    return xyz_to_xyY(rgb_to_xyz(rgb))


def xyY_to_rgb(xyY):
    return xyz_to_rgb(xyY_to_xyz(xyY))


def rgb_to_hcv(rgb):
    """Hocevar/Persson branchless hue -> (H, C, V)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    gb = g < b
    px = torch.where(gb, b, g)
    py = torch.where(gb, g, b)
    pz = torch.where(gb, -1.0, 0.0)
    pw = torch.where(gb, 2.0 / 3.0, -1.0 / 3.0)
    rp = r < px
    qx = torch.where(rp, px, r)
    qy = py
    qz = torch.where(rp, pw, pz)
    qw = torch.where(rp, r, px)
    c = qx - torch.minimum(qw, qy)
    h = ((qw - qy) / (6.0 * c + HCV_EPSILON) + qz).abs()
    return torch.stack([h, c, qx], dim=-1)


def hue_to_rgb(hue):
    """hue (...,) -> (..., 3)."""
    r = (hue * 6.0 - 3.0).abs() - 1.0
    g = 2.0 - (hue * 6.0 - 2.0).abs()
    b = 2.0 - (hue * 6.0 - 4.0).abs()
    return _sat(torch.stack([r, g, b], dim=-1))


def hsv_to_rgb(hsv):
    rgb = hue_to_rgb(hsv[..., 0])
    return ((rgb - 1.0) * hsv[..., 1:2] + 1.0) * hsv[..., 2:3]


def hsl_to_rgb(hsl):
    rgb = hue_to_rgb(hsl[..., 0])
    c = (1.0 - (2.0 * hsl[..., 2] - 1.0).abs()) * hsl[..., 1]
    return (rgb - 0.5) * c[..., None] + hsl[..., 2:3]


def hcy_to_rgb(hcy):
    rgb = hue_to_rgb(hcy[..., 0])
    z = _dot3(rgb, _HCY_WTS)
    y = hcy[..., 2]
    c = hcy[..., 1]
    c = torch.where(y < z, c * (y / z),
                    torch.where(z < 1.0, c * (1.0 - y) / (1.0 - z), c))
    return (rgb - z[..., None]) * c[..., None] + y[..., None]


def rgb_to_hsv(rgb):
    hcv = rgb_to_hcv(rgb)
    s = hcv[..., 1] / (hcv[..., 2] + HCV_EPSILON)
    return torch.stack([hcv[..., 0], s, hcv[..., 2]], dim=-1)


def rgb_to_hsl(rgb):
    hcv = rgb_to_hcv(rgb)
    lum = hcv[..., 2] - hcv[..., 1] * 0.5
    s = hcv[..., 1] / (1.0 - (lum * 2.0 - 1.0).abs() + HSL_EPSILON)
    return torch.stack([hcv[..., 0], s, lum], dim=-1)


def rgb_to_hcy(rgb):
    """Schaeffer correction."""
    hcv = rgb_to_hcv(rgb)
    y = _dot3(rgb, _HCY_WTS)
    z = _dot3(hue_to_rgb(hcv[..., 0]), _HCY_WTS)
    c = torch.where(y < z, hcv[..., 1] * z / (HCY_EPSILON + y),
                    hcv[..., 1] * (1.0 - z) / (HCY_EPSILON + 1.0 - y))
    return torch.stack([hcv[..., 0], c, y], dim=-1)


def rgb_to_ycbcr(rgb):
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    cb = (rgb[..., 2] - y) * 0.565
    cr = (rgb[..., 0] - y) * 0.713
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr_to_rgb(yuv):
    return torch.stack([
        yuv[..., 0] + 1.403 * yuv[..., 2],
        yuv[..., 0] - 0.344 * yuv[..., 1] - 0.714 * yuv[..., 2],
        yuv[..., 0] + 1.770 * yuv[..., 1]], dim=-1)


# chained conversions, as tpurt composes them, including the reference's
# ycbcr_to_hcv typo that routes through rgb_to_hcy

def xyz_to_srgb(xyz):
    return rgb_to_srgb(xyz_to_rgb(xyz))


def xyY_to_srgb(xyY):
    return rgb_to_srgb(xyY_to_rgb(xyY))


def hue_to_srgb(hue):
    return rgb_to_srgb(hue_to_rgb(hue))


def hsv_to_srgb(hsv):
    return rgb_to_srgb(hsv_to_rgb(hsv))


def hsl_to_srgb(hsl):
    return rgb_to_srgb(hsl_to_rgb(hsl))


def hcy_to_srgb(hcy):
    return rgb_to_srgb(hcy_to_rgb(hcy))


def ycbcr_to_srgb(yuv):
    return rgb_to_srgb(ycbcr_to_rgb(yuv))


def srgb_to_xyz(srgb):
    return rgb_to_xyz(srgb_to_rgb(srgb))


def hue_to_xyz(hue):
    return rgb_to_xyz(hue_to_rgb(hue))


def hsv_to_xyz(hsv):
    return rgb_to_xyz(hsv_to_rgb(hsv))


def hsl_to_xyz(hsl):
    return rgb_to_xyz(hsl_to_rgb(hsl))


def hcy_to_xyz(hcy):
    return rgb_to_xyz(hcy_to_rgb(hcy))


def ycbcr_to_xyz(yuv):
    return rgb_to_xyz(ycbcr_to_rgb(yuv))


def srgb_to_xyY(srgb):
    return rgb_to_xyY(srgb_to_rgb(srgb))


def hue_to_xyY(hue):
    return rgb_to_xyY(hue_to_rgb(hue))


def hsv_to_xyY(hsv):
    return rgb_to_xyY(hsv_to_rgb(hsv))


def hsl_to_xyY(hsl):
    return rgb_to_xyY(hsl_to_rgb(hsl))


def hcy_to_xyY(hcy):
    return rgb_to_xyY(hcy_to_rgb(hcy))


def ycbcr_to_xyY(yuv):
    return rgb_to_xyY(ycbcr_to_rgb(yuv))


def srgb_to_hcv(srgb):
    return rgb_to_hcv(srgb_to_rgb(srgb))


def xyz_to_hcv(xyz):
    return rgb_to_hcv(xyz_to_rgb(xyz))


def xyY_to_hcv(xyY):
    return rgb_to_hcv(xyY_to_rgb(xyY))


def hue_to_hcv(hue):
    return rgb_to_hcv(hue_to_rgb(hue))


def hsv_to_hcv(hsv):
    return rgb_to_hcv(hsv_to_rgb(hsv))


def hsl_to_hcv(hsl):
    return rgb_to_hcv(hsl_to_rgb(hsl))


def hcy_to_hcv(hcy):
    return rgb_to_hcv(hcy_to_rgb(hcy))


def ycbcr_to_hcv(yuv):
    # the reference calls rgb_to_hcy here; kept
    return rgb_to_hcy(ycbcr_to_rgb(yuv))


def srgb_to_hsv(srgb):
    return rgb_to_hsv(srgb_to_rgb(srgb))


def xyz_to_hsv(xyz):
    return rgb_to_hsv(xyz_to_rgb(xyz))


def xyY_to_hsv(xyY):
    return rgb_to_hsv(xyY_to_rgb(xyY))


def hue_to_hsv(hue):
    return rgb_to_hsv(hue_to_rgb(hue))


def hsl_to_hsv(hsl):
    return rgb_to_hsv(hsl_to_rgb(hsl))


def hcy_to_hsv(hcy):
    return rgb_to_hsv(hcy_to_rgb(hcy))


def ycbcr_to_hsv(yuv):
    return rgb_to_hsv(ycbcr_to_rgb(yuv))


def srgb_to_hsl(srgb):
    return rgb_to_hsl(srgb_to_rgb(srgb))


def xyz_to_hsl(xyz):
    return rgb_to_hsl(xyz_to_rgb(xyz))


def xyY_to_hsl(xyY):
    return rgb_to_hsl(xyY_to_rgb(xyY))


def hue_to_hsl(hue):
    return rgb_to_hsl(hue_to_rgb(hue))


def hsv_to_hsl(hsv):
    return rgb_to_hsl(hsv_to_rgb(hsv))


def hcy_to_hsl(hcy):
    return rgb_to_hsl(hcy_to_rgb(hcy))


def ycbcr_to_hsl(yuv):
    return rgb_to_hsl(ycbcr_to_rgb(yuv))


def srgb_to_hcy(srgb):
    return rgb_to_hcy(srgb_to_rgb(srgb))


def xyz_to_hcy(xyz):
    return rgb_to_hcy(xyz_to_rgb(xyz))


def xyY_to_hcy(xyY):
    return rgb_to_hcy(xyY_to_rgb(xyY))


def hue_to_hcy(hue):
    return rgb_to_hcy(hue_to_rgb(hue))


def hsv_to_hcy(hsv):
    return rgb_to_hcy(hsv_to_rgb(hsv))


def hsl_to_hcy(hsl):
    return rgb_to_hcy(hsl_to_rgb(hsl))


def ycbcr_to_hcy(yuv):
    return rgb_to_hcy(ycbcr_to_rgb(yuv))


def srgb_to_ycbcr(srgb):
    return rgb_to_ycbcr(srgb_to_rgb(srgb))


def xyz_to_ycbcr(xyz):
    return rgb_to_ycbcr(xyz_to_rgb(xyz))


def xyY_to_ycbcr(xyY):
    return rgb_to_ycbcr(xyY_to_rgb(xyY))


def hue_to_ycbcr(hue):
    return rgb_to_ycbcr(hue_to_rgb(hue))


def hsv_to_ycbcr(hsv):
    return rgb_to_ycbcr(hsv_to_rgb(hsv))


def hsl_to_ycbcr(hsl):
    return rgb_to_ycbcr(hsl_to_rgb(hsl))


def hcy_to_ycbcr(hcy):
    return rgb_to_ycbcr(hcy_to_rgb(hcy))
