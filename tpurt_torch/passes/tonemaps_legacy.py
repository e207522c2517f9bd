"""Legacy tonemapping curves (Lottes, Uchimura, ACES fitted and film) —
port of ``tpurt/passes/tonemaps_legacy.py``, over tensors.

The reference keeps these beside its LPM tonemapper. ``aces_fitted``
applies the transposes of the standard Hill ACES matrices, as the
reference's GLSL (column-major constructors from row-listed literals,
matrix * vector) and tpurt do.
"""
from __future__ import annotations

import torch


def tonemap_lottes(x):
    """Lottes 2016, elementwise."""
    a = 1.6
    d = 0.977
    hdr_max = 8.0
    mid_in = 0.18
    mid_out = 0.267
    b = ((-(mid_in ** a) + (hdr_max ** a) * mid_out)
         / (((hdr_max ** (a * d)) - (mid_in ** (a * d))) * mid_out))
    c = (((hdr_max ** (a * d)) * (mid_in ** a)
          - (hdr_max ** a) * (mid_in ** (a * d)) * mid_out)
         / (((hdr_max ** (a * d)) - (mid_in ** (a * d))) * mid_out))
    x = torch.clamp_min(x, 0.0)
    return torch.pow(x, a) / (torch.pow(x, a * d) * b + c)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def tonemap_uchimura(x, P=1.0, a=1.0, m=0.22, l=0.4, c=1.33, b=0.0):
    """Uchimura 2017, "HDR theory and practice"."""
    l0 = ((P - m) * l) / a
    S1 = m + a * l0
    C2 = (a * P) / (P - S1)
    CP = -C2 / P
    S0 = m + l0

    x = torch.clamp_min(x, 0.0)
    w0 = 1.0 - _smoothstep(0.0, m, x)
    w2 = torch.where(x >= m + l0, 1.0, 0.0)
    w1 = 1.0 - w0 - w2

    T = m * torch.pow(x / m, c) + b
    S = P - (P - S1) * torch.exp(CP * (x - S0))
    L = m + a * (x - m)
    return T * w0 + L * w1 + S * w2


_ACES_IN = ((0.59719, 0.35458, 0.04823),
            (0.07600, 0.90834, 0.01566),
            (0.02840, 0.13383, 0.83777))
_ACES_OUT = ((1.60475, -0.53108, -0.07367),
             (-0.10208, 1.10813, -0.00605),
             (-0.00327, -0.07276, 1.07602))


def _rtt_and_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def _vec_mat(v, m):
    """v @ m over (..., 3): out_i = sum_j v_j m[j][i], left to right."""
    return torch.stack([v[..., 0] * m[0][i] + v[..., 1] * m[1][i]
                        + v[..., 2] * m[2][i] for i in range(3)], dim=-1)


def aces_fitted(rgb):
    """ACES fitted over (..., 3) linear color, with the reference's
    transposed matrices."""
    v = _rtt_and_odt_fit(_vec_mat(rgb, _ACES_IN))
    return _vec_mat(v, _ACES_OUT)


def aces_film(x):
    """ACES filmic approximation."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
