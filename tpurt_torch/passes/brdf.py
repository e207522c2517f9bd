"""PBR BRDF terms used by the shade pass — port of ``tpurt/passes/brdf.py``
(the GGX specular with the fast height-correlated Smith visibility, and the
Burley diffuse with a local subsurface term). Elementwise over leading
axes; colors carry a trailing axis of 3.
"""
from __future__ import annotations

import torch

PI = 3.14159265359


def _mix(a, b, t):
    return a + (b - a) * t


def d_ggx(roughness, NdotH):
    """Walter et al. 2007 GGX NDF."""
    one_minus_noh2 = 1.0 - NdotH * NdotH
    a = NdotH * roughness
    k = roughness / (one_minus_noh2 + a * a)
    return k * k * (1.0 / PI)


def v_smith_ggx_correlated_fast(roughness, NdotV, NdotL):
    """Hammon 2017 approximation of the height-correlated Smith term."""
    return 0.5 / _mix(2.0 * NdotL * NdotV, NdotL + NdotV, roughness)


def f_schlick(F0, HdotV, F90=1.0):
    """Schlick Fresnel; F0 may be a float or (..., 3)."""
    if isinstance(F0, torch.Tensor) and F0.ndim > HdotV.ndim:
        HdotV = HdotV[..., None]
    return F0 + (F90 - F0) * torch.pow(1.0 - HdotV, 5.0)


def cook_torrance_specular(NdotL, NdotV, NdotH, roughness, F):
    """(D * G_fast) * F; F is (..., 3)."""
    D = d_ggx(roughness, NdotH)
    G = v_smith_ggx_correlated_fast(roughness, NdotV, NdotL)
    return (D * G)[..., None] * F


def burley_diffuse_local_sss(roughness, NdotV, nc_NdotV, nc_NdotL, LdotH,
                             local_sss_diffuse_ratio):
    """Burley diffuse with the local subsurface-scattering term."""
    F_SS90 = roughness * LdotH * LdotH
    F_SS = f_schlick(1.0, nc_NdotL, F_SS90) * f_schlick(1.0, nc_NdotV, F_SS90)
    f_ss = (1.0 / (nc_NdotV * nc_NdotL) - 0.5) * F_SS + 0.5
    local_sss = 1.25 * local_sss_diffuse_ratio * f_ss

    f90 = 0.5 + 2.0 * F_SS90
    diffuse = ((1.0 - local_sss_diffuse_ratio)
               * f_schlick(1.0, nc_NdotL, f90) * f_schlick(1.0, nc_NdotV, f90))
    return NdotV * (diffuse + local_sss) * (1.0 / PI)
