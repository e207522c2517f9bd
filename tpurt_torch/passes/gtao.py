"""XeGTAO ambient occlusion — port of ``tpurt/passes/gtao.py`` (the main
path: no bent normals, f32).

  1. prefilter_depths — the 5-level weighted R16F depth pyramid (tensor ops,
     as tpurt runs it in plain XLA);
  2. the main pass — kernel K3 (kernels/gtao_main.py);
  3. the denoise chain — kernel K4 (kernels/gtao_denoise.py).

The final AO term is the reference's unclamped u16 range (0..~383), held
in an int32 tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.gtao_denoise import denoise_chain, denoise_pass_plain
from ..kernels.gtao_main import gtao_main, main_pass_plain
from .encodings import quantize_r16f

XE_GTAO_DEPTH_MIP_LEVELS = 5

DEFAULT_CONSTANTS = dict(
    effect_radius=0.2,
    effect_falloff_range=0.615,
    radius_multiplier=1.457,
    sample_distribution_power=2.0,
    thin_occluder_compensation=0.0,
    final_value_power=2.2,
    depth_mip_sampling_offset=3.30,
)

# the reference's plain entry points under their own names
main_pass = main_pass_plain
denoise_pass = denoise_pass_plain


@dataclass(frozen=True)
class GtaoSettings:
    """The reference's GtaoSettings (tpurt field names). denoise: 0 off,
    1 sharp, 2 medium, 3 soft. The port runs the f32 path without bent
    normals; the other options raise."""

    slice_count: int = 9
    steps_per_slice: int = 3
    denoise: int = 1
    bent_normals: bool = False
    precision: str = "exact"

    def __post_init__(self):
        if self.bent_normals:
            raise NotImplementedError(
                "bent normals are not ported yet (tpurt keeps them on its "
                "XLA path, ROADMAP F6)")
        if self.precision != "exact":
            raise NotImplementedError(
                f"GTAO precision {self.precision!r} is not ported yet")

    @property
    def denoise_blur_beta(self) -> float:
        return 1e4 if self.denoise == 0 else 1.2

    @property
    def num_denoise_passes(self) -> int:
        return max(self.denoise - 1, 0) + 1


def gtao_constants(width: int, height: int, znear: float, zfar: float,
                   fovy: float, aspect: float) -> dict:
    """Dynamic GTAOConstants (Python floats, as tpurt computes them)."""
    tan_half_fovy = math.tan(fovy * 0.5)
    tan_half_fovx = tan_half_fovy * aspect
    ndc_to_view_mul = (tan_half_fovx * 2.0, tan_half_fovy * -2.0)
    ndc_to_view_add = (-tan_half_fovx, tan_half_fovy)
    consts = dict(DEFAULT_CONSTANTS)
    consts.update(
        viewport_size=(width, height),
        viewport_pixel_size=(1.0 / width, 1.0 / height),
        depth_unpack=((zfar * znear) / (zfar - znear), zfar / (zfar - znear)),
        camera_tan_half_fov=(tan_half_fovx, tan_half_fovy),
        ndc_to_view_mul=ndc_to_view_mul,
        ndc_to_view_add=ndc_to_view_add,
        ndc_to_view_mul_x_pixel_size=(ndc_to_view_mul[0] / width,
                                      ndc_to_view_mul[1] / height),
    )
    return consts


def _hilbert_lut_64() -> np.ndarray:
    """64x64 Hilbert curve index LUT (XeGTAO HilbertIndex)."""
    lut = np.zeros((64, 64), np.uint32)
    for y in range(64):
        for x in range(64):
            px, py = x, y
            index = 0
            level = 32
            while level > 0:
                rx = 1 if (px & level) > 0 else 0
                ry = 1 if (py & level) > 0 else 0
                index += level * level * ((3 * rx) ^ ry)
                if ry == 0:
                    if rx == 1:
                        px = 63 - px
                        py = 63 - py
                    px, py = py, px
                level //= 2
            lut[y, x] = index
    return lut


_HILBERT_LUT = _hilbert_lut_64()


def noise_maps_64(noise_index: int, device) -> torch.Tensor:
    """The Hilbert/R2 spatio-temporal noise over its 64x64 period:
    (2, 64, 64) f32 = (slice noise, sample noise)."""
    idx = _HILBERT_LUT.astype(np.int64) + 288 * (int(noise_index) % 64)
    fidx = torch.as_tensor(idx.astype(np.float32), device=device)
    nx = torch.fmod(0.5 + fidx * 0.75487766624669276005, 1.0)
    ny = torch.fmod(0.5 + fidx * 0.5698402909980532659114, 1.0)
    return torch.stack([nx, ny]).contiguous()


def _depth_mip_filter(d0, d1, d2, d3, consts):
    """Weighted 2x2 depth reduction (XeGTAO_DepthMIPFilter)."""
    max_depth = torch.maximum(torch.maximum(d0, d1), torch.maximum(d2, d3))
    depth_range_scale = 0.75
    effect_radius = (depth_range_scale * consts["effect_radius"]
                     * consts["radius_multiplier"])
    falloff_range = consts["effect_falloff_range"] * effect_radius
    falloff_from = effect_radius * (1.0 - consts["effect_falloff_range"])
    falloff_mul = -1.0 / falloff_range
    falloff_add = falloff_from / falloff_range + 1.0

    def w(d):
        return torch.clamp((max_depth - d) * falloff_mul + falloff_add,
                           0.0, 1.0)

    w0, w1, w2, w3 = w(d0), w(d1), w(d2), w(d3)
    wsum = w0 + w1 + w2 + w3
    return (w0 * d0 + w1 * d1 + w2 * d2 + w3 * d3) / wsum


def prefilter_depths(view_depth, consts: dict):
    """(H, W) linear view depth -> list of 5 R16F-valued f32 mips."""
    d = torch.clamp(view_depth, 0.0, 65504.0)
    mips = [quantize_r16f(d)]
    for _ in range(XE_GTAO_DEPTH_MIP_LEVELS - 1):
        prev = mips[-1]
        h, w = prev.shape
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        x = prev[:h2 * 2, :w2 * 2]
        top = x[0::2]
        bot = x[1::2]
        m = _depth_mip_filter(top[:, 0::2], top[:, 1::2],
                              bot[:, 0::2], bot[:, 1::2], consts)
        mips.append(quantize_r16f(m).contiguous())
    return mips


def compute_ao(view_depth, normal_enc, gtao: dict, settings: GtaoSettings,
               noise_index: int):
    """Full GTAO chain: prefilter -> K3 -> K4. `gtao` is
    ``engine/convert.gtao_tensors(...)``. Returns the final AO term (H, W)
    int32 in 0..~383."""
    mips = prefilter_depths(view_depth, gtao["host"])
    ao, edges = gtao_main(mips, normal_enc.contiguous(), gtao["vec"],
                          noise_maps_64(noise_index, view_depth.device),
                          slice_count=settings.slice_count,
                          steps_per_slice=settings.steps_per_slice)
    return denoise_chain(ao, edges, n_passes=settings.num_denoise_passes,
                         blur_beta=settings.denoise_blur_beta)


def ao_visibility_u8(ao, settings: GtaoSettings):
    """Final AO term -> visibility (the identity without bent normals)."""
    del settings
    return ao
