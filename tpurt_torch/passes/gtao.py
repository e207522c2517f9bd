"""XeGTAO ambient occlusion — port of ``tpurt/passes/gtao.py``.

  1. prefilter_depths — the 5-level weighted R16F depth pyramid (tensor ops,
     as tpurt runs it in plain XLA; with fp16 the filter's lpfloat
     arithmetic rounds to f16 after every operation);
  2. the main pass — kernel K3 (kernels/gtao_main.py), its bent-normal,
     "half" and fp16 variants included;
  3. the denoise chain — kernel K4 (kernels/gtao_denoise.py), over the
     packed bent-normal term or in fp16 too.

``compute_ao_band`` runs the chain over a band of the image's rows (the
band-sharded frame, ``dist/sharding.py``), ``compute_ao`` over all of
them.

The final AO term is the reference's unclamped u16 range (0..~383), held
in an int32 tensor; with bent normals it is the packed RGBA8 (bent normal,
visibility) term as uint32 bits in an int32 tensor, which
``ao_visibility_u8`` and ``ao_bent_normals`` unpack. ``gtao_debug_image``
is the debug build's RGBA16F target.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.gtao_denoise import (decode_bent, denoise_chain,
                                    denoise_pass_plain)
from ..kernels.gtao_main import (PRECISIONS, XE_GTAO_OCCLUSION_TERM_SCALE,
                                 _Lp, encode_bent, gtao_main,
                                 main_pass_plain, rot_from_minus_z)
from .encodings import divide, quantize_r16f, sqrt

XE_GTAO_DEPTH_MIP_LEVELS = 5

# (slice_count, steps_per_slice) of XeGTAO's quality presets
QUALITY_LOW = (1, 2)
QUALITY_MEDIUM = (2, 2)
QUALITY_HIGH = (3, 3)
QUALITY_ULTRA = (9, 3)

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
    1 sharp, 2 medium, 3 soft. bent_normals adds XeGTAO's directional
    component (the packed term above). precision: "exact" (f32), "half"
    (each fetched horizon depth rounded to bf16, tpurt's Pallas main pass;
    ignored with bent_normals, whose pass tpurt computes in f32) or "fp16"
    (tpurt's min16float emulation in the prefilter, main pass and denoise).
    tpurt's diagnostic precisions ("debug_*", wrong AO by design) raise.
    tpurt's pallas_main, pallas_denoise, schedule, noise_hoist and
    thin_zero are not fields: they pick TPU routes whose result is
    bit-identical to its XLA passes, and K3 and K4 are the port's only
    route."""

    slice_count: int = 9
    steps_per_slice: int = 3
    denoise: int = 1
    bent_normals: bool = False
    precision: str = "exact"

    def __post_init__(self):
        if self.precision.startswith("debug_"):
            raise NotImplementedError(
                f"GTAO precision {self.precision!r} is one of tpurt's "
                f"diagnostic modes (wrong AO by design); not ported")
        if self.precision not in PRECISIONS:
            raise ValueError(f"GTAO precision {self.precision!r}: expected "
                             f"one of {PRECISIONS}")

    @property
    def fp16(self) -> bool:
        return self.precision == "fp16"

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


def _r2_noise(fidx):
    """(slice noise, sample noise) of index tables `fidx` (..., 64, 64):
    (..., 2, 64, 64) f32, every element computed alone."""
    nx = torch.fmod(0.5 + fidx * 0.75487766624669276005, 1.0)
    ny = torch.fmod(0.5 + fidx * 0.5698402909980532659114, 1.0)
    return torch.stack([nx, ny], dim=-3).contiguous()


def noise_maps_64(noise_index: int, device) -> torch.Tensor:
    """The Hilbert/R2 spatio-temporal noise over its 64x64 period:
    (2, 64, 64) f32 = (slice noise, sample noise), from the index table of
    `noise_index` (the Hilbert LUT + 288 * index, exact small integers in
    f32), copied to `device` from the host: GTAO's `noise` argument."""
    idx = _HILBERT_LUT.astype(np.int64) + 288 * (int(noise_index) % 64)
    return _r2_noise(torch.as_tensor(idx.astype(np.float32), device=device))


def noise_tables(device) -> torch.Tensor:
    """``noise_maps_64`` of every noise index at once, (64, 2, 64, 64) f32
    on `device` (2 MiB; one copy of the 64 index tables): the same values,
    since every element is computed alone. ``Renderer`` keeps them on the
    device and passes a frame its index's maps, so no frame copies
    anything from the host for its noise."""
    idx = (_HILBERT_LUT.astype(np.int64)[None]
           + 288 * np.arange(64, dtype=np.int64)[:, None, None])
    return _r2_noise(torch.as_tensor(idx.astype(np.float32), device=device))


def _depth_mip_filter(d0, d1, d2, d3, consts, fp16: bool = False):
    """Weighted 2x2 depth reduction (XeGTAO_DepthMIPFilter). With fp16
    every quantity is lpfloat: tpurt's ``lp(x)`` of a constant is its f32
    rounded to f16, each operation rounds to f16."""
    if fp16:
        r = _Lp(True).r
        f16 = np.float16

        def c(key):
            return f16(np.float32(consts[key]))

        effect_radius = f16(0.75) * c("effect_radius") * c(
            "radius_multiplier")
        falloff_range = c("effect_falloff_range") * effect_radius
        falloff_from = effect_radius * (f16(1.0) - c("effect_falloff_range"))
        falloff_mul = float(f16(-1.0) / falloff_range)
        falloff_add = float(falloff_from / falloff_range + f16(1.0))
    else:
        def r(x):
            return x

        depth_range_scale = 0.75
        effect_radius = (depth_range_scale * consts["effect_radius"]
                         * consts["radius_multiplier"])
        falloff_range = consts["effect_falloff_range"] * effect_radius
        falloff_from = effect_radius * (1.0 - consts["effect_falloff_range"])
        falloff_mul = -1.0 / falloff_range
        falloff_add = falloff_from / falloff_range + 1.0
    max_depth = torch.maximum(torch.maximum(d0, d1), torch.maximum(d2, d3))

    def w(d):
        return torch.clamp(r(r(r(max_depth - d) * falloff_mul)
                             + falloff_add), 0.0, 1.0)

    w0, w1, w2, w3 = w(d0), w(d1), w(d2), w(d3)
    wsum = r(r(r(w0 + w1) + w2) + w3)
    num = r(r(r(r(w0 * d0) + r(w1 * d1)) + r(w2 * d2)) + r(w3 * d3))
    return r(num / wsum)


def prefilter_depths(view_depth, consts: dict, fp16: bool = False):
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
                              bot[:, 0::2], bot[:, 1::2], consts, fp16)
        mips.append(quantize_r16f(m).contiguous())
    return mips


def _main_pass(mips, normal_enc, gtao: dict, settings: GtaoSettings,
               noise, row_start: int = 0, num_rows=None):
    """K3h + K3 in the settings' variant, over the whole image or a band of
    rows (``kernels/gtao_main.band_rows``): (ao term, edges_u8)."""
    return gtao_main(mips, normal_enc.contiguous(),
                     gtao["vec16" if settings.fp16 else "vec"],
                     noise,
                     slice_count=settings.slice_count,
                     steps_per_slice=settings.steps_per_slice,
                     bent=settings.bent_normals,
                     precision=settings.precision, row_start=row_start,
                     num_rows=num_rows)


def compute_ao(view_depth, normal_enc, gtao: dict, settings: GtaoSettings,
               noise):
    """Full GTAO chain: prefilter -> K3 -> K4. `gtao` is
    ``engine/convert.gtao_tensors(...)``, `noise` the frame's (2, 64, 64)
    noise maps on the device of the depth (``noise_maps_64(index, ...)``,
    or the index's row of ``noise_tables``). Returns the final AO term
    (H, W) int32: 0..~383, or the packed term with bent normals."""
    return compute_ao_band(view_depth, normal_enc, gtao, settings, noise, 0,
                           view_depth.shape[0])


def compute_ao_band(view_depth, normal_enc, gtao: dict,
                    settings: GtaoSettings, noise, row_start: int,
                    band_rows: int):
    """The final AO term of rows [row_start, row_start + band_rows) of the
    frame whose whole (H, W) depth and normals are given (tpurt's
    ``compute_ao_band``, the band-sharded frame's GTAO). The prefilter runs
    over the whole image, K3 over the band and a halo of
    num_denoise_passes + 1 rows on each side, K4 over that (up to
    band_rows + 2 * halo, W) array, and the halo is trimmed. Returns
    (band_rows, W) int32; ``compute_ao`` is the band of the whole image.

    The halo stops at the image's edges. tpurt's band runs on there with
    rows that repeat the edge row; each denoise pass after the first then
    reads a repeated row that the whole frame's edge clamp does not see,
    so with two or more passes its first and last rows differ from its
    ``compute_ao`` (ROADMAP F22). Here the band array's edge is the
    image's, and K4 clamps there as over the whole frame. `noise` as in
    ``compute_ao``."""
    h = view_depth.shape[0]
    if not (band_rows >= 1 and 0 <= row_start and row_start + band_rows <= h):
        raise ValueError(f"compute_ao_band: rows [{row_start}, "
                         f"{row_start + band_rows}) outside an image of {h}")
    halo = settings.num_denoise_passes + 1
    lo = max(row_start - halo, 0)
    hi = min(row_start + band_rows + halo, h)
    mips = prefilter_depths(view_depth, gtao["host"], fp16=settings.fp16)
    ao, edges = _main_pass(mips, normal_enc, gtao, settings, noise,
                           row_start=lo, num_rows=hi - lo)
    ao = denoise_chain(ao, edges, n_passes=settings.num_denoise_passes,
                       blur_beta=settings.denoise_blur_beta,
                       bent=settings.bent_normals, fp16=settings.fp16)
    return ao[row_start - lo:row_start - lo + band_rows]


def encode_visibility_bent_normal(visibility, bent_normal):
    """XeGTAO_EncodeVisibilityBentNormal: the RGBA8 pack of (bn * 0.5 +
    0.5, visibility), uint32 bits in int32. bent_normal is (..., 3)."""
    return encode_bent(visibility, bent_normal[..., 0], bent_normal[..., 1],
                       bent_normal[..., 2])


def decode_visibility_bent_normal(packed):
    """XeGTAO_DecodeVisibilityBentNormal: (visibility (...,), bn (..., 3))
    f32 of the packed int32 term."""
    v, bn = decode_bent(packed)
    return v, torch.stack(bn, dim=-1)


def _rot_from_minus_z(to):
    """XeGTAO_RotFromToMatrix with from = (0, 0, -1) over (..., 3) targets
    (f32; the plain K3's ``rot_from_minus_z``): returns rot(v), the matrix
    applied to (..., 3) vectors."""
    rot = rot_from_minus_z(to[..., 0], to[..., 1], to[..., 2])
    return lambda v: torch.stack(rot(v[..., 0], v[..., 1], v[..., 2]),
                                 dim=-1)


def _norm3(v):
    return sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                + v[..., 2] * v[..., 2])


def ao_visibility_u8(ao, settings: GtaoSettings):
    """Final AO term -> visibility: the identity without bent normals, the
    packed term's visibility as u8 values (int32) with them."""
    if not settings.bent_normals:
        return ao
    v, _ = decode_bent(ao)
    return (torch.clamp(v, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).to(
        torch.int32)


def ao_bent_normals(ao, settings: GtaoSettings):
    """Final AO term -> view-space bent normals (H, W, 3) f32, or None."""
    if not settings.bent_normals:
        return None
    _, bn = decode_visibility_bent_normal(ao)
    return bn / torch.clamp_min(_norm3(bn), 1e-20)[..., None]


def _calculate_edges(center, left, right, top, bottom):
    """XeGTAO_CalculateEdges (f32): the unquantized (..., 4) LRTB edges."""
    e = torch.stack([left, right, top, bottom], dim=-1) - center[..., None]
    slope_lr = (e[..., 1] - e[..., 0]) * 0.5
    slope_tb = (e[..., 3] - e[..., 2]) * 0.5
    adj = e + torch.stack([slope_lr, -slope_lr, slope_tb, -slope_tb], dim=-1)
    e = torch.minimum(e.abs(), adj.abs())
    return torch.clamp(1.25 - e / (center[..., None] * 0.011), 0.0, 1.0)


def _shift_clamp(img, dy: int, dx: int):
    h, w = img.shape[:2]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


DEBUG_MODES = ("normals", "edges", "ao")


def gtao_debug_image(view_depth, normal_enc, gtao: dict,
                     settings: GtaoSettings, noise,
                     mode: str = "normals"):
    """The debug build's RGBA16F image (tpurt's ``gtao_debug_image``):
    (H, W, 4) float16.

    * "normals": abs(n * 0.5 + 0.5) of the decoded view normal, alpha 1;
    * "edges": 1 - (e.l, e.r * 0.5 + e.b * 0.5, e.t, 1) of the unquantized
      edges of the depth pyramid's mip 0;
    * "ao": abs(v * 0.5 + 0.5) of the main pass's working AO visibility
      (K3 in the settings' variant, no denoise) broadcast to rgb.
    `gtao` is ``engine/convert.gtao_tensors(...)``; `noise` as in
    ``compute_ao``."""
    if mode not in DEBUG_MODES:
        raise ValueError(f"unknown debug image mode: {mode!r}")
    mips = prefilter_depths(view_depth, gtao["host"], fp16=settings.fp16)
    d0 = mips[0]
    ones = torch.ones_like(d0)
    if mode == "normals":
        n = normal_enc * 2.0 - 1.0
        n = n / torch.clamp_min(_norm3(n), 1e-20)[..., None]
        rgba = torch.cat([(n * 0.5 + 0.5).abs(), ones[..., None]], dim=-1)
    elif mode == "edges":
        e = _calculate_edges(d0, _shift_clamp(d0, 0, -1),
                             _shift_clamp(d0, 0, 1), _shift_clamp(d0, -1, 0),
                             _shift_clamp(d0, 1, 0))
        rgba = 1.0 - torch.stack([e[..., 0], e[..., 1] * 0.5 + e[..., 3] * 0.5,
                                  e[..., 2], ones], dim=-1)
    else:
        ao, _ = _main_pass(mips, normal_enc, gtao, settings, noise)
        v = divide(ao_visibility_u8(ao, settings).to(torch.float32), 255.0)
        rgb = (v[..., None] * 0.5 + 0.5).abs().expand(*v.shape, 3)
        rgba = torch.cat([rgb, ones[..., None]], dim=-1)
    return rgba.to(torch.float16)
