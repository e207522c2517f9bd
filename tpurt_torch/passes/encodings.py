"""Storage-format quantizers — port of ``tpurt/passes/encodings.py``.

The frame stores color and encoded normals in B10G11R11_UFLOAT, view depth
in R16F and the image in unorm8, at the same points as the reference. The
small floats round-trip exactly through their f16 bit patterns. XeGTAO's
R11G11B10 unorm packing holds its uint32 words as int32 bits.
"""
from __future__ import annotations

import numpy as np
import torch


def sqrt(x):
    """The f32 square root of x, correctly rounded on every device. On the
    card it is PyTorch's (IEEE). PyTorch's CPU kernel goes through MKL's
    VML, which is not correctly rounded (1 ULP off on ~1% of inputs) and,
    on the first call of a process that two of its threads share (inputs of
    4,096 and more elements, in chunks of 2,048), has returned ~12-bit
    results on the second thread's chunk (tools/sqrt_probe.py); on CPU
    tensors the root is numpy's, which is IEEE's. Every square root of the
    package goes through here."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):    # NaN below 0, as torch's
            return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch_sqrt(x)


def torch_sqrt(x):
    """PyTorch's own root on every device (MKL's VML on the CPU). Only
    ``sqrt`` and ``tools/sqrt_probe.py``, which counts what VML gets wrong,
    call it."""
    return torch.sqrt(x)


def divide(x, s: float):
    """x / s, rounded once on every device. PyTorch's CUDA kernels multiply
    by the reciprocal of a host scalar divisor, which rounds twice; a
    divisor that lives on the tensor's device divides exactly, as the CPU
    kernels and the CUDA kernels of this package do."""
    return x / x.new_full((), s)


def rdivide(s: float, x):
    """s / x, rounded once (``s / x`` with a host scalar computes
    reciprocal(x) * s)."""
    return x.new_full((), s) / x


def _quantize_small_float(x, mantissa_bits: int):
    """Round a positive f32 through a 5-exponent / `mantissa_bits` unsigned
    float (R11F: 6, B10F: 5) by dropping f16 mantissa bits, nearest."""
    x = torch.clamp_min(x, 0.0)
    bits = x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    drop = 10 - mantissa_bits
    half = 1 << (drop - 1)
    mask = ~((1 << drop) - 1) & 0xFFFF
    rounded = (bits + half) & mask
    max_finite = 0x7BFF & mask
    rounded = torch.where(
        rounded >= 0x7C00,
        torch.where(bits >= 0x7C00, bits & mask,
                    torch.full_like(bits, max_finite)),
        rounded)
    return rounded.to(torch.int16).view(torch.float16).to(torch.float32)


def quantize_r11g11b10f(rgb):
    """Round-trip (..., 3) through B10G11R11_UFLOAT."""
    return torch.stack([_quantize_small_float(rgb[..., 0], 6),
                        _quantize_small_float(rgb[..., 1], 6),
                        _quantize_small_float(rgb[..., 2], 5)], dim=-1)


def quantize_r16f(x):
    """Round-trip through R16F (the G-buffer depth format)."""
    return x.to(torch.float16).to(torch.float32)


def pack_unorm8(x):
    """float [0,1] -> u8 with the +0.5 rounding the shaders use."""
    return torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def srgb_approx(rgb):
    """Linear -> sRGB, pow(1/2.2)."""
    return torch.pow(torch.clamp_min(rgb, 0.0), 1.0 / 2.2)


def unpack_unorm8(x):
    """u8 -> float [0, 1]."""
    return divide(x.to(torch.float32), 255.0)


def r11g11b10_unorm_pack(v):
    """XeGTAO's R11G11B10 unorm packing of (..., 3) in [0, 1]: the uint32
    word as int32 bits."""
    q = [(torch.clamp(v[..., i], 0.0, 1.0) * scale + 0.5).to(torch.int64)
         for i, scale in enumerate((2047.0, 2047.0, 1023.0))]
    return (q[0] | (q[1] << 11) | (q[2] << 22)).to(torch.int32)


def r11g11b10_unorm_unpack(p):
    """The inverse of r11g11b10_unorm_pack: (..., 3) f32."""
    p = p.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([divide((p & 0x7FF).to(torch.float32), 2047.0),
                        divide(((p >> 11) & 0x7FF).to(torch.float32),
                               2047.0),
                        divide(((p >> 22) & 0x3FF).to(torch.float32),
                               1023.0)], dim=-1)


def srgb_inverse_approx(srgb):
    """sRGB -> linear, pow(2.2)."""
    return torch.pow(torch.clamp_min(srgb, 0.0), 2.2)
