"""XeGTAO denoise chain (K4).

``denoise_chain`` replaces tpurt's ``denoise_chain_pallas``
(``tpurt/kernels/gtao_pallas.py``): N edge-aware 3x3 passes, u8 between
passes, the last pass scaled by 1.5 into u16 values (int32) without a
clamp. On CUDA tensors each pass is one launch of ``csrc/gtao_denoise.cu``
(the last one writes the int32 result itself); on CPU
tensors :func:`denoise_pass_plain` (the PyTorch port of tpurt's XLA
``denoise_pass``) runs instead.

The variants run tpurt's ``denoise_pass`` options, which tpurt computes on
its XLA chain, as template instantiations of the same kernel:

  * ``bent=True`` — the AO term is the packed (bent normal, visibility)
    RGBA8 as uint32 bits in int32 (``kernels/gtao_main.encode_bent``); each
    pass decodes the 4-vector, blurs it with the same weights, normalizes
    the bent normal and re-encodes it, the last pass scaling the visibility
    by 1.5 first (the encoding clips it to 1, so the frame's AO stays
    <= 255). Every pass returns the packed int32.
  * ``fp16=True`` — tpurt's lpfloat blur: every AO term, edge weight and
    weighted sum rounded to f16 after its operation.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..passes.encodings import divide, sqrt
from . import build
from .gtao_main import _Lp, encode_bent

XE_GTAO_OCCLUSION_TERM_SCALE = 1.5
DIAG_WEIGHT = 0.85 * 0.5
LEAK_THRESHOLD = 2.5
LEAK_STRENGTH = 0.5


def count_key(bent: bool, fp16: bool) -> str:
    """The launch-count entry of the denoise kernel's instantiation."""
    return "gtao_denoise" + ("_bent" if bent else "") + ("_fp16" if fp16
                                                         else "")


def denoise_chain(ao, edges_u8, *, n_passes: int, blur_beta: float,
                  bent: bool = False, fp16: bool = False):
    """(H, W) AO (u8, or the packed int32 with bent normals) + packed edges
    -> (H, W) int32 final AO term (u16 values, or the packed term)."""
    want = torch.int32 if bent else torch.uint8
    if ao.dtype != want or edges_u8.dtype != torch.uint8:
        raise TypeError(f"denoise_chain: ao must be {want} and edges uint8")
    if ao.shape != edges_u8.shape or ao.ndim != 2:
        raise ValueError("denoise_chain: ao and edges must be equal (H, W)")
    if n_passes < 1:
        raise ValueError("denoise_chain: at least one pass")
    if ao.is_cuda:
        build.require_cuda("denoise_chain", dict(ao=ao, edges=edges_u8),
                           ao.device)
    elif edges_u8.device.type != "cpu":
        raise ValueError("denoise_chain: mixed devices")
    for i in range(n_passes):
        final = i == n_passes - 1
        blur = blur_beta if final else blur_beta / 5.0
        if ao.is_cuda:
            ao = _denoise_pass_cuda(ao, edges_u8, blur, final, bent, fp16)
        else:
            ao = denoise_pass_plain(ao, edges_u8, blur, final, bent=bent,
                                    fp16=fp16)
    return ao


def _denoise_pass_cuda(ao, edges, blur: float, final: bool, bent: bool,
                       fp16: bool):
    h, w = ao.shape
    out = torch.empty((h, w), dtype=torch.int32 if bent or final
                      else torch.uint8, device=ao.device)
    fn = build.function("tpurt_gtao_denoise", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    p = build.ptr
    # the blur weight as tpurt's jnp.full makes it in the blur's type
    blur = float(np.float16(blur)) if fp16 else float(blur)
    build.check(fn(p(ao), p(edges), h, w, blur, int(final), int(bent),
                   int(fp16), p(out), build.stream_of(ao)),
                "tpurt_gtao_denoise")
    build.launch_counts[count_key(bent, fp16)] += 1
    return out


def _unpack_edges(p):
    p = p.to(torch.int32)
    return [divide(((p >> s) & 3).to(torch.float32), 3.0)
            for s in (6, 4, 2, 0)]


def _shift(img, dy: int, dx: int):
    """out[y, x] = img[clamp(y + dy), clamp(x + dx)]."""
    h, w = img.shape[:2]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def decode_bent(packed):
    """XeGTAO_DecodeVisibilityBentNormal of int32-held uint32 bits:
    (visibility, [bn_x, bn_y, bn_z]) f32."""
    def f(shift):
        return divide(((packed >> shift) & 0xFF).to(torch.float32), 255.0)

    return f(24), [f(s) * 2.0 - 1.0 for s in (0, 8, 16)]


def denoise_pass_plain(ao, edges_u8, blur: float, final_apply: bool, *,
                       bent: bool = False, fp16: bool = False):
    """One XeGTAO_Denoise pass, PyTorch port of tpurt's ``denoise_pass``.
    Returns u8, or int32 u16 values when final; with bent normals the
    packed int32 term."""
    lp = _Lp(fp16)
    r, k = lp.r, lp.k
    if bent:
        v, bn = decode_bent(ao)
        vis = [r(x) for x in (*bn, v)]
    else:
        vis = [r(divide(ao.to(torch.float32), 255.0))]
    ec = [r(e) for e in _unpack_edges(edges_u8)]
    el = [r(e) for e in _unpack_edges(_shift(edges_u8, 0, -1))]
    er = [r(e) for e in _unpack_edges(_shift(edges_u8, 0, 1))]
    et = [r(e) for e in _unpack_edges(_shift(edges_u8, -1, 0))]
    eb = [r(e) for e in _unpack_edges(_shift(edges_u8, 1, 0))]

    ec = [r(ec[0] * el[1]), r(ec[1] * er[0]), r(ec[2] * et[3]),
          r(ec[3] * eb[2])]
    esum = r(ec[0] + ec[1] + ec[2] + ec[3])
    edginess = r(divide(torch.clamp(r(k(4.0 - LEAK_THRESHOLD) - esum),
                                    0.0, 1.0),
                        k(4.0 - LEAK_THRESHOLD)) * k(LEAK_STRENGTH))
    ec = [torch.clamp(r(e + edginess), 0.0, 1.0) for e in ec]

    diag = k(DIAG_WEIGHT)
    w_tl = r(diag * r(r(ec[0] * el[2]) + r(ec[2] * et[0])))
    w_tr = r(diag * r(r(ec[2] * et[1]) + r(ec[1] * er[2])))
    w_bl = r(diag * r(r(ec[3] * eb[0]) + r(ec[0] * el[3])))
    w_br = r(diag * r(r(ec[1] * er[3]) + r(ec[3] * eb[1])))

    sum_weight = torch.full_like(vis[0], k(blur))
    total = [r(v * sum_weight) for v in vis]
    for (dy, dx), wt in (((0, -1), ec[0]), ((0, 1), ec[1]), ((-1, 0), ec[2]),
                         ((1, 0), ec[3]), ((-1, -1), w_tl), ((-1, 1), w_tr),
                         ((1, -1), w_bl), ((1, 1), w_br)):
        total = [r(t + r(_shift(v, dy, dx) * wt)) for t, v in zip(total, vis)]
        sum_weight = r(sum_weight + wt)
    out = [r(t / sum_weight) for t in total]
    if bent:
        # XeGTAO_Output, bent-normal branch
        v = r(out[3] * k(XE_GTAO_OCCLUSION_TERM_SCALE)) if final_apply \
            else out[3]
        bx, by, bz = out[:3]
        blen = torch.clamp_min(
            r(sqrt(r(r(bx * bx) + r(by * by) + r(bz * bz)))), lp.eps)
        return encode_bent(v, r(bx / blen), r(by / blen), r(bz / blen), lp)
    out = out[0]
    if final_apply:
        out = out * XE_GTAO_OCCLUSION_TERM_SCALE
        return (torch.clamp_min(out, 0.0) * 255.0 + 0.5).to(torch.int32)
    return (torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
