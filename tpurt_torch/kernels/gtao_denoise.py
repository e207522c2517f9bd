"""XeGTAO denoise chain (K4).

``denoise_chain`` replaces tpurt's ``denoise_chain_pallas``
(``tpurt/kernels/gtao_pallas.py``): N edge-aware 3x3 passes, u8 between
passes, the last pass scaled by 1.5 into u16 values (int32) without a
clamp. On CUDA tensors each pass is one launch of ``csrc/gtao_denoise.cu``
(the last one writes the int32 result itself); on CPU
tensors :func:`denoise_pass_plain` (the PyTorch port of tpurt's XLA
``denoise_pass``) runs instead.
"""
from __future__ import annotations

import ctypes

import torch

from ..passes.encodings import divide
from . import build

XE_GTAO_OCCLUSION_TERM_SCALE = 1.5
DIAG_WEIGHT = 0.85 * 0.5
LEAK_THRESHOLD = 2.5
LEAK_STRENGTH = 0.5


def denoise_chain(ao_u8, edges_u8, *, n_passes: int, blur_beta: float):
    """(H, W) u8 AO + packed edges -> (H, W) int32 final AO term (u16
    values)."""
    if ao_u8.dtype != torch.uint8 or edges_u8.dtype != torch.uint8:
        raise TypeError("denoise_chain: ao and edges must be uint8")
    if ao_u8.shape != edges_u8.shape or ao_u8.ndim != 2:
        raise ValueError("denoise_chain: ao and edges must be equal (H, W)")
    if n_passes < 1:
        raise ValueError("denoise_chain: at least one pass")
    if ao_u8.is_cuda:
        build.require_cuda("denoise_chain", dict(ao=ao_u8, edges=edges_u8),
                           ao_u8.device)
    elif edges_u8.device.type != "cpu":
        raise ValueError("denoise_chain: mixed devices")
    ao = ao_u8
    for i in range(n_passes):
        final = i == n_passes - 1
        blur = blur_beta if final else blur_beta / 5.0
        if ao.is_cuda:
            ao = _denoise_pass_cuda(ao, edges_u8, blur, final)
        else:
            ao = denoise_pass_plain(ao, edges_u8, blur, final)
    return ao


def _denoise_pass_cuda(ao, edges, blur: float, final: bool):
    h, w = ao.shape
    out = torch.empty((h, w), dtype=torch.int32 if final else torch.uint8,
                      device=ao.device)
    fn = build.function("tpurt_gtao_denoise", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    p = build.ptr
    build.check(fn(p(ao), p(edges), h, w, float(blur), int(final), p(out),
                   build.stream_of(ao)), "tpurt_gtao_denoise")
    build.launch_counts["gtao_denoise"] += 1
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


def denoise_pass_plain(ao_u8, edges_u8, blur: float, final_apply: bool):
    """One XeGTAO_Denoise pass, PyTorch port of tpurt's ``denoise_pass``
    (non-bent-normal, f32). Returns u8, or int32 u16 values when final."""
    vis = divide(ao_u8.to(torch.float32), 255.0)
    ec = _unpack_edges(edges_u8)
    el = _unpack_edges(_shift(edges_u8, 0, -1))
    er = _unpack_edges(_shift(edges_u8, 0, 1))
    et = _unpack_edges(_shift(edges_u8, -1, 0))
    eb = _unpack_edges(_shift(edges_u8, 1, 0))

    ec = [ec[0] * el[1], ec[1] * er[0], ec[2] * et[3], ec[3] * eb[2]]
    esum = ec[0] + ec[1] + ec[2] + ec[3]
    edginess = divide(torch.clamp((4.0 - LEAK_THRESHOLD) - esum, 0.0, 1.0),
                      4.0 - LEAK_THRESHOLD) * LEAK_STRENGTH
    ec = [torch.clamp(e + edginess, 0.0, 1.0) for e in ec]

    w_tl = DIAG_WEIGHT * (ec[0] * el[2] + ec[2] * et[0])
    w_tr = DIAG_WEIGHT * (ec[2] * et[1] + ec[1] * er[2])
    w_bl = DIAG_WEIGHT * (ec[3] * eb[0] + ec[0] * el[3])
    w_br = DIAG_WEIGHT * (ec[1] * er[3] + ec[3] * eb[1])

    sum_weight = torch.full_like(vis, blur)
    total = vis * sum_weight
    for (dy, dx), wt in (((0, -1), ec[0]), ((0, 1), ec[1]), ((-1, 0), ec[2]),
                         ((1, 0), ec[3]), ((-1, -1), w_tl), ((-1, 1), w_tr),
                         ((1, -1), w_bl), ((1, 1), w_br)):
        total = total + _shift(vis, dy, dx) * wt
        sum_weight = sum_weight + wt
    out = total / sum_weight
    if final_apply:
        out = out * XE_GTAO_OCCLUSION_TERM_SCALE
        return (torch.clamp_min(out, 0.0) * 255.0 + 0.5).to(torch.int32)
    return (torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
