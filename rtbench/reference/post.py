"""The reference's post chain in plain torch: tests/oracle_post.py rewritten
for tensors (XeGTAO prefilter, main pass and denoise, XeGTAO.hlsli:
121-836 and XeGTAO.h:59-204; the FidelityFX LPM filter, ffx_lpm.h:727-937;
the composite and sRGB store, tonemap.comp.glsl:29-39), with the two blocks
of constants worked out again from the inputs: GTAOUpdateConstants
(XeGTAO.h:170-204, the renderer's radius 0.2 and XeGTAO.h's defaults) and
the LPM control block (ffx_lpm.h's LpmSetup with LPM_CONFIG_709_709, in
``lpm_control``).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

PI = 3.1415926535897932384626433832795
PI_HALF = 1.5707963267948966192313216916398
MIP_LEVELS = 5
TERM_SCALE = 1.5


# ------------------------------------------------------- storage formats --

def q_r16f(x):
    return x.to(torch.float16).to(x.dtype)


def _q_small_ufloat(x, mantissa_bits: int):
    """An unsigned small float (R11F/B10F) round trip through fp16 bits:
    the mantissa rounded to nearest, overflow to the largest finite."""
    h = torch.clamp_min(x.to(torch.float32), 0.0).to(torch.float16)
    bits = h.view(torch.int16).to(torch.int32) & 0xFFFF
    drop = 10 - mantissa_bits
    mask = ~((1 << drop) - 1) & 0xFFFF
    r = (bits + (1 << (drop - 1))) & mask
    r = torch.where(r >= 0x7C00, torch.where(bits >= 0x7C00, bits & mask,
                                             torch.full_like(r, 0x7BFF & mask)),
                    r)
    r = torch.where(r >= 0x8000, r - 0x10000, r).to(torch.int16)
    return r.view(torch.float16).to(x.dtype)


def q_r11g11b10f(rgb):
    return torch.stack([_q_small_ufloat(rgb[..., 0], 6),
                        _q_small_ufloat(rgb[..., 1], 6),
                        _q_small_ufloat(rgb[..., 2], 5)], -1)


def _fast_acos(x):
    """XeGTAO_FastACos with XeGTAO_FastSqrt's bit trick (on f32 bits)."""
    ax = torch.abs(x)
    s = torch.clamp_min(1.0 - ax, 0.0).to(torch.float32)
    sq = ((s.view(torch.int32).to(torch.int64) >> 1) + 0x1FBD1DF5)
    sq = (sq & 0xFFFFFFFF)
    sq = torch.where(sq >= 2 ** 31, sq - 2 ** 32, sq).to(torch.int32)
    sq = sq.view(torch.float32).to(x.dtype)
    res = (-0.156583 * ax + PI_HALF) * sq
    return torch.where(x >= 0, res, PI - res)


# ----------------------------------------------------------------- noise --

def _hilbert(x: int, y: int) -> int:
    index, level = 0, 32
    while level > 0:
        rx = 1 if (x & level) > 0 else 0
        ry = 1 if (y & level) > 0 else 0
        index += level * level * ((3 * rx) ^ ry)
        if ry == 0:
            if rx == 1:
                x, y = 63 - x, 63 - y
            x, y = y, x
        level //= 2
    return index


@lru_cache(maxsize=1)
def _hilbert_64() -> np.ndarray:
    return np.array([[_hilbert(x, y) for x in range(64)] for y in range(64)],
                    np.uint32)


def noise(height: int, width: int, noise_index: int):
    """SpatioTemporalNoise (main_pass.comp.hlsl:48-65) in f32, numpy."""
    hil = _hilbert_64()
    idx = np.tile(hil, (height // 64 + 1, width // 64 + 1))[:height, :width]
    idx = idx + np.uint32(288) * np.uint32(int(noise_index) % 64)
    f = idx.astype(np.float32)
    nx = np.mod(np.float32(0.5) + f * np.float32(0.75487766624669276005), 1.0)
    ny = np.mod(np.float32(0.5) + f * np.float32(0.5698402909980532659114),
                1.0)
    return nx.astype(np.float32), ny.astype(np.float32)


# ------------------------------------------------------------- constants --

def gtao_constants(width: int, height: int, fovy: float, aspect: float,
                   radius: float = 0.2) -> dict:
    """GTAOUpdateConstants (XeGTAO.h:170-204), the fields read here."""
    thy = math.tan(fovy * 0.5)
    thx = thy * aspect
    mul = (thx * 2.0, thy * -2.0)
    return dict(pixel=(1.0 / width, 1.0 / height), ndc_mul=mul,
                ndc_add=(-thx, thy),
                ndc_mul_x_pixel=(mul[0] / width, mul[1] / height),
                effect_radius=radius, radius_multiplier=1.457,
                falloff_range=0.615, sample_distribution_power=2.0,
                thin_occluder_compensation=0.0, mip_sampling_offset=3.30,
                final_value_power=2.2)


# ------------------------------------------------------------- prefilter --

def prefilter(depth, c):
    """Viewspace depth MIPs (XeGTAO.hlsli:580-694), each stored R16F."""
    d = torch.clamp(depth, 0.0, 65504.0)
    mips = [q_r16f(d)]
    er = 0.75 * c["effect_radius"] * c["radius_multiplier"]
    fr = c["falloff_range"] * er
    f_from = er * (1.0 - c["falloff_range"])
    f_mul, f_add = -1.0 / fr, f_from / fr + 1.0
    for _ in range(MIP_LEVELS - 1):
        p = mips[-1]
        h2, w2 = max(p.shape[0] // 2, 1), max(p.shape[1] // 2, 1)
        q = p[:h2 * 2, :w2 * 2].reshape(h2, 2, w2, 2)
        ds = (q[:, 0, :, 0], q[:, 0, :, 1], q[:, 1, :, 0], q[:, 1, :, 1])
        mx = torch.maximum(torch.maximum(ds[0], ds[1]),
                           torch.maximum(ds[2], ds[3]))
        ws = [torch.clamp((mx - di) * f_mul + f_add, 0.0, 1.0) for di in ds]
        num = ws[0] * ds[0] + ws[1] * ds[1] + ws[2] * ds[2] + ws[3] * ds[3]
        mips.append(q_r16f(num / (ws[0] + ws[1] + ws[2] + ws[3])))
    return mips


def _shift(img, dy: int, dx: int):
    h, w = img.shape[:2]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def _sample_mip(mips, sx, sy, mip):
    out = torch.zeros_like(sx)
    for m, img in enumerate(mips):
        h, w = img.shape
        x = torch.clamp((sx * w).to(torch.int64), 0, w - 1)
        y = torch.clamp((sy * h).to(torch.int64), 0, h - 1)
        out = torch.where(mip == m, img[y, x], out)
    return out


def _sat(x):
    return torch.clamp(x, 0.0, 1.0)


def _edges(c, left, right, top, bottom):
    e = torch.stack([left, right, top, bottom], -1) - c[..., None]
    slr = (e[..., 1] - e[..., 0]) * 0.5
    stb = (e[..., 3] - e[..., 2]) * 0.5
    adj = e + torch.stack([slr, -slr, stb, -stb], -1)
    e = torch.minimum(torch.abs(e), torch.abs(adj))
    return _sat(1.25 - e / (c[..., None] * 0.011))


def _pack_edges(lrtb):
    q = torch.round(_sat(lrtb) * 2.9)
    return (q[..., 0] * 64 + q[..., 1] * 16 + q[..., 2] * 4
            + q[..., 3]).to(torch.int64)


def _unpack_edges(p, dtype):
    return torch.stack([(p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3, p & 3],
                       -1).to(dtype) / 3.0


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


def main_pass(mips, normal_enc, c, slices: int, steps: int,
              noise_index: int):
    """XeGTAO_MainPass (XeGTAO.hlsli:246-577): the working AO term (u8
    values) and the packed edges."""
    d0 = mips[0]
    h, w = d0.shape
    dt, dev = d0.dtype, d0.device
    xs = (torch.arange(w, device=dev, dtype=dt) + 0.5) / w
    ys = (torch.arange(h, device=dev, dtype=dt) + 0.5) / h
    spy, spx = torch.meshgrid(ys, xs, indexing="ij")
    edges = _pack_edges(_edges(d0, _shift(d0, 0, -1), _shift(d0, 0, 1),
                               _shift(d0, -1, 0), _shift(d0, 1, 0)))
    n = normal_enc * 2.0 - 1.0
    n = n / torch.clamp_min(_norm(n), 1e-20)[..., None]
    vz = d0 * 0.99920
    mul, add = c["ndc_mul"], c["ndc_add"]

    def view_pos(sx, sy, z):
        return torch.stack([(mul[0] * sx + add[0]) * z,
                            (mul[1] * sy + add[1]) * z, z], -1)

    center = view_pos(spx, spy, vz)
    view_vec = -center / torch.clamp_min(_norm(center), 1e-20)[..., None]
    er = c["effect_radius"] * c["radius_multiplier"]
    fr = c["falloff_range"] * er
    f_from = er * (1.0 - c["falloff_range"])
    f_mul, f_add = -1.0 / fr, f_from / fr + 1.0
    ns_np, nsm_np = noise(h, w, noise_index)
    n_slice = torch.as_tensor(ns_np, device=dev).to(dt)
    n_sample = torch.as_tensor(nsm_np, device=dev).to(dt)
    ssr = er / (vz * c["ndc_mul_x_pixel"][0])
    vis = _sat((10.0 - ssr) / 100.0) * 0.5
    min_s = 1.3 / ssr
    for sl in range(slices):
        phi = (sl + n_slice) / slices * PI
        cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
        ox, oy = cos_phi * ssr, -sin_phi * ssr
        dvec = torch.stack([cos_phi, sin_phi, torch.zeros_like(cos_phi)], -1)
        ortho = dvec - (dvec * view_vec).sum(-1, keepdim=True) * view_vec
        axis = torch.linalg.cross(ortho, view_vec)
        axis = axis / torch.clamp_min(_norm(axis), 1e-20)[..., None]
        proj_n = n - axis * (n * axis).sum(-1, keepdim=True)
        sign_n = torch.sign((ortho * proj_n).sum(-1))
        proj_len = _norm(proj_n)
        cos_n = _sat((proj_n * view_vec).sum(-1)
                     / torch.clamp_min(proj_len, 1e-20))
        ang_n = sign_n * _fast_acos(cos_n)
        low0, low1 = torch.cos(ang_n + PI_HALF), torch.cos(ang_n - PI_HALF)
        hc = [low0, low1]
        for st in range(steps):
            base = (sl + st * steps) * 0.6180339887498948482
            step_noise = torch.remainder(n_sample + base, 1.0)
            s = (st + step_noise) / steps
            s = s ** c["sample_distribution_power"] + min_s
            sox, soy = s * ox, s * oy
            so_len = torch.sqrt(sox * sox + soy * soy)
            lvl = torch.clamp(torch.log2(torch.clamp_min(so_len, 1e-20))
                              - c["mip_sampling_offset"], 0, MIP_LEVELS)
            mip = torch.clamp(torch.round(lvl), 0, MIP_LEVELS - 1)
            offx = torch.round(sox) * c["pixel"][0]
            offy = torch.round(soy) * c["pixel"][1]
            for side, sgn, low in ((0, 1.0, low0), (1, -1.0, low1)):
                sx, sy = spx + sgn * offx, spy + sgn * offy
                sz = _sample_mip(mips, torch.clamp(sx, 0.0, 1.0),
                                 torch.clamp(sy, 0.0, 1.0), mip)
                delta = view_pos(sx, sy, sz) - center
                dist = _norm(delta)
                hvec = delta / torch.clamp_min(dist, 1e-20)[..., None]
                fb = torch.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2
                                + (delta[..., 2] * (
                                    1.0 + c["thin_occluder_compensation"]))
                                ** 2)
                weight = _sat(fb * f_mul + f_add)
                shc = (hvec * view_vec).sum(-1)
                shc = low + (shc - low) * weight
                hc[side] = torch.maximum(hc[side], shc)
        proj_len = proj_len + (1.0 - proj_len) * 0.05
        h0 = -_fast_acos(torch.clamp(hc[1], -1.0, 1.0))
        h1 = _fast_acos(torch.clamp(hc[0], -1.0, 1.0))
        sin_n = torch.sin(ang_n)
        arc0 = (cos_n + 2.0 * h0 * sin_n - torch.cos(2.0 * h0 - ang_n)) / 4.0
        arc1 = (cos_n + 2.0 * h1 * sin_n - torch.cos(2.0 * h1 - ang_n)) / 4.0
        vis = vis + proj_len * (arc0 + arc1)
    vis = vis / slices
    vis = torch.clamp_min(torch.clamp_min(vis, 0.0)
                          ** c["final_value_power"], 0.03)
    ao = torch.floor(torch.clamp(vis / TERM_SCALE, 0.0, 1.0) * 255.0 + 0.5)
    return ao, edges


def denoise(ao, edges, blur_beta: float, final: bool):
    """XeGTAO_Denoise (XeGTAO.hlsli:744-836): the next integer AO term,
    unclamped after the final pass."""
    dt = ao.dtype
    blur = blur_beta if final else blur_beta / 5.0
    diag = 0.85 * 0.5
    vis = ao / 255.0
    ec = _unpack_edges(edges, dt)
    el = _unpack_edges(_shift(edges, 0, -1), dt)
    er = _unpack_edges(_shift(edges, 0, 1), dt)
    et = _unpack_edges(_shift(edges, -1, 0), dt)
    eb = _unpack_edges(_shift(edges, 1, 0), dt)
    ec = ec * torch.stack([el[..., 1], er[..., 0], et[..., 3], eb[..., 2]],
                          -1)
    edginess = _sat(4.0 - 2.5 - ec.sum(-1)) / (4.0 - 2.5) * 0.5
    ec = _sat(ec + edginess[..., None])
    w_tl = diag * (ec[..., 0] * el[..., 2] + ec[..., 2] * et[..., 0])
    w_tr = diag * (ec[..., 2] * et[..., 1] + ec[..., 1] * er[..., 2])
    w_bl = diag * (ec[..., 3] * eb[..., 0] + ec[..., 0] * el[..., 3])
    w_br = diag * (ec[..., 1] * er[..., 3] + ec[..., 3] * eb[..., 1])
    sum_w = torch.full_like(vis, blur)
    total = vis * sum_w
    for (dy, dx), wgt in (((0, -1), ec[..., 0]), ((0, 1), ec[..., 1]),
                          ((-1, 0), ec[..., 2]), ((1, 0), ec[..., 3]),
                          ((-1, -1), w_tl), ((-1, 1), w_tr),
                          ((1, -1), w_bl), ((1, 1), w_br)):
        total = total + _shift(vis, dy, dx) * wgt
        sum_w = sum_w + wgt
    out = total / sum_w
    if final:
        return torch.floor(torch.clamp_min(out * TERM_SCALE, 0.0) * 255.0
                           + 0.5)
    return torch.floor(_sat(out) * 255.0 + 0.5)


def gtao(depth, normal_enc, c, slices: int, steps: int, denoise_passes: int,
         noise_index: int):
    """The whole chain: the final AO term's integers (as floats)."""
    mips = prefilter(depth, c)
    ao, edges = main_pass(mips, normal_enc, c, slices, steps, noise_index)
    beta = 1e4 if denoise_passes == 0 else 1.2
    n = max(denoise_passes - 1, 0) + 1
    for i in range(n):
        ao = denoise(ao, edges, beta, final=(i == n - 1))
    return ao


# ------------------------------------------------------------------- LPM --

def _xyz(r, g, b, w):
    def z(s):
        return np.array([s[0], s[1], 1.0 - s[0] + s[1]], np.float32)

    rgb3 = np.stack([z(r), z(g), z(b)], axis=1)
    w3 = z(w) / np.float32(w[1])
    return rgb3 * (np.linalg.inv(rgb3) @ w3)[None, :]


REC709 = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06), (0.3127, 0.3290))


def lpm_control(hdr_max=256.0, exposure=8.0, contrast=0.25,
                shoulder_contrast=1.0, saturation=(0.0, 0.0, 0.0),
                crosstalk=(1.0, 0.5, 1.0 / 32.0)) -> dict:
    """LpmSetup (ffx_lpm.h) for LPM_CONFIG_709_709 at the renderer's
    settings: the filter's float words, each rounded to f32 as the control
    block stores them."""
    con = contrast + 1.0
    sat = np.array(saturation, np.float32) + np.float32(con)
    mid_in = hdr_max * 0.18 * 2.0 ** -exposure
    mid_out = 0.18
    cs = con * shoulder_contrast
    z0 = -(mid_in ** con)
    z1 = hdr_max ** cs * mid_in ** con
    z2 = hdr_max ** con * mid_in ** cs * mid_out
    z3 = hdr_max ** cs * mid_out
    z4 = mid_in ** cs * mid_out
    bias_x = -((z0 + (mid_out * (z1 - z2)) / (z3 - z4)) / z4)
    bias_y = (z1 - z2) / (z3 - z4)
    luma = _xyz(*REC709)[1]
    luma = luma / luma.sum()
    f32 = np.float32
    return dict(saturation=sat.astype(np.float32), contrast=f32(con),
                bias=np.array([bias_x, bias_y], np.float32),
                luma=luma.astype(np.float32),
                rcp_luma=(1.0 / luma).astype(np.float32),
                crosstalk=np.array(crosstalk, np.float32))


def lpm_filter(color, ctl: dict):
    """LpmFilter -> LpmMap (ffx_lpm.h:727-828, 895-937), 709 in and out."""
    def t(x):
        return torch.as_tensor(x, device=color.device).to(color.dtype)

    sat, luma_t, cross = t(ctl["saturation"]), t(ctl["luma"]), \
        t(ctl["crosstalk"])
    rcp = t(ctl["rcp_luma"])
    bias = ctl["bias"]
    c = torch.clamp_min(color, 0.0)
    mx = c.amax(-1, keepdim=True)
    ratio = (c / torch.clamp_min(mx, 1e-30)) ** sat
    luma = (c * luma_t).sum(-1) ** float(ctl["contrast"])
    luma = luma / torch.clamp_min(luma * float(bias[0]) + float(bias[1]),
                                  1e-30)
    lr = (ratio * luma_t).sum(-1)
    out = _sat(ratio * _sat(luma / torch.clamp_min(lr, 1e-30))[..., None])
    cap = -cross * out + cross
    add = _sat(luma - (out * luma_t).sum(-1))
    tt = add / torch.clamp_min((cap * luma_t).sum(-1), 1e-30)
    out = _sat(tt[..., None] * cap + out)
    add = _sat(luma - (out * luma_t).sum(-1))
    return _sat(add[..., None] * rcp + out)


def compose(color, ao, ctl: dict):
    """AO composite, LPM, sRGB approximation, u8 store."""
    out = lpm_filter(color * (ao / 255.0)[..., None], ctl)
    out = torch.clamp_min(out, 0.0) ** (1.0 / 2.2)
    return torch.clamp(out * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
