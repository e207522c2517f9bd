"""Independent post-process oracle: numpy XeGTAO (prefilter / main /
denoise) and FidelityFX-LPM filter implemented DIRECTLY from the reference
shader sources — no tpurt rendering code anywhere.

Sources re-derived (file:line under the reference's src/vk_renderer/shaders):
  * depth prefilter        xegtao/XeGTAO.hlsli:580-694
  * GTAO main pass         xegtao/XeGTAO.hlsli:246-577
  * edge-aware denoise     xegtao/XeGTAO.hlsli:696-836
  * noise + normal decode  xegtao/main_pass.comp.hlsl:29-65, XeGTAO.h:117-142
  * constants setup        xegtao/XeGTAO.h:59-204 (GTAOUpdateConstants)
  * LPM filter             tonemap/ffx_lpm.h:727-828 (LpmMap) + :895-937
                           (LpmFilter ctl-block word layout)
  * composite + sRGB       tonemap/tonemap.comp.glsl:29-39,
                           color_spaces.glsl (rgb_to_srgb_approx)
  * storage formats        B10G11R11_UFLOAT / R16F / R32_UINT / B8G8R8A8
                           (vk_rt_lightning_shadows.rs:125-159,
                            vk_xe_gtao.rs image formats)

Together with tests/oracle.py (configs 1-3: shading/lights/shadows) this
closes the verification loop for BASELINE config 4: the COMPLETE frame
(shade -> GTAO -> LPM -> sRGB u8) is gated against an implementation that
shares zero code with tpurt/. It consumes only *data*: the G-buffer, the
GTAOConstants values, and the packed 24xuvec4 LPM control block (read
bit-level exactly as the GLSL's LpmFilterCtl does).

Precision note: the reference runs much of XeGTAO in min16float (lpfloat);
this oracle and the tpurt pipeline both run f32 with the reference's
storage-format quantization at every image boundary, so the comparison
checks structural parity, and the <=1% RMSE gate absorbs fp16-vs-f32 noise.
"""
from __future__ import annotations

import math

import numpy as np

PI = 3.1415926535897932384626433832795
PI_HALF = 1.5707963267948966192313216916398
XE_GTAO_DEPTH_MIP_LEVELS = 5
XE_GTAO_OCCLUSION_TERM_SCALE = 1.5   # XeGTAO.h:114


# ------------------------------------------------------- storage formats --

def q_r16f(x):
    """R16F storage round-trip."""
    return np.asarray(x, np.float32).astype(np.float16).astype(np.float32)


def _q_small_ufloat(x, mantissa_bits):
    """Unsigned small-float (R11F/B10F) round-trip: 5-bit exponent shared
    with fp16, mantissa truncated with round-to-nearest."""
    x = np.maximum(np.asarray(x, np.float32), 0.0)
    bits = x.astype(np.float16).view(np.uint16).astype(np.uint32)
    drop = 10 - mantissa_bits
    half = 1 << (drop - 1)
    mask = np.uint32(~((1 << drop) - 1) & 0xFFFF)
    rounded = (bits + half) & mask
    max_finite = np.uint32(0x7BFF) & mask
    rounded = np.where(rounded >= 0x7C00,
                       np.where(bits >= 0x7C00, bits & mask, max_finite),
                       rounded)
    return rounded.astype(np.uint16).view(np.float16).astype(np.float32)


def q_r11g11b10f(rgb):
    """B10G11R11_UFLOAT storage round-trip over (..., 3)."""
    return np.stack([_q_small_ufloat(rgb[..., 0], 6),
                     _q_small_ufloat(rgb[..., 1], 6),
                     _q_small_ufloat(rgb[..., 2], 5)], axis=-1)


# ------------------------------------------------------------ bit tricks --

def _fast_sqrt(x):
    """XeGTAO_FastSqrt (XeGTAO.hlsli:172-175)."""
    xi = np.asarray(x, np.float32).view(np.uint32).astype(np.int64)
    out = (0x1FBD1DF5 + (xi >> 1)) & 0xFFFFFFFF
    return out.astype(np.uint32).view(np.float32)


def _fast_acos(x):
    """XeGTAO_FastACos (XeGTAO.hlsli:177-185): [-1,1] -> [0, PI]."""
    x = np.asarray(x, np.float32)
    ax = np.abs(x)
    res = np.float32(-0.156583) * ax + np.float32(PI_HALF)
    res = res * _fast_sqrt(np.maximum(1.0 - ax, 0.0).astype(np.float32))
    return np.where(x >= 0, res, np.float32(PI) - res)


# ----------------------------------------------------------------- noise --

def _hilbert_index(x, y):
    """HilbertIndex, XE_HILBERT_LEVEL=6 (XeGTAO.h:117-142)."""
    px, py = int(x), int(y)
    index = 0
    level = 32  # XE_HILBERT_WIDTH / 2
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
    return index


def _noise(height, width, noise_index):
    """SpatioTemporalNoise (main_pass.comp.hlsl:48-65): Hilbert-curve index
    driving the R2 sequence, computed in f32 like the shader."""
    hil = np.array([[_hilbert_index(x % 64, y % 64) for x in range(64)]
                    for y in range(64)], np.uint32)
    idx = np.empty((height, width), np.uint32)
    for y in range(height):
        idx[y] = hil[y % 64, np.arange(width) % 64]
    idx = idx + np.uint32(288) * np.uint32(int(noise_index) % 64)
    f = idx.astype(np.float32)
    nx = np.mod(np.float32(0.5) + f * np.float32(0.75487766624669276005), 1.0)
    ny = np.mod(np.float32(0.5) + f * np.float32(0.5698402909980532659114), 1.0)
    return nx.astype(np.float32), ny.astype(np.float32)


# ------------------------------------------------------------- prefilter --

def _depth_mip_filter(d0, d1, d2, d3, c):
    """XeGTAO_DepthMIPFilter (XeGTAO.hlsli:580-604)."""
    max_depth = np.maximum(np.maximum(d0, d1), np.maximum(d2, d3))
    effect_radius = 0.75 * c["effect_radius"] * c["radius_multiplier"]
    falloff_range = c["effect_falloff_range"] * effect_radius
    falloff_from = effect_radius * (1.0 - c["effect_falloff_range"])
    falloff_mul = -1.0 / falloff_range
    falloff_add = falloff_from / falloff_range + 1.0

    def w(d):
        return np.clip((max_depth - d) * falloff_mul + falloff_add, 0.0, 1.0)

    w0, w1, w2, w3 = w(d0), w(d1), w(d2), w(d3)
    return (w0 * d0 + w1 * d1 + w2 * d2 + w3 * d3) / (w0 + w1 + w2 + w3)


def xegtao_prefilter(view_depth, c):
    """XeGTAO_PrefilterDepths16x16 (XeGTAO.hlsli:617-694) in viewspace-depth
    mode (prefilter_depths.comp.hlsl:3): 5 mips, each a weighted 2x2
    reduction of the previous, stored R16F (lpfloat textures)."""
    d = np.clip(np.asarray(view_depth, np.float32), 0.0, 65504.0)
    mips = [q_r16f(d)]
    for _ in range(XE_GTAO_DEPTH_MIP_LEVELS - 1):
        p = mips[-1]
        h2, w2 = max(p.shape[0] // 2, 1), max(p.shape[1] // 2, 1)
        q = p[:h2 * 2, :w2 * 2].reshape(h2, 2, w2, 2)
        mips.append(q_r16f(_depth_mip_filter(
            q[:, 0, :, 0], q[:, 0, :, 1], q[:, 1, :, 0], q[:, 1, :, 1], c)))
    return mips


# --------------------------------------------------------------- helpers --

def _shift(img, dy, dx):
    """out[y,x] = img[y+dy, x+dx] with clamp addressing."""
    h, w = img.shape[:2]
    ys = np.clip(np.arange(h) + dy, 0, h - 1)
    xs = np.clip(np.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


def _sample_mip(mips, uv_x, uv_y, mip_idx):
    """SampleLevel with a MIN_MAG_MIP_POINT + CLAMP sampler at integer mip:
    nearest texel of the nearest mip."""
    out = np.zeros(uv_x.shape, np.float32)
    for m in range(len(mips)):
        sel = mip_idx == m
        if not sel.any():
            continue
        h, w = mips[m].shape
        x = np.clip((uv_x[sel] * w).astype(np.int64), 0, w - 1)
        y = np.clip((uv_y[sel] * h).astype(np.int64), 0, h - 1)
        out[sel] = mips[m][y, x]
    return out


def _saturate(x):
    return np.clip(x, 0.0, 1.0)


def _calculate_edges(center, left, right, top, bottom):
    """XeGTAO_CalculateEdges (XeGTAO.hlsli:121-130) -> (..., 4) LRTB."""
    e = np.stack([left, right, top, bottom], -1) - center[..., None]
    slope_lr = (e[..., 1] - e[..., 0]) * 0.5
    slope_tb = (e[..., 3] - e[..., 2]) * 0.5
    adj = e + np.stack([slope_lr, -slope_lr, slope_tb, -slope_tb], -1)
    e = np.minimum(np.abs(e), np.abs(adj))
    return _saturate(1.25 - e / (center[..., None] * 0.011))


def _pack_edges(lrtb):
    """XeGTAO_PackEdges (:133-142) -> u8."""
    q = np.round(_saturate(lrtb) * 2.9)
    return (q[..., 0] * 64 + q[..., 1] * 16 + q[..., 2] * 4
            + q[..., 3]).astype(np.uint8)


def _unpack_edges(p):
    """XeGTAO_UnpackEdges (:696-706)."""
    p = p.astype(np.int32)
    return np.stack([(p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3, p & 3],
                    -1).astype(np.float32) / 3.0


# --------------------------------------------------------------- main pass --

def xegtao_main(mips, normal_enc, c, slice_count, steps_per_slice,
                noise_index):
    """XeGTAO_MainPass (XeGTAO.hlsli:246-577), XE_GTAO_USE_DEFAULT_CONSTANTS=0
    path, no bent normals. Returns (ao_working u8, edges u8)."""
    d0 = mips[0]
    h, w = d0.shape
    pix = np.asarray(c["viewport_pixel_size"], np.float32)
    ndc_mul = np.asarray(c["ndc_to_view_mul"], np.float32)
    ndc_add = np.asarray(c["ndc_to_view_add"], np.float32)

    xs = (np.arange(w, dtype=np.float32) + 0.5) / w
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h
    spx, spy = np.meshgrid(xs, ys)

    # GatherRed quads at the texel corner (main pass :251-261)
    vz = d0
    edges = _calculate_edges(vz, _shift(d0, 0, -1), _shift(d0, 0, 1),
                             _shift(d0, -1, 0), _shift(d0, 1, 0))
    edges_u8 = _pack_edges(edges)

    n = np.asarray(normal_enc, np.float32) * 2.0 - 1.0
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)

    vz = vz * np.float32(0.99920)  # fp16-depth offset (:284)

    def view_pos(sx, sy, z):
        return np.stack([(ndc_mul[0] * sx + ndc_add[0]) * z,
                         (ndc_mul[1] * sy + ndc_add[1]) * z, z], -1)

    center = view_pos(spx, spy, vz)
    view_vec = -center / np.maximum(
        np.linalg.norm(center, axis=-1, keepdims=True), 1e-20)

    effect_radius = np.float32(c["effect_radius"] * c["radius_multiplier"])
    falloff_range = np.float32(c["effect_falloff_range"]) * effect_radius
    falloff_from = effect_radius * (1.0 - np.float32(c["effect_falloff_range"]))
    falloff_mul = np.float32(-1.0) / falloff_range
    falloff_add = falloff_from / falloff_range + np.float32(1.0)

    noise_slice, noise_sample = _noise(h, w, noise_index)

    visibility = np.zeros((h, w), np.float32)

    # :336-344
    pixel_too_close = np.float32(1.3)
    ndc_mul_x_pix = np.asarray(c["ndc_to_view_mul_x_pixel_size"], np.float32)
    ssr = effect_radius / (vz * ndc_mul_x_pix[0])
    visibility += _saturate((10.0 - ssr) / 100.0) * 0.5
    min_s = pixel_too_close / ssr

    for sl in range(int(slice_count)):
        slice_k = (np.float32(sl) + noise_slice) / np.float32(slice_count)
        phi = slice_k * np.float32(PI)
        cos_phi = np.cos(phi)
        sin_phi = np.sin(phi)
        omega_x = cos_phi * ssr
        omega_y = -sin_phi * ssr

        dvec = np.stack([cos_phi, sin_phi, np.zeros_like(cos_phi)], -1)
        ortho = dvec - np.sum(dvec * view_vec, -1, keepdims=True) * view_vec
        axis = np.cross(ortho, view_vec)
        axis = axis / np.maximum(
            np.linalg.norm(axis, axis=-1, keepdims=True), 1e-20)
        proj_n = n - axis * np.sum(n * axis, -1, keepdims=True)
        sign_norm = np.sign(np.sum(ortho * proj_n, -1))
        proj_len = np.linalg.norm(proj_n, axis=-1)
        cos_norm = _saturate(np.sum(proj_n * view_vec, -1)
                             / np.maximum(proj_len, 1e-20))
        ang_n = sign_norm * _fast_acos(cos_norm)

        low0 = np.cos(ang_n + np.float32(PI_HALF))
        low1 = np.cos(ang_n - np.float32(PI_HALF))
        hc0, hc1 = low0.copy(), low1.copy()

        for st in range(int(steps_per_slice)):
            base = np.float32((sl + st * steps_per_slice)
                              * 0.6180339887498948482)
            step_noise = np.mod(noise_sample + base, 1.0)
            s = (np.float32(st) + step_noise) / np.float32(steps_per_slice)
            s = np.power(s, np.float32(c["sample_distribution_power"])) + min_s

            sox = s * omega_x
            soy = s * omega_y
            so_len = np.sqrt(sox * sox + soy * soy)
            mip_level = np.clip(
                np.log2(np.maximum(so_len, 1e-20))
                - np.float32(c["depth_mip_sampling_offset"]),
                0, XE_GTAO_DEPTH_MIP_LEVELS)
            mip = np.clip(np.round(mip_level), 0,
                          XE_GTAO_DEPTH_MIP_LEVELS - 1).astype(np.int32)
            # snap to pixel centers (:443)
            ox = np.round(sox) * pix[0]
            oy = np.round(soy) * pix[1]

            for sgn, low, cur in ((1.0, low0, 0), (-1.0, low1, 1)):
                sx = spx + np.float32(sgn) * ox
                sy = spy + np.float32(sgn) * oy
                sz = _sample_mip(mips, np.clip(sx, 0.0, 1.0),
                                 np.clip(sy, 0.0, 1.0), mip)
                delta = view_pos(sx, sy, sz) - center
                dist = np.linalg.norm(delta, axis=-1)
                hvec = delta / np.maximum(dist, 1e-20)[..., None]
                # thin-occluder falloff base (:481-485)
                fb = np.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2
                             + (delta[..., 2]
                                * (1.0 + np.float32(
                                    c["thin_occluder_compensation"]))) ** 2)
                weight = _saturate(fb * falloff_mul + falloff_add)
                shc = np.sum(hvec * view_vec, -1)
                shc = low + (shc - low) * weight   # lerp (:493)
                if cur == 0:
                    hc0 = np.maximum(hc0, shc)     # :506
                else:
                    hc1 = np.maximum(hc1, shc)

        proj_len = proj_len + (1.0 - proj_len) * 0.05  # fudge (:533)
        h0 = -_fast_acos(np.clip(hc1, -1.0, 1.0))
        h1 = _fast_acos(np.clip(hc0, -1.0, 1.0))
        sin_n = np.sin(ang_n)
        iarc0 = (cos_norm + 2.0 * h0 * sin_n - np.cos(2.0 * h0 - ang_n)) / 4.0
        iarc1 = (cos_norm + 2.0 * h1 * sin_n - np.cos(2.0 * h1 - ang_n)) / 4.0
        visibility += proj_len * (iarc0 + iarc1)

    visibility /= np.float32(slice_count)
    visibility = np.power(np.maximum(visibility, 0.0),
                          np.float32(c["final_value_power"]))
    visibility = np.maximum(0.03, visibility)

    # XeGTAO_OutputWorkingTerm (:199-207)
    ao_u8 = (np.clip(visibility / XE_GTAO_OCCLUSION_TERM_SCALE, 0.0, 1.0)
             * 255.0 + 0.5).astype(np.uint8)
    return ao_u8, edges_u8


# ----------------------------------------------------------------- denoise --

def xegtao_denoise(ao, edges_u8, blur_beta, final_apply):
    """XeGTAO_Denoise (XeGTAO.hlsli:744-836), non-bent-normals. ao: integer
    working term (u8 scale). Returns the next integer term — u8 for
    intermediate passes, UNCLAMPED u32 (:729-731) for the final one."""
    blur = np.float32(blur_beta if final_apply else blur_beta / 5.0)
    diag_weight = np.float32(0.85 * 0.5)

    vis = ao.astype(np.float32) / 255.0
    ec = _unpack_edges(edges_u8)
    el = _unpack_edges(_shift(edges_u8, 0, -1))
    er = _unpack_edges(_shift(edges_u8, 0, 1))
    et = _unpack_edges(_shift(edges_u8, -1, 0))
    eb = _unpack_edges(_shift(edges_u8, 1, 0))

    # symmetry (:780)
    ec = ec * np.stack([el[..., 1], er[..., 0], et[..., 3], eb[..., 2]], -1)
    # AO leak (:782-786)
    leak_threshold, leak_strength = np.float32(2.5), np.float32(0.5)
    edginess = (_saturate(4.0 - leak_threshold - np.sum(ec, -1))
                / (4.0 - leak_threshold)) * leak_strength
    ec = _saturate(ec + edginess[..., None])

    w_tl = diag_weight * (ec[..., 0] * el[..., 2] + ec[..., 2] * et[..., 0])
    w_tr = diag_weight * (ec[..., 2] * et[..., 1] + ec[..., 1] * er[..., 2])
    w_bl = diag_weight * (ec[..., 3] * eb[..., 0] + ec[..., 0] * el[..., 3])
    w_br = diag_weight * (ec[..., 1] * er[..., 3] + ec[..., 3] * eb[..., 1])

    sum_w = np.full(vis.shape, blur, np.float32)
    total = vis * sum_w
    for (dy, dx), wgt in (((0, -1), ec[..., 0]), ((0, 1), ec[..., 1]),
                          ((-1, 0), ec[..., 2]), ((1, 0), ec[..., 3]),
                          ((-1, -1), w_tl), ((-1, 1), w_tr),
                          ((1, -1), w_bl), ((1, 1), w_br)):
        total = total + _shift(vis, dy, dx) * wgt
        sum_w = sum_w + wgt
    out = total / sum_w
    # XeGTAO_Output (:729-731): final x1.5, `uint(v*255+0.5)`, NO saturate
    if final_apply:
        out = out * np.float32(XE_GTAO_OCCLUSION_TERM_SCALE)
        return (np.maximum(out, 0.0) * 255.0 + 0.5).astype(np.uint32)
    return (_saturate(out) * 255.0 + 0.5).astype(np.uint8)


def xegtao_full(view_depth, normal_enc, c, slice_count, steps_per_slice,
                denoise_passes, noise_index):
    """Full chain: prefilter -> main -> (denoise-1)+1 denoise dispatches
    (the host schedule, vk_xe_gtao.rs; DenoiseBlurBeta = 1e4 when denoise
    is disabled, XeGTAO.h:195). Returns the final unclamped AO integers."""
    mips = xegtao_prefilter(view_depth, c)
    ao, edges = xegtao_main(mips, normal_enc, c, slice_count,
                            steps_per_slice, noise_index)
    blur_beta = 1e4 if denoise_passes == 0 else 1.2
    n = max(denoise_passes - 1, 0) + 1
    for i in range(n):
        ao = xegtao_denoise(ao, edges, blur_beta, final_apply=(i == n - 1))
    return ao


# --------------------------------------------------------------------- LPM --

def _ctl_f32(ctl, i, j):
    """LpmFilterCtl word -> float (the shader's AF4_AU4 bitcast)."""
    return np.asarray(ctl, np.uint32)[i, j].copy().view(np.float32)


def lpm_filter_709_709(color, ctl):
    """LpmFilter (ffx_lpm.h:895-937) -> LpmMap (:727-828) with
    LPM_CONFIG_709_709 (shoulder/con/soft/con2/clip/scaleOnly all false,
    tonemap.comp.glsl:36). Consumes the packed 24xuvec4 control block at
    the bit level, exactly like the GLSL's LpmFilterCtl."""
    f = lambda i, j: _ctl_f32(ctl, i, j)  # noqa: E731
    saturation = np.array([f(0, 0), f(0, 1), f(0, 2)], np.float32)
    contrast = f(0, 3)
    tone_scale_bias = np.array([f(1, 0), f(1, 1)], np.float32)
    luma_t = np.array([f(1, 2), f(1, 3), f(2, 0)], np.float32)
    crosstalk = np.array([f(2, 1), f(2, 2), f(2, 3)], np.float32)
    rcp_luma_t = np.array([f(3, 0), f(3, 1), f(3, 2)], np.float32)

    c = np.maximum(np.asarray(color, np.float32), 0.0)
    max3 = np.max(c, axis=-1, keepdims=True)
    # ARcpF1(0) = inf; inf*0 = NaN which GPU saturate flushes to 0 — the
    # black-pixel case; emulate by guarding the reciprocal
    ratio = c / np.maximum(max3, 1e-30)
    ratio = np.power(ratio, saturation)

    luma = np.sum(c * luma_t, axis=-1)
    luma = np.power(luma, contrast)
    luma = luma / np.maximum(luma * tone_scale_bias[0] + tone_scale_bias[1],
                             1e-30)

    luma_ratio = np.sum(ratio * luma_t, axis=-1)
    ratio_scale = _saturate(luma / np.maximum(luma_ratio, 1e-30))
    out = _saturate(ratio * ratio_scale[..., None])

    cap = -crosstalk * out + crosstalk
    luma_add = _saturate(luma - np.sum(out * luma_t, axis=-1))
    t = luma_add / np.maximum(np.sum(cap * luma_t, axis=-1), 1e-30)
    out = _saturate(t[..., None] * cap + out)
    luma_add = _saturate(luma - np.sum(out * luma_t, axis=-1))
    return _saturate(luma_add[..., None] * rcp_luma_t + out)


# --------------------------------------------------------------- constants --

def oracle_gtao_consts(width, height, fovy, aspect, radius=0.2):
    """GTAOUpdateConstants (XeGTAO.h:170-204) with the renderer's settings:
    Radius = 0.2 (vk_xe_gtao.rs), remaining heuristics at the XeGTAO.h
    defaults (:107-112). Only the fields the viewspace-depth path reads."""
    thy = math.tan(fovy * 0.5)
    thx = thy * aspect
    ndc_mul = (thx * 2.0, thy * -2.0)
    return dict(
        viewport_pixel_size=(1.0 / width, 1.0 / height),
        ndc_to_view_mul=ndc_mul,
        ndc_to_view_add=(-thx, thy),
        ndc_to_view_mul_x_pixel_size=(ndc_mul[0] / width, ndc_mul[1] / height),
        effect_radius=radius,
        radius_multiplier=1.457,
        effect_falloff_range=0.615,
        sample_distribution_power=2.0,
        thin_occluder_compensation=0.0,
        depth_mip_sampling_offset=3.30,
        final_value_power=2.2,
    )


# ------------------------------------------------------------- full frame --

def oracle_post_process(color_hdr, view_depth, normal_enc, gtao_consts,
                        lpm_ctl, slice_count, steps_per_slice,
                        denoise_passes, noise_index):
    """The complete reference post chain on an unquantized G-buffer:
    storage quantization -> XeGTAO -> AO composite -> LpmFilter -> sRGB ->
    u8 (tonemap.comp.glsl:29-39 + swapchain UNORM store). Returns the
    (H, W, 3) u8 frame."""
    color = q_r11g11b10f(color_hdr)
    depth = q_r16f(view_depth)
    normal = q_r11g11b10f(normal_enc)

    ao = xegtao_full(depth, normal, gtao_consts, slice_count,
                     steps_per_slice, denoise_passes, noise_index)
    out = color * (ao.astype(np.float32) / 255.0)[..., None]
    out = lpm_filter_709_709(out, lpm_ctl)
    out = np.power(np.maximum(out, 0.0), 1.0 / 2.2)  # rgb_to_srgb_approx
    return np.clip(out * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
