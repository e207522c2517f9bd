"""XeGTAO main pass (K3, with the noise hoist K3h computed inline).

``gtao_main`` replaces tpurt's ``main_pass_pallas``
(``tpurt/kernels/gtao_main_pallas.py``). On CUDA tensors it launches
``csrc/gtao_main.cu``; on CPU tensors it runs :func:`main_pass_plain`, the
PyTorch port of tpurt's XLA ``passes/gtao.py:main_pass`` (full frame, no
bent normals, f32). Both read the depth pyramid by direct point loads with
main_pass's mip selection, and compute the slice angle's cos/sin and the
sample-distribution pow per pixel with main_pass's expressions.

Inputs: five R16F-valued depth mips (f32), the encoded view normals
(H, W, 3), the (14,) constants vector of ``engine/convert.gtao_tensors``
and the two 64x64 noise maps. Outputs: AO u8 and packed LRTB edges u8.
"""
from __future__ import annotations

import ctypes

import torch

from ..passes.encodings import divide, rdivide
from . import build

# entries of the (14,) constants vector (engine/convert.gtao_tensors);
# csrc/gtao_main.cu reads the same layout
GTAO_VEC = ("pixel_size_x", "pixel_size_y", "ndc_mul_x", "ndc_mul_y",
            "ndc_add_x", "ndc_add_y", "effect_radius",
            "sample_distribution_power", "thin_mul",
            "falloff_mul", "falloff_add", "final_value_power",
            "depth_mip_sampling_offset", "ndc_mul_x_pix")
XE_GTAO_DEPTH_MIP_LEVELS = 5
XE_GTAO_OCCLUSION_TERM_SCALE = 1.5
PI = 3.1415926535897932384626433832795
PI_HALF = 1.5707963267948966192313216916398


def _mip_meta(mips):
    sizes = [tuple(int(s) for s in m.shape) for m in mips]
    offs, acc = [], 0
    for h, w in sizes:
        offs.append(acc)
        acc += h * w
    return offs, [h for h, _ in sizes], [w for _, w in sizes]


def _check(name, mips, normal_enc, gvec, noise):
    if len(mips) != XE_GTAO_DEPTH_MIP_LEVELS:
        raise ValueError(f"{name}: expected {XE_GTAO_DEPTH_MIP_LEVELS} mips")
    h, w = mips[0].shape
    if normal_enc.shape != (h, w, 3):
        raise ValueError(f"{name}: normal_enc {tuple(normal_enc.shape)} "
                         f"does not match depth ({h}, {w})")
    if gvec.shape != (len(GTAO_VEC),) or noise.shape != (2, 64, 64):
        raise ValueError(f"{name}: bad constants or noise shape")
    for t in (*mips, normal_enc, gvec, noise):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be float32")
    dev = mips[0].device
    tensors = dict(normal_enc=normal_enc, gvec=gvec, noise=noise,
                   **{f"mip{i}": m for i, m in enumerate(mips)})
    if dev.type == "cuda":
        build.require_cuda(name, tensors, dev)
    elif any(t.device.type != "cpu" for t in tensors.values()):
        raise ValueError(f"{name}: mixed devices")


def gtao_main(mips, normal_enc, gvec, noise, *, slice_count: int,
              steps_per_slice: int):
    """Returns (ao_u8 (H, W), edges_u8 (H, W))."""
    _check("gtao_main", mips, normal_enc, gvec, noise)
    if not mips[0].is_cuda:
        return main_pass_plain(mips, normal_enc, gvec, noise,
                               slice_count=slice_count,
                               steps_per_slice=steps_per_slice)
    dev = mips[0].device
    h, w = mips[0].shape
    offs, hs, ws = _mip_meta(mips)
    atlas = torch.cat([m.reshape(-1) for m in mips])
    meta = torch.tensor(offs + hs + ws, dtype=torch.int32, device=dev)
    ao = torch.empty((h, w), dtype=torch.uint8, device=dev)
    edges = torch.empty((h, w), dtype=torch.uint8, device=dev)
    fn = build.function("tpurt_gtao_main", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    p = build.ptr
    build.check(fn(p(atlas), p(meta), p(normal_enc), p(gvec), p(noise),
                   h, w, slice_count, steps_per_slice, p(ao), p(edges),
                   build.stream_of(atlas)), "tpurt_gtao_main")
    build.launch_counts["gtao_main"] += 1
    return ao, edges


def _fast_sqrt(x):
    """XeGTAO_FastSqrt bit trick."""
    xi = x.contiguous().view(torch.int32)
    return (0x1FBD1DF5 + (xi >> 1)).to(torch.int32).view(torch.float32)


def _fast_acos(x):
    """XeGTAO_FastACos, [-1, 1] -> [0, PI]."""
    ax = x.abs()
    res = -0.156583 * ax + PI_HALF
    res = res * _fast_sqrt(torch.clamp_min(1.0 - ax, 0.0))
    return torch.where(x >= 0, res, PI - res)


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


def main_pass_plain(mips, normal_enc, gvec, noise, *, slice_count: int,
                    steps_per_slice: int):
    """PyTorch port of tpurt's ``passes/gtao.py:main_pass`` (XeGTAO
    MainPass). Dot products and norms sum left to right."""
    g = {k: gvec[i] for i, k in enumerate(GTAO_VEC)}
    d0 = mips[0]
    h, w = d0.shape
    dev = d0.device
    offs, hs, ws = _mip_meta(mips)
    flat = torch.cat([m.reshape(-1) for m in mips])
    offs_t = torch.tensor(offs, dtype=torch.int64, device=dev)
    hs_t = torch.tensor(hs, dtype=torch.int32, device=dev)
    ws_t = torch.tensor(ws, dtype=torch.int32, device=dev)

    xs = divide(torch.arange(w, dtype=torch.float32, device=dev) + 0.5, w)
    ys = divide(torch.arange(h, dtype=torch.float32, device=dev) + 0.5, h)
    sp_y, sp_x = torch.meshgrid(ys, xs, indexing="ij")
    yi = torch.arange(h, device=dev)
    xi = torch.arange(w, device=dev)

    vz = d0
    pix_l = d0[:, torch.clamp(xi - 1, 0, w - 1)]
    pix_r = d0[:, torch.clamp(xi + 1, 0, w - 1)]
    pix_t = d0[torch.clamp(yi - 1, 0, h - 1)]
    pix_b = d0[torch.clamp(yi + 1, 0, h - 1)]

    # XeGTAO_CalculateEdges + XeGTAO_PackEdges
    e_l, e_r, e_t, e_b = pix_l - vz, pix_r - vz, pix_t - vz, pix_b - vz
    slope_lr = (e_r - e_l) * 0.5
    slope_tb = (e_b - e_t) * 0.5
    denom = vz * 0.011

    def edge_q(e, adj):
        e = torch.minimum(e.abs(), adj.abs())
        edge = _clip(1.25 - e / denom, 0.0, 1.0)
        return torch.round(_clip(edge, 0.0, 1.0) * 2.9)

    packed = (edge_q(e_l, e_l + slope_lr) * 64 + edge_q(e_r, e_r - slope_lr)
              * 16 + edge_q(e_t, e_t + slope_tb) * 4
              + edge_q(e_b, e_b - slope_tb))
    edges_u8 = packed.to(torch.uint8)

    nx = normal_enc[..., 0] * 2.0 - 1.0
    ny = normal_enc[..., 1] * 2.0 - 1.0
    nz = normal_enc[..., 2] * 2.0 - 1.0
    nlen = torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen

    vz = vz * 0.99920

    def view_pos(spx, spy, z):
        return ((g["ndc_mul_x"] * spx + g["ndc_add_x"]) * z,
                (g["ndc_mul_y"] * spy + g["ndc_add_y"]) * z, z)

    px, py, pz = view_pos(sp_x, sp_y, vz)
    plen = torch.clamp_min(torch.sqrt(px * px + py * py + pz * pz), 1e-20)
    vx, vy, vzv = -px / plen, -py / plen, -pz / plen

    ssr = g["effect_radius"] / (vz * g["ndc_mul_x_pix"])
    visibility = _clip(divide(10.0 - ssr, 100.0), 0.0, 1.0) * 0.5
    min_s = rdivide(1.3, ssr)

    noise_slice = noise[0][yi % 64][:, xi % 64]
    noise_sample = noise[1][yi % 64][:, xi % 64]

    def sample(mip, ux, uy):
        hm = hs_t[mip]
        wm = ws_t[mip]
        x = torch.minimum(torch.clamp_min(
            (ux * wm.to(torch.float32)).to(torch.int32), 0), wm - 1)
        y = torch.minimum(torch.clamp_min(
            (uy * hm.to(torch.float32)).to(torch.int32), 0), hm - 1)
        return flat[offs_t[mip] + (y * wm + x).long()]

    def horizon(sx, sy, mip, low, hcos):
        sz = sample(mip, _clip(sx, 0.0, 1.0), _clip(sy, 0.0, 1.0))
        qx, qy, qz = view_pos(sx, sy, sz)
        dx, dy, dz = qx - px, qy - py, qz - pz
        dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
        dmax = torch.clamp_min(dist, 1e-20)
        hx, hy, hz = dx / dmax, dy / dmax, dz / dmax
        dzt = dz * g["thin_mul"]
        falloff_base = torch.sqrt(dx * dx + dy * dy + dzt * dzt)
        weight = _clip(falloff_base * g["falloff_mul"] + g["falloff_add"],
                       0.0, 1.0)
        shc = hx * vx + hy * vy + hz * vzv
        shc = low + (shc - low) * weight
        return torch.maximum(hcos, shc)

    for slice_i in range(slice_count):
        slice_k = divide(slice_i + noise_slice, slice_count)
        phi = slice_k * PI
        cos_phi = torch.cos(phi)
        sin_phi = torch.sin(phi)
        omega_x = cos_phi * ssr
        omega_y = -sin_phi * ssr

        dd = cos_phi * vx + sin_phi * vy + 0.0 * vzv
        ox, oy, oz = cos_phi - dd * vx, sin_phi - dd * vy, 0.0 - dd * vzv
        ax, ay, az = oy * vzv - oz * vy, oz * vx - ox * vzv, ox * vy - oy * vx
        alen = torch.clamp_min(torch.sqrt(ax * ax + ay * ay + az * az), 1e-20)
        ax, ay, az = ax / alen, ay / alen, az / alen

        na = nx * ax + ny * ay + nz * az
        pnx, pny, pnz = nx - ax * na, ny - ay * na, nz - az * na
        sign_norm = torch.sign(ox * pnx + oy * pny + oz * pnz)
        pn_len = torch.sqrt(pnx * pnx + pny * pny + pnz * pnz)
        cos_norm = _clip((pnx * vx + pny * vy + pnz * vzv)
                         / torch.clamp_min(pn_len, 1e-20), 0.0, 1.0)
        n_angle = sign_norm * _fast_acos(cos_norm)

        low0 = torch.cos(n_angle + PI_HALF)
        low1 = torch.cos(n_angle - PI_HALF)
        h0c, h1c = low0, low1
        for step in range(steps_per_slice):
            step_base_noise = ((slice_i + step * steps_per_slice)
                               * 0.6180339887498948482)
            step_noise = torch.fmod(noise_sample + step_base_noise, 1.0)
            s = divide(step + step_noise, steps_per_slice)
            s = torch.pow(s, g["sample_distribution_power"]) + min_s

            so_x = s * omega_x
            so_y = s * omega_y
            so_len = torch.sqrt(so_x * so_x + so_y * so_y)
            mip_level = _clip(torch.log2(torch.clamp_min(so_len, 1e-20))
                              - g["depth_mip_sampling_offset"], 0.0,
                              float(XE_GTAO_DEPTH_MIP_LEVELS))
            mip = torch.clamp(torch.round(mip_level).to(torch.int32), 0,
                              XE_GTAO_DEPTH_MIP_LEVELS - 1).long()
            sox = torch.round(so_x) * g["pixel_size_x"]
            soy = torch.round(so_y) * g["pixel_size_y"]
            h0c = horizon(sp_x + sox, sp_y + soy, mip, low0, h0c)
            h1c = horizon(sp_x - sox, sp_y - soy, mip, low1, h1c)

        pn_len = pn_len + (1.0 - pn_len) * 0.05
        hh0 = -_fast_acos(_clip(h1c, -1.0, 1.0))
        hh1 = _fast_acos(_clip(h0c, -1.0, 1.0))
        sin_n = torch.sin(n_angle)
        iarc0 = (cos_norm + 2.0 * hh0 * sin_n
                 - torch.cos(2.0 * hh0 - n_angle)) / 4.0
        iarc1 = (cos_norm + 2.0 * hh1 * sin_n
                 - torch.cos(2.0 * hh1 - n_angle)) / 4.0
        visibility = visibility + pn_len * (iarc0 + iarc1)

    visibility = divide(visibility, slice_count)
    visibility = torch.pow(torch.clamp_min(visibility, 0.0),
                           g["final_value_power"])
    visibility = torch.clamp_min(visibility, 0.03)
    vis_packed = _clip(divide(visibility, XE_GTAO_OCCLUSION_TERM_SCALE),
                       0.0, 1.0)
    ao_u8 = (vis_packed * 255.0 + 0.5).to(torch.uint8)
    return ao_u8, edges_u8
