"""The GTAO main pass's plain version as it stood before the noise table
(K3h) was split out: every noise-only quantity (the slice angle's cos/sin,
the sample-distribution pow) computed inline per pixel. The tests hold the
split version (kernels/gtao_main.py: noise_table_plain + main_body_plain)
to these bits."""
import torch

from tpurt_torch.kernels.gtao_main import (GTAO_VEC, PI, PI_HALF,
                                           XE_GTAO_DEPTH_MIP_LEVELS,
                                           XE_GTAO_OCCLUSION_TERM_SCALE,
                                           _clip, _fast_acos, _mip_meta)
from tpurt_torch.passes.encodings import divide, rdivide, sqrt


def main_pass_inline(mips, normal_enc, gvec, noise, *, slice_count: int,
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
    nlen = torch.clamp_min(sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen

    vz = vz * 0.99920

    def view_pos(spx, spy, z):
        return ((g["ndc_mul_x"] * spx + g["ndc_add_x"]) * z,
                (g["ndc_mul_y"] * spy + g["ndc_add_y"]) * z, z)

    px, py, pz = view_pos(sp_x, sp_y, vz)
    plen = torch.clamp_min(sqrt(px * px + py * py + pz * pz), 1e-20)
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
        dist = sqrt(dx * dx + dy * dy + dz * dz)
        dmax = torch.clamp_min(dist, 1e-20)
        hx, hy, hz = dx / dmax, dy / dmax, dz / dmax
        dzt = dz * g["thin_mul"]
        falloff_base = sqrt(dx * dx + dy * dy + dzt * dzt)
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
        alen = torch.clamp_min(sqrt(ax * ax + ay * ay + az * az), 1e-20)
        ax, ay, az = ax / alen, ay / alen, az / alen

        na = nx * ax + ny * ay + nz * az
        pnx, pny, pnz = nx - ax * na, ny - ay * na, nz - az * na
        sign_norm = torch.sign(ox * pnx + oy * pny + oz * pnz)
        pn_len = sqrt(pnx * pnx + pny * pny + pnz * pnz)
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
            so_len = sqrt(so_x * so_x + so_y * so_y)
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
