"""XeGTAO main pass (K3) and its noise table (K3h).

``gtao_main`` replaces tpurt's ``main_pass_pallas``
(``tpurt/kernels/gtao_main_pallas.py``), which runs ``_noise_hoist_kernel``
(K3h) before its main kernel (K3). On CUDA tensors it launches both kernels
of ``csrc/gtao_main.cu``: ``gtao_noise_table`` (K3h) builds the per-texel
table of everything that depends only on the 64x64 noise maps (per slice
the slice angle's cos and sin, per slice and step the sample-distribution
pow), then the main kernel reads it per pixel. On CPU tensors it runs
:func:`main_pass_plain`, the PyTorch port of tpurt's XLA
``passes/gtao.py:main_pass`` (full frame, no bent normals, f32), split the
same way: :func:`noise_table_plain` plus the per-pixel body, with
main_pass's expressions, so its bits are those of main_pass's inline form.
Both read the depth pyramid by direct point loads with main_pass's mip
selection.

Inputs: five R16F-valued depth mips (f32), the encoded view normals
(H, W, 3), the (14,) constants vector of ``engine/convert.gtao_tensors``
and the two 64x64 noise maps. Outputs: AO u8 and packed LRTB edges u8.
The table: (slice_count * (2 + steps), 64, 64) f32, per slice the planes
cos, sin, then the pow of each step.
"""
from __future__ import annotations

import ctypes

import torch

from ..passes.encodings import divide, rdivide, sqrt
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


def _check(name, mips, normal_enc, gvec, noise=None):
    if len(mips) != XE_GTAO_DEPTH_MIP_LEVELS:
        raise ValueError(f"{name}: expected {XE_GTAO_DEPTH_MIP_LEVELS} mips")
    h, w = mips[0].shape
    if normal_enc.shape != (h, w, 3):
        raise ValueError(f"{name}: normal_enc {tuple(normal_enc.shape)} "
                         f"does not match depth ({h}, {w})")
    if gvec.shape != (len(GTAO_VEC),) or (
            noise is not None and noise.shape != (2, 64, 64)):
        raise ValueError(f"{name}: bad constants or noise shape")
    tensors = dict(normal_enc=normal_enc, gvec=gvec,
                   **{f"mip{i}": m for i, m in enumerate(mips)})
    if noise is not None:
        tensors["noise"] = noise
    for t in tensors.values():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be float32")
    dev = mips[0].device
    if dev.type == "cuda":
        build.require_cuda(name, tensors, dev)
    elif any(t.device.type != "cpu" for t in tensors.values()):
        raise ValueError(f"{name}: mixed devices")


def _check_counts(name, slice_count, steps_per_slice):
    if slice_count < 1 or steps_per_slice < 1:
        raise ValueError(f"{name}: slice_count and steps_per_slice must be "
                         f">= 1, got {slice_count}, {steps_per_slice}")


def table_planes(slice_count: int, steps_per_slice: int) -> int:
    """Planes of the noise table: per slice cos, sin and one pow per step."""
    return slice_count * (2 + steps_per_slice)


def gtao_noise_table(noise, gvec, *, slice_count: int, steps_per_slice: int):
    """K3h: the (planes, 64, 64) f32 noise table of the module docstring.
    On CUDA tensors it launches csrc/gtao_main.cu's noise kernel, on CPU
    tensors it runs noise_table_plain."""
    name = "gtao_noise_table"
    _check_counts(name, slice_count, steps_per_slice)
    if noise.shape != (2, 64, 64) or gvec.shape != (len(GTAO_VEC),) \
            or noise.dtype != torch.float32 or gvec.dtype != torch.float32:
        raise ValueError(f"{name}: noise must be (2, 64, 64) and the "
                         f"constants ({len(GTAO_VEC)},), both float32")
    if not noise.is_cuda:
        if gvec.device.type != "cpu":
            raise ValueError(f"{name}: mixed devices")
        return noise_table_plain(noise, gvec, slice_count=slice_count,
                                 steps_per_slice=steps_per_slice)
    build.require_cuda(name, dict(noise=noise, gvec=gvec), noise.device)
    table = torch.empty((table_planes(slice_count, steps_per_slice), 64, 64),
                        dtype=torch.float32, device=noise.device)
    fn = build.function("tpurt_gtao_noise_table", [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    p = build.ptr
    build.check(fn(p(noise), p(gvec), slice_count, steps_per_slice, p(table),
                   build.stream_of(noise)), "tpurt_gtao_noise_table")
    build.launch_counts["gtao_noise"] += 1
    return table


def gtao_main(mips, normal_enc, gvec, noise, *, slice_count: int,
              steps_per_slice: int):
    """Returns (ao_u8 (H, W), edges_u8 (H, W)): K3h then K3 on CUDA
    tensors, main_pass_plain on CPU tensors."""
    _check("gtao_main", mips, normal_enc, gvec, noise)
    _check_counts("gtao_main", slice_count, steps_per_slice)
    if not mips[0].is_cuda:
        return main_pass_plain(mips, normal_enc, gvec, noise,
                               slice_count=slice_count,
                               steps_per_slice=steps_per_slice)
    table = gtao_noise_table(noise, gvec, slice_count=slice_count,
                             steps_per_slice=steps_per_slice)
    return main_kernel(mips, normal_enc, gvec, table,
                       slice_count=slice_count,
                       steps_per_slice=steps_per_slice)


def main_kernel(mips, normal_enc, gvec, table, *, slice_count: int,
                steps_per_slice: int):
    """K3 alone on CUDA tensors, reading K3h's `table` for the same
    counts."""
    name = "gtao_main"
    planes = table_planes(slice_count, steps_per_slice)
    if table.shape != (planes, 64, 64) or table.dtype != torch.float32:
        raise ValueError(f"{name}: table must be ({planes}, 64, 64) float32")
    _check(name, mips, normal_enc, gvec)
    dev = mips[0].device
    build.require_cuda(name, dict(table=table), dev)
    h, w = mips[0].shape
    ao = torch.empty((h, w), dtype=torch.uint8, device=dev)
    edges = torch.empty((h, w), dtype=torch.uint8, device=dev)
    levels = (ctypes.c_void_p * XE_GTAO_DEPTH_MIP_LEVELS)(
        *(m.data_ptr() for m in mips))
    dims = (ctypes.c_int * (2 * XE_GTAO_DEPTH_MIP_LEVELS))(
        *(int(m.shape[0]) for m in mips), *(int(m.shape[1]) for m in mips))
    fn = build.function("tpurt_gtao_main", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    p = build.ptr
    build.check(fn(ctypes.cast(levels, ctypes.c_void_p),
                   ctypes.cast(dims, ctypes.c_void_p), p(normal_enc),
                   p(gvec), p(table), h, w, slice_count, steps_per_slice,
                   p(ao), p(edges), build.stream_of(table)),
                "tpurt_gtao_main")
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


def noise_table_plain(noise, gvec, *, slice_count: int,
                      steps_per_slice: int):
    """Plain version of K3h: main_pass's noise-only expressions on the 64x64
    noise maps. Returns (planes, 64, 64) f32 (module docstring)."""
    sdp = gvec[GTAO_VEC.index("sample_distribution_power")]
    planes = []
    for slice_i in range(slice_count):
        slice_k = divide(slice_i + noise[0], slice_count)
        phi = slice_k * PI
        planes += [torch.cos(phi), torch.sin(phi)]
        for step in range(steps_per_slice):
            step_base_noise = ((slice_i + step * steps_per_slice)
                               * 0.6180339887498948482)
            step_noise = torch.fmod(noise[1] + step_base_noise, 1.0)
            s = divide(step + step_noise, steps_per_slice)
            planes.append(torch.pow(s, sdp))
    return torch.stack(planes)


def main_pass_plain(mips, normal_enc, gvec, noise, *, slice_count: int,
                    steps_per_slice: int):
    """PyTorch port of tpurt's ``passes/gtao.py:main_pass`` (XeGTAO
    MainPass): noise_table_plain, then the per-pixel body reading it."""
    table = noise_table_plain(noise, gvec, slice_count=slice_count,
                              steps_per_slice=steps_per_slice)
    return main_body_plain(mips, normal_enc, gvec, table,
                           slice_count=slice_count,
                           steps_per_slice=steps_per_slice)


def main_body_plain(mips, normal_enc, gvec, table, *, slice_count: int,
                    steps_per_slice: int):
    """The per-pixel part of main_pass_plain, reading the noise table of
    the same counts. Dot products and norms sum left to right."""
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

    ty, tx = yi % 64, xi % 64

    def texels(plane):
        """Plane `plane` of the table at every pixel's noise texel."""
        return table[plane][ty][:, tx]

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

    per_slice = 2 + steps_per_slice
    for slice_i in range(slice_count):
        plane = slice_i * per_slice
        cos_phi = texels(plane)
        sin_phi = texels(plane + 1)
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
            s = texels(plane + 2 + step) + min_s

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
