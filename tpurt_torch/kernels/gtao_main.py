"""XeGTAO main pass (K3) and its noise table (K3h).

``gtao_main`` replaces tpurt's ``main_pass_pallas``
(``tpurt/kernels/gtao_main_pallas.py``), which runs ``_noise_hoist_kernel``
(K3h) before its main kernel (K3). On CUDA tensors it launches both kernels
of ``csrc/gtao_main.cu``: ``gtao_noise_table`` (K3h) builds the per-texel
table of everything that depends only on the 64x64 noise maps (per slice
the slice angle's cos and sin, per slice and step the sample-distribution
pow), then the main kernel reads it per pixel. On CPU tensors it runs
:func:`main_pass_plain`, the PyTorch port of tpurt's XLA
``passes/gtao.py:main_pass`` (full frame), split the same way:
:func:`noise_table_plain` plus the per-pixel body, with main_pass's
expressions, so its bits are those of main_pass's inline form. Both read
the depth pyramid by direct point loads with main_pass's mip selection.

The variants are compile-time instantiations of the same kernels, each with
its plain version here:

  * ``bent=True`` — XeGTAO's "Algorithm 2" bent normal per slice, rotated
    from -z to the view vector; the AO output is the packed RGBA8 of
    (visibility / 1.5, normalized bent normal) as uint32 bits in an int32
    tensor (``encode_bent``). tpurt computes it on its XLA main pass.
  * ``precision="half"`` — every fetched horizon depth rounded to bf16
    (tpurt's Pallas ``precision="half"``, a single bf16 matmul per fetch).
    tpurt's XLA main pass ignores "half", and bent normals always take that
    pass, so with ``bent=True`` "half" computes the f32 bent pass.
  * ``precision="fp16"`` — tpurt's min16float emulation: every lpfloat
    intermediate of main_pass rounded to f16 after each operation (dot
    products and norms sum their rounded products in f32 and round once,
    as ``jnp.sum`` does over f16; the cross product rounds its first
    product only with the difference, as XLA:CPU contracts ``jnp.cross``);
    screen positions, sample positions and their deltas stay f32. K3h's
    table then holds the f16-rounded cos, sin and pow, and the constants
    vector is ``gtao_tensors(...)["vec16"]``. Held to tpurt's eager
    ``main_pass`` on the CPU this gives its bits.

Inputs: five R16F-valued depth mips (f32), the encoded view normals
(H, W, 3), the (14,) constants vector of ``engine/convert.gtao_tensors``
and the two 64x64 noise maps. Outputs: AO u8 (or the packed int32 with
bent normals) and packed LRTB edges u8. The table: (slice_count * (2 +
steps), 64, 64) f32, per slice the planes cos, sin, then the pow of each
step.
"""
from __future__ import annotations

import ctypes

import numpy as np
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
PRECISIONS = ("exact", "half", "fp16")
# csrc/gtao_main.cu's instantiations: exact, bent, half, fp16, bent + fp16
_MODES = {(False, "exact"): 0, (True, "exact"): 1, (False, "half"): 2,
          (False, "fp16"): 3, (True, "fp16"): 4}


def _mode(bent: bool, precision: str) -> int:
    if precision not in PRECISIONS:
        raise ValueError(f"GTAO precision {precision!r}: expected one of "
                         f"{PRECISIONS}")
    # tpurt's bent pass is its XLA main_pass, which computes "half" in f32
    return _MODES[(bool(bent), "exact" if bent and precision == "half"
                   else precision)]


def count_key(bent: bool, precision: str) -> str:
    """The launch-count entry of the main kernel's instantiation over the
    whole image; a launch over another band of rows counts under
    "gtao_main_band" in every instantiation."""
    return ("gtao_main", "gtao_main_bent", "gtao_main_half",
            "gtao_main_fp16", "gtao_main_bent_fp16")[_mode(bent, precision)]


class _Lp:
    """The lpfloat arithmetic of one precision: ``r(x)`` rounds a f32
    tensor to f16 after an operation (identity in f32), ``k(c)`` is a
    Python constant as tpurt's weakly-typed literal meets an lpfloat operand
    (f16 nearest of the double; the f32 literal otherwise) and ``eps`` is
    jnp.maximum's 1e-20 guard in that type (0 in f16)."""

    def __init__(self, fp16: bool):
        self.fp16 = fp16
        self.eps = 0.0 if fp16 else 1e-20

    def r(self, x):
        if self.fp16:
            return x.to(torch.float16).to(torch.float32)
        return x

    def k(self, c: float) -> float:
        return float(np.float16(c)) if self.fp16 else c


_F32 = _Lp(False)


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


def gtao_noise_table(noise, gvec, *, slice_count: int, steps_per_slice: int,
                     fp16: bool = False):
    """K3h: the (planes, 64, 64) f32 noise table of the module docstring
    (f16-rounded values with fp16). On CUDA tensors it launches
    csrc/gtao_main.cu's noise kernel, on CPU tensors it runs
    noise_table_plain."""
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
                                 steps_per_slice=steps_per_slice, fp16=fp16)
    build.require_cuda(name, dict(noise=noise, gvec=gvec), noise.device)
    table = torch.empty((table_planes(slice_count, steps_per_slice), 64, 64),
                        dtype=torch.float32, device=noise.device)
    fn = build.function("tpurt_gtao_noise_table", [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    p = build.ptr
    build.check(fn(p(noise), p(gvec), slice_count, steps_per_slice,
                   int(fp16), p(table), build.stream_of(noise)),
                "tpurt_gtao_noise_table")
    build.launch_counts["gtao_noise_fp16" if fp16 else "gtao_noise"] += 1
    return table


def band_rows(h: int, row_start: int, num_rows) -> tuple[int, int]:
    """(row_start, num_rows) of a band of an image of `h` rows: output row
    i is image row row_start + i, and the band lies inside the image. None
    rows is the whole image from row_start = 0."""
    if num_rows is None:
        if row_start != 0:
            raise ValueError("gtao_main: a band from row_start != 0 needs "
                             "num_rows")
        return 0, h
    row_start, num_rows = int(row_start), int(num_rows)
    if num_rows < 1 or row_start < 0 or row_start + num_rows > h:
        raise ValueError(f"gtao_main: band of {num_rows} rows from "
                         f"{row_start} outside an image of {h} rows")
    return row_start, num_rows


def gtao_main(mips, normal_enc, gvec, noise, *, slice_count: int,
              steps_per_slice: int, bent: bool = False,
              precision: str = "exact", row_start: int = 0, num_rows=None):
    """Returns (ao (R, W), edges_u8 (R, W)) of the band of `num_rows` rows
    from `row_start` (``band_rows``; the whole image by default): K3h then
    K3 on CUDA tensors, main_pass_plain on CPU tensors. ao is u8, or with
    bent normals the packed (visibility, bent normal) uint32 bits as
    int32."""
    _check("gtao_main", mips, normal_enc, gvec, noise)
    _check_counts("gtao_main", slice_count, steps_per_slice)
    _mode(bent, precision)
    row_start, num_rows = band_rows(mips[0].shape[0], row_start, num_rows)
    band = dict(row_start=row_start, num_rows=num_rows)
    if not mips[0].is_cuda:
        return main_pass_plain(mips, normal_enc, gvec, noise,
                               slice_count=slice_count,
                               steps_per_slice=steps_per_slice, bent=bent,
                               precision=precision, **band)
    table = gtao_noise_table(noise, gvec, slice_count=slice_count,
                             steps_per_slice=steps_per_slice,
                             fp16=precision == "fp16")
    return main_kernel(mips, normal_enc, gvec, table,
                       slice_count=slice_count,
                       steps_per_slice=steps_per_slice, bent=bent,
                       precision=precision, **band)


def main_kernel(mips, normal_enc, gvec, table, *, slice_count: int,
                steps_per_slice: int, bent: bool = False,
                precision: str = "exact", row_start: int = 0,
                num_rows=None):
    """K3 alone on CUDA tensors over the band of ``gtao_main``, reading
    K3h's `table` for the same counts and precision."""
    name = "gtao_main"
    mode = _mode(bent, precision)
    planes = table_planes(slice_count, steps_per_slice)
    if table.shape != (planes, 64, 64) or table.dtype != torch.float32:
        raise ValueError(f"{name}: table must be ({planes}, 64, 64) float32")
    _check(name, mips, normal_enc, gvec)
    dev = mips[0].device
    build.require_cuda(name, dict(table=table), dev)
    h, w = mips[0].shape
    row_start, rows = band_rows(h, row_start, num_rows)
    ao = torch.empty((rows, w), dtype=torch.int32 if bent else torch.uint8,
                     device=dev)
    edges = torch.empty((rows, w), dtype=torch.uint8, device=dev)
    levels = (ctypes.c_void_p * XE_GTAO_DEPTH_MIP_LEVELS)(
        *(m.data_ptr() for m in mips))
    dims = (ctypes.c_int * (2 * XE_GTAO_DEPTH_MIP_LEVELS))(
        *(int(m.shape[0]) for m in mips), *(int(m.shape[1]) for m in mips))
    fn = build.function("tpurt_gtao_main", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
    p = build.ptr
    build.check(fn(ctypes.cast(levels, ctypes.c_void_p),
                   ctypes.cast(dims, ctypes.c_void_p), p(normal_enc),
                   p(gvec), p(table), h, w, row_start, rows, slice_count,
                   steps_per_slice, mode, p(ao), p(edges),
                   build.stream_of(table)),
                "tpurt_gtao_main")
    whole = (row_start, rows) == (0, h)
    build.launch_counts[count_key(bent, precision) if whole
                        else "gtao_main_band"] += 1
    return ao, edges


def _fast_sqrt(x):
    """XeGTAO_FastSqrt bit trick."""
    xi = x.contiguous().view(torch.int32)
    return (0x1FBD1DF5 + (xi >> 1)).to(torch.int32).view(torch.float32)


def _fast_acos(x, lp: _Lp = _F32):
    """XeGTAO_FastACos, [-1, 1] -> [0, PI]. With fp16 the polynomial runs
    in f16 and the bit-trick root and the result in f32, as tpurt's
    ``_fast_acos`` on an f16 operand; the caller rounds the result."""
    r, k = lp.r, lp.k
    ax = x.abs()
    res = r(r(k(-0.156583) * ax) + k(PI_HALF))
    res = res * _fast_sqrt(torch.clamp_min(r(k(1.0) - ax), 0.0))
    return torch.where(x >= 0, res, PI - res)


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


def encode_bent(vis, bx, by, bz, lp: _Lp = _F32):
    """XeGTAO_EncodeVisibilityBentNormal in the given precision: the RGBA8
    pack of (bn * 0.5 + 0.5, clip(vis, 0, 1)) as uint32 bits in int32."""
    r, k = lp.r, lp.k

    def u8(x):
        q = _clip(r(r(x * k(255.0)) + k(0.5)), 0.0, 255.0)
        return q.to(torch.int64)

    def half_up(b):
        return u8(r(r(b * k(0.5)) + k(0.5)))

    packed = (half_up(bx) | (half_up(by) << 8) | (half_up(bz) << 16)
              | (u8(_clip(vis, 0.0, 1.0)) << 24))
    return packed.to(torch.int32)


def rot_from_minus_z(tx, ty, tz, lp: _Lp = _F32):
    """XeGTAO_RotFromToMatrix from (0, 0, -1) to the unit vector (tx, ty,
    tz), tpurt's ``_rot_from_minus_z`` in the given precision: returns
    rot(x, y, z) -> [x', y', z'], the matrix applied (the vector itself
    where the target is within 0.0003 of -z or +z)."""
    r, k = lp.r, lp.k
    e = -tz
    vx, vy = ty, -tx
    h = r(rdivide(k(1.0), torch.clamp_min(r(k(1.0) + e), k(1e-6))))
    m01 = r(r(h * vx) * vy)
    rows = ((r(e + r(r(h * vx) * vx)), m01, vy),
            (m01, r(e + r(r(h * vy) * vy)), -vx),
            (-vy, vx, e))
    near_identity = e.abs() > k(1.0 - 0.0003)

    def rot(x, y, z):
        return [torch.where(near_identity, v, r(r(r(m[0] * x) + r(m[1] * y))
                                                + r(m[2] * z)))
                for m, v in zip(rows, (x, y, z))]

    return rot


def noise_table_plain(noise, gvec, *, slice_count: int,
                      steps_per_slice: int, fp16: bool = False):
    """Plain version of K3h: main_pass's noise-only expressions on the 64x64
    noise maps. Returns (planes, 64, 64) f32 (module docstring)."""
    lp = _Lp(fp16)
    r, k = lp.r, lp.k
    sdp = gvec[GTAO_VEC.index("sample_distribution_power")]
    noise_slice, noise_sample = r(noise[0]), r(noise[1])
    planes = []
    for slice_i in range(slice_count):
        slice_k = r(divide(r(slice_i + noise_slice), slice_count))
        phi = r(slice_k * k(PI))
        planes += [r(torch.cos(phi)), r(torch.sin(phi))]
        for step in range(steps_per_slice):
            step_base_noise = k((slice_i + step * steps_per_slice)
                                * 0.6180339887498948482)
            step_noise = torch.fmod(r(noise_sample + step_base_noise), 1.0)
            s = r(divide(r(step + step_noise), steps_per_slice))
            planes.append(r(torch.pow(s, sdp)))
    return torch.stack(planes)


def main_pass_plain(mips, normal_enc, gvec, noise, *, slice_count: int,
                    steps_per_slice: int, bent: bool = False,
                    precision: str = "exact", row_start: int = 0,
                    num_rows=None):
    """PyTorch port of tpurt's ``passes/gtao.py:main_pass`` (XeGTAO
    MainPass): noise_table_plain, then the per-pixel body reading it, over
    the band of ``gtao_main``."""
    table = noise_table_plain(noise, gvec, slice_count=slice_count,
                              steps_per_slice=steps_per_slice,
                              fp16=precision == "fp16")
    return main_body_plain(mips, normal_enc, gvec, table,
                           slice_count=slice_count,
                           steps_per_slice=steps_per_slice, bent=bent,
                           precision=precision, row_start=row_start,
                           num_rows=num_rows)


def main_body_plain(mips, normal_enc, gvec, table, *, slice_count: int,
                    steps_per_slice: int, bent: bool = False,
                    precision: str = "exact", row_start: int = 0,
                    num_rows=None):
    """The per-pixel part of main_pass_plain, reading the noise table of
    the same counts and precision, over the band of ``gtao_main``: output
    row i is image row row_start + i, each pixel computed as in the whole
    image. Dot products and norms sum left to right; with
    fp16 every lpfloat value is rounded after its operation."""
    mode = _mode(bent, precision)
    half = mode == 2
    lp = _Lp(precision == "fp16")
    r, k, eps = lp.r, lp.k, lp.eps
    g = {key: gvec[i] for i, key in enumerate(GTAO_VEC)}
    d0 = mips[0]
    h, w = d0.shape
    dev = d0.device
    offs, hs, ws = _mip_meta(mips)
    flat = torch.cat([m.reshape(-1) for m in mips])
    offs_t = torch.tensor(offs, dtype=torch.int64, device=dev)
    hs_t = torch.tensor(hs, dtype=torch.int32, device=dev)
    ws_t = torch.tensor(ws, dtype=torch.int32, device=dev)

    row_start, rows = band_rows(h, row_start, num_rows)
    yi = torch.arange(row_start, row_start + rows, device=dev)
    xi = torch.arange(w, device=dev)
    xs = divide(xi.to(torch.float32) + 0.5, w)
    ys = divide(yi.to(torch.float32) + 0.5, h)
    sp_y, sp_x = torch.meshgrid(ys, xs, indexing="ij")

    vz = d0[yi]
    pix_l = vz[:, torch.clamp(xi - 1, 0, w - 1)]
    pix_r = vz[:, torch.clamp(xi + 1, 0, w - 1)]
    pix_t = d0[torch.clamp(yi - 1, 0, h - 1)]
    pix_b = d0[torch.clamp(yi + 1, 0, h - 1)]
    normal_enc = normal_enc[yi]

    # XeGTAO_CalculateEdges + XeGTAO_PackEdges
    e_l, e_r = r(pix_l - vz), r(pix_r - vz)
    e_t, e_b = r(pix_t - vz), r(pix_b - vz)
    slope_lr = r(r(e_r - e_l) * 0.5)
    slope_tb = r(r(e_b - e_t) * 0.5)
    denom = r(vz * k(0.011))

    def edge_q(e, adj):
        e = torch.minimum(e.abs(), adj.abs())
        edge = _clip(r(k(1.25) - r(e / denom)), 0.0, 1.0)
        return torch.round(r(_clip(edge, 0.0, 1.0) * k(2.9)))

    packed = (edge_q(e_l, r(e_l + slope_lr)) * 64
              + edge_q(e_r, r(e_r - slope_lr)) * 16
              + edge_q(e_t, r(e_t + slope_tb)) * 4
              + edge_q(e_b, r(e_b - slope_tb)))
    edges_u8 = packed.to(torch.uint8)

    nx = normal_enc[..., 0] * 2.0 - 1.0
    ny = normal_enc[..., 1] * 2.0 - 1.0
    nz = normal_enc[..., 2] * 2.0 - 1.0
    nlen = torch.clamp_min(sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
    nx, ny, nz = r(nx / nlen), r(ny / nlen), r(nz / nlen)

    vz = r(vz * k(0.99920))

    def view_pos(spx, spy, z):
        return ((g["ndc_mul_x"] * spx + g["ndc_add_x"]) * z,
                (g["ndc_mul_y"] * spy + g["ndc_add_y"]) * z, z)

    px, py, pz = view_pos(sp_x, sp_y, vz)
    plen = torch.clamp_min(sqrt(px * px + py * py + pz * pz), 1e-20)
    vx, vy, vzv = r(-px / plen), r(-py / plen), r(-pz / plen)

    ssr = r(g["effect_radius"] / r(vz * g["ndc_mul_x_pix"]))
    visibility = r(_clip(r(divide(r(k(10.0) - ssr), k(100.0))), 0.0, 1.0)
                   * k(0.5))
    min_s = r(rdivide(k(1.3), ssr))

    if bent:
        rot = rot_from_minus_z(vx, vy, vzv, lp)
        bent_acc = [torch.zeros_like(vz) for _ in range(3)]

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
        if half:
            sz = sz.to(torch.bfloat16).to(torch.float32)
        qx, qy, qz = view_pos(sx, sy, sz)
        dx, dy, dz = qx - px, qy - py, qz - pz
        dist = sqrt(dx * dx + dy * dy + dz * dz)
        dmax = torch.clamp_min(dist, 1e-20)
        hx, hy, hz = r(dx / dmax), r(dy / dmax), r(dz / dmax)
        fx, fy, fz = r(dx), r(dy), r(dz * g["thin_mul"])
        falloff_base = r(sqrt(r(r(r(fx * fx) + r(fy * fy)) + r(fz * fz))))
        weight = _clip(r(r(falloff_base * g["falloff_mul"])
                         + g["falloff_add"]), 0.0, 1.0)
        shc = r(r(hx * vx) + r(hy * vy) + r(hz * vzv))
        shc = r(low + r(r(shc - low) * weight))
        return torch.maximum(hcos, shc)

    per_slice = 2 + steps_per_slice
    for slice_i in range(slice_count):
        plane = slice_i * per_slice
        cos_phi = texels(plane)
        sin_phi = texels(plane + 1)
        omega_x = r(cos_phi * ssr)
        omega_y = r(-sin_phi * ssr)

        dd = r(r(cos_phi * vx) + r(sin_phi * vy) + r(0.0 * vzv))
        ox = r(cos_phi - r(dd * vx))
        oy = r(sin_phi - r(dd * vy))
        oz = r(0.0 - r(dd * vzv))
        # jnp.cross: XLA:CPU contracts its a * b - c * d into a fused
        # multiply-subtract, so the first product is not rounded (exact in
        # f32 for f16 operands)
        ax = r(oy * vzv - r(oz * vy))
        ay = r(oz * vx - r(ox * vzv))
        az = r(ox * vy - r(oy * vx))
        alen = torch.clamp_min(
            r(sqrt(r(r(ax * ax) + r(ay * ay) + r(az * az)))), eps)
        ax, ay, az = r(ax / alen), r(ay / alen), r(az / alen)

        na = r(r(nx * ax) + r(ny * ay) + r(nz * az))
        pnx, pny, pnz = r(nx - r(ax * na)), r(ny - r(ay * na)), \
            r(nz - r(az * na))
        sign_norm = torch.sign(r(r(ox * pnx) + r(oy * pny) + r(oz * pnz)))
        pn_len = r(sqrt(r(r(pnx * pnx) + r(pny * pny) + r(pnz * pnz))))
        # f16 flushes the 1e-20 guard to 0: tpurt uses the least f16 normal
        pn_eps = k(6.104e-05) if lp.fp16 else 1e-20
        cos_norm = _clip(r(r(r(pnx * vx) + r(pny * vy) + r(pnz * vzv))
                           / torch.clamp_min(pn_len, pn_eps)), 0.0, 1.0)
        n_angle = r(sign_norm * r(_fast_acos(cos_norm, lp)))

        low0 = r(torch.cos(r(n_angle + k(PI_HALF))))
        low1 = r(torch.cos(r(n_angle - k(PI_HALF))))
        h0c, h1c = low0, low1
        for step in range(steps_per_slice):
            s = r(texels(plane + 2 + step) + min_s)

            so_x = r(s * omega_x)
            so_y = r(s * omega_y)
            so_len = r(sqrt(r(r(so_x * so_x) + r(so_y * so_y))))
            mip_level = _clip(
                r(r(torch.log2(torch.clamp_min(so_len, eps)))
                  - g["depth_mip_sampling_offset"]), 0.0,
                float(XE_GTAO_DEPTH_MIP_LEVELS))
            mip = torch.clamp(torch.round(mip_level).to(torch.int32), 0,
                              XE_GTAO_DEPTH_MIP_LEVELS - 1).long()
            sox = r(torch.round(so_x) * g["pixel_size_x"])
            soy = r(torch.round(so_y) * g["pixel_size_y"])
            h0c = horizon(sp_x + sox, sp_y + soy, mip, low0, h0c)
            h1c = horizon(sp_x - sox, sp_y - soy, mip, low1, h1c)

        pn_len = r(pn_len + r(r(k(1.0) - pn_len) * k(0.05)))
        hh0 = -r(_fast_acos(_clip(h1c, -1.0, 1.0), lp))
        hh1 = r(_fast_acos(_clip(h0c, -1.0, 1.0), lp))
        sin_n = r(torch.sin(n_angle))
        two0, two1 = r(k(2.0) * hh0), r(k(2.0) * hh1)
        iarc0 = r(divide(r(r(cos_norm + r(two0 * sin_n))
                           - r(torch.cos(r(two0 - n_angle)))), k(4.0)))
        iarc1 = r(divide(r(r(cos_norm + r(two1 * sin_n))
                           - r(torch.cos(r(two1 - n_angle)))), k(4.0)))
        visibility = r(visibility + r(pn_len * r(iarc0 + iarc1)))

        if bent:
            # "Algorithm 2" directional component (XeGTAO.hlsli:548-554)
            def fn3(f, a, b):
                return r(f(r(r(k(3.0) * a) - b)))

            def fn(f, a):
                return r(f(a))

            t0v = r(r(k(6.0) * fn(torch.sin, r(hh0 - n_angle)))
                    - fn3(torch.sin, hh0, n_angle))
            t0v = r(t0v + r(k(6.0) * fn(torch.sin, r(hh1 - n_angle))))
            t0v = r(t0v - fn3(torch.sin, hh1, n_angle))
            t0v = r(t0v + r(k(16.0) * sin_n))
            t0v = r(t0v - r(k(3.0) * r(fn(torch.sin, r(hh0 + n_angle))
                                       + fn(torch.sin, r(hh1 + n_angle)))))
            t0v = r(divide(t0v, k(12.0)))
            t1v = r(-fn3(torch.cos, hh0, n_angle)
                    - fn3(torch.cos, hh1, n_angle))
            t1v = r(t1v + r(k(8.0) * fn(torch.cos, n_angle)))
            t1v = r(t1v - r(k(3.0) * r(fn(torch.cos, r(hh0 + n_angle))
                                       + fn(torch.cos, r(hh1 + n_angle)))))
            t1v = r(divide(t1v, k(12.0)))
            local = rot(r(cos_phi * t0v), r(sin_phi * t0v), -t1v)
            bent_acc = [r(b + r(x * pn_len)) for b, x in zip(bent_acc, local)]

    visibility = r(divide(visibility, slice_count))
    visibility = r(torch.pow(torch.clamp_min(visibility, 0.0),
                             g["final_value_power"]))
    visibility = torch.clamp_min(visibility, k(0.03))
    vis_packed = _clip(r(divide(visibility, k(XE_GTAO_OCCLUSION_TERM_SCALE))),
                       0.0, 1.0)
    if bent:
        bx, by, bz = bent_acc
        blen = torch.clamp_min(
            r(sqrt(r(r(bx * bx) + r(by * by) + r(bz * bz)))), eps)
        return encode_bent(vis_packed, r(bx / blen), r(by / blen),
                           r(bz / blen), lp), edges_u8
    ao_u8 = (vis_packed * 255.0 + 0.5).to(torch.uint8)
    return ao_u8, edges_u8
