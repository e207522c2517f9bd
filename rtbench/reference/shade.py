"""The reference's camera rays, texture samplers and shading in plain
torch: tests/oracle.py (raytrace.rgen.glsl:77-199, light.glsl:34-124,
brdfs.glsl:6-99) rewritten for tensors, with what it lacks added:

* the camera worked out from its pose: a right-handed look-at with up
  (0, -1, 0) and an OpenGL perspective (vk_camera.rs:182-193);
* the ray-cone texture LOD (Akenine-Moeller et al., "Texture Level of
  Detail Strategies for Real-Time Ray Tracing"): the cone's diameter t *
  2 / (proj[1][1] * rows) at the hit, over the obliquity |N.D| (bounded at
  4x), in texels of the triangle's mapping; trilinear sampling of the
  box-filtered chain at that LOD;
* anisotropic sampling (the reference sampler's max_anisotropy = 16):
  `taps` trilinear taps at the minor axis's LOD, spread along the
  footprint's major axis, the cone's diameter over |N.D| (at most 16x)
  along D projected into the surface, mapped to uv by the triangle's 2x2
  Gram system, and averaged.

Every float is in the dtype of the tables handed in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PI = 3.14159265359
T_MIN = 0.001
T_MAX = 10000.0
SHADOW_T_MIN = 0.01
SHADOW_ATTENUATION = 0.05
LOCAL_SSS_RATIO = 0.4
MAX_ANISO = 16


def camera(pos, direction, width: int, height: int, fovy=math.pi / 2,
           znear=0.1, zfar=1000.0) -> dict:
    """view, view_inv, proj, proj_inv (4, 4) and the position, float64
    numpy."""
    eye = np.asarray(pos, np.float64)
    f = np.asarray(direction, np.float64)
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.array([0.0, -1.0, 0.0]))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[:3, 3] = [-s @ eye, -u @ eye, f @ eye]
    t = 1.0 / math.tan(fovy / 2.0)
    aspect = width / height
    proj = np.zeros((4, 4))
    proj[0, 0] = t / aspect
    proj[1, 1] = t
    proj[2, 2] = (zfar + znear) / (znear - zfar)
    proj[2, 3] = 2.0 * zfar * znear / (znear - zfar)
    proj[3, 2] = -1.0
    return dict(view=view, view_inv=np.linalg.inv(view), proj=proj,
                proj_inv=np.linalg.inv(proj), pos=eye, fovy=fovy,
                aspect=aspect)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(x):
    return torch.sqrt(_dot(x, x))


def _normalize(x):
    return x / torch.clamp_min(_norm(x), 1e-20)[..., None]


def _mat(m, v, rows=3):
    """(rows of) a small host matrix m times vectors v (..., k)."""
    k = v.shape[-1]
    return torch.stack([sum(float(m[r, j]) * v[..., j] for j in range(k))
                        for r in range(rows)], -1)


def camera_rays(cam: dict, width: int, height: int, dtype, device):
    """(origin, direction) (H*W, 3) through the pixel centers, row 0 at
    the top (raytrace.rgen.glsl:78-84)."""
    x = (torch.arange(width, device=device, dtype=dtype) + 0.5) / width
    y = (torch.arange(height, device=device, dtype=dtype) + 0.5) / height
    dy, dx = torch.meshgrid(y * 2.0 - 1.0, x * 2.0 - 1.0, indexing="ij")
    one = torch.ones_like(dx)
    ndc = torch.stack([dx, dy, one, one], -1).reshape(-1, 4)
    target = _normalize(_mat(cam["proj_inv"], ndc))
    direction = _mat(cam["view_inv"][:3, :3], target)
    origin = torch.tensor(cam["view_inv"][:3, 3], device=device,
                          dtype=dtype).expand_as(direction).contiguous()
    return origin, direction


# ------------------------------------------------------------- samplers --

def _texel(size_hw, uv):
    """Top-left texel (x0, y0) REPEAT-wrapped and weights fx, fy."""
    h, w = size_hw[:, 0], size_hw[:, 1]
    px = uv[:, 0] * w.to(uv.dtype) - 0.5
    py = uv[:, 1] * h.to(uv.dtype) - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0)[:, None], (py - y0)[:, None]
    return (torch.remainder(x0.to(torch.int64), w),
            torch.remainder(y0.to(torch.int64), h), fx, fy)


def _bilerp(fetch, x0, y0, w, h, fx, fy, dtype):
    x1, y1 = torch.remainder(x0 + 1, w), torch.remainder(y0 + 1, h)
    t00, t10 = fetch(y0, x0).to(dtype), fetch(y0, x1).to(dtype)
    t01, t11 = fetch(y1, x0).to(dtype), fetch(y1, x1).to(dtype)
    return (((t00 * (1 - fx) + t10 * fx) * (1 - fy)
             + (t01 * (1 - fx) + t11 * fx) * fy) / 255.0)


def sample_bilinear(t: dict, prim, layer: int, uv):
    """Bilinear REPEAT fetch of one layer of each primitive's image."""
    hw = t["tex_size"][prim]
    x0, y0, fx, fy = _texel(hw, uv)
    img = prim * 3 + layer
    stack = t["tex_stack"]
    return _bilerp(lambda y, x: stack[img, y, x], x0, y0, hw[:, 1], hw[:, 0],
                   fx, fy, uv.dtype)


def _sample_level(t: dict, prim, layer: int, uv, level):
    hw = t["mip_sizes"][prim, level]
    x0, y0, fx, fy = _texel(hw, uv)
    base = t["mip_offsets"][prim * 3 + layer, level]
    atlas, w = t["mip_atlas"], hw[:, 1]
    return _bilerp(lambda y, x: atlas[base + y * w + x], x0, y0, w,
                   hw[:, 0], fx, fy, uv.dtype)


def sample_trilinear(t: dict, prim, layer: int, uv, lod):
    """Bilinear at the two levels around the clamped LOD, lerped."""
    levels = t["mip_sizes"].shape[1]
    lod = torch.clamp(torch.nan_to_num(lod, nan=0.0), 0.0, levels - 1.0)
    l0 = torch.floor(lod)
    frac = (lod - l0)[:, None]
    l0 = l0.to(torch.int64)
    l1 = torch.clamp_max(l0 + 1, levels - 1)
    return (_sample_level(t, prim, layer, uv, l0) * (1 - frac)
            + _sample_level(t, prim, layer, uv, l1) * frac)


def sample_anisotropic(t: dict, prim, layer: int, uv, lod_minor,
                       duv_major, taps: int):
    acc = 0.0
    for i in range(taps):
        f = (i + 0.5) / taps - 0.5
        acc = acc + sample_trilinear(t, prim, layer, uv + duv_major * f,
                                     lod_minor)
    return acc / taps


def _texel_density(p, uvs, tex_w, tex_h):
    e1, e2 = p[1] - p[0], p[2] - p[0]
    world_area = 0.5 * _norm(torch.linalg.cross(e1, e2))
    duv1, duv2 = uvs[1] - uvs[0], uvs[2] - uvs[0]
    uv_area = 0.5 * torch.abs(duv1[:, 0] * duv2[:, 1]
                              - duv1[:, 1] * duv2[:, 0])
    tpw = torch.sqrt(uv_area * tex_w * tex_h
                     / torch.clamp_min(world_area, 1e-12))
    return tpw, e1, e2, duv1, duv2


def cone_lod(t_hit, d, n_geo, p, uvs, tex_w, tex_h, spread):
    """Isotropic ray-cone LOD."""
    cone = t_hit * spread
    foot = cone / torch.clamp_min(torch.abs(_dot(n_geo, d)), 0.25)
    tpw = _texel_density(p, uvs, tex_w, tex_h)[0]
    return torch.log2(torch.clamp_min(foot * tpw, 1e-6))


def cone_aniso(t_hit, d, n_geo, p, uvs, tex_w, tex_h, spread):
    """(minor-axis LOD, major axis in uv) of the elliptical footprint."""
    cone = t_hit * spread
    dn = _dot(n_geo, d)
    cos_in = torch.abs(dn)
    tpw, e1, e2, duv1, duv2 = _texel_density(p, uvs, tex_w, tex_h)
    lod = torch.log2(torch.clamp_min(cone * tpw, 1e-6))
    pdir = _normalize(d - dn[:, None] * n_geo)
    aniso = torch.clamp(1.0 / torch.clamp_min(cos_in, 1e-4), 1.0,
                        float(MAX_ANISO))
    major = cone * aniso
    g11, g12, g22 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
    r1, r2 = _dot(pdir, e1), _dot(pdir, e2)
    det = g11 * g22 - g12 * g12
    ok = (det > 1e-8 * g11 * g22)[:, None]
    a = (r1 * g22 - r2 * g12) / torch.clamp_min(det, 1e-30)
    b = (g11 * r2 - g12 * r1) / torch.clamp_min(det, 1e-30)
    duv = (a[:, None] * duv1 + b[:, None] * duv2) * major[:, None]
    return lod, torch.where(ok, duv, torch.zeros_like(duv))


# ----------------------------------------------------------------- BRDFs --

def _f_schlick1(f0, f90, x):
    return f0 + (f90 - f0) * (1.0 - x) ** 5.0


def _burley_local_sss(rough, ndv, nc_ndv, nc_ndl, ldh, ratio):
    f_ss90 = rough * ldh * ldh
    f_ss = _f_schlick1(1.0, f_ss90, nc_ndl) * _f_schlick1(1.0, f_ss90, nc_ndv)
    f_ss = (1.0 / (nc_ndv * nc_ndl) - 0.5) * f_ss + 0.5
    local = 1.25 * ratio * f_ss
    f90 = 0.5 + 2.0 * f_ss90
    diffuse = ((1.0 - ratio) * _f_schlick1(1.0, f90, nc_ndl)
               * _f_schlick1(1.0, f90, nc_ndv))
    return ndv * (diffuse + local) * (1.0 / PI)


# ---------------------------------------------------------------- lights --

def _barycentric(a, b, c, p):
    v0, v1, v2 = b - a, c - a, p - a
    d00, d01, d11 = _dot(v0, v0), _dot(v0, v1), _dot(v1, v1)
    d20, d21 = _dot(v2, v0), _dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    bx = (d11 * d20 - d01 * d21) / denom
    by = (d00 * d21 - d01 * d20) / denom
    return bx, by, 1.0 - bx - by


def _closest_on_segment(p0, p1, p):
    v = p1 - p0
    t = torch.clamp(_dot(p - p0, v) / _dot(v, v), 0.0, 1.0)
    return p0 + t[:, None] * v


def _closest_on_triangle(p0, p1, p2, p):
    bx, by, bz = _barycentric(p0, p1, p2, p)
    out = torch.where((bz < 0)[:, None], _closest_on_segment(p1, p2, p), p)
    return torch.where((bx < 0)[:, None], _closest_on_segment(p2, p0, p),
                       out)


def unnormalized_l(light: dict, pos):
    """light.glsl:93-124."""
    kind = light["type"]
    if kind in ("point", "spot"):
        return light["pos"] - pos
    if kind == "directional":
        return (-light["dir"] * 10.0).expand_as(pos)
    n, p1, p2, p3 = light["dir"], light["pos"], light["pos2"], light["pos3"]
    dist = _dot(n, p2) - _dot(pos, n.expand_as(pos))
    cp = pos + dist[:, None] * n
    bx, by, bz = _barycentric(p1, p2, p3, cp)
    out = torch.where((bz < 0)[:, None], _closest_on_segment(p2, p3, cp), cp)
    out = torch.where((by < 0)[:, None], _closest_on_segment(p1, p2, cp), out)
    p4 = p1 - p2 + p3
    out = torch.where((bx < 0)[:, None], _closest_on_triangle(p1, p3, p4, cp),
                      out)
    return out - pos


def radiance(light: dict, pos, L):
    """light.glsl:34-48."""
    rad = light["color"].expand_as(pos)
    if light["type"] in ("spot", "area"):
        cos_t = torch.clamp(-_dot(L, light["dir"].expand_as(L)), -1.0, 1.0)
        theta = torch.arccos(cos_t)
        t = torch.clamp((theta - light["umbra"])
                        / (light["penumbra"] - light["umbra"]), 0.0, 1.0)
        rad = rad * (t ** 2.0)[:, None]
    if light["falloff"] > 0.0:
        dist = _norm(light["pos"] - pos)
        fall = torch.clamp_min(1.0 - (dist / light["falloff"]) ** 2.0,
                               0.0) ** 2.0
        rad = rad * fall[:, None]
    return rad


def light_tensors(lights: list, dtype, device) -> list:
    """The configuration's lights as the shading reads them: unit
    directions (an area light's plane normal from its corners), angles in
    radians. Values pass through float32 first, as the lights are
    stated."""
    out = []
    for spec in lights:
        def v(x):
            return torch.tensor(np.asarray(x, np.float32), dtype=dtype,
                                device=device)
        kind = spec["type"]
        item = dict(type=kind, casts_shadows=bool(spec["casts_shadows"]),
                    color=v(spec["color"]), pos=v(spec.get("pos", [0, 0, 0])),
                    falloff=float(np.float32(spec.get("falloff", 0.0))))
        if kind in ("spot", "directional"):
            d = np.asarray(spec["dir"], np.float64)
            item["dir"] = v(d / np.linalg.norm(d))
        if kind in ("spot", "area"):
            item["penumbra"] = float(np.float32(np.radians(spec["penumbra_deg"])))
            item["umbra"] = float(np.float32(np.radians(spec["umbra_deg"])))
        if kind == "area":
            p1 = np.asarray(spec["pos"], np.float32)
            p2 = np.asarray(spec["pos2"], np.float32)
            p3 = np.asarray(spec["pos3"], np.float32)
            n = np.cross(p1 - p2, p3 - p2)
            if spec.get("invert_normal", False):
                n = -n
            item.update(dir=v(n / np.linalg.norm(n)), pos2=v(p2), pos3=v(p3))
        out.append(item)
    return out


# ---------------------------------------------------------------- shading --

def shade(t: dict, world: tuple, cam: dict, lights: list, hit: tuple,
          direction, *, rows: int, aniso_taps: int, any_hit):
    """The G-buffer of the primary hits: color (N, 3), view depth (N,),
    encoded view normal (N, 3), and `shadow_undecided` (N,), the hits with
    an undecided shadow ray. world = (vertex positions, normals, tangents);
    hit = (t, tri, u, v, undecided); any_hit(o, d, t_min, t_max) ->
    (occluded, undecided) traces the shadow rays."""
    vpos, vnrm, vtan = world
    t_hit, tri, u, v, _ = hit
    dtype = vpos.dtype
    valid = tri >= 0
    k = torch.clamp_min(tri, 0)
    vid = t["idx"][k]
    prim = t["prim"][k]
    wb, ub, vb = (1.0 - u - v)[:, None], u[:, None], v[:, None]

    def interp(table):
        return table[vid[:, 0]] * wb + table[vid[:, 1]] * ub \
            + table[vid[:, 2]] * vb

    world_pos = interp(vpos)
    uv = interp(t["uv"])
    n_geo = _normalize(interp(vnrm))
    tangent = _normalize(interp(vtan))
    tangent = _normalize(tangent - _dot(tangent, n_geo)[:, None] * n_geo)
    binormal = torch.linalg.cross(n_geo, tangent)

    if "mip_atlas" in t:
        hw = t["mip_sizes"][prim, 0].to(dtype)
        p = [vpos[vid[:, i]] for i in range(3)]
        uvs = [t["uv"][vid[:, i]] for i in range(3)]
        spread = 2.0 / (float(cam["proj"][1, 1]) * rows)
        cone = (t_hit, direction, n_geo, p, uvs, hw[:, 1], hw[:, 0], spread)
        if aniso_taps > 1:
            lod, duv = cone_aniso(*cone)

            def fetch(layer):
                return sample_anisotropic(t, prim, layer, uv, lod, duv,
                                          aniso_taps)
        else:
            lod = cone_lod(*cone)

            def fetch(layer):
                return sample_trilinear(t, prim, layer, uv, lod)
    else:
        def fetch(layer):
            return sample_bilinear(t, prim, layer, uv)

    nmap = fetch(2)
    n_ts = _normalize(nmap[:, :3] * 2.0 - 1.0)
    N = _normalize(n_ts[:, 0:1] * tangent + n_ts[:, 1:2] * binormal
                   + n_ts[:, 2:3] * n_geo)
    albedo = fetch(0)[:, :3] ** 2.2
    orm = fetch(1)
    rough, metal = orm[:, 1], orm[:, 2]

    cam_pos = torch.tensor(cam["pos"], dtype=dtype, device=vpos.device)
    V = _normalize(cam_pos - world_pos)
    F0 = 0.04 * (1.0 - metal[:, None]) + albedo * metal[:, None]
    cr = rough * rough
    nc_ndv = _dot(N, V)
    ndv = torch.clamp(nc_ndv, 1e-5, 1.0)

    rho = torch.zeros_like(world_pos)
    shadow_undecided = torch.zeros_like(valid)
    for light in lights:
        nn_l = unnormalized_l(light, world_pos)
        l_len = _norm(nn_l)
        L = nn_l / torch.clamp_min(l_len, 1e-20)[:, None]
        H = _normalize(V + L)
        nc_ndl = _dot(N, L)
        ndl = torch.clamp(nc_ndl, 0.0, 1.0)
        ndh = torch.clamp(_dot(N, H), 0.0, 1.0)
        ldh = torch.clamp(_dot(L, H), 0.0, 1.0)
        ks = F0 + (1.0 - F0) * (1.0 - ldh[:, None]) ** 5.0
        kd = (1.0 - metal[:, None]) * albedo
        one_minus = 1.0 - ndh * ndh
        a = ndh * cr
        dk = cr / (one_minus + a * a)
        D = dk * dk * (1.0 / PI)
        G = 0.5 / ((2 * ndl * ndv) * (1 - cr) + (ndl + ndv) * cr)
        rho_s = (D * G)[:, None] * ks
        rho_d = kd * _burley_local_sss(cr, ndv, nc_ndv, nc_ndl, ldh,
                                       LOCAL_SSS_RATIO)[:, None]
        att = torch.ones_like(ndl)
        wants = valid & (nc_ndl > 0)
        if light["casts_shadows"] and bool(wants.any()):
            sel = torch.nonzero(wants, as_tuple=True)[0]
            occ, und = any_hit(world_pos[sel], L[sel], SHADOW_T_MIN,
                               l_len[sel])
            att[sel[occ]] = SHADOW_ATTENUATION
            shadow_undecided[sel[und]] = True
        rho = rho + (rho_s + rho_d) * radiance(light, world_pos, L) \
            * (att * ndl)[:, None]

    view = cam["view"]
    color = torch.where(valid[:, None], rho, torch.zeros_like(rho))
    view_z = _mat(view[2:3, :3], world_pos, 1)[:, 0] + float(view[2, 3])
    depth = torch.where(valid, -view_z, torch.full_like(view_z, T_MAX))
    nv = _mat(view[:3, :3], N)
    nv = nv * torch.tensor([1.0, -1.0, -1.0], dtype=dtype, device=nv.device)
    nenc = _normalize(nv) * 0.5 + 0.5
    nenc = torch.where(valid[:, None], nenc, torch.full_like(nenc, 0.5))
    return dict(color=color, depth=depth, normal_enc=nenc,
                shadow_undecided=shadow_undecided)
