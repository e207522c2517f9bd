"""Independent reference oracle: a pure-numpy renderer implementing the
Vulkan reference's shader math DIRECTLY from the GLSL sources — brute-force
ray/triangle intersection, no tpurt trace/shade code anywhere.

Sources re-derived (file:line in the reference's src/vk_renderer/shaders):
  * camera rays + shading loop  rt_lightning_shadows/raytrace.rgen.glsl:77-199
  * light radiance / L vectors  rt_lightning_shadows/light.glsl:34-124
  * BRDFs                       brdfs.glsl:6-99

It consumes the same *data* tables as the framework (vertex/index/texture
arrays are inputs, not implementation) but shares zero rendering code, so a
match is evidence the pipeline implements the reference's math — the ≤1%
RMSE gate of BASELINE.json, previously only self-referential.
"""
from __future__ import annotations

import numpy as np

PI = 3.14159265359
T_MIN = 0.001
T_MAX = 10000.0
SHADOW_T_MIN = 0.01
SHADOW_ATTENUATION = 0.05
LOCAL_SSS_RATIO = 0.4


# ----------------------------------------------------------- intersection --

def _moeller_trumbore(orig, d, v0, v1, v2, t_min, t_max):
    """Brute force: orig/d (N,3), v0/v1/v2 (T,3), scalar t_min/t_max ->
    per-ray closest (t, tri, u, v). Pure numpy, O(N*T)."""
    e1 = (v1 - v0)[None, :, :]            # (1, T, 3)
    e2 = (v2 - v0)[None, :, :]
    dN = d[:, None, :]                     # (N, 1, 3)
    p = np.cross(dN, e2)                   # (N, T, 3)
    det = np.einsum("ntk,ntk->nt", np.broadcast_to(e1, p.shape), p)
    valid = np.abs(det) > 1e-12
    inv_det = np.where(valid, 1.0 / np.where(valid, det, 1.0), 0.0)
    tvec = orig[:, None, :] - v0[None, :, :]
    u = np.einsum("ntk,ntk->nt", tvec, p) * inv_det
    q = np.cross(tvec, np.broadcast_to(e1, tvec.shape))
    v = np.einsum("ntk,ntk->nt", np.broadcast_to(dN, q.shape), q) * inv_det
    t = np.einsum("ntk,ntk->nt", np.broadcast_to(e2, q.shape), q) * inv_det
    hit = (valid & (u >= 0) & (v >= 0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    t_all = np.where(hit, t, np.inf)
    best = np.argmin(t_all, axis=1)
    rows = np.arange(len(orig))
    best_t = t_all[rows, best]
    found = np.isfinite(best_t)
    return (np.where(found, best_t, t_max),
            np.where(found, best, -1),
            np.where(found, u[rows, best], 0.0),
            np.where(found, v[rows, best], 0.0))


def _any_hit(orig, d, v0, v1, v2, t_min, t_max):
    e1 = (v1 - v0)[None, :, :]
    e2 = (v2 - v0)[None, :, :]
    dN = d[:, None, :]
    p = np.cross(dN, e2)
    det = np.einsum("ntk,ntk->nt", np.broadcast_to(e1, p.shape), p)
    valid = np.abs(det) > 1e-12
    inv_det = np.where(valid, 1.0 / np.where(valid, det, 1.0), 0.0)
    tvec = orig[:, None, :] - v0[None, :, :]
    u = np.einsum("ntk,ntk->nt", tvec, p) * inv_det
    q = np.cross(tvec, np.broadcast_to(e1, tvec.shape))
    v = np.einsum("ntk,ntk->nt", np.broadcast_to(dN, q.shape), q) * inv_det
    t = np.einsum("ntk,ntk->nt", np.broadcast_to(e2, q.shape), q) * inv_det
    hit = (valid & (u >= 0) & (v >= 0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max[:, None]))
    return hit.any(axis=1)


# --------------------------------------------------------------- sampling --

def _sample_layer(tex_stack, tex_size, prim, layer, uv):
    """Bilinear REPEAT fetch from the (P*3, H, W, 4) stack — the reference's
    trilinear aniso sampler reduces to bilinear with 1 allocated mip
    (vk_rt_descriptor_set.rs:76-97, image_mip_levels=1)."""
    hw = tex_size[prim].astype(np.float64)        # (N, 2) h, w
    h, w = hw[:, 0], hw[:, 1]
    px = uv[:, 0] * w - 0.5
    py = uv[:, 1] * h - 0.5
    x0 = np.floor(px)
    y0 = np.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    hi = tex_size[prim][:, 0]
    wi = tex_size[prim][:, 1]
    x0i = np.mod(x0.astype(np.int64), wi)
    y0i = np.mod(y0.astype(np.int64), hi)
    x1i = np.mod(x0i + 1, wi)
    y1i = np.mod(y0i + 1, hi)
    img = prim * 3 + layer
    t00 = tex_stack[img, y0i, x0i].astype(np.float64)
    t10 = tex_stack[img, y0i, x1i].astype(np.float64)
    t01 = tex_stack[img, y1i, x0i].astype(np.float64)
    t11 = tex_stack[img, y1i, x1i].astype(np.float64)
    out = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
           + (t01 * (1 - fx) + t11 * fx) * fy)
    return out / 255.0


def _normalize(x, axis=-1):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-20)


# ------------------------------------------------------------------ BRDFs --

def _d_ggx(roughness, NdotH):
    """brdfs.glsl:6-14."""
    one_minus = 1.0 - NdotH * NdotH
    a = NdotH * roughness
    k = roughness / (one_minus + a * a)
    return k * k * (1.0 / PI)


def _v_smith_fast(roughness, NdotV, NdotL):
    """brdfs.glsl:25-29 (Hammon)."""
    lerped = (2 * NdotL * NdotV) * (1 - roughness) + (NdotL + NdotV) * roughness
    return 0.5 / lerped


def _f_schlick3(F0, HdotV):
    """brdfs.glsl:31-33."""
    return F0 + (1.0 - F0) * (1.0 - HdotV[:, None]) ** 5.0


def _f_schlick1(F0, F90, x):
    """brdfs.glsl:40-42."""
    return F0 + (F90 - F0) * (1.0 - x) ** 5.0


def _burley_local_sss(roughness, NdotV, nc_NdotV, nc_NdotL, LdotH, ratio):
    """brdfs.glsl:89-99."""
    F_SS90 = roughness * LdotH * LdotH
    F_SS = _f_schlick1(1.0, F_SS90, nc_NdotL) * _f_schlick1(1.0, F_SS90, nc_NdotV)
    f_ss = (1.0 / (nc_NdotV * nc_NdotL) - 0.5) * F_SS + 0.5
    local_sss = 1.25 * ratio * f_ss
    f90 = 0.5 + 2.0 * F_SS90
    diffuse = ((1.0 - ratio) * _f_schlick1(1.0, f90, nc_NdotL)
               * _f_schlick1(1.0, f90, nc_NdotV))
    return NdotV * (diffuse + local_sss) * (1.0 / PI)


# ----------------------------------------------------------------- lights --

def _compute_barycentric(a, b, c, p):
    """light.glsl:50-67, vectorized over p (N,3)."""
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = np.dot(v0, v0)
    d01 = np.dot(v0, v1)
    d11 = np.dot(v1, v1)
    d20 = v2 @ v0
    d21 = v2 @ v1
    denom = d00 * d11 - d01 * d01
    bx = (d11 * d20 - d01 * d21) / denom
    by = (d00 * d21 - d01 * d20) / denom
    return bx, by, 1.0 - bx - by


def _closest_point_to_segment(p0, p1, p):
    """light.glsl:69-74."""
    v01 = p1 - p0
    t = np.clip((p - p0) @ v01 / np.dot(v01, v01), 0.0, 1.0)
    return p0 + t[:, None] * v01


def _closest_point_to_triangle(p0, p1, p2, point):
    """light.glsl:76-91."""
    bx, by, bz = _compute_barycentric(p0, p1, p2, point)
    out = point.copy()
    m = bz < 0
    out[m] = _closest_point_to_segment(p1, p2, point[m])
    m = bx < 0  # checked first in the GLSL, so it wins overlaps
    out[m] = _closest_point_to_segment(p2, p0, point[m])
    return out


def _unnormalized_L(light, pos):
    """light.glsl:93-124. light: dict of scalars/vec3; pos (N,3)."""
    ltype = int(light["type"])
    if ltype in (0, 1):     # point / spot
        return light["pos"][None, :] - pos
    if ltype == 2:          # directional
        return np.broadcast_to(-light["dir"] * 10.0, pos.shape).copy()
    # area: closest point on the bounded plane rectangle
    n = light["dir"]
    distance = np.dot(n, light["area_pos2"]) - pos @ n
    cp = pos + distance[:, None] * n[None, :]
    bx, by, bz = _compute_barycentric(light["pos"], light["area_pos2"],
                                      light["area_pos3"], cp)
    out = cp.copy()
    m = bz < 0
    out[m] = _closest_point_to_segment(light["area_pos2"], light["area_pos3"],
                                       cp[m])
    m = by < 0
    out[m] = _closest_point_to_segment(light["pos"], light["area_pos2"], cp[m])
    m = bx < 0  # first branch in the GLSL wins
    pos4 = light["pos"] - light["area_pos2"] + light["area_pos3"]
    out[m] = _closest_point_to_triangle(light["pos"], light["area_pos3"],
                                        pos4, cp[m])
    return out - pos


def _radiance(light, pos, L):
    """light.glsl:34-48."""
    radiance = np.broadcast_to(light["color"], pos.shape).astype(np.float64)
    ltype = int(light["type"])
    if ltype in (1, 3):     # spot / area: penumbra->umbra falloff
        cos_t = np.clip(-(L @ light["dir"]), -1.0, 1.0)
        theta_s = np.arccos(cos_t)
        t = np.clip((theta_s - light["umbra"]) /
                    (light["penumbra"] - light["umbra"]), 0.0, 1.0)
        radiance = radiance * (t ** 2.0)[:, None]
    if light["falloff"] > 0.0:
        dist = np.linalg.norm(light["pos"][None, :] - pos, axis=1)
        fall = np.maximum(1.0 - (dist / light["falloff"]) ** 2.0, 0.0) ** 2.0
        radiance = radiance * fall[:, None]
    return radiance


def _lights_rows(lights_arrays):
    """Split the framework's struct-of-arrays light dict into per-light
    dicts (pure data reshuffling)."""
    out = []
    n = len(lights_arrays["pos"])
    for i in range(n):
        if lights_arrays.get("active") is not None \
                and float(lights_arrays["active"][i]) == 0.0:
            continue
        out.append(dict(
            pos=np.asarray(lights_arrays["pos"][i], np.float64),
            type=int(lights_arrays["light_type"][i]),
            dir=np.asarray(lights_arrays["dir"][i], np.float64),
            casts_shadows=int(lights_arrays["casts_shadows"][i]),
            color=np.asarray(lights_arrays["color"][i], np.float64),
            falloff=float(lights_arrays["falloff_distance"][i]),
            area_pos2=np.asarray(lights_arrays["area_pos2"][i], np.float64),
            penumbra=float(lights_arrays["penumbra_angle"][i]),
            area_pos3=np.asarray(lights_arrays["area_pos3"][i], np.float64),
            umbra=float(lights_arrays["umbra_angle"][i]),
        ))
    return out


# ------------------------------------------------------------------ frame --

def oracle_render(scene: dict, camera: dict, lights_arrays: dict,
                  width: int, height: int):
    """Render linear HDR color + view depth + encoded normals exactly per
    raytrace.rgen.glsl:77-199, brute force. scene: data tables (tri_vertex,
    tri_prim, vtx_pos/uv/normal/tangent (world space), tex_stack, tex_size).
    Returns dict(color (H,W,3) f64, depth (H,W), normal_enc (H,W,3))."""
    view = np.asarray(camera["view"], np.float64)
    view_inv = np.asarray(camera["view_inv"], np.float64)
    proj_inv = np.asarray(camera["proj_inv"], np.float64)
    camera_pos = np.asarray(camera["camera_pos"], np.float64)

    tv = np.asarray(scene["tri_vertex"])
    vp = np.asarray(scene["vtx_pos"], np.float64)
    tri_v0 = vp[tv[:, 0]]
    tri_v1 = vp[tv[:, 1]]
    tri_v2 = vp[tv[:, 2]]

    # rgen.glsl:78-84 camera rays
    px = (np.arange(width) + 0.5) / width * 2.0 - 1.0
    py = (np.arange(height) + 0.5) / height * 2.0 - 1.0
    dx, dy = np.meshgrid(px, py)
    ndc = np.stack([dx, dy, np.ones_like(dx), np.ones_like(dx)], axis=-1)
    target = ndc.reshape(-1, 4) @ proj_inv.T
    tgt = _normalize(target[:, :3])
    direction = tgt @ view_inv[:3, :3].T
    origin = np.broadcast_to(view_inv[:3, 3], direction.shape).copy()
    n_rays = len(origin)

    t, tri, u, v = _moeller_trumbore(origin, direction, tri_v0, tri_v1,
                                     tri_v2, T_MIN, np.float64(T_MAX))
    valid = tri >= 0
    tidx = np.maximum(tri, 0)

    vids = tv[tidx]
    prim = np.asarray(scene["tri_prim"])[tidx]
    w_b = (1.0 - u - v)[:, None]
    u_b = u[:, None]
    v_b = v[:, None]

    def interp(table):
        tb = np.asarray(table, np.float64)
        return tb[vids[:, 0]] * w_b + tb[vids[:, 1]] * u_b + tb[vids[:, 2]] * v_b

    world_pos = interp(scene["vtx_pos"])
    tex_coord = interp(scene["vtx_uv"])
    world_normal = _normalize(interp(scene["vtx_normal"]))
    tan = np.asarray(scene["vtx_tangent"], np.float64)
    world_tangent = _normalize(tan[vids[:, 0], :3] * w_b
                               + tan[vids[:, 1], :3] * u_b
                               + tan[vids[:, 2], :3] * v_b)
    # rgen.glsl:128-131 Gram-Schmidt + handedness from v0.tangent.w
    world_tangent = _normalize(
        world_tangent - np.sum(world_tangent * world_normal, -1, keepdims=True)
        * world_normal)
    world_binormal = np.cross(world_normal, world_tangent) * tan[vids[:, 0], 3:4]

    tex_stack = np.asarray(scene["tex_stack"])
    tex_size = np.asarray(scene["tex_size"])
    nmap = _sample_layer(tex_stack, tex_size, prim, 2, tex_coord)
    N_ts = _normalize(nmap[:, :3] * 2.0 - 1.0)
    N = _normalize(N_ts[:, 0:1] * world_tangent + N_ts[:, 1:2] * world_binormal
                   + N_ts[:, 2:3] * world_normal)

    albedo = _sample_layer(tex_stack, tex_size, prim, 0, tex_coord)[:, :3] ** 2.2
    orm = _sample_layer(tex_stack, tex_size, prim, 1, tex_coord)
    roughness = orm[:, 1]
    metallic = orm[:, 2]

    V = _normalize(camera_pos[None, :] - world_pos)
    F0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
    corrected_roughness = roughness * roughness
    nc_NdotV = np.sum(N * V, axis=-1)
    NdotV = np.clip(nc_NdotV, 1e-5, 1.0)

    rho = np.zeros((n_rays, 3))
    for light in _lights_rows(lights_arrays):
        nn_L = _unnormalized_L(light, world_pos)
        L_len = np.linalg.norm(nn_L, axis=-1)
        L = nn_L / np.maximum(L_len, 1e-20)[:, None]
        H = _normalize(V + L)
        nc_NdotL = np.sum(N * L, axis=-1)
        NdotL = np.clip(nc_NdotL, 0.0, 1.0)
        NdotH = np.clip(np.sum(N * H, axis=-1), 0.0, 1.0)
        LdotH = np.clip(np.sum(L * H, axis=-1), 0.0, 1.0)

        Ks = _f_schlick3(F0, LdotH)
        Kd = (1.0 - metallic[:, None]) * albedo
        D = _d_ggx(corrected_roughness, NdotH)
        G = _v_smith_fast(corrected_roughness, NdotV, NdotL)
        rho_s = (D * G)[:, None] * Ks
        rho_d = Kd * _burley_local_sss(corrected_roughness, NdotV, nc_NdotV,
                                       nc_NdotL, LdotH, LOCAL_SSS_RATIO)[:, None]

        shadow_attenuation = np.ones(n_rays)
        wants = valid & (light["casts_shadows"] > 0) & (nc_NdotL > 0)
        if wants.any():
            occ = _any_hit(world_pos[wants], L[wants], tri_v0, tri_v1, tri_v2,
                           SHADOW_T_MIN, L_len[wants])
            att = shadow_attenuation[wants]
            att[occ] = SHADOW_ATTENUATION
            shadow_attenuation[wants] = att

        radiance = _radiance(light, world_pos, L)
        rho += (rho_s + rho_d) * radiance * (shadow_attenuation * NdotL)[:, None]

    out_color = np.where(valid[:, None], rho, 0.0)
    view_z = world_pos @ view[2, :3] + view[2, 3]
    out_depth = np.where(valid, -view_z, T_MAX)
    normal_view = N @ view[:3, :3].T
    normal_view = normal_view * np.array([1.0, -1.0, -1.0])
    normal_enc = _normalize(normal_view) * 0.5 + 0.5
    out_normal = np.where(valid[:, None], normal_enc, 0.5)

    return dict(color=out_color.reshape(height, width, 3),
                depth=out_depth.reshape(height, width),
                normal_enc=out_normal.reshape(height, width, 3))
