"""Primary-hit shading — port of ``tpurt/passes/shade.py:shade`` on its
``tri_attr`` + ``tex_quad48`` tables, with its per-light and fused shadows.

Per hit: one ``tri_attr`` row gives the three corners' position, uv,
normal and tangent; barycentric interpolation; Gram-Schmidt TBN; one quad
row gives the whole 2x2 bilinear footprint of albedo, ORM and normal map.
When the closest-hit trace emitted the uv payload (hit keys ``texu``,
``texv``, ``img``, ``texh``, ``texw``: ``trace_closest_bvh8(uv_payload=
True)``), the quad index reads them instead of the ``tri_attr`` row
(tpurt ``shade.py:703-708``); the values are bit-equal. Outputs the
unquantized G-buffer: color, view depth, encoded view normal.

The light schedule (tpurt ``shade.py:747-804``): a pre-pass builds every
light's L vector and shadow ray (lanes that need no ray get ``t_max = 0``);
then, per light, the GGX + Burley BRDF math, the any-hit trace and the
radiance accumulation. With ``fuse_shadows=True``, the BVH8 tables and
more than one light, one fused multi-set trace (K5,
``trace_any_bvh8_multi``) covers every light instead of the per-light
traces, bit-equal to them. tpurt's frame never sets it; a fused frame is
``engine/frame.render_frame_fused``. tpurt's ``light_eval="hoist"`` /
``"batch"`` schedules, which only steer XLA's scheduling and give the
loop's bits, are not ported.

``tables`` picks the shadow tracer as tpurt's ``pallas_tables`` /
``max_leaf`` do (``tpurt/passes/shade.py:526-528, 867-872``): "bvh8" for
the BVH8 rows (K2: static and refit frames), "bvh2" for a binary BVH (K6
any-hit, leaves of up to ``max_leaf`` triangles: the rebuild frames, which
never fuse). tpurt's sharded-geometry hook ``shadow_trace_multi_fn`` is not
ported yet.
"""
from __future__ import annotations

import torch

from ..kernels.traverse_bvh2 import trace_any_bvh2
from ..kernels.traverse_bvh8 import trace_any_bvh8, trace_any_bvh8_multi
from . import brdf
from .encodings import divide, sqrt
from .light import get_light_radiance, get_unnormalized_L_vec

LOCAL_SSS_RATIO = 0.4
SHADOW_T_MIN = 0.01
SHADOW_ATTENUATION = 0.05
MISS_DEPTH = 10000.0


def _dot(a, b):
    """Left-to-right 3-term dot product: the same sum on every device (a
    library reduction may order the three terms differently)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _norm(v):
    return sqrt(_dot(v, v))[..., None]


def _normalize(v, eps=1e-20):
    return v / torch.clamp_min(_norm(v), eps)


def sample_bilinear_quad(quad, quad_shape, hw, img, uv):
    """Bilinear REPEAT fetch from quad rows: each (rows, 64) u8 row carries
    its texel's 2x2 footprint across the 3 packed layers (bytes 0..47).
    hw: (N, 2) f32 (h, w) extents; img: (N,) unique-image slot."""
    _, H, W, _ = quad_shape
    h = hw[:, 0]
    w = hw[:, 1]
    px = uv[:, 0] * w - 0.5
    py = uv[:, 1] * h - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int32), w.to(torch.int32))
    y0i = torch.remainder(y0.to(torch.int32), h.to(torch.int32))
    flat = (img.long() * H + y0i) * W + x0i
    row = quad[flat].to(torch.float32)
    t00, t10, t01, t11 = (row[:, 0:12], row[:, 12:24], row[:, 24:36],
                          row[:, 36:48])
    out = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
           + (t01 * (1 - fx) + t11 * fx) * fy)
    return divide(out, 255.0)


def surface(scene: dict, camera: dict, hits: dict) -> dict:
    """Reconstruct the shading point of each hit: position, shading normal
    N, view vector V and the material terms."""
    tri = hits["tri"]
    valid = tri >= 0
    tidx = torch.clamp_min(tri, 0).long()

    u = hits["u"][:, None]
    v = hits["v"][:, None]
    w = 1.0 - u - v

    attr = scene["tri_attr"][tidx]                     # (N, 40)
    p0, p1, p2 = attr[:, 0:3], attr[:, 12:15], attr[:, 24:27]
    uv0, uv1, uv2 = attr[:, 3:5], attr[:, 15:17], attr[:, 27:29]
    n0, n1, n2 = attr[:, 5:8], attr[:, 17:20], attr[:, 29:32]
    t0, t1, t2 = attr[:, 8:12], attr[:, 20:24], attr[:, 32:36]
    if "texu" in hits:
        # the closest-hit trace's uv payload: the quad gather no longer
        # waits on the tri_attr row
        tex_hw = torch.stack([hits["texh"], hits["texw"]], dim=-1)
        img = hits["img"].to(torch.int32)
    else:
        tex_hw = attr[:, 37:39]
        img = attr[:, 39].to(torch.int32)

    world_pos = p0 * w + p1 * u + p2 * v
    tex_coord = uv0 * w + uv1 * u + uv2 * v
    world_normal = _normalize(n0 * w + n1 * u + n2 * v)
    world_tangent = _normalize(t0[:, :3] * w + t1[:, :3] * u + t2[:, :3] * v)
    world_tangent = _normalize(
        world_tangent
        - _dot(world_tangent, world_normal)[:, None] * world_normal)
    world_binormal = torch.linalg.cross(world_normal, world_tangent) \
        * t0[:, 3:4]

    quad_uv = torch.stack([hits["texu"], hits["texv"]], dim=-1) \
        if "texu" in hits else tex_coord
    packed = sample_bilinear_quad(scene["tex_quad"], scene["tex_quad_shape"],
                                  tex_hw, img, quad_uv)

    def fetch(layer):
        return packed[:, layer * 4:layer * 4 + 4]

    nmap = fetch(2)
    N_ts = _normalize(nmap[:, :3] * 2.0 - 1.0)
    N = _normalize(N_ts[:, 0:1] * world_tangent
                   + N_ts[:, 1:2] * world_binormal
                   + N_ts[:, 2:3] * world_normal)

    orm = fetch(1)
    return dict(valid=valid, world_pos=world_pos.contiguous(), N=N,
                V=_normalize(camera["camera_pos"][None, :] - world_pos),
                albedo=torch.pow(fetch(0)[:, :3], 2.2),
                roughness=orm[:, 1], metallic=orm[:, 2])


def light_ray(surf: dict, light: dict) -> dict:
    """The normalized light vector and the shadow ray toward one light;
    lanes that need no ray get t_max = 0 (the kernel retires them at
    once)."""
    nn_L = get_unnormalized_L_vec(light, surf["world_pos"])
    L_len = _norm(nn_L)[:, 0]
    L = nn_L / torch.clamp_min(L_len, 1e-20)[:, None]
    nc_NdotL = _dot(surf["N"], L)
    wants_shadow = (surf["valid"] & (light["casts_shadows"] > 0)
                    & (nc_NdotL > 0))
    t_max = torch.where(wants_shadow, L_len, torch.zeros_like(L_len))
    return dict(L=L.contiguous(), nc_NdotL=nc_NdotL,
                wants_shadow=wants_shadow, t_max=t_max)


def shadow_rays(scene: dict, camera: dict, lights: dict, hits: dict):
    """(origin, direction, t_max) of every light's shadow rays, exactly as
    shade() traces them."""
    surf = surface(scene, camera, hits)
    rays = []
    for i in range(lights["pos"].shape[0]):
        lr = light_ray(surf, {k: arr[i] for k, arr in lights.items()})
        rays.append((surf["world_pos"], lr["L"], lr["t_max"]))
    return rays


def shadow_tracer(tables: str, max_leaf: int = 1):
    """The any-hit tracer of a table kind: (scene, origin, direction,
    t_min, t_max, height=, width=) -> (N,) bool."""
    if tables == "bvh8":
        return trace_any_bvh8
    if tables == "bvh2":
        return lambda *args, height=0, width=0: trace_any_bvh2(
            *args, max_leaf=max_leaf, height=height, width=width)
    raise ValueError(f"unknown shadow tables {tables!r}")


def _light(lights: dict, i: int) -> dict:
    return {k: arr[i] for k, arr in lights.items()}


def shade(scene: dict, camera: dict, lights: dict, hits: dict,
          tables: str = "bvh8", max_leaf: int = 1,
          fuse_shadows: bool = False, height: int = 0, width: int = 0):
    """Shade one batch of primary hits; returns dict(color (N, 3),
    depth (N,), normal_enc (N, 3)). fuse_shadows as in the module
    docstring (tpurt's parameter and default); height and width, tpurt's
    too, the frame's shape when the hits are its pixels in row order (0
    otherwise), go to the shadow traces (per light or fused)."""
    trace_any = shadow_tracer(tables, max_leaf)
    surf = surface(scene, camera, hits)
    N, V, albedo = surf["N"], surf["V"], surf["albedo"]
    world_pos = surf["world_pos"]
    metallic = surf["metallic"]
    F0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
    corrected_roughness = surf["roughness"] * surf["roughness"]

    nc_NdotV = _dot(N, V)
    NdotV = torch.clamp(nc_NdotV, 1e-5, 1.0)

    # pre-pass: every light's L vector and shadow ray, so that all shadow
    # rays can go out in one fused launch
    num_lights = lights["pos"].shape[0]
    pre = [light_ray(surf, _light(lights, i)) for i in range(num_lights)]

    occ_all = None
    if fuse_shadows and tables == "bvh8" and num_lights > 1:
        occ_all = trace_any_bvh8_multi(scene, world_pos,
                                       [p["L"] for p in pre], SHADOW_T_MIN,
                                       [p["t_max"] for p in pre],
                                       height=height, width=width)

    rho = torch.zeros_like(albedo)
    for i, lr in enumerate(pre):
        light = _light(lights, i)
        L, nc_NdotL = lr["L"], lr["nc_NdotL"]
        H = _normalize(V + L)

        NdotL = torch.clamp(nc_NdotL, 0.0, 1.0)
        NdotH = torch.clamp(_dot(N, H), 0.0, 1.0)
        LdotH = torch.clamp(_dot(L, H), 0.0, 1.0)

        Ks = brdf.f_schlick(F0, LdotH)
        Kd = (1.0 - metallic[:, None]) * albedo
        rho_s = brdf.cook_torrance_specular(NdotL, NdotV, NdotH,
                                            corrected_roughness, Ks)
        rho_d = Kd * brdf.burley_diffuse_local_sss(
            corrected_roughness, NdotV, nc_NdotV, nc_NdotL, LdotH,
            LOCAL_SSS_RATIO)[..., None]

        occluded = occ_all[i] if occ_all is not None else trace_any(
            scene, world_pos, L, SHADOW_T_MIN, lr["t_max"], height=height,
            width=width)
        attenuation = torch.where(lr["wants_shadow"] & occluded,
                                  torch.full_like(NdotL, SHADOW_ATTENUATION),
                                  torch.ones_like(NdotL))
        radiance = get_light_radiance(light, world_pos, L)
        rho = rho + ((rho_s + rho_d) * radiance
                     * (attenuation * NdotL * light["active"])[..., None])

    return _shade_outputs(rho, surf["valid"], camera, world_pos, N)


def _shade_outputs(rho, valid, camera, world_pos, N):
    """G-buffer encode: color, view depth -(view * P).z, view normal *0.5+0.5
    with y and z negated."""
    out_color = torch.where(valid[:, None], rho, torch.zeros_like(rho))

    view = camera["view"]

    def row(i, p):
        return p[:, 0] * view[i, 0] + p[:, 1] * view[i, 1] \
            + p[:, 2] * view[i, 2]

    view_z = row(2, world_pos) + view[2, 3]
    out_depth = torch.where(valid, -view_z,
                            torch.full_like(view_z, MISS_DEPTH))

    normal_view = torch.stack([row(0, N), -row(1, N), -row(2, N)], dim=-1)
    normal_enc = _normalize(normal_view) * 0.5 + 0.5
    out_normal = torch.where(valid[:, None], normal_enc,
                             torch.full_like(normal_enc, 0.5))
    return dict(color=out_color, depth=out_depth, normal_enc=out_normal)
