"""Shade's light loop (K8): the pre-pass and the sum around the shadow
traces.

``light_rays`` (K8a) gives every light's normalized L vector, N.L, whether
each lane wants a shadow ray and the ray's t_max (0 where it wants none);
``light_sum`` (K8b) takes those and each light's occlusion mask and sums
the lights' GGX + Burley BRDF times radiance and shadow attenuation into
rho. On CUDA tensors each is one launch of ``csrc/shade_lights.cu`` (the
sum one launch per ``OCC_CHUNK`` lights); on CPU tensors
:func:`light_rays_plain` and :func:`light_sum_plain` run instead, the
chain that ``passes/shade.py`` ran per light (``passes/light.py``,
``passes/brdf.py``), bit-equal to the kernels on the card. tpurt has no
kernel here: its loop is XLA code (``tpurt/passes/shade.py:747-804``).
"""
from __future__ import annotations

import ctypes

import torch

from ..passes import brdf
from ..passes.encodings import sqrt
from ..passes.light import _dot, get_light_radiance, get_unnormalized_L_vec
from . import build

LOCAL_SSS_RATIO = 0.4
SHADOW_ATTENUATION = 0.05
# occlusion masks one K8b launch takes (csrc/shade_lights.cu OCC_CHUNK)
OCC_CHUNK = 32
# engine/convert.light_tensors' arrays the kernels read, by dtype and row
LIGHT_KEYS = {"pos": (torch.float32, 3), "dir": (torch.float32, 3),
              "color": (torch.float32, 3), "area_pos2": (torch.float32, 3),
              "area_pos3": (torch.float32, 3),
              "falloff_distance": (torch.float32, 0),
              "penumbra_angle": (torch.float32, 0),
              "umbra_angle": (torch.float32, 0),
              "active": (torch.float32, 0), "light_type": (torch.int32, 0),
              "casts_shadows": (torch.int32, 0)}
RAY_KEYS = ("L", "nc_NdotL", "wants_shadow", "t_max")


def _light(lights: dict, i: int) -> dict:
    return {k: arr[i] for k, arr in lights.items()}


def light_rays_plain(world_pos, N, valid, lights: dict) -> dict:
    """Plain PyTorch version of K8a on any device: per light the normalized
    L, nc_NdotL = N.L, wants_shadow = valid & casts_shadows & N.L > 0, and
    t_max, |L| where the lane wants a shadow ray and 0 elsewhere, stacked
    (S, N, 3), (S, N), (S, N) bool, (S, N)."""
    rays = []
    for i in range(lights["pos"].shape[0]):
        light = _light(lights, i)
        nn_L = get_unnormalized_L_vec(light, world_pos)
        L_len = sqrt(_dot(nn_L, nn_L))
        L = nn_L / torch.clamp_min(L_len, 1e-20)[:, None]
        nc_NdotL = _dot(N, L)
        wants_shadow = (valid & (light["casts_shadows"] > 0)
                        & (nc_NdotL > 0))
        t_max = torch.where(wants_shadow, L_len, torch.zeros_like(L_len))
        rays.append((L, nc_NdotL, wants_shadow, t_max))
    return {k: torch.stack(v) for k, v in zip(RAY_KEYS, zip(*rays))}


def light_sum_plain(surf: dict, rays: dict, occluded, lights: dict):
    """Plain PyTorch version of K8b on any device: rho (N, 3), the lights'
    terms added in index order to zeros. `surf` holds N, V, albedo (N, 3),
    roughness, metallic (N,) and world_pos (N, 3); `rays` is K8a's;
    occluded[i] is light i's (N,) bool occlusion."""
    N, V, albedo = surf["N"], surf["V"], surf["albedo"]
    metallic = surf["metallic"]
    F0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
    corrected_roughness = surf["roughness"] * surf["roughness"]
    nc_NdotV = _dot(N, V)
    NdotV = torch.clamp(nc_NdotV, 1e-5, 1.0)

    rho = torch.zeros_like(albedo)
    for i in range(rays["L"].shape[0]):
        light = _light(lights, i)
        L, nc_NdotL = rays["L"][i], rays["nc_NdotL"][i]
        VL = V + L
        H = VL / torch.clamp_min(sqrt(_dot(VL, VL))[..., None], 1e-20)

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

        attenuation = torch.where(
            rays["wants_shadow"][i] & occluded[i],
            torch.full_like(NdotL, SHADOW_ATTENUATION),
            torch.ones_like(NdotL))
        radiance = get_light_radiance(light, surf["world_pos"], L)
        rho = rho + ((rho_s + rho_d) * radiance
                     * (attenuation * NdotL * light["active"])[..., None])
    return rho


def _require(name: str, cond: bool, what: str):
    if not cond:
        raise ValueError(f"{name}: {what}")


def _check_lights(name: str, lights: dict, device) -> int:
    """The light count S; each array (S, 3) or (S,) of its dtype."""
    s = lights["pos"].shape[0]
    _require(name, s > 0, "needs at least one light")
    for key, (dtype, width) in LIGHT_KEYS.items():
        t = lights[key]
        shape = (s, width) if width else (s,)
        _require(name, t.dtype == dtype and tuple(t.shape) == shape,
                 f"lights[{key!r}] must be {shape} {dtype}, got "
                 f"{tuple(t.shape)} {t.dtype}")
    build.require_cuda(name, {k: lights[k] for k in LIGHT_KEYS}, device)
    return s


def _check(name: str, tensors: dict, shapes: dict, device):
    """Each tensor of its (shape, dtype), on `device` and contiguous."""
    for key, t in tensors.items():
        shape, dtype = shapes[key]
        _require(name, tuple(t.shape) == shape and t.dtype == dtype,
                 f"{key} must be {shape} {dtype}, got {tuple(t.shape)} "
                 f"{t.dtype}")
    build.require_cuda(name, tensors, device)


def _light_args(lights: dict):
    return [build.ptr(lights[k]) for k in LIGHT_KEYS]


def light_rays(world_pos, N, valid, lights: dict) -> dict:
    """Every light's shadow ray inputs from the shading points (N, 3) f32,
    shading normals N (N, 3) f32 and the hit mask valid (N,) bool:
    dict(L (S, N, 3) f32, nc_NdotL (S, N) f32, wants_shadow (S, N) bool,
    t_max (S, N) f32), for the S lights of ``engine/convert.
    light_tensors``. Refuses other shapes, dtypes, devices and
    non-contiguous inputs on every device."""
    name = "light_rays"
    n, dev = world_pos.shape[0], world_pos.device
    f3, b1 = ((n, 3), torch.float32), ((n,), torch.bool)
    _check(name, dict(world_pos=world_pos, N=N, valid=valid),
           dict(world_pos=f3, N=f3, valid=b1), dev)
    s = _check_lights(name, lights, dev)
    if not world_pos.is_cuda:
        return light_rays_plain(world_pos, N, valid, lights)
    out = dict(L=torch.empty((s, n, 3), dtype=torch.float32, device=dev),
               nc_NdotL=torch.empty((s, n), dtype=torch.float32, device=dev),
               wants_shadow=torch.empty((s, n), dtype=torch.bool, device=dev),
               t_max=torch.empty((s, n), dtype=torch.float32, device=dev))
    fn = build.function("tpurt_shade_light_rays", [ctypes.c_void_p] * 3 + [
        ctypes.c_int] + [ctypes.c_void_p] * len(LIGHT_KEYS) + [
        ctypes.c_int] + [ctypes.c_void_p] * 5)
    p = build.ptr
    build.check(fn(p(world_pos), p(N), p(valid), n, *_light_args(lights), s,
                   *(p(out[k]) for k in RAY_KEYS),
                   build.stream_of(world_pos)), "tpurt_shade_light_rays")
    build.launch_counts["shade_light_rays"] += 1
    return out


def light_sum(surf: dict, rays: dict, occluded, lights: dict):
    """rho (N, 3) f32: the S lights' BRDF x radiance x shadow attenuation
    x active, added in index order. `surf` holds N, V, albedo, world_pos
    (N, 3) f32 and roughness, metallic (N,) f32 (these two may be strided
    views); `rays` is :func:`light_rays`' output; occluded[i] is light i's
    (N,) bool occlusion mask (a list, or an (S, N) tensor). Refuses other
    shapes, dtypes, devices and non-contiguous inputs on every device."""
    name = "light_sum"
    n, dev = surf["world_pos"].shape[0], surf["world_pos"].device
    s = _check_lights(name, lights, dev)
    occluded = list(occluded)
    _require(name, len(occluded) == s, f"{len(occluded)} occlusion masks "
             f"for {s} lights")
    f1, f3 = ((n,), torch.float32), ((n, 3), torch.float32)
    rows = {k: surf[k] for k in ("N", "V", "albedo", "world_pos")}
    rows.update({k: rays[k] for k in ("L", "nc_NdotL", "wants_shadow")})
    rows.update({f"occluded[{i}]": m for i, m in enumerate(occluded)})
    shapes = dict(N=f3, V=f3, albedo=f3, world_pos=f3,
                  L=((s, n, 3), torch.float32),
                  nc_NdotL=((s, n), torch.float32),
                  wants_shadow=((s, n), torch.bool))
    shapes.update({f"occluded[{i}]": ((n,), torch.bool) for i in range(s)})
    _check(name, rows, shapes, dev)
    rough, metal = surf["roughness"], surf["metallic"]
    for key, t in (("roughness", rough), ("metallic", metal)):
        _require(name, (tuple(t.shape), t.dtype) == f1 and t.device == dev,
                 f"{key} must be ({n},) float32 on {dev}, got "
                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if dev.type != "cuda":
        return light_sum_plain(surf, rays, occluded, lights)
    rho = torch.empty((n, 3), dtype=torch.float32, device=dev)
    masks = (ctypes.c_void_p * s)(*(m.data_ptr() for m in occluded))
    fn = build.function("tpurt_shade_light_sum", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_void_p] * len(LIGHT_KEYS) + [ctypes.c_int] + [
        ctypes.c_float] * 3 + [ctypes.c_void_p] * 2)
    p = build.ptr
    build.check(fn(p(surf["N"]), p(surf["V"]), p(surf["albedo"]), p(rough),
                   rough.stride(0), p(metal), metal.stride(0),
                   p(surf["world_pos"]), n, p(rays["L"]),
                   p(rays["nc_NdotL"]), p(rays["wants_shadow"]), masks,
                   *_light_args(lights), s, 1.25 * LOCAL_SSS_RATIO,
                   1.0 - LOCAL_SSS_RATIO, SHADOW_ATTENUATION, p(rho),
                   build.stream_of(rho)), "tpurt_shade_light_sum")
    build.launch_counts["shade_light_sum"] += -(-s // OCC_CHUNK)
    return rho
