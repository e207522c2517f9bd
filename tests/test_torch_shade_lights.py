"""Shade's light loop split in two (``kernels/shade_lights.py``, K8) on the
CPU, port only: a tiny bench frame (32x24, every 13th lane forced to miss).

Held: on CPU tensors ``light_rays`` and ``light_sum`` take the plain chain
and launch nothing; the split plain pre-pass and sum give the bits of the
interleaved loop that ``passes/shade.py`` ran before the split (kept here
as it was: per light the pre-pass, then BRDF, trace and sum in one loop),
for L, nc_NdotL, wants_shadow, t_max and rho, on every light set of
``tests/torch_light_cases.py`` (all four light types, S = 1 to 4 and 33,
an inactive light, no shadow, equal penumbra and umbra angles, falloff 0,
a type outside the four, the empty set); ``shade()`` and ``shadow_rays()``
give the interleaved loop's outputs; the wrappers refuse a wrong dtype,
shape, device or contiguity on every device before anything runs.
"""
import pytest
import torch

from torch_light_cases import light_cases

W, H = 32, 24
CASES = ["point", "spot", "directional", "area", "mixed1", "mixed2",
         "mixed3", "mixed4", "inactive", "no_shadow", "equal_angles",
         "no_falloff", "other_type", "empty", "many"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frame():
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig, convert
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import surface

    r = build_bench_scene(Renderer(RendererConfig(width=W, height=H,
                                                  device="cpu")),
                          field=dict(nx=2, nz=2, subdiv=1), cubes=2)
    cam, _, _ = r._frame_inputs()
    scene = r.scene_device
    o, d = camera_rays(cam, W, H)
    hits = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX)
    hits["tri"][::13] = -1
    surf = surface(scene, cam, hits)
    assert bool(surf["valid"].any()) and not bool(surf["valid"].all())
    lights = {name: convert.light_tensors(arrays, "cpu")
              for name, arrays in light_cases(r).items()}
    assert sorted(lights) == sorted(CASES)
    return dict(scene=scene, cam=cam, hits=hits, surf=surf, lights=lights)


# passes/shade.py's light loop before the split, as it was
def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _norm(v):
    from tpurt_torch.passes.encodings import sqrt

    return sqrt(_dot(v, v))[..., None]


def _normalize(v, eps=1e-20):
    return v / torch.clamp_min(_norm(v), eps)


def _old_light_ray(surf, light):
    from tpurt_torch.passes.light import get_unnormalized_L_vec

    nn_L = get_unnormalized_L_vec(light, surf["world_pos"])
    L_len = _norm(nn_L)[:, 0]
    L = nn_L / torch.clamp_min(L_len, 1e-20)[:, None]
    nc_NdotL = _dot(surf["N"], L)
    wants_shadow = (surf["valid"] & (light["casts_shadows"] > 0)
                    & (nc_NdotL > 0))
    t_max = torch.where(wants_shadow, L_len, torch.zeros_like(L_len))
    return dict(L=L.contiguous(), nc_NdotL=nc_NdotL,
                wants_shadow=wants_shadow, t_max=t_max)


def _old_loop(surf, lights, trace):
    """(rho, the pre-pass per light, the occlusion per light), with
    trace(L, t_max) the shadow trace."""
    from tpurt_torch.passes import brdf
    from tpurt_torch.passes.light import get_light_radiance

    def _light(i):
        return {k: arr[i] for k, arr in lights.items()}

    N, V, albedo = surf["N"], surf["V"], surf["albedo"]
    world_pos = surf["world_pos"]
    metallic = surf["metallic"]
    F0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
    corrected_roughness = surf["roughness"] * surf["roughness"]
    nc_NdotV = _dot(N, V)
    NdotV = torch.clamp(nc_NdotV, 1e-5, 1.0)
    pre = [_old_light_ray(surf, _light(i))
           for i in range(lights["pos"].shape[0])]
    rho = torch.zeros_like(albedo)
    occ = []
    for i, lr in enumerate(pre):
        light = _light(i)
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
            0.4)[..., None]
        occluded = trace(L, lr["t_max"])
        occ.append(occluded)
        attenuation = torch.where(
            lr["wants_shadow"] & occluded,
            torch.full_like(NdotL, 0.05), torch.ones_like(NdotL))
        radiance = get_light_radiance(light, world_pos, L)
        rho = rho + ((rho_s + rho_d) * radiance
                     * (attenuation * NdotL * light["active"])[..., None])
    return rho, pre, occ


def _tracer(f):
    from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8
    from tpurt_torch.passes.shade import SHADOW_T_MIN

    return lambda L, t_max: trace_any_bvh8(f["scene"], f["surf"]["world_pos"],
                                           L, SHADOW_T_MIN, t_max)


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_split_chain_equals_interleaved_loop(frame, case):
    from tpurt_torch.kernels.shade_lights import (RAY_KEYS, light_rays_plain,
                                                  light_sum_plain)

    surf, lights = frame["surf"], frame["lights"][case]
    rho_old, pre, occ = _old_loop(surf, lights, _tracer(frame))
    rays = light_rays_plain(surf["world_pos"], surf["N"], surf["valid"],
                            lights)
    assert rays["L"].shape == (len(pre), W * H, 3)
    for key in RAY_KEYS:
        for i, lr in enumerate(pre):
            assert _same(rays[key][i], lr[key]), (key, i)
    rho = light_sum_plain(surf, rays, occ, lights)
    assert _same(rho, rho_old)
    if case != "empty":
        assert bool((rho != 0).any())
    if case in ("mixed3", "mixed4"):
        assert any(bool(o.any()) for o in occ)


def test_shade_on_cpu_takes_the_plain_chain(frame):
    """shade() and shadow_rays() on CPU tensors: the interleaved loop's
    outputs, no kernel launched."""
    from tpurt_torch.kernels import build
    from tpurt_torch.passes.shade import _shade_outputs, shade, shadow_rays

    surf, lights = frame["surf"], frame["lights"]["mixed4"]
    rho, pre, _ = _old_loop(surf, lights, _tracer(frame))
    want = _shade_outputs(rho, surf["valid"], frame["cam"],
                          surf["world_pos"], surf["N"])
    build.reset_counts()
    got = shade(frame["scene"], frame["cam"], lights, frame["hits"])
    rays = shadow_rays(frame["scene"], frame["cam"], lights, frame["hits"])
    assert all(v == 0 for v in build.launch_counts.values())
    for key in want:
        assert _same(got[key], want[key]), key
    assert len(rays) == len(pre)
    for (o, d, t_max), lr in zip(rays, pre):
        assert _same(o, surf["world_pos"]) and _same(d, lr["L"])
        assert _same(t_max, lr["t_max"])


def _strided(x):
    """x's values in a non-contiguous tensor of the same shape."""
    return torch.stack([x, x], dim=-1)[..., 0]


FAULTS = {
    "world_pos float64": ("rays", "world_pos", lambda x: x.double()),
    "N (N, 4)": ("rays", "N", lambda x: torch.cat([x, x[:, :1]], 1)),
    "N strided": ("rays", "N", _strided),
    "valid uint8": ("rays", "valid", lambda x: x.to(torch.uint8)),
    "light_type float32": ("lights", "light_type", lambda x: x.float()),
    "pos (S, 4)": ("lights", "pos", lambda x: torch.cat([x, x[:, :1]], 1)),
    "albedo strided": ("sum", "albedo", _strided),
    "L strided": ("sum", "L", _strided),
    "nc_NdotL (S, N - 1)": ("sum", "nc_NdotL", lambda x: x[:, 1:]),
    "occluded float32": ("sum", "occluded", lambda x: x.float()),
    "occluded missing": ("sum", "occluded", lambda x: x[:-1]),
    "metallic (N, 1)": ("sum", "metallic", lambda x: x[:, None]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_wrappers_refuse_bad_inputs(frame, fault):
    """Both wrappers check what K8a and K8b read on every device, before
    anything runs: a wrong dtype, shape or contiguity raises ValueError and
    launches nothing."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.shade_lights import light_rays, light_sum

    where, key, bad = FAULTS[fault]
    surf = dict(frame["surf"])
    lights = dict(frame["lights"]["mixed4"])
    rays = light_rays(surf["world_pos"], surf["N"], surf["valid"], lights)
    occ = torch.zeros(rays["t_max"].shape, dtype=torch.bool)
    if where == "lights":
        lights[key] = bad(lights[key])
    elif key == "occluded":
        occ = bad(occ)
    elif key in rays:
        rays = dict(rays, **{key: bad(rays[key])})
    else:
        surf[key] = bad(surf[key])
    calls = []
    if where in ("rays", "lights"):
        calls.append(lambda: light_rays(surf["world_pos"], surf["N"],
                                        surf["valid"], lights))
    if where in ("sum", "lights"):
        calls.append(lambda: light_sum(surf, rays, occ, lights))
    build.reset_counts()
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert all(v == 0 for v in build.launch_counts.values())
