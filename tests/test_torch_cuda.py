"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need a CUDA device and the CUDA toolkit, and skip
without one (a CUDA kernel has no CPU mode). Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest

(``--noconftest`` because the repository's conftest.py sets up JAX, which
the machine with the card need not have.)

Budgets (as chip_smoke.py holds them): K1, K2, K4, K5, K5p, K7a, K7b, K7c,
K6, K8a, K8b, K9 and K10 bit-identical with their plain versions (K10,
shade's surface, in tests/test_torch_surface.py; K8a and
K8b, shade's light loop, on every light set of tests/torch_light_cases.py;
K9, the texel fetch, in every tier at 1, 4 and 16 taps with its
footprint, over the table and over rows a gather hook serves, and a
textured frame with it against the frame with the torch chain; K1, K2,
K7a, K7b, K7c and K6 in pixel tiles and on consecutive rays, K1, K7a,
K7b, K7c and K6 also on triangle soups with equal-t ties and sibling
boxes and K7a/K7b/K7c on a deep tree, K6
also on SAH trees with leaves of up to 4, K2 also with the plain any hit
over the rows, K5/K5p also with K2 per set (in pixel tiles
and on consecutive rays, on soups and a deep tree), K7a's and K7b's t
with K1's, their occlusion with K2's, K7c's t, tri, u and v with K1's);
K3h's table within P1's ATOL_TRIG of its plain version; P1 within
ATOL_TRIG / RTOL_POW of its plain version (kernels/trans_equiv.py; the
probe's 9x3, and 1x2, 2x2 and 3x3); the LBVH, its
nodes2c and the BVH8 refit built on the card equal to the same built on
the host; K3 edges
equal and AO within 1 u8 step on <= 0.1% of pixels (each preset's
compile-time instantiation and a generic count); the GTAO variants' K3
instantiations (bent normals, "half", fp16, bent + fp16) the same, per
byte of the packed term, with K3h's fp16 table bit-exact, and K4's
(bent, fp16, bent + fp16) bit-exact. The frame on the card
against the plain frame on the host:
equal on >= 99.9% of pixels, <= 0.1% off by more than 2.
"""
import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


# per shade() call: K10 (the surface) and shade's light loop, K8a and K8b,
# once each
SHADE_CALL = dict(shade_surface=1, shade_light_rays=1, shade_light_sum=1)


def _counts(**nonzero):
    """A full launch-count dict: every kernel 0 but `nonzero`."""
    from tpurt_torch.kernels import build

    return {k: nonzero.get(k, 0) for k in build.launch_counts}


def _launched(fn):
    """fn()'s result and the port's kernels it ran on the card, by CUDA
    function, from a torch.profiler trace (``profiler.kernel_launches``)."""
    from torch.profiler import ProfilerActivity, profile

    from tpurt_torch.engine.profiler import kernel_launches

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, kernel_launches(prof.events())


@pytest.fixture(scope="module")
def cuda_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    return build_bench_scene(
        Renderer(RendererConfig(width=96, height=80, device="cuda")),
        field=dict(nx=4, nz=4, subdiv=3), cubes=4)


def _inputs(r):
    from tpurt_torch.engine import convert
    from tpurt_torch.passes.gtao import gtao_constants

    c = r.config
    cam = convert.camera_tensors(r.camera.uniform(), r.device)
    lights = convert.light_tensors(r.lights.shader_arrays(), r.device)
    gtao = convert.gtao_tensors(gtao_constants(
        c.width, c.height, r.camera.znear, r.camera.zfar, r.camera.fovy,
        r.camera.aspect), r.device)
    return cam, lights, gtao


def test_traversal_kernels_bit_identical(cuda_frame):
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_any_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    r = cuda_frame
    cam, lights, _ = _inputs(r)
    sc = r.scene_device
    o, d = camera_rays(cam, r.config.width, r.config.height)
    hk = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX)
    hp = trace_closest_plain(sc, o, d, T_MIN, T_MAX)
    for k in ("t", "tri", "u", "v"):
        assert torch.equal(hk[k].view(torch.int32), hp[k].view(torch.int32))
    for so, sd, stmax in shadow_rays(sc, cam, lights, hk):
        assert torch.equal(trace_any_bvh8(sc, so, sd, SHADOW_T_MIN, stmax),
                           trace_any_plain(sc, so, sd, SHADOW_T_MIN, stmax))


def test_gtao_kernels_within_budget(cuda_frame):
    from tpurt_torch.kernels.gtao_denoise import (denoise_chain,
                                                  denoise_pass_plain)
    from tpurt_torch.kernels.gtao_main import gtao_main, main_pass_plain
    from tpurt_torch.passes.gtao import noise_maps_64, prefilter_depths

    r = cuda_frame
    out = r.render()
    _, _, gtao = _inputs(r)
    mips = prefilter_depths(out["depth"], gtao["host"])
    noise = noise_maps_64(3, r.device)
    kw = dict(slice_count=9, steps_per_slice=3)
    ao_k, ed_k = gtao_main(mips, out["normal"], gtao["vec"], noise, **kw)
    ao_p, ed_p = main_pass_plain(mips, out["normal"], gtao["vec"], noise,
                                 **kw)
    assert torch.equal(ed_k, ed_p)
    d = (ao_k.int() - ao_p.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    dk = denoise_chain(ao_k, ed_k, n_passes=1, blur_beta=1.2)
    dp = denoise_pass_plain(ao_k, ed_k, 1.2, True)
    assert torch.equal(dk, dp)


def test_frame_on_card_matches_host(cuda_frame):
    """The same frame from the kernels on the card and the plain versions
    on the host."""
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.kernels import build

    r = cuda_frame
    host = build_bench_scene(
        Renderer(RendererConfig(width=96, height=80, device="cpu")),
        field=dict(nx=4, nz=4, subdiv=3), cubes=4)
    for _ in range(2):  # the frame's CUDA graph captured by now
        r.render()
    host._frame_idx = r._frame_idx  # the same GTAO noise index
    build.reset_counts()
    img_gpu, ran = _launched(r.render_image)
    # one launch of the graph, which runs the frame's kernels on the card
    assert build.launch_counts == _counts(frame_graph=1)
    assert ran == build.by_kernel(_counts(bvh8_closest=1, bvh8_any=3,
                                          gtao_noise=1, gtao_main=1,
                                          gtao_denoise=1, **SHADE_CALL))
    img_cpu = host.render_image()
    # the host's pow/cos/log2 come from another math library than the
    # card's: a sample can move to another mip or a shading term by an ulp
    d = np.abs(img_gpu.astype(int) - img_cpu.astype(int)).max(-1)
    assert (d == 0).mean() >= 0.999 and (d > 2).mean() <= 1e-3


def _dynamic_inputs(r):
    from tpurt_torch.app.bench_scene import rotation_frames
    from tpurt_torch.engine import convert
    from tpurt_torch.engine.dynamic import make_refit_data

    t = rotation_frames(r.scene.transforms, 5)[4]
    obj = {d: convert.object_tensors(r.scene.as_object_pytree(), d)
           for d in ("cuda", "cpu")}
    refit = {d: convert.refit_tensors(make_refit_data(r.scene), d)
             for d in ("cuda", "cpu")}
    return t, obj, refit


def test_lbvh_and_refit_on_card_equal_host(cuda_frame):
    """The per-frame acceleration structures: bit-equal on both devices."""
    from tpurt_torch.bvh.wide import LEAF8_MAX, refit_bvh8
    from tpurt_torch.engine.dynamic import build_world_tables, world_vertices

    t, obj, refit = _dynamic_inputs(cuda_frame)
    dev, host = (build_world_tables(obj[d], t) for d in ("cuda", "cpu"))
    for k in host["bvh"]:
        a, b = dev["bvh"][k].cpu(), host["bvh"][k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k
    assert torch.equal(dev["nodes2"].cpu().view(torch.int32),
                       host["nodes2"].view(torch.int32))
    nodes8 = {}
    for d in ("cuda", "cpu"):
        vp = world_vertices(obj[d], torch.as_tensor(t, device=d))[0]
        tvo = obj[d]["tri_vertex"][refit[d]["order"]]
        v = [vp[tvo[:, k]] for k in range(3)]
        nodes8[d] = refit_bvh8(
            refit[d]["nodes8"], refit[d]["levels"],
            torch.minimum(torch.minimum(v[0], v[1]), v[2]),
            torch.maximum(torch.maximum(v[0], v[1]), v[2]), LEAF8_MAX)
    assert torch.equal(nodes8["cuda"].cpu().view(torch.int32),
                       nodes8["cpu"].view(torch.int32))


def test_k6_bit_identical(cuda_frame):
    """K6 closest and any hit (csrc/bvh2_trace.cu over nodes2c) against the
    plain version on the card, on the rebuild frame's rays (shadow rays
    with t_max = 0 lanes included): in 16x8 pixel tiles (as the rebuild
    frame traces them), on consecutive rays and on a frame whose height is
    not a multiple of the tile, with the launches counted; nodes2c built on
    the card equals the host's."""
    from tpurt_torch.engine.dynamic import build_world_tables
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.traverse_bvh2 import (trace_any_bvh2,
                                                   trace_any_plain,
                                                   trace_closest_bvh2,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    r = cuda_frame
    w, h = r.config.width, r.config.height
    t, obj, _ = _dynamic_inputs(r)
    cam, lights, _ = _inputs(r)
    sc = build_world_tables(obj["cuda"], t)
    host = build_world_tables(obj["cpu"], t)
    assert torch.equal(sc["nodes2c"].cpu().view(torch.int32),
                       host["nodes2c"].view(torch.int32))
    o, d = camera_rays(cam, w, h)
    build.reset_counts()
    hk = trace_closest_bvh2(sc, o, d, T_MIN, T_MAX, height=h, width=w)
    hr = trace_closest_bvh2(sc, o, d, T_MIN, T_MAX)
    n = 37 * w
    part = trace_closest_bvh2(sc, o[:n], d[:n], T_MIN, T_MAX, height=37,
                              width=w)
    assert build.launch_counts == _counts(bvh2_closest=3)
    hp = trace_closest_plain(sc, o, d, T_MIN, T_MAX)
    for k in ("t", "tri", "u", "v"):
        for got in (hk, hr, {key: v[:n] for key, v in part.items()}):
            want = hp[k][:got[k].shape[0]]
            assert torch.equal(_bits(got[k]), _bits(want)), k
    assert bool((hk["tri"] >= 0).any())
    build.reset_counts()
    for so, sd, stmax in shadow_rays(sc, cam, lights, hk):
        assert bool((stmax == 0).any())
        want = trace_any_plain(sc, so, sd, SHADOW_T_MIN, stmax)
        assert torch.equal(trace_any_bvh2(sc, so, sd, SHADOW_T_MIN, stmax,
                                          height=h, width=w), want)
        assert torch.equal(trace_any_bvh2(sc, so, sd, SHADOW_T_MIN, stmax),
                           want)
    # shadow_rays' surface and light-ray pre-pass: K10 and K8a once
    assert build.launch_counts == _counts(bvh2_any=6, shade_surface=1,
                                          shade_light_rays=1)


def test_k6_over_sah_trees_and_soups(cuda_frame):
    """K6 on host-built binary SAH trees with leaves of up to 4 triangles
    (max_leaf 4: the batched leaf step): the bench scene's tree on the
    frame's camera rays, and the triangle soups of
    tests/torch_closest_cases.py (every triangle twice: equal-t ties,
    sibling leaves with identical boxes; grazing and axis-aligned rays,
    t_max <= t_min) with leaves of 1 and 4; in tiles and on rows, bit for
    bit against the plain version."""
    from torch_closest_cases import H, T_MIN, W, frame_rays, port_scene, \
        soup
    from tpurt_torch.bvh.flat import bvh_max_depth
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh2 import (trace_any_bvh2,
                                                   trace_any_plain,
                                                   trace_closest_bvh2,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, camera_rays

    def tree(bvh, geom):
        return convert.bvh2_tensors(bvh, geom, bvh_max_depth(
            np.asarray(bvh["entry"]), np.asarray(bvh["skip"]),
            np.asarray(bvh["tri_count"])), "cuda")

    r = cuda_frame
    w, h = r.config.width, r.config.height
    o, d = camera_rays(_inputs(r)[0], w, h)
    cases = [(tree(r.scene.bvh, r.scene.geom), 4, o, d,
              torch.full((w * h,), T_MAX, device="cuda"), 1e-3, (h, w))]
    v0, v1, v2 = soup()
    rays = [torch.tensor(x, device="cuda") for x in frame_rays(v0, v1, v2)]
    for leaf_max in (1, 4):
        _, bvh, geom = port_scene(v0, v1, v2, leaf_max)
        cases.append((tree(bvh.as_pytree(), geom), leaf_max, *rays, T_MIN,
                      (H, W)))
    for sc, max_leaf, so, sd, tmx, t_min, (fh, fw) in cases:
        want = trace_closest_plain(sc, so, sd, t_min, tmx, max_leaf)
        occ = trace_any_plain(sc, so, sd, t_min, tmx, max_leaf)
        assert int((want["tri"] >= 0).sum()) > 0 and bool(occ.any())
        for shape in (dict(height=fh, width=fw), {}):
            got = trace_closest_bvh2(sc, so, sd, t_min, tmx, max_leaf,
                                     **shape)
            for k in ("t", "tri", "u", "v"):
                assert torch.equal(_bits(got[k]), _bits(want[k])), k
            assert torch.equal(trace_any_bvh2(sc, so, sd, t_min, tmx,
                                              max_leaf, **shape), occ)


def test_dynamic_frames_on_card_match_host(cuda_frame):
    """Refit and rebuild frames on the card against the plain versions on
    the host, with the launches of each path."""
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.kernels import build

    r = cuda_frame
    host = build_bench_scene(
        Renderer(RendererConfig(width=96, height=80, device="cpu")),
        field=dict(nx=4, nz=4, subdiv=3), cubes=4)
    t = _dynamic_inputs(r)[0]
    want = {True: _counts(bvh8_closest=1, bvh8_any=3, gtao_noise=1,
                          gtao_main=1, gtao_denoise=1, **SHADE_CALL),
            False: _counts(gtao_noise=1, gtao_main=1, gtao_denoise=1,
                           bvh2_closest=1, bvh2_any=3, **SHADE_CALL)}
    for refit in (True, False):
        host._frame_idx = r._frame_idx
        build.reset_counts()
        img_gpu = r.render_dynamic(t, refit=refit)["image"].cpu().numpy()
        assert build.launch_counts == want[refit]
        img_cpu = host.render_dynamic(t, refit=refit)["image"].numpy()
        d = np.abs(img_gpu.astype(int) - img_cpu.astype(int)).max(-1)
        assert (d == 0).mean() >= 0.999 and (d > 2).mean() <= 1e-3


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_pop2_and_payload_kernels_bit_identical(cuda_frame):
    """K7b (closest and any) and K7c (all nine outputs), in 16x8 pixel
    tiles and on consecutive rays, against their plain versions on the
    frame's rays; K7b's t equals K1's, its tri differs only on ties, its
    occlusion is K2's; K7c's t, tri, u and v are K1's."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_any_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    r = cuda_frame
    cam, lights, _ = _inputs(r)
    sc = r.scene_device
    w, h = r.config.width, r.config.height
    o, d = camera_rays(cam, w, h)
    build.reset_counts()
    k1 = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX)
    hk = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX, pop2=True)
    tiles = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX, pop2=True, height=h,
                               width=w)
    hp = trace_closest_plain(sc, o, d, T_MIN, T_MAX, pop2=True)
    for k in ("t", "tri", "u", "v"):
        assert torch.equal(_bits(hk[k]), _bits(hp[k])), k
        assert torch.equal(_bits(tiles[k]), _bits(hp[k])), k
    assert torch.equal(_bits(hk["t"]), _bits(k1["t"]))
    assert bool((hk["tri"] >= 0).any())
    up = trace_closest_plain(sc, o, d, T_MIN, T_MAX, uv_payload=True)
    assert bool((up["tri"] >= 0).any())
    for frame in ({}, dict(height=h, width=w)):
        uk = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX, uv_payload=True,
                                **frame)
        assert set(uk) == set(up) == {"t", "tri", "u", "v", "texu", "texv",
                                      "img", "texh", "texw"}
        for k in uk:
            assert torch.equal(_bits(uk[k]), _bits(up[k])), (k, frame)
        for k in k1:
            assert torch.equal(_bits(uk[k]), _bits(k1[k])), (k, frame)
    for so, sd, stmax in shadow_rays(sc, cam, lights, k1):
        want = trace_any_plain(sc, so, sd, SHADOW_T_MIN, stmax, pop2=True)
        assert torch.equal(trace_any_bvh8(sc, so, sd, SHADOW_T_MIN, stmax,
                                          pop2=True), want)
        assert torch.equal(trace_any_bvh8(sc, so, sd, SHADOW_T_MIN, stmax,
                                          pop2=True, height=h, width=w),
                           want)
        assert torch.equal(want, trace_any_plain(sc, so, sd, SHADOW_T_MIN,
                                                 stmax))
    # shadow_rays' surface and light-ray pre-pass: K10 and K8a once
    assert build.launch_counts == _counts(bvh8_closest=1,
                                          bvh8_closest_pop2=2,
                                          bvh8_closest_uvp=2,
                                          bvh8_any_pop2=6,
                                          shade_surface=1,
                                          shade_light_rays=1)


@pytest.mark.parametrize("pop2", [False, True])
def test_multi_kernels_bit_identical(cuda_frame, pop2):
    """K5 / K5p (csrc/bvh8_multi.cu, nodes8c) against the plain version and
    against K2 per set, for S = 1, the frame's 3 lights, and S = 6 (above
    the per-launch cap: two launches), in 16x8 pixel tiles (the frame's
    shape, as shade() traces them) and on consecutive rays; a frame that is
    not a multiple of the tile."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.traverse_bvh8 import (MULTI_SETS_MAX,
                                                   multi_stack_size,
                                                   trace_any_bvh8,
                                                   trace_any_bvh8_multi,
                                                   trace_any_multi_plain,
                                                   trace_closest_bvh8)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    r = cuda_frame
    cam, lights, _ = _inputs(r)
    sc = r.scene_device
    w, h = r.config.width, r.config.height
    o, d = camera_rays(cam, w, h)
    rays = shadow_rays(sc, cam, lights, trace_closest_bvh8(sc, o, d, T_MIN,
                                                           T_MAX))
    origin = rays[0][0]
    solo = [trace_any_bvh8(sc, so, sd, SHADOW_T_MIN, stmax)
            for so, sd, stmax in rays]
    assert any(bool(x.any()) for x in solo)
    assert multi_stack_size(sc["depth8"], 2 if pop2 else 1) == \
        (64 if pop2 else 48)
    kind = "bvh8_any_multi_pop2" if pop2 else "bvh8_any_multi"
    for sets in ([0], [0, 1, 2], [0, 1, 2, 2, 1, 0]):
        dirs = torch.stack([rays[i][1] for i in sets])
        tmax = torch.stack([rays[i][2] for i in sets])
        launches = -(-len(sets) // MULTI_SETS_MAX)
        build.reset_counts()
        got = trace_any_bvh8_multi(sc, origin, dirs, SHADOW_T_MIN, tmax,
                                   pop2=pop2, height=h, width=w)
        assert build.launch_counts == _counts(**{kind: launches})
        assert got.shape == (len(sets), o.shape[0])
        assert torch.equal(got, trace_any_multi_plain(
            sc, origin, dirs, SHADOW_T_MIN, tmax, pop2=pop2))
        for row, i in zip(got, sets):
            assert torch.equal(row, solo[i])
        assert torch.equal(got, trace_any_bvh8_multi(
            sc, origin, dirs, SHADOW_T_MIN, tmax, pop2=pop2))
        # 37 of the 80 rows, 96 wide: the last tile row is partial
        n = 37 * w
        part = trace_any_bvh8_multi(sc, origin[:n], dirs[:, :n],
                                    SHADOW_T_MIN, tmax[:, :n], pop2=pop2,
                                    height=37, width=w)
        assert torch.equal(part, got[:, :n])
        assert build.launch_counts == _counts(**{kind: 3 * launches})


@pytest.mark.parametrize("pop2", [False, True])
def test_multi_kernels_on_soups_and_a_deep_tree(cuda_frame, pop2):
    """K5 / K5p against the plain version and K2 per set on the triangle
    soups of tests/torch_closest_cases.py (identical sibling boxes, grazing
    and axis-aligned rays, t_max <= t_min) and on its deep soup, whose
    9-level tree takes the 192-entry stack instantiation, for 1, 3 and 4
    sets, in tiles and on rows."""
    from torch_closest_cases import (CASES, H, T_MIN, W, deep_soup,
                                     port_scene, shared_origin_sets, soup)
    from tpurt_torch.kernels.traverse_bvh8 import (multi_stack_size,
                                                   trace_any_bvh8,
                                                   trace_any_bvh8_multi,
                                                   trace_any_multi_plain)

    pops = 2 if pop2 else 1
    cases = [(soup(), leaf_max) for leaf_max in CASES.values()]
    cases.append((deep_soup(), 1))
    for tris, leaf_max in cases:
        scene, _, _ = port_scene(*tris, leaf_max, device="cuda")
        deep = multi_stack_size(scene["depth8"], pops) == 192
        assert deep == (tris[0].shape[0] == 80)
        for sets in (1, 3, 4):
            o, dirs, tmax = (torch.tensor(x, device="cuda")
                             for x in shared_origin_sets(*tris, sets))
            want = trace_any_multi_plain(scene, o, dirs, T_MIN, tmax,
                                         pop2=pop2)
            assert bool(want.any())
            for i in range(sets):
                assert torch.equal(want[i], trace_any_bvh8(
                    scene, o, dirs[i], T_MIN, tmax[i]))
            assert torch.equal(trace_any_bvh8_multi(
                scene, o, dirs, T_MIN, tmax, pop2=pop2, height=H,
                width=W), want)
            assert torch.equal(trace_any_bvh8_multi(
                scene, o, dirs, T_MIN, tmax, pop2=pop2), want)


def test_variant_frames_on_card(cuda_frame):
    """The frames with the two-pop kernels, the uv payload and the fused
    shadows: their launches, and their images against the default frame's
    (bit-identical for the payload and fused frames)."""
    from tpurt_torch.engine.frame import render_frame_fused
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels import traverse_bvh8 as tb

    r = cuda_frame
    c = r.config
    cam, lights, gtao = _inputs(r)

    def fused():
        return render_frame_fused(r.scene_device, cam, lights, gtao, r._lpm,
                                  r._noise[0], width=c.width,
                                  height=c.height, gtao_settings=c.gtao)

    def render():
        r._frame_idx = 0
        return r.render()

    base = render()["image"]
    cases = [("uvp", dict(UVP_DEFAULT=True), render,
              _counts(bvh8_closest_uvp=1, bvh8_any=3, **SHADE_CALL)),
             ("fused", {}, fused, _counts(bvh8_closest=1, bvh8_any_multi=1,
                                          **SHADE_CALL)),
             ("pop2", dict(POP2_DEFAULT=True), render,
              _counts(bvh8_closest_pop2=1, bvh8_any_pop2=3, **SHADE_CALL)),
             ("fused_pop2", dict(POP2_DEFAULT=True), fused,
              _counts(bvh8_closest_pop2=1, bvh8_any_multi_pop2=1,
                      **SHADE_CALL))]
    for name, flags, frame, want in cases:
        try:
            for k, val in flags.items():
                setattr(tb, k, val)
            build.reset_counts()
            img = frame()["image"]
            counts = dict(build.launch_counts)
        finally:
            tb.POP2_DEFAULT = tb.UVP_DEFAULT = False
        want = dict(want, gtao_noise=1, gtao_main=1, gtao_denoise=1)
        assert counts == want, name
        diff = (img.int() - base.int()).abs().amax(-1)
        if name in ("uvp", "fused"):
            assert torch.equal(img, base), name
        else:
            assert float((diff == 0).float().mean()) >= 0.999, name
            assert float((diff > 2).float().mean()) <= 1e-3, name


@pytest.mark.parametrize("order", ["sort", "nearlast", "none"])
def test_step_count_kernels_bit_identical(cuda_frame, order):
    """K7a closest and any hit with step counts against the plain versions
    on the frame's rays (t, tri, counts, occlusion bit for bit), in 16x8
    pixel tiles and on consecutive rays, for each push order; t and
    occlusion equal to K1/K2's, tri differing only on equal-t ties; the
    counts' sums equal to the plain traversal's work."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_any_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    r = cuda_frame
    cam, lights, _ = _inputs(r)
    sc = r.scene_device
    w, h = r.config.width, r.config.height
    o, d = camera_rays(cam, w, h)
    k1 = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX)
    rays = shadow_rays(sc, cam, lights, k1)
    build.reset_counts()
    hk = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX, count_steps=True,
                            push_order=order)
    tiles = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX, count_steps=True,
                               push_order=order, height=h, width=w)
    plain = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX, push_order=order)
    work = {}
    hp = trace_closest_plain(sc, o, d, T_MIN, T_MAX, stats=work,
                             count_steps=True, push_order=order)
    for k in ("t", "tri", "u", "v"):
        assert torch.equal(_bits(hk[k]), _bits(hp[k])), k
        assert torch.equal(_bits(tiles[k]), _bits(hp[k])), k
    assert torch.equal(_bits(hk["t"]), _bits(k1["t"]))
    assert torch.equal(_bits(plain["t"]), _bits(k1["t"]))
    assert torch.equal(plain["tri"], hk["tri"])
    assert float((hk["tri"] == k1["tri"]).float().mean()) >= 0.999
    assert int(hk["u"].sum()) == int(work["node_pops"])
    assert int(hk["v"].sum()) == int(work["leaf_pops"])
    for so, sd, stmax in rays:
        occ, node, leaf = trace_any_bvh8(sc, so, sd, SHADOW_T_MIN, stmax,
                                         count_steps=True, push_order=order)
        work = {}
        p_occ, p_node, p_leaf = trace_any_plain(
            sc, so, sd, SHADOW_T_MIN, stmax, stats=work, count_steps=True,
            push_order=order)
        assert torch.equal(occ, p_occ) and torch.equal(node, p_node) \
            and torch.equal(leaf, p_leaf)
        for got, want in zip(trace_any_bvh8(
                sc, so, sd, SHADOW_T_MIN, stmax, count_steps=True,
                push_order=order, height=h, width=w), (p_occ, p_node,
                                                       p_leaf)):
            assert torch.equal(got, want)
        assert torch.equal(occ, trace_any_bvh8(sc, so, sd, SHADOW_T_MIN,
                                               stmax))
        assert int(node.sum()) == int(work["node_pops"])
        assert int(leaf.sum()) == int(work["leaf_pops"])
        assert not bool(node[stmax <= SHADOW_T_MIN].any())
    # the uncounted K7a closest launch runs only for a push order of its own
    want = _counts(bvh8_closest_steps=2 if order == "sort" else 3,
                   bvh8_closest=1 if order == "sort" else 0,
                   bvh8_any_steps=6, bvh8_any=3)
    assert build.launch_counts == want


@pytest.mark.parametrize("pop2", [False, True])
def test_variant_kernels_on_soups_and_a_deep_tree(cuda_frame, pop2):
    """K7a (every push order, counted and not) and K7c (the uv payload,
    over a random uvp table) or K7b (two pops) against the plain versions
    on the triangle soups of tests/torch_closest_cases.py (equal-t ties,
    sibling slots with identical boxes, grazing and axis-aligned rays,
    t_max <= t_min) and on its deep soup, whose 9-level tree takes the
    192-entry stack instantiation, in 16x8 pixel tiles and on consecutive
    rays, bit for bit."""
    from torch_closest_cases import (CASES, H, T_MIN, W, deep_soup,
                                     frame_rays, port_scene, soup)
    from tpurt_torch.kernels.traverse_bvh8 import (compact_stack_size,
                                                   trace_any_bvh8,
                                                   trace_any_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)

    traces = [dict(pop2=True)] if pop2 else [
        dict(count_steps=c, push_order=o)
        for o in ("sort", "nearlast", "none") for c in (False, True)] + [
        dict(uv_payload=True)]
    cases = [(soup(), leaf_max) for leaf_max in CASES.values()]
    cases.append((deep_soup(), 1))
    for tris, leaf_max in cases:
        scene, _, _ = port_scene(*tris, leaf_max, device="cuda")
        scene["uvp"] = torch.tensor(np.random.default_rng(7).uniform(
            -2.0, 2.0, (tris[0].shape[0], 9)), dtype=torch.float32,
            device="cuda")
        deep = compact_stack_size(scene["depth8"], 2 if pop2 else 1) == 192
        assert deep == (tris[0].shape[0] == 80)
        rays = [torch.tensor(x, device="cuda") for x in frame_rays(*tris)]
        args = (scene, rays[0], rays[1], T_MIN, rays[2])
        for kw in traces:
            if "uv_payload" not in kw:
                want = trace_any_plain(*args, **kw)
                want = want if isinstance(want, tuple) else (want,)
                assert bool(want[0].any())
                for frame in ({}, dict(height=H, width=W)):
                    got = trace_any_bvh8(*args, **kw, **frame)
                    got = got if isinstance(got, tuple) else (got,)
                    assert all(torch.equal(a, b)
                               for a, b in zip(got, want)), kw
                if not kw.get("count_steps") \
                        and kw.get("push_order") == "sort":
                    continue  # K1's trace
            want = trace_closest_plain(*args, **kw)
            assert int((want["tri"] >= 0).sum()) > 0
            for frame in ({}, dict(height=H, width=W)):
                got = trace_closest_bvh8(*args, **kw, **frame)
                assert got.keys() == want.keys(), kw
                assert all(torch.equal(_bits(got[k]), _bits(want[k]))
                           for k in want), kw


def test_k7a_entries_refuse_other_traces():
    """The K7a / K7b C entries (csrc/bvh8_variants.cu) take a counted
    one-pop trace, a push order of its own, or an uncounted two-pop "sort"
    trace: an uncounted one-pop trace at K1's order ("sort", closest hit)
    or K2's ("none", any hit), an unknown order, a counted two-pop trace, a
    two-pop trace at another order and a ragged frame come back as
    cudaErrorInvalidValue (1) before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import ctypes

    from tpurt_torch.kernels import build

    vp = ctypes.c_void_p
    for name, outs in (("tpurt_bvh8_closest_variant", 5),
                       ("tpurt_bvh8_any_variant", 4)):
        fn = build.function(name, [vp] * 4 + [ctypes.c_float, vp]
                            + [ctypes.c_int] * 6 + [vp] * outs)

        def call(count_steps, order, pop2=0, n=0, tile_w=0):
            # n = 0 rays (or a refusal): no pointer is read
            return fn(None, None, None, None, 0.0, None, n, pop2,
                      count_steps, order, 48, tile_w, *[None] * outs)

        assert [call(1, 3), call(0, -1)] == [1, 1], name
        assert [call(1, 0), call(0, 1), call(1, 2)] == [0, 0, 0], name
        assert call(0, 0) == (0 if "any" in name else 1), name
        assert call(0, 2) == (1 if "any" in name else 0), name
        assert [call(1, 0, pop2=1), call(0, 2, pop2=1)] == [1, 1], name
        assert call(0, 0, pop2=1) == 0, name
        assert call(1, 0, n=10, tile_w=3) == 1, name


def test_trans_equiv_kernel_within_tolerance():
    """P1 on the card against its plain version (torch on the card): cos
    and sin within ATOL_TRIG, pow within RTOL_POW; the arguments of both
    equal to the host's bit for bit. The same at the other preset counts
    (1x2, 2x2, 3x3: other grid heights and rows per slice)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.trans_equiv import (row_ops, trans_equiv,
                                                 trans_equiv_plain)
    from tpurt_torch.tools import trans_equiv_probe

    build.reset_counts()
    report = trans_equiv_probe.run("cuda")
    assert build.launch_counts == _counts(trans_equiv=1)
    assert report["arguments_equal_to_host"]
    for op in ("cos", "sin", "pow"):
        assert report["tolerance"][op]["outside"] == 0, report
        assert report["kernel_vs_float64"][op]["max_ulp"] <= 4, report
    planes = trans_equiv_probe.noise_planes().cuda()
    for counts in ((1, 2), (2, 2), (3, 3)):
        args = (planes, trans_equiv_probe.SDP, *counts)
        got, want = trans_equiv(*args), trans_equiv_plain(*args)
        assert got.shape == want.shape == (counts[0] * (2 + counts[1]),
                                           *planes.shape[1:])
        tol = trans_equiv_probe.within_tolerance(got, want,
                                                 row_ops(*counts))
        assert all(x["outside"] == 0 for x in tol.values()), (counts, tol)


def test_profiler_and_stream_on_card(cuda_frame):
    """profile_frame and device_profile on the card: render()'s launches,
    tpurt's pass names, positive device times; render_stream at depth 1
    and 3 equal to successive render() frames."""
    from tpurt_torch.engine import profiler

    from tpurt_torch.kernels import build

    r = cuda_frame
    for _ in range(2):  # the frame's CUDA graph captured by now
        r.render()
    build.reset_counts()
    stats = profiler.profile_frame(r, 2)
    # one untimed frame, render()'s replay, and two timed eager frames
    assert build.launch_counts == _counts(bvh8_closest=2, bvh8_any=6,
                                          gtao_noise=2, gtao_main=2,
                                          gtao_denoise=2, shade_surface=2,
                                          shade_light_rays=2,
                                          shade_light_sum=2, frame_graph=1)
    assert list(stats.ms_per_pass) == ["rays", "trace", "shade+shadows",
                                       "gtao", "tonemap"]
    assert all(v > 0 for v in stats.ms_per_pass.values())
    dev = profiler.device_profile(r, reps=2, k=2)
    assert list(dev.ms_per_pass) == ["trace", "shade", "gtao", "tonemap"]
    assert all(v > 0 for v in dev.ms_per_pass.values())
    assert dev.ms_total <= stats.ms_total * 1.5
    for depth in (1, 3):
        r._frame_idx = 0
        seq = [r.render()["image"] for _ in range(4)]
        r._frame_idx = 0
        got = [out["image"] for out in r.render_stream(4, depth=depth)]
        assert len(got) == 4
        assert all(torch.equal(a, b) for a, b in zip(seq, got))


def test_any_hit_kernel_over_compact_table(cuda_frame):
    """K2 (csrc/bvh8_any.cu, nodes8c) against its plain version and the
    plain any hit over the nodes8 rows on the frame's shadow rays, t_max =
    0 lanes included, traced as shade() traces them (the frame's shape:
    16x8 pixel tiles); on consecutive rays it gives the same bits; a frame
    that is not a multiple of the tile; the deep-tree stack size."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.traverse_bvh8 import (_trace_plain, any_kernel,
                                                   compact_stack_size,
                                                   trace_any_bvh8,
                                                   trace_any_plain,
                                                   trace_closest_bvh8)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    r = cuda_frame
    cam, lights, _ = _inputs(r)
    sc = r.scene_device
    w, h = r.config.width, r.config.height
    o, d = camera_rays(cam, w, h)
    rays = shadow_rays(sc, cam, lights, trace_closest_bvh8(sc, o, d, T_MIN,
                                                           T_MAX))
    assert compact_stack_size(sc["depth8"]) == 48
    assert compact_stack_size(27) == 192
    build.reset_counts()
    for so, sd, stmax in rays:
        assert bool((stmax == 0).any())
        got = trace_any_bvh8(sc, so, sd, SHADOW_T_MIN, stmax, height=h,
                             width=w)
        assert torch.equal(got, trace_any_plain(sc, so, sd, SHADOW_T_MIN,
                                                stmax))
        assert torch.equal(got, _trace_plain(
            sc, so, sd, SHADOW_T_MIN, stmax, any_hit=True, order="none",
            compact=False))
        assert torch.equal(got, any_kernel(sc, so, sd, SHADOW_T_MIN,
                                           stmax))
        # 37 of the 80 rows, 96 wide: the last tile row is partial
        n = 37 * w
        assert torch.equal(any_kernel(sc, so[:n], sd[:n], SHADOW_T_MIN,
                                      stmax[:n], tile_w=w), got[:n])
    assert build.launch_counts == _counts(bvh8_any=9)


@pytest.mark.parametrize("preset", [(1, 2), (2, 2), (3, 3), (9, 3), (4, 2)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
def test_gtao_main_with_noise_table(cuda_frame, preset):
    """K3h + K3 against the plain version for each preset's compile-time
    instantiation and a generic count (4x2): edges equal, AO within 1 u8
    step on <= 0.1% of pixels; the table within ATOL_TRIG of its plain
    version; K3 alone on that table gives the same bits; one K3h and one
    K3 launch per call."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.gtao_main import (gtao_main, gtao_noise_table,
                                               main_kernel, main_pass_plain,
                                               noise_table_plain)
    from tpurt_torch.kernels.trans_equiv import ATOL_TRIG
    from tpurt_torch.passes.gtao import noise_maps_64, prefilter_depths

    r = cuda_frame
    out = r.render()
    _, _, gtao = _inputs(r)
    mips = prefilter_depths(out["depth"], gtao["host"])
    noise = noise_maps_64(7, r.device)
    kw = dict(slice_count=preset[0], steps_per_slice=preset[1])
    build.reset_counts()
    ao_k, ed_k = gtao_main(mips, out["normal"], gtao["vec"], noise, **kw)
    assert build.launch_counts == _counts(gtao_noise=1, gtao_main=1)
    ao_p, ed_p = main_pass_plain(mips, out["normal"], gtao["vec"], noise,
                                 **kw)
    assert torch.equal(ed_k, ed_p)
    d = (ao_k.int() - ao_p.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    table = gtao_noise_table(noise, gtao["vec"], **kw)
    assert float((table - noise_table_plain(noise, gtao["vec"], **kw))
                 .abs().max()) <= ATOL_TRIG
    alone = main_kernel(mips, out["normal"], gtao["vec"], table, **kw)
    assert torch.equal(alone[0], ao_k) and torch.equal(alone[1], ed_k)


GTAO_VARIANTS = [(True, "exact"), (False, "half"), (False, "fp16"),
                 (True, "fp16")]


def _bytes_diff(a, b, bent):
    """Per-pixel u8 differences of two AO terms: the largest over the four
    bytes of the packed term with bent normals."""
    if bent:
        a = a.contiguous().view(torch.uint8).reshape(*a.shape, 4)
        b = b.contiguous().view(torch.uint8).reshape(*b.shape, 4)
        return (a.int() - b.int()).abs().amax(dim=-1)
    return (a.int() - b.int()).abs()


@pytest.mark.parametrize("preset", [(9, 3), (4, 2)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("bent,precision", GTAO_VARIANTS,
                         ids=["bent", "half", "fp16", "bent_fp16"])
def test_gtao_main_variants(cuda_frame, bent, precision, preset):
    """K3h + K3's variant instantiations (bent normals, "half", fp16 and
    bent + fp16) against their plain versions on a 64x64 cut of the frame's
    G-buffer, at ULTRA and a generic count: edges equal, the AO term within
    1 u8 step (per byte of the packed term) on <= 0.1% of pixels; the fp16
    table equal to its plain version bit for bit (the same device math),
    the f32 one within ATOL_TRIG; one K3h and one K3 launch of the variant
    per call."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.gtao_main import (count_key, gtao_main,
                                               gtao_noise_table,
                                               main_pass_plain,
                                               noise_table_plain)
    from tpurt_torch.kernels.trans_equiv import ATOL_TRIG
    from tpurt_torch.passes.gtao import noise_maps_64, prefilter_depths

    r = cuda_frame
    out = r.render()
    _, _, gtao = _inputs(r)
    fp16 = precision == "fp16"
    depth = out["depth"][:64, :64].contiguous()
    normal = out["normal"][:64, :64].contiguous()
    mips = prefilter_depths(depth, gtao["host"], fp16=fp16)
    gvec = gtao["vec16" if fp16 else "vec"]
    noise = noise_maps_64(7, r.device)
    kw = dict(slice_count=preset[0], steps_per_slice=preset[1], bent=bent,
              precision=precision)
    build.reset_counts()
    ao_k, ed_k = gtao_main(mips, normal, gvec, noise, **kw)
    assert build.launch_counts == _counts(
        **{"gtao_noise_fp16" if fp16 else "gtao_noise": 1,
           count_key(bent, precision): 1})
    ao_p, ed_p = main_pass_plain(mips, normal, gvec, noise, **kw)
    assert torch.equal(ed_k, ed_p)
    d = _bytes_diff(ao_k, ao_p, bent)
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    tkw = dict(slice_count=preset[0], steps_per_slice=preset[1], fp16=fp16)
    table = gtao_noise_table(noise, gvec, **tkw)
    table_p = noise_table_plain(noise, gvec, **tkw)
    if fp16:
        assert torch.equal(table, table_p)
    else:
        assert float((table - table_p).abs().max()) <= ATOL_TRIG


@pytest.mark.parametrize("shape,passes", [((64, 64), 1), ((37, 50), 2),
                                          ((20, 136), 2)],
                         ids=["64x64", "37x50-2pass", "20x136-2pass"])
@pytest.mark.parametrize("bent,fp16", [(True, False), (False, True),
                                       (True, True)],
                         ids=["bent", "fp16", "bent_fp16"])
def test_denoise_variants_bit_exact(cuda_frame, bent, fp16, shape, passes):
    """K4's variant instantiations (the packed bent-normal term, fp16 and
    both) bit for bit against their plain versions on random AO terms and
    packed edges, on a tile and a half with 16-byte stores too, one launch
    of the variant per pass."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.gtao_denoise import (count_key, denoise_chain,
                                                  denoise_pass_plain)

    h, w = shape
    g = torch.Generator(device="cuda").manual_seed(h * w + passes)
    ao = torch.randint(0, 256, (h, w, 4) if bent else (h, w), generator=g,
                       device="cuda", dtype=torch.int32).to(torch.uint8)
    if bent:
        ao = ao.view(torch.int32).reshape(h, w)
    ed = torch.randint(0, 256, (h, w), generator=g, device="cuda",
                       dtype=torch.int32).to(torch.uint8)
    build.reset_counts()
    got = denoise_chain(ao, ed, n_passes=passes, blur_beta=1.2, bent=bent,
                        fp16=fp16)
    assert build.launch_counts == _counts(**{count_key(bent, fp16): passes})
    want = ao
    for i in range(passes):
        final = i == passes - 1
        want = denoise_pass_plain(want, ed, 1.2 if final else 1.2 / 5.0,
                                  final, bent=bent, fp16=fp16)
    assert torch.equal(got, want)


def test_closest_kernel_over_compact_table(cuda_frame):
    """K1 (csrc/bvh8_closest.cu, nodes8c) against its plain version: the
    frame's primary rays in 16x8 pixel tiles (as the frame traces them),
    on consecutive rays and on a frame that is not a multiple of the tile;
    the triangle soups of tests/torch_closest_cases.py (equal-t ties,
    sibling slots with identical boxes, grazing and axis-aligned rays,
    t_max <= t_min) in tiles and rows; K7a "sort" gives K1's t."""
    from torch_closest_cases import CASES, H, T_MIN, W, frame_rays, \
        port_scene, soup
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.traverse_bvh8 import (closest_kernel,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, camera_rays

    def same(a, b):
        return all(torch.equal(a[k].view(torch.int32),
                               b[k].view(torch.int32))
                   for k in ("t", "tri", "u", "v"))

    r = cuda_frame
    cam, _, _ = _inputs(r)
    sc = r.scene_device
    w, h = r.config.width, r.config.height
    o, d = camera_rays(cam, w, h)
    tmx = torch.full((w * h,), T_MAX, device=o.device)
    build.reset_counts()
    got = trace_closest_bvh8(sc, o, d, 1e-3, T_MAX, height=h, width=w)
    assert same(got, trace_closest_plain(sc, o, d, 1e-3, T_MAX))
    assert same(got, closest_kernel(sc, o, d, 1e-3, tmx))
    n = 37 * w
    part = closest_kernel(sc, o[:n], d[:n], 1e-3, tmx[:n], tile_w=w)
    assert same(part, {k: v[:n] for k, v in got.items()})
    assert build.launch_counts == _counts(bvh8_closest=3)
    steps = trace_closest_bvh8(sc, o, d, 1e-3, T_MAX, count_steps=True)
    assert torch.equal(steps["t"], got["t"])
    for leaf_max in CASES.values():
        v0, v1, v2 = soup()
        scene, _, _ = port_scene(v0, v1, v2, leaf_max, device="cuda")
        rays = [torch.tensor(x, device="cuda") for x in frame_rays(v0, v1,
                                                                     v2)]
        want = trace_closest_plain(scene, rays[0], rays[1], T_MIN, rays[2])
        assert int((want["tri"] >= 0).sum()) > 0
        assert same(trace_closest_bvh8(scene, rays[0], rays[1], T_MIN,
                                       rays[2], height=H, width=W), want)
        assert same(closest_kernel(scene, rays[0], rays[1], T_MIN, rays[2]),
                    want)


@pytest.mark.parametrize("shape,passes", [((80, 96), 1), ((37, 50), 1),
                                          ((5, 3), 1), ((80, 96), 3),
                                          ((37, 50), 2)],
                         ids=["80x96", "37x50", "5x3", "80x96-3pass",
                              "37x50-2pass"])
def test_denoise_kernel_bit_exact(cuda_frame, shape, passes):
    """K4 (csrc/gtao_denoise.cu) bit for bit against its plain version on
    random AO and packed edges: rows of a multiple of 4 (4-byte loads and
    stores) and not, tiles cut by the image's edge, an image smaller than
    one tile, several passes, and inputs that are not 4-byte aligned."""
    from tpurt_torch.kernels.gtao_denoise import (denoise_chain,
                                                  denoise_pass_plain)

    h, w = shape
    g = torch.Generator(device="cuda").manual_seed(h * w + passes)
    buf = torch.randint(0, 256, (2, h * w + 1), generator=g,
                        device="cuda", dtype=torch.int32).to(torch.uint8)
    for ao, ed in ((buf[0, :-1].view(h, w), buf[1, :-1].view(h, w)),
                   (buf[0, 1:].view(h, w), buf[1, 1:].view(h, w))):
        got = denoise_chain(ao, ed, n_passes=passes, blur_beta=1.2)
        want = ao
        for i in range(passes):
            final = i == passes - 1
            blur = 1.2 if final else 1.2 / 5.0
            want = denoise_pass_plain(want, ed, blur, final)
        assert torch.equal(got, want)


def test_sqrt_on_card_is_ieee(cuda_frame):
    """passes/encodings.sqrt on the card (PyTorch's CUDA root) equals
    numpy's IEEE root bit for bit, as it does on the host, so the camera
    rays are the same on both."""
    from tpurt_torch.passes.encodings import sqrt

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(0.0, 10.0, 1_000_000),
                        10.0 ** rng.uniform(-37, 38, 100_000)]).astype(
                            np.float32)
    got = sqrt(torch.from_numpy(x).cuda()).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))


@pytest.mark.parametrize("bent,precision",
                         [(False, "exact")] + GTAO_VARIANTS,
                         ids=["exact", "bent", "half", "fp16", "bent_fp16"])
def test_gtao_main_band(cuda_frame, bent, precision):
    """K3 over a band of rows (the band-sharded frame's GTAO) in every
    instantiation: bit for bit the same rows of the whole-frame K3 (bands
    at the image's first and last rows included), against its plain
    version at K3's budget (edges equal, 1 u8 step per byte on <= 0.1%),
    one K3h and one K3 band launch per band, a band leaving the image
    refused before any launch; compute_ao_band on the card equal to
    compute_ao's rows on every band of a 4-way split."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.gtao_main import (count_key, gtao_main,
                                               main_pass_plain)
    from tpurt_torch.passes.gtao import (GtaoSettings, compute_ao,
                                         compute_ao_band, noise_maps_64,
                                         prefilter_depths)

    r = cuda_frame
    out = r.render()
    _, _, gtao = _inputs(r)
    fp16 = precision == "fp16"
    h, w = out["depth"].shape
    mips = prefilter_depths(out["depth"], gtao["host"], fp16=fp16)
    args = (mips, out["normal"], gtao["vec16" if fp16 else "vec"],
            noise_maps_64(3, r.device))
    kw = dict(slice_count=9, steps_per_slice=3, bent=bent,
              precision=precision)
    ao, edges = gtao_main(*args, **kw)
    for row_start, rows in ((0, 17), (13, 9), (h - 9, 9), (0, h), (40, 1)):
        build.reset_counts()
        band_ao, band_edges = gtao_main(*args, row_start=row_start,
                                        num_rows=rows, **kw)
        whole = (row_start, rows) == (0, h)
        assert build.launch_counts == _counts(**{
            "gtao_noise_fp16" if fp16 else "gtao_noise": 1,
            count_key(bent, precision) if whole else "gtao_main_band": 1})
        idx = slice(row_start, row_start + rows)
        assert torch.equal(band_ao, ao[idx]) and torch.equal(band_edges,
                                                             edges[idx])
        ao_p, ed_p = main_pass_plain(*args, row_start=row_start,
                                     num_rows=rows, **kw)
        assert torch.equal(band_edges, ed_p)
        d = _bytes_diff(band_ao, ao_p, bent)
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    build.reset_counts()
    for row_start, rows in ((-1, 9), (h - 8, 9)):
        with pytest.raises(ValueError):
            gtao_main(*args, row_start=row_start, num_rows=rows, **kw)
    assert build.launch_counts == _counts()
    s = GtaoSettings(9, 3, denoise=2, bent_normals=bent, precision=precision)
    noise = noise_maps_64(3, r.device)
    full = compute_ao(out["depth"], out["normal"], gtao, s, noise)
    band = h // 4
    for k in range(4):
        got = compute_ao_band(out["depth"], out["normal"], gtao, s, noise,
                              k * band, band)
        assert torch.equal(got, full[k * band:(k + 1) * band])


def test_sharded_geometry_frame(tmp_path):
    """The sharded-geometry frame ("bvh8": K1 and K5 on each shard, the
    attribute and texel rows through ring_gather, a mip scene's into K9)
    with 2 gloo ranks on the card, spawned (tests/torch_geometry_worker.py
    checks each rank's launches): every output of the default and the mip
    frame equal to render()'s, and K9 over the ring's rows bit-equal to K9
    over the table at 1 and 4 taps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_geometry_worker as worker

    worker.spawn(worker.cuda_worker, 2, str(tmp_path))
    got = np.load(tmp_path / "cuda.npz")
    cases = [c for c, _, _ in worker.CUDA_CASES]
    assert {c: bool(got[f"{c}/ok_launches"]) for c in cases} == {
        c: True for c in cases}
    assert {c: bool(got[f"{c}/ok_texels"]) for c in cases} == {
        c: True for c in cases}
    off = [k for k in got.files if not k.split("/")[1].startswith("ok_")]
    assert {k.split("/")[0] for k in off} == set(cases)
    assert {k: int(got[k].sum()) for k in off} == {k: 0 for k in off}


def test_sync_spans_are_the_stream_syncs(cuda_frame):
    """No frame of render_passes synchronises the stream, with the camera
    moved or still: neither the eager frame (a step hook) nor the replay
    of the frame's CUDA graph raises a warning of torch.cuda's sync debug
    mode; the hooked frame enters no sync.* span, and one upload span
    where the camera moved. The camera is put back afterwards."""
    import collections
    import warnings

    from tpurt_torch.kernels import build

    r = cuda_frame
    pos = np.array(r.camera.pos)
    for _ in range(2):  # the eager frame of this key, then the capture
        r.render_passes(r.noise_index)
    torch.cuda.synchronize()

    def frame(hooked):
        spans = collections.Counter()

        @contextlib.contextmanager
        def step(name):
            spans[name] += 1
            yield

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                if hooked:
                    r.render_passes(r.noise_index, step)
                else:
                    r.render_passes(r.noise_index)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = [str(w.message) for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
        return spans, syncs

    try:
        for hooked in (True, False):
            for moved in (True, False):
                if moved:
                    r.camera_mut().set_pos(np.array(r.camera.pos)
                                           + np.float32([0.05, 0.0, 0.0]))
                replays = build.launch_counts["frame_graph"]
                spans, syncs = frame(hooked)
                assert syncs == [], (hooked, moved, syncs)
                assert not [n for n in spans if n.startswith("sync.")]
                if hooked:
                    assert spans["upload"] == int(moved), spans
                assert build.launch_counts["frame_graph"] == replays + (
                    not hooked)
    finally:
        r.camera_mut().set_pos(pos)


def _eager_step(name):
    """A step hook that times nothing: the frame runs eagerly."""
    return contextlib.nullcontext()


def _bench_renderer(width=96, height=80):
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    return build_bench_scene(Renderer(RendererConfig(
        width=width, height=height, device="cuda")),
        field=dict(nx=4, nz=4, subdiv=3), cubes=4)


FRAME_KEYS = ("image", "color", "depth", "normal", "ao")


def _same_frame(got, want, what):
    for key in FRAME_KEYS:
        assert torch.equal(_bits(got[key]), _bits(want[key])), (what, key)


def _graph_moves(r, fn):
    """fn()'s result and what r's frame graph did in it: (launches of the
    graph, captures)."""
    from tpurt_torch.kernels import build

    launches, captures = build.launch_counts["frame_graph"], r._graph.captures
    out = fn()
    return out, (build.launch_counts["frame_graph"] - launches,
                 r._graph.captures - captures)


def _nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def test_graph_frames_equal_eager_frames():
    """12 render() frames, the camera moved before each, all enqueued
    without a sync (more than 3 in flight) and every output held to the
    end: the first frame runs eagerly, the second captures the frame's
    CUDA graph, and from it every frame is one launch of the graph and no
    kernel launch of the host; each frame's outputs are tensors of their
    own, read after at least three later replays, and equal bit for bit
    the eager frame (a hooked render_passes) of a second renderer at the
    same pose and noise index. On the card (a torch.profiler trace) the
    last 10 frames run 10 times the eager frame's kernels, the launches
    the capture recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpurt_torch.kernels import build

    g, e = _bench_renderer(), _bench_renderer()
    pos0 = np.array(g.camera.pos)
    poses = [pos0 + np.float32([0.02 * i, 0.01 * i, 0.0]) for i in range(12)]
    outs, host = [], []

    def frames(poses):
        for pos in poses:
            g.camera_mut().set_pos(pos)
            before = dict(build.launch_counts)
            outs.append(g.render(block=False))
            host.append({k: n - before[k]
                         for k, n in build.launch_counts.items()
                         if n != before[k]})

    frames(poses[:2])
    _, ran = _launched(lambda: frames(poses[2:]))
    torch.cuda.synchronize()
    ptrs = {outs[i][k].data_ptr() for i in range(12) for k in FRAME_KEYS}
    assert len(ptrs) == 12 * len(FRAME_KEYS)
    assert not torch.equal(outs[0]["image"], outs[11]["image"])
    eager = []
    for i, pos in enumerate(poses):
        e.camera_mut().set_pos(pos)
        build.reset_counts()
        want = e.render_passes(i, _eager_step)
        eager.append(_nonzero(build.launch_counts))
        _same_frame(outs[i], want, i)
    per_frame = eager[0]
    assert eager == [per_frame] * 12 and "frame_graph" not in per_frame
    assert host == [per_frame] + [{"frame_graph": 1}] * 11
    assert g._graph.captures == 1 and g._graph.recorded == per_frame
    assert ran == {k: 10 * n for k, n in build.by_kernel(per_frame).items()}


def test_graph_recaptures_on_resize_and_light_count():
    """A light recoloured in place replays the same graph; a resize and a
    new light count each run one eager frame and capture again at the
    next; every frame equals the eager frame of a second renderer with
    the same change, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpurt_torch.scene.lights import PointLight

    g, e = _bench_renderer(), _bench_renderer()

    def recolour(r):
        light = r.lights_mut().all_lights()[0]
        light.color = np.asarray(light.color, np.float32) * 0.5

    def resize(r):
        r.resize(80, 64)

    def add_light(r):
        r.lights_mut().point_lights.append(PointLight(
            pos=np.float32([0.0, -3.0, 0.0]),
            color=np.float32([2.0, 1.5, 1.0]), falloff_distance=12.0,
            casts_shadows=True))

    for _ in range(3):  # eager, capture, replay
        g.render()
    for change, want_moves in ((recolour, [(1, 0)]),
                               (resize, [(0, 0), (1, 1), (1, 0)]),
                               (add_light, [(0, 0), (1, 1), (1, 0)])):
        change(g)
        change(e)
        for want in want_moves:
            noise = g.noise_index
            got, moves = _graph_moves(g, g.render)
            assert moves == want, change.__name__
            _same_frame(got, e.render_passes(noise, _eager_step),
                        change.__name__)
    assert tuple(got["image"].shape) == (64, 80, 3)


def test_replayed_frame_launches_equal_the_eager_frame():
    """On a mip scene (K9 and K10's epilogue in the frame) the kernel
    launches the host counts at an eager frame are those the capture
    records, and those a replay runs on the card (a torch.profiler
    trace, by kernel); the host launches the graph once a replayed
    frame and no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpurt_torch.kernels import build

    r = _mip_renderer("pair", 4)
    shadow = r.stats()["shadow_casting_lights"]
    want = _nonzero(_counts(bvh8_closest=1, bvh8_any=shadow, gtao_noise=1,
                            gtao_main=1, gtao_denoise=1, mip_texels=1,
                            shade_surface_nmap=1, **SHADE_CALL))
    seen = []
    for _ in range(2):  # eager, capture
        build.reset_counts()
        _, moves = _graph_moves(r, r.render)
        seen.append((_nonzero(build.launch_counts), moves))
    assert seen == [(want, (0, 0)), ({"frame_graph": 1}, (1, 1))]
    assert r._graph.recorded == want
    build.reset_counts()
    (_, moves), ran = _launched(lambda: _graph_moves(r, r.render))
    assert (_nonzero(build.launch_counts), moves) == ({"frame_graph": 1},
                                                      (1, 0))
    assert ran == build.by_kernel(want)


def test_hooked_dynamic_and_mesh_frames_run_eager():
    """The frames that need a hook, a sync or a collective stay eager
    (frame_graph does not move): render_passes with a step hook,
    render_dynamic (refit and rebuild), and render() over a one-rank
    NCCL mesh, whose frame equals the single-device frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import socket

    import torch.distributed as dist

    from tpurt_torch.app.bench_scene import rotation_frames
    from tpurt_torch.dist import make_mesh
    from tpurt_torch.kernels import build

    r = _bench_renderer()
    t = rotation_frames(r.scene.transforms, 3)[2]
    replays = build.launch_counts["frame_graph"]
    for _ in range(3):
        r.render_passes(r.noise_index, _eager_step)
        r.render_dynamic(t, refit=True)
        r.render_dynamic(t, refit=False)
    assert build.launch_counts["frame_graph"] == replays
    single = _bench_renderer()
    for _ in range(2):
        single.render()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        meshed = _bench_renderer()
        meshed.config.mesh = make_mesh()
        replays = build.launch_counts["frame_graph"]
        for _ in range(2):
            got = meshed.render()
        assert build.launch_counts["frame_graph"] == replays
    finally:
        dist.destroy_process_group()
    _same_frame(got, single.render_passes(1, _eager_step), "mesh")


LIGHT_CASES = ["point", "spot", "directional", "area", "mixed1", "mixed2",
               "mixed3", "mixed4", "inactive", "no_shadow", "equal_angles",
               "no_falloff", "other_type", "empty", "many"]


@pytest.mark.parametrize("case", LIGHT_CASES)
def test_shade_light_kernels_bit_identical(cuda_frame, case):
    """K8a and K8b (csrc/shade_lights.cu) against the plain pre-pass and
    sum on the card, bit for bit in L, nc_NdotL, wants_shadow, t_max and
    rho, on the frame's surface with every 17th lane a miss: all 7,680
    lanes (30 blocks) and the first 7,643 (not a multiple of the block);
    the light sets of tests/torch_light_cases.py. shade()'s three outputs
    against the plain chain (plain pre-pass, K2, plain sum, the encode),
    with 1 + 1 launches per call (K8b 2 for 33 lights)."""
    from torch_light_cases import light_cases

    from tpurt_torch.engine import convert
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.shade_lights import (OCC_CHUNK, RAY_KEYS,
                                                  light_rays,
                                                  light_rays_plain,
                                                  light_sum, light_sum_plain)
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_closest_bvh8)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import (SHADOW_T_MIN, _shade_outputs,
                                          shade, surface)

    r = cuda_frame
    cam, _, _ = _inputs(r)
    sc = r.scene_device
    w, h = r.config.width, r.config.height
    o, d = camera_rays(cam, w, h)
    hits = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX)
    hits["tri"][::17] = -1
    lights = convert.light_tensors(light_cases(r)[case], "cuda")
    s = lights["pos"].shape[0]
    sums = -(-s // OCC_CHUNK)
    whole = surface(sc, cam, hits)
    assert bool(whole["valid"].any()) and not bool(whole["valid"].all())
    for n in (w * h, w * h - 37):
        surf = {k: v[:n] for k, v in whole.items()}
        build.reset_counts()
        rays = light_rays(surf["world_pos"], surf["N"], surf["valid"],
                          lights)
        assert build.launch_counts == _counts(shade_light_rays=1)
        plain = light_rays_plain(surf["world_pos"], surf["N"],
                                 surf["valid"], lights)
        for key in RAY_KEYS:
            assert torch.equal(_bits(rays[key]), _bits(plain[key])), (key, n)
        occ = [trace_any_bvh8(sc, surf["world_pos"], L, SHADOW_T_MIN, t)
               for L, t in zip(rays["L"], rays["t_max"])]
        if case == "mixed3":
            assert any(bool((m & o_).any())
                       for m, o_ in zip(rays["wants_shadow"], occ))
        build.reset_counts()
        rho = light_sum(surf, rays, occ, lights)
        assert build.launch_counts == _counts(shade_light_sum=sums)
        want = light_sum_plain(surf, plain, occ, lights)
        assert torch.equal(_bits(rho), _bits(want)), n
    build.reset_counts()
    got = shade(sc, cam, lights, hits)
    assert build.launch_counts == _counts(bvh8_any=s, shade_surface=1,
                                          shade_light_rays=1,
                                          shade_light_sum=sums)
    plain = light_rays_plain(whole["world_pos"], whole["N"], whole["valid"],
                             lights)
    occ = [trace_any_bvh8(sc, whole["world_pos"], L, SHADOW_T_MIN, t)
           for L, t in zip(plain["L"], plain["t_max"])]
    want = _shade_outputs(light_sum_plain(whole, plain, occ, lights),
                          whole["valid"], cam, whole["world_pos"], whole["N"])
    for key in want:
        assert torch.equal(_bits(got[key]), _bits(want[key])), key


def test_shade_light_kernels_refuse_before_launch(cuda_frame):
    """On the card the wrappers refuse a strided row, a light table on
    another device and a missing occlusion mask with ValueError, and
    launch nothing."""
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.shade_lights import light_rays, light_sum
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import surface

    r = cuda_frame
    cam, lights, _ = _inputs(r)
    sc = r.scene_device
    o, d = camera_rays(cam, r.config.width, r.config.height)
    surf = surface(sc, cam, trace_closest_bvh8(sc, o, d, T_MIN, T_MAX))
    rays = light_rays(surf["world_pos"], surf["N"], surf["valid"], lights)
    occ = torch.zeros_like(rays["wants_shadow"])
    host_lights = convert.light_tensors(r.lights.shader_arrays(), "cpu")
    strided = torch.stack([surf["N"], surf["N"]], -1)[..., 0]
    build.reset_counts()
    for call in (
            lambda: light_rays(surf["world_pos"], strided, surf["valid"],
                               lights),
            lambda: light_rays(surf["world_pos"], surf["N"], surf["valid"],
                               host_lights),
            lambda: light_sum(dict(surf, V=strided), rays, occ, lights),
            lambda: light_sum(surf, rays, occ[:-1], lights)):
        with pytest.raises(ValueError):
            call()
    assert build.launch_counts == _counts()


# K9's tiers and taps; the cut textures workload (tests/test_torch_mip_frame
# .py's field) and the budgets (quad, pair) that make flatten_scene pick
# each tier
MIP_TIERS = ("quad", "pair", "block4")
MIP_TAPS = (1, 4, 16)
MIP_FIELD = dict(nx=3, nz=3, subdiv=2, spacing=1.0, extents=(16, 32, 64))
MIP_BUDGETS = dict(quad=(1 << 40, 1 << 40), pair=(0, 1 << 40),
                   block4=(0, 0))


def _same_bits(got, want):
    """Equal NaN masks and equal bits elsewhere (a NaN's payload may
    differ between the kernel and PyTorch's ops)."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(_bits(got[~nan]), _bits(want[~nan])))


def _mip_renderer(tier, taps):
    from tpurt_torch.app.textures_scene import build_textures_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.scene import scene

    saved = scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES
    try:
        scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES = \
            MIP_BUDGETS[tier]
        r = build_textures_scene(Renderer(RendererConfig(
            width=96, height=80, mipmaps=True, aniso_taps=taps,
            device="cuda")), field=MIP_FIELD)
    finally:
        scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES = saved
    assert f"tex_mip_{tier}" in r.scene_device
    return r


@pytest.mark.parametrize("tier", MIP_TIERS)
def test_mip_texels_kernel_bit_identical(tier):
    """K9 (csrc/mip_texels.cu) against its plain version on the card in
    each tier at 1, 4 and 16 taps, on a textured frame's hits with
    tests/test_torch_texture_sampling.py's edges (every 17th lane a miss,
    a NaN distance, distances of 0 and 1e30 for LODs under 0 and past the
    last level, uv = +-1e4): its LOD, its major axis and its texels
    bit-equal to the torch chain's, one launch per call; the rows K9 reads
    (mip_texel_rows) equal to the plain version's, and K9 over those rows
    served by a gather hook bit-equal to K9 over the table, one launch
    each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.mip_texels import (mip_texel_rows,
                                                mip_texel_rows_plain,
                                                mip_texels, mip_texels_plain)
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import _normalize, cone_spread

    r = _mip_renderer(tier, 1)
    sc = r.scene_device
    table, offsets, sizes = (sc[f"tex_mip_{tier}"],
                             sc[f"tex_mip_{tier}_offsets"],
                             sc["tex_mip_sizes"])
    cam, _, _ = _inputs(r)
    w, h = r.config.width, r.config.height
    o, d = camera_rays(cam, w, h)
    hits = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX)
    hits["tri"][::17] = -1
    hits["t"][::17] = T_MAX
    hits["t"][5] = float("nan")
    hits["t"][6] = 0.0
    hits["t"][7] = 1e30
    tri = torch.clamp_min(hits["tri"], 0).long()
    attr = sc["tri_attr"][tri]
    u, v = hits["u"][:, None], hits["v"][:, None]
    wgt = 1.0 - u - v
    uv = attr[:, 3:5] * wgt + attr[:, 15:17] * u + attr[:, 27:29] * v
    uv[1:5] = torch.tensor([[1e4, -1e4], [-1e4, 1e4], [1e4, 1e4],
                            [-1e4, -1e4]], device=uv.device)
    normal = _normalize(attr[:, 5:8] * wgt + attr[:, 17:20] * u
                        + attr[:, 29:32] * v)
    spread = cone_spread(cam, h)
    served = []

    def gather(flat):
        served.append(flat.numel())
        return table[flat]

    for taps in MIP_TAPS:
        lanes = (hits["t"], d, normal, attr, uv, spread, taps)
        build.reset_counts()
        got, lod, duv = mip_texels(tier, table, offsets, sizes, *lanes,
                                   footprint=True)
        assert build.launch_counts == _counts(mip_texels=1)
        want, want_lod, want_duv = mip_texels_plain(
            tier, table, offsets, sizes, *lanes, footprint=True)
        assert _same_bits(lod, want_lod), (tier, taps, "lod")
        assert float(lod[6]) < 0 and float(lod[7]) > sizes.shape[1]
        if taps > 1:
            assert _same_bits(duv, want_duv), (tier, taps, "duv")
        assert bool(torch.isnan(got[5]).all())
        assert _same_bits(got, want), (tier, taps, "texels")
        build.reset_counts()
        rows = mip_texel_rows(tier, offsets, sizes, *lanes)
        assert build.launch_counts == _counts(mip_texel_rows=1)
        assert torch.equal(rows, mip_texel_rows_plain(
            tier, offsets, sizes, *lanes)), (tier, taps, "rows")
        build.reset_counts()
        served.clear()
        through = mip_texels(tier, None, offsets, sizes, *lanes,
                             gather=gather)
        assert build.launch_counts == _counts(mip_texels=1,
                                              mip_texel_rows=1)
        assert served == [rows.numel()]
        assert _same_bits(through, got), (tier, taps, "gathered")


@pytest.mark.parametrize("tier", MIP_TIERS)
def test_textured_frame_with_k9_equals_the_torch_chain(tier, monkeypatch):
    """A textured render() frame with K9 against the same frame with the
    torch chain in its place, at 1 and 16 taps: every output bit-equal;
    K9 launches once per frame beside K1, K2 per shadow light, K10 and
    its epilogue, K8a, K8b, K3h, K3 and K4 once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels import mip_texels as k9
    from tpurt_torch.passes import shade

    for taps in (1, 16):
        r = _mip_renderer(tier, taps)
        shadow = r.stats()["shadow_casting_lights"]
        for _ in range(2):  # eager, the graph's capture
            r.render()
        torch.cuda.synchronize()
        # a replay: its kernels on the card
        got, ran = _launched(lambda: r.render_passes(r.noise_index))
        assert ran == build.by_kernel(_counts(
            bvh8_closest=1, bvh8_any=shadow, gtao_noise=1, gtao_main=1,
            gtao_denoise=1, mip_texels=1, shade_surface_nmap=1,
            **SHADE_CALL)), ran
        with monkeypatch.context() as m:
            m.setattr(shade, "mip_texels", k9.mip_texels_plain)
            build.reset_counts()
            # a hooked frame runs eagerly: the graph holds K9
            want = r.render_passes(r.noise_index, _eager_step)
            assert build.launch_counts["mip_texels"] == 0
        assert float((got["image"].amax(-1) > 0).float().mean()) > 0.3
        for key in ("image", "color", "depth", "normal", "ao"):
            assert torch.equal(_bits(got[key]), _bits(want[key])), (
                tier, taps, key)
