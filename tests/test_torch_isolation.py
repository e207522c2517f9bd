"""The port stands alone: with ``import tpurt`` and ``import jax`` made to
fail by a meta-path hook, every module of tpurt_torch and chip_smoke.py
import, and 32x32 CPU frames render through Renderer.render() and
Renderer.render_dynamic() (refit and rebuild), a mip-mapped anisotropic
frame (its shadow rays equal to the steps probe's) and a streaming step of
its texture arena, as do a fused-shadow frame
with two pops and a uv-payload frame, and the diagnostics (the profiler,
render_stream, FrameTimer, the steps and transcendental probes, a counted
trace) and the ground-truth path (an spp frame, a resize, accumulation
with a checkpoint round trip, an RTAO frame, the image metrics), the GTAO
variants' frames with their debug images and the output libraries (HDR10,
color spaces, legacy tonemaps, encodings, validation), the app (the
offline CLI with a checkpoint, the replay loop and the live server on a
written glTF), the band-sharded frame (``RendererConfig.mesh`` on a
one-rank gloo world) and the sharded-geometry frame in both tiers (one
gloo rank). Each
check runs in a fresh subprocess: the pytest process itself has
both packages loaded.
"""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = textwrap.dedent("""
    import importlib.abc
    import sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("tpurt", "jax", "jaxlib"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
""")

CHECKS = {
    "modules": """
        import pkgutil
        import tpurt_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpurt_torch.__path__, "tpurt_torch.")]
        for name in names:
            __import__(name)
        assert len(names) >= 30, names
        import chip_smoke
        assert callable(chip_smoke.main)
    """,
    "frames": """
        import numpy as np
        from tpurt_torch.app.bench_scene import (build_bench_scene,
                                                 rotation_frames)
        from tpurt_torch.engine import Renderer, RendererConfig
        r = build_bench_scene(Renderer(RendererConfig(
            width=32, height=32, device="cpu")),
            field=dict(nx=2, nz=2, subdiv=1), cubes=2)
        assert r.render()["image"].shape == (32, 32, 3)
        t = rotation_frames(r.scene.transforms, 4)[3]
        a = r.render_dynamic(t)
        b = r.render_dynamic(t, refit=False)
        assert "refit_sah_ratio" in a and "refit_sah_ratio" not in b
        for out in (a, b):
            assert out["image"].shape == (32, 32, 3)
            assert int(out["image"].max()) > 0
        # mip-mapped anisotropic frame through the arena, then one
        # streaming step: the textured cube leaves; its slots free and
        # only the rows of images new to the arena upload
        m = build_bench_scene(Renderer(RendererConfig(
            width=32, height=32, device="cpu", mipmaps=True,
            aniso_taps=4)), field=dict(nx=2, nz=2, subdiv=1), cubes=2)
        assert "tex_mip_quad" in m.scene_device
        # the steps probe's shadow rays are the ones the frame traces
        import torch
        from tpurt_torch.passes import shade as shade_pass
        from tpurt_torch.tools import steps_probe
        traced, trace_any = [], shade_pass.trace_any_bvh8
        def recording(scene, o, d, t_min, t_max, **kw):
            traced.append((o, d, t_min, t_max))
            return trace_any(scene, o, d, t_min, t_max, **kw)
        shade_pass.trace_any_bvh8 = recording
        try:
            assert int(m.render()["image"].max()) > 0
        finally:
            shade_pass.trace_any_bvh8 = trace_any
        _, shadow = steps_probe.frame_rays(m)
        assert len(shadow) == len(traced) > 0
        for got, want in zip(shadow, traced):
            assert all(torch.equal(torch.as_tensor(g), torch.as_tensor(w))
                       for g, w in zip(got, want))
        assert steps_probe.run(m)["push_orders"]["none"]["primary"][
            "warp_steps_sum"] > 0
        arena = m._tex_arena
        before = dict(arena._live)
        m.models[-1].set_visible(False)
        assert m.render()["image"].shape == (32, 32, 3)
        after = arena._live
        assert arena.last_freed == len(set(before) - set(after)) > 0
        assert arena.last_uploaded_rows == sum(
            n for k, (_, n) in after.items() if k not in before)
    """,
    "variants": """
        import torch
        from tpurt_torch.app.bench_scene import build_bench_scene
        from tpurt_torch.engine import Renderer, RendererConfig
        from tpurt_torch.engine.frame import render_frame_fused
        from tpurt_torch.kernels import traverse_bvh8 as tb
        from tpurt_torch.passes.gtao import noise_maps_64
        r = build_bench_scene(Renderer(RendererConfig(
            width=32, height=32, device="cpu")),
            field=dict(nx=2, nz=2, subdiv=1), cubes=2)
        base = r.render()["image"]
        cam, lights, gtao = r._frame_inputs()
        tb.POP2_DEFAULT = True
        fused = render_frame_fused(r.scene_device, cam, lights, gtao, r._lpm,
                                   noise_maps_64(0, "cpu"), width=32,
                                   height=32,
                                   gtao_settings=r.config.gtao)["image"]
        tb.POP2_DEFAULT, tb.UVP_DEFAULT = False, True
        r._frame_idx = 0
        uvp = r.render()["image"]
        assert "uvp" in r.scene_device
        assert torch.equal(uvp, base) and int(fused.max()) > 0
        assert (fused.int() - base.int()).abs().max() <= 2
    """,
    "outputs": """
        import dataclasses
        import torch
        from tpurt_torch.app.bench_scene import build_bench_scene
        from tpurt_torch.engine import Renderer, RendererConfig, convert
        from tpurt_torch.passes import (color_spaces, encodings,
                                        tonemaps_legacy)
        from tpurt_torch.passes.tonemap import (a_from_pq, lpm_setup_hdr10,
                                                tonemap_frame_hdr10)
        from tpurt_torch.utils import debug
        r = build_bench_scene(Renderer(RendererConfig(
            width=32, height=32, device="cpu")),
            field=dict(nx=2, nz=2, subdiv=1), cubes=2)
        base = r.config.gtao
        for over in (dict(bent_normals=True), dict(precision="half"),
                     dict(precision="fp16"),
                     dict(bent_normals=True, precision="fp16")):
            r.config.gtao = dataclasses.replace(base, **over)
            out = r.render()
            assert ("bent_normals" in out) == r.config.gtao.bent_normals
            assert int(out["image"].max()) > 0
            for mode in ("normals", "edges", "ao"):
                img = r.gtao_debug_image(mode, out=out)
                assert img.shape == (32, 32, 4) and img.dtype == torch.float16
        hdr = tonemap_frame_hdr10(out["color"], out["ao"], convert.lpm_tensors(
            lpm_setup_hdr10()[1], "cpu"))
        assert bool(torch.isfinite(a_from_pq(hdr)).all())
        rgb = torch.rand(8, 3)
        assert color_spaces.ycbcr_to_hcv(rgb).shape == (8, 3)
        assert tonemaps_legacy.aces_fitted(rgb).shape == (8, 3)
        packed = encodings.r11g11b10_unorm_pack(rgb)
        assert encodings.r11g11b10_unorm_unpack(packed).shape == (8, 3)
        debug.validate_scene(r.scene_device)
        debug.validate_camera(r._frame_inputs()[0])
        with debug.validation(eager=True):
            r.render()
    """,
    "ground_truth": """
        import os
        import tempfile
        import numpy as np
        import torch
        from tpurt_torch.app.bench_scene import build_bench_scene
        from tpurt_torch.engine import Renderer, RendererConfig
        from tpurt_torch.engine import accumulate
        from tpurt_torch.passes.rtao import rtao_frame
        from tpurt_torch.utils import image_metrics
        r = build_bench_scene(Renderer(RendererConfig(
            width=32, height=32, device="cpu", spp=3)),
            field=dict(nx=2, nz=2, subdiv=1), cubes=2)
        aa = r.render()["image"]
        r.resize(40, 24)
        assert r.render()["image"].shape == (24, 40, 3)
        r.resize(32, 32)
        cam, lights, _ = r._frame_inputs()
        st = accumulate.accumulate_samples_scan(
            accumulate.init_accumulation(32, 32, 1), r.scene_device, cam,
            lights, 2, width=32, height=32)
        with tempfile.TemporaryDirectory() as d:
            accumulate.save_checkpoint(os.path.join(d, "a"), st)
            back = accumulate.load_checkpoint(os.path.join(d, "a"))
        assert back.num_samples == 2
        assert torch.equal(back.color_sum, st.color_sum)
        vis, valid = rtao_frame(r.scene_device, cam,
                                torch.Generator().manual_seed(0),
                                width=32, height=32)
        assert vis.shape == (32, 32) and bool(valid.any())
        assert image_metrics.psnr(aa.numpy(), aa.numpy()) == float("inf")
    """,
    "app": """
        import os
        import sys
        import tempfile
        import urllib.request
        import numpy as np
        sys.path.insert(0, "tests")
        from torch_gltf_writer import CAM_DIR, CAM_POS, write_bench_gltf
        from tpurt_torch.app import interactive, live, offline
        from tpurt_torch.engine import Renderer, RendererConfig
        with tempfile.TemporaryDirectory() as d:
            model = os.path.join(d, "m.gltf")
            write_bench_gltf(model, field=dict(nx=2, nz=2, subdiv=1),
                             cubes=1)
            cam = ["--cam-pos", *map(str, CAM_POS), "--cam-dir",
                   *map(str, CAM_DIR)]
            png = os.path.join(d, "f.png")
            offline.main(["--model", model, "--width", "32", "--height",
                          "32", "--quality", "low", "--device", "cpu",
                          "--out", png, *cam])
            offline.main(["--model", model, "--width", "32", "--height",
                          "32", "--spp", "2", "--checkpoint",
                          os.path.join(d, "a"), "--device", "cpu",
                          "--out", png, *cam])
            r = Renderer(RendererConfig(width=32, height=32, device="cpu"))
            offline.default_scene(r, model)
            r.camera_mut().set_pos(CAM_POS)
            r.prepare_first_frame()
            events = os.path.join(d, "e.jsonl")
            interactive.record_orbit(events, frames=3)
            img = interactive.run_replay(r, interactive.load_replay(events),
                                         frames=3)
            assert img.shape == (32, 32, 3)
            app = live.LiveApp(r)
            server = live.serve(app, 32, 32, port=0, host="127.0.0.1")
            try:
                app.render_once()
                url = f"http://127.0.0.1:{server.server_address[1]}"
                jpg = urllib.request.urlopen(url + "/frame.jpg",
                                             timeout=20).read()
                assert jpg[:2] == b"\\xff\\xd8"
            finally:
                app.stop()
                server.shutdown()
                server.server_close()
    """,
    "dist": """
        import socket
        import torch
        import torch.distributed as dist
        from tpurt_torch.app.bench_scene import build_bench_scene
        from tpurt_torch.dist import make_mesh
        from tpurt_torch.engine import Renderer, RendererConfig
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", world_size=1, rank=0,
                                init_method=f"tcp://127.0.0.1:{port}")
        try:
            def make(**kw):
                return build_bench_scene(Renderer(RendererConfig(
                    width=32, height=32, device="cpu", **kw)),
                    field=dict(nx=2, nz=2, subdiv=1), cubes=2)
            want = make().render()
            got = make(mesh=make_mesh(device_type="cpu")).render()
            assert all(torch.equal(want[k], got[k]) for k in want)
        finally:
            dist.destroy_process_group()
    """,
    "geometry": """
        import socket
        import torch
        import torch.distributed as dist
        from tpurt_torch.app.bench_scene import build_bench_scene
        from tpurt_torch.dist import (freeze_meta, gather_frame, make_mesh,
                                      rank_tensors,
                                      render_frame_sharded_geometry,
                                      shard_geometry, shard_tables)
        from tpurt_torch.engine import Renderer, RendererConfig
        from tpurt_torch.kernels.traverse_bvh8 import (_moller_trumbore,
                                                       trace_closest_bvh8)
        from tpurt_torch.passes.gtao import noise_maps_64
        from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
        from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", world_size=1, rank=0,
                                init_method=f"tcp://127.0.0.1:{port}")
        try:
            r = build_bench_scene(Renderer(RendererConfig(
                width=32, height=32, device="cpu")),
                field=dict(nx=2, nz=2, subdiv=1), cubes=2)
            want = r.render_passes(0)
            mesh = make_mesh(device_type="cpu")
            pt = r.scene.as_pytree()
            cam, lights, gtao = r._frame_inputs()
            for tier in ("bvh8", "xla"):
                tbl, meta = shard_tables(pt, 1)
                if tier == "xla":
                    tbl, meta = None, None
                sc, shard, chunks = rank_tensors(
                    pt, shard_geometry(pt, 1, tier), tbl, 0, "cpu")
                got = gather_frame(render_frame_sharded_geometry(
                    sc, shard, cam, lights, gtao, r._lpm,
                    noise_maps_64(0, "cpu"), width=32,
                    height=32, gtao_settings=r.config.gtao, mesh=mesh,
                    tables=tier, shade_tables=chunks,
                    meta=meta and freeze_meta(meta)), mesh)
                if tier == "bvh8":
                    assert all(torch.equal(want[k], got[k]) for k in want)
                    continue
                # the shard's binary tree may decide a shadow ray through a
                # triangle's edge otherwise than the scene's BVH8 (ROADMAP
                # F26): only the pixels whose shadow rays hit the scene
                # only within 1e-5 of triangles' edges, by brute force over
                # every triangle, may differ (one such ray measured)
                o, d = camera_rays(cam, 32, 32)
                hits = trace_closest_bvh8(r.scene_device, o, d, T_MIN,
                                          T_MAX)
                tris = r.scene_device["tris"]
                graze = torch.zeros(32 * 32, dtype=torch.bool)
                for so, sd, tm in shadow_rays(r.scene_device, cam, lights,
                                              hits, d, height=32):
                    hit, _, u, v = _moller_trumbore(
                        tris[None].expand(so.shape[0], -1, -1), so, sd,
                        SHADOW_T_MIN, tm)
                    edge = torch.minimum(torch.minimum(u, v),
                                         1.0 - u - v) <= 1e-5
                    graze |= hit.any(1) & ~(hit & ~edge).any(1)
                assert int(graze.sum()) <= 4, int(graze.sum())
                for k in want:
                    off = (want[k] != got[k]).reshape(32 * 32, -1).any(-1)
                    assert not (off & ~graze).any(), k
        finally:
            dist.destroy_process_group()
    """,
    "diagnostics": """
        import torch
        from tpurt_torch.app.bench_scene import build_bench_scene
        from tpurt_torch.engine import FrameTimer, Renderer, RendererConfig
        from tpurt_torch.engine import profiler
        from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8
        from tpurt_torch.tools import steps_probe, trans_equiv_probe
        r = build_bench_scene(Renderer(RendererConfig(
            width=32, height=32, device="cpu")),
            field=dict(nx=2, nz=2, subdiv=1), cubes=2)
        assert profiler.profile_frame(r, 1).rays_traced == 32 * 32 * 4
        assert len(profiler.device_profile(r, reps=1, k=1).ms_per_pass) == 4
        assert len(list(r.render_stream(2, depth=2))) == 2
        FrameTimer(print_fn=lambda s: None).frame_end()
        rep = steps_probe.run(r)
        assert rep["push_orders"]["none"]["primary"]["warp_steps_sum"] > 0
        primary, shadow = steps_probe.frame_rays(r)
        occ, node, leaf = trace_any_bvh8(r.scene_device, *shadow[0],
                                         count_steps=True,
                                         push_order="nearlast")
        assert node.shape == occ.shape and int(node.sum()) > 0
        assert trans_equiv_probe.run("cpu")["arguments_equal_to_host"]
    """,
}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_port_runs_without_tpurt_and_jax(check):
    code = BLOCK + textwrap.dedent(CHECKS[check]) + textwrap.dedent("""
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("tpurt", "jax", "jaxlib")]
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_blocker_blocks():
    """The hook really refuses tpurt and jax (so a pass above means
    something)."""
    code = BLOCK + "import tpurt\n"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, timeout=120)
    assert out.returncode != 0 and "blocked import of tpurt" in out.stderr
