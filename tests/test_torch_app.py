"""The app layer: the port's controller, offline CLI and replay loop
against tpurt's, on a cut bench scene written as a textured ``.gltf``
(``tests/torch_gltf_writer.py``; tpurt's own app tests load BoxTextured,
which this machine lacks, ROADMAP F1).

The port renders with ``--device cpu``. tpurt's CLI builds its renderer
with the default tracer, which on the CPU is its XLA tracer (ROADMAP F2),
while the port traces BVH8 (its K1/K2 plain versions); the frames are held
at the frame bars of chip_smoke.py's phase 3 and test_torch_frame.py: u8
equal on >= 99.9% of pixels and off by more than 2 on <= 0.1%. The
controller's camera path is numpy in both packages and is held bit for
bit.
"""
import json

import numpy as np
import pytest
import torch

from torch_gltf_writer import CAM_DIR, CAM_POS, write_bench_gltf

SIZE = 64
CLI = ["--width", str(SIZE), "--height", str(SIZE), "--quality", "low",
       "--cam-pos", *map(str, CAM_POS), "--cam-dir", *map(str, CAM_DIR)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("app") / "bench_cut.gltf"
    write_bench_gltf(str(path), field=dict(nx=3, nz=3, subdiv=2), cubes=2)
    return str(path)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _assert_frame_bars(got, ref):
    assert got.shape == ref.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int)).max(-1)
    assert (d == 0).mean() >= 0.999, (d == 0).mean()
    assert (d > 2).mean() <= 1e-3, (d > 2).mean()


EVENTS = ([("mouse", 3.0, -1.0), ("key", "w", 16.7), ("key", "a", 5.0),
           ("mouse", -7.5, 2.25), ("key", "ctrl", 33.0), ("key", "s", 9.0),
           ("key", "space", 16.0), ("key", "D", 12.5), ("mouse", 40.0, 0.0),
           ("key", "shift", 100.0)])


def test_controller_matches_tpurt():
    from tpurt.app.controller import FlyCameraController as RefController
    from tpurt.scene.camera import Camera as RefCamera
    from tpurt_torch.app.controller import FlyCameraController
    from tpurt_torch.scene.camera import Camera

    ref, got = RefController(RefCamera()), FlyCameraController(Camera())
    for c in (ref, got):
        c.camera.set_pos(CAM_POS)
        c.camera.set_dir(CAM_DIR)
    for ev in EVENTS:
        for c in (ref, got):
            if ev[0] == "key":
                c.key(ev[1], ev[2])
            else:
                c.mouse(ev[1], ev[2])
        for attr in ("pos", "dir"):
            a, b = getattr(got.camera, attr), getattr(ref.camera, attr)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.virtual_pos, ref.virtual_pos)
    assert not np.array_equal(got.camera.pos, np.float32(CAM_POS))


def test_offline_matches_tpurt(model, tmp_path):
    from tpurt.app import offline as ref_offline
    from tpurt_torch.app import offline

    got_png, ref_png = str(tmp_path / "got.png"), str(tmp_path / "ref.png")
    offline.main(["--model", model, *CLI, "--frames", "2", "--out", got_png,
                  "--device", "cpu"])
    ref_offline.main(["--model", model, *CLI, "--frames", "2",
                      "--out", ref_png])
    got = _png(got_png)
    _assert_frame_bars(got, _png(ref_png))
    assert got.shape == (SIZE, SIZE, 3) and (got.max(-1) > 0).mean() > 0.1


def test_offline_equals_render_image(model, tmp_path):
    """The CLI's PNG is Renderer.render_image() of the same scene, bit for
    bit (the 3rd frame: its GTAO noise index included); --bent-normals
    and --profile run."""
    from tpurt_torch.app import offline
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.passes.gtao import GtaoSettings

    out = str(tmp_path / "f.png")
    offline.main(["--model", model, *CLI, "--frames", "3", "--out", out,
                  "--device", "cpu", "--bent-normals", "--profile"])
    r = Renderer(RendererConfig(
        width=SIZE, height=SIZE, device="cpu",
        gtao=GtaoSettings(1, 2, denoise=1, bent_normals=True)))
    offline.default_scene(r, model)
    r.camera_mut().set_pos(CAM_POS)
    r.camera_mut().set_dir(CAM_DIR)
    r.prepare_first_frame()
    for _ in range(3):
        want = r.render_image()
    np.testing.assert_array_equal(_png(out), want)


def test_accumulation_resumes_from_checkpoint(model, tmp_path):
    """--spp 6 with --checkpoint-every 2, stopped after 4 samples and
    resumed from the file, equals one uninterrupted run bit for bit."""
    from tpurt_torch.app import offline

    ckpt = str(tmp_path / "accum.npz")
    parts, whole = str(tmp_path / "parts.png"), str(tmp_path / "whole.png")
    acc = ["--model", model, *CLI, "--device", "cpu",
           "--checkpoint-every", "2"]
    offline.main(acc + ["--spp", "4", "--checkpoint", ckpt, "--out", parts])
    assert int(np.load(ckpt)["num_samples"]) == 4
    offline.main(acc + ["--spp", "6", "--checkpoint", ckpt, "--out", parts])
    assert int(np.load(ckpt)["num_samples"]) == 6
    offline.main(acc + ["--spp", "6", "--out", whole])
    a, b = _png(parts), _png(whole)
    np.testing.assert_array_equal(a, b)
    assert (a.max(-1) > 0).mean() > 0.1


def test_cli_refuses_without_a_card(model, tmp_path):
    """Without --device cpu the CLIs render on the card, and raise where
    there is none."""
    from tpurt_torch.app import interactive, offline

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline.main(["--model", model, *CLI, "--out",
                      str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interactive.main(["--model", model, "--frames", "1"])


def _record(renderer, path):
    """Record the camera at each render() of `renderer`."""
    render = renderer.render

    def wrapped(*a, **kw):
        path.append((renderer.camera.pos.copy(), renderer.camera.dir.copy()))
        return render(*a, **kw)

    renderer.render = wrapped


def test_replay_matches_tpurt(model, tmp_path):
    """run_replay over record_orbit: the camera path bit for bit, the last
    frame at the frame bars."""
    from tpurt.app import interactive as ref_interactive
    from tpurt.app.offline import default_scene as ref_default_scene
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt.passes.gtao import GtaoSettings as RefSettings
    from tpurt_torch.app import interactive
    from tpurt_torch.app.offline import default_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.passes.gtao import GtaoSettings

    events = str(tmp_path / "orbit.jsonl")
    interactive.record_orbit(events, frames=6)
    with open(events) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    ref_interactive.record_orbit(str(tmp_path / "ref.jsonl"), frames=6)
    with open(tmp_path / "ref.jsonl") as f:
        assert lines == [json.loads(x) for x in f if x.strip()]
    replay = interactive.load_replay(events)
    assert sum(len(v) for v in replay.values()) == len(lines) == 8

    renderers, paths = [], []
    for make, config, settings, scene in (
            (Renderer, RendererConfig, GtaoSettings, default_scene),
            (RefRenderer, RefConfig, RefSettings, ref_default_scene)):
        kw = dict(device="cpu") if make is Renderer else {}
        r = make(config(width=SIZE, height=SIZE,
                        gtao=settings(1, 2, denoise=1), **kw))
        scene(r, model)
        r.camera_mut().set_pos(CAM_POS)
        r.camera_mut().set_dir(CAM_DIR)
        r.prepare_first_frame()
        path = []
        _record(r, path)
        renderers.append(r)
        paths.append(path)
    got = interactive.run_replay(renderers[0], replay, frames=6)
    ref = ref_interactive.run_replay(renderers[1], replay, frames=6)
    assert len(paths[0]) == len(paths[1]) == 6
    for (gp, gd), (rp, rd) in zip(*paths):
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(gd, rd)
    assert not np.array_equal(paths[0][0][1], paths[0][-1][1])
    _assert_frame_bars(got, np.asarray(ref))
    assert renderers[0].rendered_frames == 6


def test_interactive_main_saves_frames(model, tmp_path):
    from tpurt_torch.app import interactive

    prefix = str(tmp_path / "f")
    interactive.main(["--model", model, "--frames", "3", "--width", "32",
                      "--height", "32", "--quality", "low", "--save-every",
                      "2", "--out-prefix", prefix, "--cam-pos",
                      *map(str, CAM_POS), "--device", "cpu"])
    for i in (0, 2):
        assert _png(f"{prefix}_{i:05d}.png").shape == (32, 32, 3)
