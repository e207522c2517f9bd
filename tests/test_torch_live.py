"""The port's live server (app/live.py): the HTTP surface, the event route
into the fly controller and the frames-in-flight loop against the blocking
loop, on a cut bench scene written as a ``.gltf``, rendered on the CPU.

Every socket binds 127.0.0.1 on an ephemeral port, every request has a
timeout, /stream is read only for its first bytes, every thread is joined
with a timeout, and the app and the server stop in ``finally``.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_gltf_writer import CAM_DIR, CAM_POS, write_bench_gltf

SIZE = 48
TIMEOUT = 20.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("live") / "bench_cut.gltf"
    write_bench_gltf(str(path), field=dict(nx=3, nz=3, subdiv=2), cubes=2)
    return str(path)


def _make_app(model, depth=2):
    from tpurt_torch.app.live import LiveApp
    from tpurt_torch.app.offline import default_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.passes.gtao import GtaoSettings

    r = Renderer(RendererConfig(width=SIZE, height=SIZE, device="cpu",
                                gtao=GtaoSettings(1, 2, denoise=1)))
    default_scene(r, model)
    r.camera_mut().set_pos(CAM_POS)
    r.camera_mut().set_dir(CAM_DIR)
    r.prepare_first_frame()
    return LiveApp(r, pipeline_depth=depth)


def _post(url, ev):
    req = urllib.request.Request(url, method="POST",
                                 data=json.dumps(ev).encode())
    return urllib.request.urlopen(req, timeout=TIMEOUT).status


def test_live_server_end_to_end(model):
    from tpurt_torch.app.live import serve

    app = _make_app(model)
    server = serve(app, SIZE, SIZE, port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    reader = None
    try:
        app.render_once()
        html = urllib.request.urlopen(f"{base}/", timeout=TIMEOUT).read()
        assert b"/stream" in html and b"keydown" in html
        jpg = urllib.request.urlopen(f"{base}/frame.jpg",
                                     timeout=TIMEOUT).read()
        assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"

        # events reach the fly controller before the next frame
        pos0 = app.renderer.camera.pos.copy()
        dir0 = app.renderer.camera.dir.copy()
        for _ in range(5):
            assert _post(f"{base}/event",
                         dict(type="key", name="w", ms=100.0)) == 200
        assert _post(f"{base}/event", dict(type="mouse", dx=30.0,
                                           dy=0.0)) == 200
        app.render_once()
        assert np.linalg.norm(app.renderer.camera.pos - pos0) > 1e-4
        assert not np.array_equal(app.renderer.camera.dir, dir0)
        assert app.frames_rendered == 2

        # a malformed event and an unknown path
        req = urllib.request.Request(f"{base}/event", method="POST",
                                     data=b"{not json")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nothing", timeout=TIMEOUT)
        assert e.value.code == 404

        # the MJPEG stream yields a multipart frame
        got = {}

        def read_stream():
            with urllib.request.urlopen(f"{base}/stream",
                                        timeout=TIMEOUT) as resp:
                got["type"] = resp.headers["Content-Type"]
                got["head"] = resp.read(120)

        reader = threading.Thread(target=read_stream, daemon=True)
        reader.start()
        time.sleep(0.2)
        app.render_once()
        reader.join(timeout=TIMEOUT)
        assert not reader.is_alive()
        assert got["type"].startswith("multipart/x-mixed-replace")
        assert b"--tpurtframe" in got["head"]
        assert b"Content-Type: image/jpeg" in got["head"]
    finally:
        app.stop()
        server.shutdown()
        server.server_close()
        if reader is not None:
            reader.join(timeout=TIMEOUT)


def _recording(app):
    frames = []
    publish = app.publish

    def wrapper(image):
        frames.append(image.copy())
        publish(image)

    app.publish = wrapper
    return frames


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_loop_matches_blocking(model, depth):
    """The frames-in-flight loop (render(block=False)) publishes the same
    frames as the blocking loop, compared before JPEG encoding, frame index
    for frame index (the GTAO noise follows it), and drains its queue on
    stop."""
    blocking_app = _make_app(model, depth=1)
    blocking = _recording(blocking_app)
    for _ in range(4):
        blocking_app.render_once()

    app = _make_app(model, depth=depth)
    pipelined = _recording(app)
    t = threading.Thread(target=app.run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while app.frames_rendered < 4 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        app.stop()
        t.join(timeout=60.0)
    assert not t.is_alive()
    assert app.frames_rendered == len(pipelined) >= 4
    for a, b in zip(blocking, pipelined):
        np.testing.assert_array_equal(a, b)
    assert (blocking[0].max(-1) > 0).mean() > 0.1


def test_latest_times_out_without_a_frame(model):
    app = _make_app(model)
    t0 = time.monotonic()
    assert app.latest(timeout=0.05) == (None, -1)
    assert time.monotonic() - t0 < 5.0
