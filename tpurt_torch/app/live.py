"""Live interactive delivery: fly the scene from a browser — port of
``tpurt/app/live.py``.

The reference is a windowed winit app (main.rs:78-130): events pump into
the camera controller, every MainEventsCleared renders + presents. A render
node is headless, so presentation becomes an HTTP surface served by the
node itself:

  * GET  /          — a canvas page that shows the MJPEG stream and
                      captures WASD/+mouse-drag, POSTing them as the same
                      event dicts the replay loop uses (interactive.py),
  * GET  /stream    — multipart/x-mixed-replace MJPEG of the latest frames
                      (the swapchain-present analogue),
  * GET  /frame.jpg — single latest frame (polling fallback / tests),
  * POST /event     — {"type":"key","name":"w","ms":16.7} or
                      {"type":"mouse","dx":3,"dy":-1}; queued to the render
                      thread (the winit event queue analogue).

One render thread owns the card: it applies the queued events, launches
the frames and reads each back with ``.cpu()``; HTTP threads only swap the
encoded-frame buffer and the event queue. ``Renderer.render(block=False)``
returns freshly allocated tensors every frame, so a frame in flight stays
valid while the next one runs.

Usage:
  python -m tpurt_torch.app.live --model path.gltf --port 8080
      [--device cuda|cpu]
then open http://host:8080/ and fly with WASD + drag.
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..engine import FrameTimer, Renderer, RendererConfig
from ..passes.gtao import GtaoSettings
from .controller import FlyCameraController
from .interactive import apply_event
from .offline import QUALITY, add_device_arg, default_scene

_PAGE = """<!doctype html>
<html><head><title>tpurt live</title><style>
 body{background:#111;color:#ccc;font:13px monospace;margin:12px}
 img{image-rendering:pixelated;border:1px solid #444;cursor:crosshair}
</style></head><body>
<div>tpurt — WASD/space/shift to move, drag to look</div>
<img id="v" src="/stream" width="%(w)d" height="%(h)d">
<div id="s"></div>
<script>
const post = o => fetch('/event', {method:'POST', body:JSON.stringify(o)});
let last = performance.now(), down = {};
document.addEventListener('keydown', e => { down[e.key.toLowerCase()] = 1; });
document.addEventListener('keyup',   e => { down[e.key.toLowerCase()] = 0; });
setInterval(() => {
  const now = performance.now(), ms = now - last; last = now;
  for (const k of ['w','a','s','d',' ','shift'])
    if (down[k]) post({type:'key', name: k === ' ' ? 'space' : k, ms: ms});
}, 33);
const img = document.getElementById('v');
let drag = false;
img.addEventListener('mousedown', () => drag = true);
document.addEventListener('mouseup', () => drag = false);
document.addEventListener('mousemove', e => {
  if (drag) post({type:'mouse', dx: e.movementX, dy: e.movementY});
});
</script></body></html>"""


class LiveApp:
    """Render loop + frame buffer + event queue shared with the server."""

    def __init__(self, renderer: Renderer, jpeg_quality: int = 85,
                 pipeline_depth: int = 2):
        self.renderer = renderer
        self.controller = FlyCameraController(renderer.camera_mut())
        self.events: "queue.Queue[dict]" = queue.Queue(maxsize=1024)
        self.timer = FrameTimer()
        self.jpeg_quality = jpeg_quality
        # frames-in-flight depth (the reference pipelines 3 deep,
        # renderer.rs:300-318; depth 2 keeps one frame of input latency
        # while the host launches the next frame). 1 = the blocking loop.
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._frame_lock = threading.Condition()
        self._frame_bytes: bytes | None = None
        self._frame_seq = 0
        self._stop = threading.Event()
        self.frames_rendered = 0

    # -- render side --------------------------------------------------------

    def apply_events(self):
        while True:
            try:
                ev = self.events.get_nowait()
            except queue.Empty:
                return
            apply_event(self.controller, ev)

    def render_once(self):
        self.apply_events()
        self._consume(self.renderer.render(block=True))

    def _consume(self, out):
        self.publish(out["image"].cpu().numpy())  # waits for the frame
        self.timer.frame_end()
        self.frames_rendered += 1

    def run_pipelined(self):
        """Bounded frames-in-flight render loop: camera events apply at
        DISPATCH time (frame i+depth-1 is launched while frame i is on the
        device — the reference's overlap, renderer.rs:400-466), the
        oldest frame is consumed/published once the queue is full. Input
        latency = depth-1 frames."""
        q: deque = deque()
        while not self._stop.is_set():
            self.apply_events()
            q.append(self.renderer.render(block=False))
            if len(q) >= self.pipeline_depth:
                self._consume(q.popleft())
        while q:
            self._consume(q.popleft())

    def publish(self, image: np.ndarray):
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="JPEG",
                                    quality=self.jpeg_quality)
        with self._frame_lock:
            self._frame_bytes = buf.getvalue()
            self._frame_seq += 1
            self._frame_lock.notify_all()

    def run(self):
        if self.pipeline_depth > 1:
            self.run_pipelined()
            return
        while not self._stop.is_set():
            self.render_once()

    def stop(self):
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    # -- server side --------------------------------------------------------

    def latest(self, after_seq: int = -1, timeout: float = 5.0):
        """(jpeg_bytes, seq) — blocks until a frame newer than after_seq."""
        deadline = time.monotonic() + timeout
        with self._frame_lock:
            while (self._frame_bytes is None
                   or self._frame_seq <= after_seq):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None, after_seq
                self._frame_lock.wait(remaining)
            return self._frame_bytes, self._frame_seq

def make_handler(app: LiveApp, width: int, height: int):
    page = (_PAGE % dict(w=width, h=height)).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)
            elif self.path == "/frame.jpg":
                data, _ = app.latest()
                if data is None:
                    self.send_response(503)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=tpurtframe")
                self.end_headers()
                seq = -1
                try:
                    while True:
                        data, seq = app.latest(after_seq=seq)
                        if data is None:
                            if app.stopped:  # no frame will come
                                break
                            continue
                        self.wfile.write(b"--tpurtframe\r\n")
                        self.wfile.write(b"Content-Type: image/jpeg\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(data)}\r\n\r\n".encode())
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path == "/event":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                    app.events.put_nowait(ev)
                    code = 200
                except (json.JSONDecodeError, queue.Full):
                    code = 400
                self.send_response(code)
                self.send_header("Content-Length", "0")
                self.end_headers()
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def serve(app: LiveApp, width: int, height: int, port: int = 8080,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port),
                                 make_handler(app, width, height))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--quality", choices=QUALITY, default="ultra")
    p.add_argument("--cam-pos", type=float, nargs=3, default=[0.0, 0.0, -3.0])
    add_device_arg(p)
    args = p.parse_args(argv)

    slices, steps = QUALITY[args.quality]
    cfg = RendererConfig(width=args.width, height=args.height,
                         gtao=GtaoSettings(slice_count=int(slices),
                                           steps_per_slice=int(steps)),
                         device=args.device)
    renderer = Renderer(cfg)
    default_scene(renderer, args.model)
    renderer.camera_mut().set_pos(args.cam_pos)
    renderer.prepare_first_frame()

    app = LiveApp(renderer)
    server = serve(app, args.width, args.height, port=args.port)
    print(f"live: serving http://0.0.0.0:{args.port}/ "
          f"(WASD + drag; ctrl-c to stop)", flush=True)
    try:
        app.run()   # the render loop owns the main thread (and the card)
    except KeyboardInterrupt:
        pass
    finally:
        app.stop()
        server.shutdown()


if __name__ == "__main__":
    main()
