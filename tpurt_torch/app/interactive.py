"""Replay-driven real-time loop — the living event loop of the app layer;
port of ``tpurt/app/interactive.py``.

The reference's main loop (main.rs:78-130) pumps winit events into the
camera controller and renders once per MainEventsCleared. A render node is
headless, so the equivalent is an *event replay* loop: a recorded stream
of key/mouse events (JSON lines) is fed through FlyCameraController at
real-time pacing, each iteration renders a frame, and FrameTimer prints the
once-per-second ms/FPS line exactly like frame_timer.rs:19-26.

Replay file format — one JSON object per line:
    {"frame": 0, "type": "key",   "name": "w", "ms": 16.7}
    {"frame": 2, "type": "mouse", "dx": 3.0, "dy": -1.0}
Events apply before their frame renders. `record_orbit` generates a sample
stream (a mouse orbit + WASD push-in) for tests and demos.

Usage:
  python -m tpurt_torch.app.interactive --model path.gltf
      [--replay events.jsonl] [--frames 120] [--fps 60]
      [--width 800 --height 800] [--save-every 0] [--out-prefix frame]
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

from ..engine import FrameTimer, Renderer, RendererConfig
from ..passes.gtao import GtaoSettings
from .controller import FlyCameraController
from .offline import QUALITY, add_device_arg, default_scene, write_png


def load_replay(path: str) -> dict:
    """Replay file -> {frame: [event, ...]}."""
    by_frame = defaultdict(list)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            by_frame[int(ev["frame"])].append(ev)
    return by_frame


def record_orbit(path: str, frames: int = 60, ms_per_frame: float = 16.7):
    """Write a sample replay: constant mouse yaw + a forward push."""
    with open(path, "w") as f:
        for i in range(frames):
            f.write(json.dumps(dict(frame=i, type="mouse", dx=4.0, dy=0.0))
                    + "\n")
            if i % 3 == 0:
                f.write(json.dumps(dict(frame=i, type="key", name="w",
                                        ms=ms_per_frame)) + "\n")


def apply_event(controller: FlyCameraController, ev: dict):
    """One replay or live event into the controller."""
    if ev.get("type") == "key":
        controller.key(str(ev.get("name", "")), float(ev.get("ms", 16.7)))
    elif ev.get("type") == "mouse":
        controller.mouse(float(ev.get("dx", 0.0)), float(ev.get("dy", 0.0)))


def run_replay(renderer: Renderer, replay: dict, frames: int,
               fps: float | None = None, save_every: int = 0,
               out_prefix: str = "frame", block: bool = True):
    """Drive the controller + renderer through `frames` iterations.
    fps paces the loop in real time (None = as fast as possible).
    Returns the last rendered image (numpy u8, read back from the
    renderer's device)."""
    controller = FlyCameraController(renderer.camera_mut())
    timer = FrameTimer()
    target_dt = (1.0 / fps) if fps else 0.0
    image = None
    next_deadline = time.perf_counter()
    for i in range(frames):
        for ev in replay.get(i, ()):
            apply_event(controller, ev)
        out = renderer.render(block=block)
        timer.frame_end()
        if save_every and (i % save_every == 0 or i == frames - 1):
            image = out["image"].cpu().numpy()
            write_png(f"{out_prefix}_{i:05d}.png", image)
        elif i == frames - 1:
            image = out["image"].cpu().numpy()
        if target_dt:
            next_deadline += target_dt
            sleep = next_deadline - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)
    return image


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--replay", default=None,
                   help="JSONL event stream; omit for a generated orbit")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--fps", type=float, default=0.0,
                   help="real-time pacing target; 0 = unthrottled")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--quality", choices=QUALITY, default="ultra")
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--out-prefix", default="frame")
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

    if args.replay:
        replay = load_replay(args.replay)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "orbit.jsonl")
            record_orbit(path, frames=args.frames)
            replay = load_replay(path)
    run_replay(renderer, replay, args.frames, fps=args.fps or None,
               save_every=args.save_every, out_prefix=args.out_prefix)


if __name__ == "__main__":
    main()
