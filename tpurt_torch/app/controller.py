"""Camera controller with the reference app's control math — port of
``tpurt/app/controller.py``.

The reference binds WASD/Ctrl/Shift + mouse to the camera (main.rs:78-125):
key moves are view-relative at SPEED per millisecond, mouse motion
accumulates a virtual (pitch, yaw) position at SENSITIVITY and rebuilds the
direction via the spherical formula (main.rs:117-122). A render node is
headless, so the controller is event-driven and scriptable: feed it key/mouse
events from any front end (or a replay file) and it updates the Camera. It
is numpy on the host, as tpurt's is, so the two move a camera alike.
"""
from __future__ import annotations

import numpy as np

from ..scene.camera import Camera

SPEED = 0.002        # units per millisecond (main.rs:80)
SENSITIVITY = 0.002  # radians per mouse count (main.rs:114)

_KEY_DIRS = {
    "w": np.array([0.0, 0.0, -SPEED], np.float32),
    "s": np.array([0.0, 0.0, SPEED], np.float32),
    "d": np.array([SPEED, 0.0, 0.0], np.float32),
    "a": np.array([-SPEED, 0.0, 0.0], np.float32),
    "ctrl": np.array([0.0, SPEED, 0.0], np.float32),
    "shift": np.array([0.0, -SPEED, 0.0], np.float32),
}


class FlyCameraController:
    def __init__(self, camera: Camera):
        self.camera = camera
        self.virtual_pos = np.zeros(2, np.float32)  # (pitch, yaw) accumulator

    def key(self, name: str, elapsed_ms: float):
        """View-relative translation (main.rs:79-101): the camera-space move
        is rotated to world by the transposed view rotation."""
        diff = _KEY_DIRS.get(name.lower())
        if diff is None:
            return
        view = self.camera.view_matrix()
        world = view[:3, :3].T @ (diff * np.float32(elapsed_ms))
        self.camera.set_pos(self.camera.pos + world)

    def mouse(self, dx: float, dy: float):
        """Mouse-look (main.rs:110-125): virtual_pos += (-dy, dx) * SENS,
        dir = (cos(p)sin(y), sin(p), cos(p)cos(y))."""
        self.virtual_pos += np.array([-dy, dx], np.float32) * SENSITIVITY
        p, y = float(self.virtual_pos[0]), float(self.virtual_pos[1])
        d = np.array([np.cos(p) * np.sin(y), np.sin(p), np.cos(p) * np.cos(y)],
                     np.float32)
        self.camera.set_dir(d / np.linalg.norm(d))
