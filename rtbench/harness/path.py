"""The inputs of each frame, made from the seed: the camera pose on a
smooth closed loop and, in an animated mix, the instance transforms.

The loop is the same curve for every seed; the seed picks where on it the
run starts (its phase). So every seed renders the same set of poses, in
another order. A pose is (position, direction) at frame i:

  s = 2 pi (i / period + phase)
  position = center + radius * (sin s, sin 2s, cos s)
  target = target + target_radius * (sin(s + 1), cos 2s, sin s)

The animation ``rotate_y`` is the bench animation (tpurt
``tools/dynamic_bench.py:45-54``): every instance's 3x3 part rotated about
Y by the angles ``linspace(0, max_angle, frames)``, looping, from a seeded
start.
"""
from __future__ import annotations

import math

import numpy as np


def phase(seed: int, salt: int) -> float:
    return float(np.random.default_rng([seed, salt]).uniform())


class FramePath:
    def __init__(self, traffic: dict, seed: int):
        p = traffic["path"]
        self.period = int(p["period_frames"])
        self.center = np.asarray(p["center"], np.float64)
        self.radius = np.asarray(p["radius"], np.float64)
        self.target = np.asarray(p["target"], np.float64)
        self.target_radius = np.asarray(p["target_radius"], np.float64)
        self.phase = phase(seed, 1)
        anim = traffic.get("animation")
        self.angles = None
        if anim is not None:
            if anim["kind"] != "rotate_y":
                raise ValueError(f"unknown animation {anim['kind']!r}")
            self.angles = np.linspace(0.0, float(anim["max_angle"]),
                                      int(anim["frames"])).astype(np.float32)
            self.angle_start = int(np.random.default_rng([seed, 2]).integers(
                len(self.angles)))

    def pose(self, i: int):
        """(position (3,), direction (3,)) float32 of frame i."""
        s = 2.0 * math.pi * (i / self.period + self.phase)
        pos = self.center + self.radius * np.array(
            [math.sin(s), math.sin(2 * s), math.cos(s)])
        tgt = self.target + self.target_radius * np.array(
            [math.sin(s + 1.0), math.cos(2 * s), math.sin(s)])
        d = tgt - pos
        return (pos.astype(np.float32),
                (d / np.linalg.norm(d)).astype(np.float32))

    def transforms(self, i: int, base: np.ndarray):
        """The instance transforms (I, 3, 4) f32 of frame i from the rest
        transforms `base`, or None without an animation."""
        if self.angles is None:
            return None
        a = self.angles[(self.angle_start + i) % len(self.angles)]
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t = np.array(base, np.float32, copy=True)
        t[:, :, :3] = np.einsum("ij,njk->nik", rot, t[:, :, :3])
        return t.astype(np.float32)
