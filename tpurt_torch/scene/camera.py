"""Camera with the reference's exact conventions.

Reference: src/vk_renderer/vk_camera.rs — right-handed look-at with
up = (0, -1, 0) (vk_camera.rs:182-189) and an OpenGL-style perspective
projection (nalgebra Perspective3, vk_camera.rs:191-193). The "uniform"
(view, view_inv, proj, proj_inv, camera_pos — vk_camera.rs:9-16) becomes a
pytree of f32 arrays fed straight into the jitted frame function.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def look_at_rh(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """nalgebra Isometry3::look_at_rh — camera looks down -z."""
    eye = np.asarray(eye, np.float32)
    f = np.asarray(target, np.float32) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float32)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4, dtype=np.float32)
    view[0, :3] = s
    view[1, :3] = u
    view[2, :3] = -f
    view[0, 3] = -np.dot(s, eye)
    view[1, 3] = -np.dot(u, eye)
    view[2, 3] = np.dot(f, eye)
    return view


def perspective_rh(aspect: float, fovy: float, znear: float, zfar: float) -> np.ndarray:
    """nalgebra Perspective3::to_homogeneous (OpenGL NDC, z in [-1, 1])."""
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return m


@dataclass
class Camera:
    """Defaults match the renderer's construction (renderer.rs:222-231):
    pos = origin, dir = +z, fovy = pi/2, znear = 0.1, zfar = 1000."""

    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    dir: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 1.0], np.float32))
    aspect: float = 1.0
    fovy: float = float(np.pi / 2)
    znear: float = 0.1
    zfar: float = 1000.0

    def set_pos(self, pos):
        self.pos = np.asarray(pos, np.float32)

    def set_dir(self, d):
        d = np.asarray(d, np.float32)
        self.dir = d / np.linalg.norm(d)

    def set_aspect(self, aspect: float):
        self.aspect = float(aspect)

    def set_fovy(self, fovy: float):
        self.fovy = float(fovy)

    def set_znear(self, znear: float):
        self.znear = float(znear)

    def set_zfar(self, zfar: float):
        self.zfar = float(zfar)

    def view_matrix(self) -> np.ndarray:
        return look_at_rh(self.pos, self.pos + self.dir, np.array([0.0, -1.0, 0.0], np.float32))

    def perspective_matrix(self) -> np.ndarray:
        return perspective_rh(self.aspect, self.fovy, self.znear, self.zfar)

    def uniform(self) -> dict:
        """The camera pytree consumed by the jitted frame (vk_camera.rs:104-126)."""
        view = self.view_matrix()
        proj = self.perspective_matrix()
        return dict(
            view=view,
            view_inv=np.linalg.inv(view).astype(np.float32),
            proj=proj,
            proj_inv=np.linalg.inv(proj).astype(np.float32),
            camera_pos=np.asarray(self.pos, np.float32),
        )
