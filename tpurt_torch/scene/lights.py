"""Scene light API and its GPU-side packing.

Reference: src/vk_renderer/lights.rs — typed light collections
(point/spot/directional/area) serialized into an 80-byte-equivalent struct
(lights.rs:69-82). On TPU the packed struct becomes a struct-of-arrays pytree
(one (L, ...) array per field) so the shading pass can vmap over lights.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

LIGHT_TYPE_POINT = 0
LIGHT_TYPE_SPOT = 1
LIGHT_TYPE_DIRECTIONAL = 2
LIGHT_TYPE_AREA = 3


def _v3(x):
    return np.asarray(x, np.float32).reshape(3)


@dataclass
class PointLight:
    """lights.rs:95-158."""

    pos: np.ndarray
    color: np.ndarray
    falloff_distance: float
    casts_shadows: bool

    def shader_data(self):
        return dict(pos=_v3(self.pos), light_type=LIGHT_TYPE_POINT, dir=np.zeros(3, np.float32),
                    casts_shadows=int(self.casts_shadows), color=_v3(self.color),
                    falloff_distance=float(self.falloff_distance),
                    area_pos2=np.zeros(3, np.float32), penumbra_angle=0.0,
                    area_pos3=np.zeros(3, np.float32), umbra_angle=0.0)


@dataclass
class SpotLight:
    """lights.rs:161-243. penumbra_umbra_angles = (penumbra, umbra) radians."""

    pos: np.ndarray
    dir: np.ndarray
    color: np.ndarray
    falloff_distance: float
    penumbra_umbra_angles: tuple
    casts_shadows: bool

    def shader_data(self):
        return dict(pos=_v3(self.pos), light_type=LIGHT_TYPE_SPOT, dir=_v3(self.dir),
                    casts_shadows=int(self.casts_shadows), color=_v3(self.color),
                    falloff_distance=float(self.falloff_distance),
                    area_pos2=np.zeros(3, np.float32),
                    penumbra_angle=float(self.penumbra_umbra_angles[0]),
                    area_pos3=np.zeros(3, np.float32),
                    umbra_angle=float(self.penumbra_umbra_angles[1]))


@dataclass
class DirectionalLight:
    """lights.rs:245-296."""

    dir: np.ndarray
    color: np.ndarray
    casts_shadows: bool

    def shader_data(self):
        return dict(pos=np.zeros(3, np.float32), light_type=LIGHT_TYPE_DIRECTIONAL,
                    dir=_v3(self.dir), casts_shadows=int(self.casts_shadows),
                    color=_v3(self.color), falloff_distance=0.0,
                    area_pos2=np.zeros(3, np.float32), penumbra_angle=0.0,
                    area_pos3=np.zeros(3, np.float32), umbra_angle=0.0)


@dataclass
class AreaLight:
    """lights.rs:298-403 — rectangle defined by pos/pos2/pos3; the plane normal
    is serialized into `dir` via (pos-pos2) x (pos3-pos2), optionally inverted
    (lights.rs:384-389)."""

    pos: np.ndarray
    pos2: np.ndarray
    pos3: np.ndarray
    invert_normal: bool
    color: np.ndarray
    falloff_distance: float
    penumbra_umbra_angles: tuple
    casts_shadows: bool

    def shader_data(self):
        plane_normal = np.cross(_v3(self.pos) - _v3(self.pos2), _v3(self.pos3) - _v3(self.pos2))
        if self.invert_normal:
            plane_normal = -plane_normal
        plane_normal = plane_normal / np.linalg.norm(plane_normal)
        return dict(pos=_v3(self.pos), light_type=LIGHT_TYPE_AREA,
                    dir=plane_normal.astype(np.float32),
                    casts_shadows=int(self.casts_shadows), color=_v3(self.color),
                    falloff_distance=float(self.falloff_distance),
                    area_pos2=_v3(self.pos2),
                    penumbra_angle=float(self.penumbra_umbra_angles[0]),
                    area_pos3=_v3(self.pos3),
                    umbra_angle=float(self.penumbra_umbra_angles[1]))


@dataclass
class Lights:
    """lights.rs:4-67 — serialization order: point, spot, directional, area
    (lights.rs:24-47)."""

    point_lights: List[PointLight] = field(default_factory=list)
    spot_lights: List[SpotLight] = field(default_factory=list)
    directional_lights: List[DirectionalLight] = field(default_factory=list)
    area_lights: List[AreaLight] = field(default_factory=list)

    def get_lights_count(self) -> int:
        return (len(self.point_lights) + len(self.spot_lights)
                + len(self.directional_lights) + len(self.area_lights))

    def all_lights(self):
        return (list(self.point_lights) + list(self.spot_lights)
                + list(self.directional_lights) + list(self.area_lights))

    def shader_arrays(self) -> dict:
        """Pack to a struct-of-arrays pytree with one leading light axis."""
        lights = self.all_lights()
        n = max(len(lights), 1)
        out = dict(
            pos=np.zeros((n, 3), np.float32),
            light_type=np.zeros((n,), np.int32),
            dir=np.zeros((n, 3), np.float32),
            casts_shadows=np.zeros((n,), np.int32),
            color=np.zeros((n, 3), np.float32),
            falloff_distance=np.zeros((n,), np.float32),
            area_pos2=np.zeros((n, 3), np.float32),
            penumbra_angle=np.zeros((n,), np.float32),
            area_pos3=np.zeros((n, 3), np.float32),
            umbra_angle=np.zeros((n,), np.float32),
            # `active` lets an empty light set keep a static (1, ...) shape.
            active=np.zeros((n,), np.float32),
        )
        for i, light in enumerate(lights):
            d = light.shader_data()
            out["pos"][i] = d["pos"]
            out["light_type"][i] = d["light_type"]
            out["dir"][i] = d["dir"]
            out["casts_shadows"][i] = d["casts_shadows"]
            out["color"][i] = d["color"]
            out["falloff_distance"][i] = d["falloff_distance"]
            out["area_pos2"][i] = d["area_pos2"]
            out["penumbra_angle"][i] = d["penumbra_angle"]
            out["area_pos3"][i] = d["area_pos3"]
            out["umbra_angle"][i] = d["umbra_angle"]
            out["active"][i] = 1.0
        return out
