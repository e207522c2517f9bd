"""The bench scene: tpurt's ``bench.py`` shape with procedural cubes.

tpurt's bench (``bench.py:36-80``) renders a 12x12 field of subdivided
boxes (43,200 tris) and a ground plane plus 8 textured glTF cubes, lit by a
directional sun, a spot and an area light, all three casting shadows. The
glTF asset is not shipped, so the 8 cubes here are procedural textured
cubes (``material_field(1, 1, 1, seed=i)``) placed at bench.py's model
matrices. ``build_bench_scene`` takes any renderer with tpurt's surface
(``models``, ``camera_mut``, ``lights_mut``, ``prepare_first_frame``), so
the same function builds the same scene for both packages. The scene has
10 instances (box field, ground, 8 cubes); ``rotation_frames`` and
``scrambled_transforms`` animate them for ``Renderer.render_dynamic``.
"""
from __future__ import annotations

import numpy as np

from ..scene.lights import AreaLight, DirectionalLight, SpotLight
from ..scene.procedural import box_field, ground_plane, material_field

FULL = dict(nx=12, nz=12, subdiv=5)


def build_bench_scene(renderer, field=None, cubes: int = 8):
    """Populate `renderer` with the bench scene and prepare the first
    frame. `field` (box_field kwargs) and `cubes` cut it to size for tests;
    the defaults are the bench shape."""
    field = FULL if field is None else field
    renderer.models.append(box_field(**field))
    renderer.models.append(ground_plane())
    for i in range(cubes):
        m = material_field(nx=1, nz=1, subdiv=1, seed=i)
        m.set_model_matrix(np.array([[0.45, 0, 0, (i - 3.5) * 1.4],
                                     [0, 0.45, 0, -2.2],
                                     [0, 0, 0.45, 0.0]], np.float32))
        renderer.models.append(m)

    renderer.camera_mut().set_pos([0.0, -2.5, -9.5])
    d = np.array([0.0, 0.3, 1.0])
    renderer.camera_mut().set_dir(d / np.linalg.norm(d))

    lights = renderer.lights_mut()
    lights.directional_lights.append(DirectionalLight(
        dir=np.array([0.35, 0.85, 0.4]) / np.linalg.norm([0.35, 0.85, 0.4]),
        color=[1.4, 1.3, 1.1], casts_shadows=True))
    lights.spot_lights.append(SpotLight(
        pos=[0.0, -4.0, 0.0], dir=[0.0, 1.0, 0.0],
        color=np.array([1.36, 0.16, 2.22]) * 10.0, falloff_distance=12.0,
        penumbra_umbra_angles=(np.radians(30), np.radians(45)),
        casts_shadows=True))
    lights.area_lights.append(AreaLight(
        pos=[-2.0, -3.0, 0.2], pos2=[-2.0, -3.0, -0.8],
        pos3=[-2.0, -2.2, -0.8], invert_normal=False,
        color=np.array([1.96, 0.06, 0.41]) * 3.0, falloff_distance=12.0,
        penumbra_umbra_angles=(np.radians(90), np.radians(90.1)),
        casts_shadows=True))
    renderer.prepare_first_frame()
    return renderer


def rotation_frames(base: np.ndarray, frames: int) -> np.ndarray:
    """The dynamic bench's animation (tpurt ``tools/dynamic_bench.py:45-54``):
    every instance's 3x3 part of `base` (I, 3, 4) rotated about Y by angles
    ``linspace(0, 0.5, frames)`` radians. Returns (frames, I, 3, 4) f32."""
    out = []
    for a in np.linspace(0.0, 0.5, frames).astype(np.float32):
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t = np.array(base, np.float32, copy=True)
        t[:, :, :3] = np.einsum("ij,njk->nik", rot, t[:, :, :3])
        out.append(t)
    return np.stack(out).astype(np.float32)


# tpurt's test teleports six small cubes within +-8; the bench scene's rest
# tree keeps the 43,200-tri box field apart from the small instances, and
# only +-16 lifts its refit quality ratio past the trigger (2.0) for seed 0
BENCH_SCRAMBLE_EXTENT = 16.0


def scrambled_transforms(base: np.ndarray, seed: int = 0,
                         extent: float = 8.0) -> np.ndarray:
    """Instances teleported across each other (tpurt
    ``tests/test_dynamic.py:197-205``): every translation drawn from
    uniform(-extent, extent). The rest-pose BVH8 then groups distant
    triangles and its refit quality ratio grows past the rebuild
    trigger."""
    t = np.array(base, np.float32, copy=True)
    t[:, :, 3] = np.random.default_rng(seed).uniform(-extent, extent,
                                                     t[:, :, 3].shape)
    return t
