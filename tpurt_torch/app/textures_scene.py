"""The textures workload: tpurt's ``tools/textures_bench.py:36-56``.

A 12x12 ``material_field`` of subdivided boxes (subdiv 13: 292,032
triangles, 292,034 with the ground), each box its own primitive with
distinct 256x256 albedo, ORM and normal textures (144 x 3 x 256^2 x 4
bytes = 113 MB of source texels, the analogue of the reference's 256-slot
bindless texture array), a ground plane, a sun and a spot light casting
shadows, GTAO ULTRA with sharp denoise and mip chains on
(``RendererConfig(mipmaps=True)``; at this size tpurt's cutover picks the
pair tier). ``build_textures_scene`` takes any
renderer with tpurt's surface, so the same function builds the same scene
for both packages; `field` cuts it to size for tests.
"""
from __future__ import annotations

import numpy as np

from ..scene.lights import DirectionalLight, SpotLight
from ..scene.procedural import ground_plane, material_field

FULL = dict(nx=12, nz=12, subdiv=13, spacing=1.0, extents=(256,))


def build_textures_scene(renderer, field=None):
    """Populate `renderer` with the textures workload (material_field
    kwargs `field`, the full size by default) and prepare the first
    frame."""
    renderer.models.append(material_field(**(FULL if field is None
                                             else field)))
    renderer.models.append(ground_plane())
    renderer.camera_mut().set_pos([0.0, -3.5, -9.0])
    d = np.array([0.0, 0.3, 1.0])
    renderer.camera_mut().set_dir(d / np.linalg.norm(d))
    lights = renderer.lights_mut()
    lights.directional_lights.append(DirectionalLight(
        dir=np.array([0.35, 0.85, 0.4]) / np.linalg.norm([0.35, 0.85, 0.4]),
        color=[1.4, 1.3, 1.1], casts_shadows=True))
    lights.spot_lights.append(SpotLight(
        pos=[0.0, -5.0, 0.0], dir=[0.0, 1.0, 0.0],
        color=np.array([1.36, 0.16, 2.22]) * 10.0, falloff_distance=14.0,
        penumbra_umbra_angles=(np.radians(30), np.radians(45)),
        casts_shadows=True))
    renderer.prepare_first_frame()
    return renderer
