"""The plain reference frame: camera rays, brute-force ray casting over the
reference's own box hierarchy (``trace.py``), shading with one shadow ray
per shadow-casting light (``shade.py``), the storage formats of the
G-buffer (B10G11R11F color and normals, R16F depth), XeGTAO, the AO
composite, LPM and the sRGB u8 store (``post.py``).

It imports nothing of the program and reads no table the program built:
``Reference`` takes the benchmark's scene data, lights and settings, and
each frame's pose, noise index and instance transforms. ``dtype`` is the
precision of every float (float32 as the renderer states it; a lower one
makes the control).
"""
from __future__ import annotations

import torch

from . import post, shade, trace
from .scene import SceneTables, world_vertices


class Reference:
    def __init__(self, models, lights: list, *, mipmaps: bool, gtao: dict,
                 device, dtype=torch.float32):
        self.dtype = dtype
        self.device = torch.device(device)
        self.tables = SceneTables(models, mipmaps).to(self.device, dtype)
        self.lights = shade.light_tensors(lights, dtype, self.device)
        self.gtao = gtao
        self.lpm = post.lpm_control()
        self._static = None

    def _world(self, transforms):
        if transforms is None and self._static is not None:
            return self._static
        tf = None if transforms is None else torch.as_tensor(
            transforms, device=self.device).to(self.dtype)
        vpos, vnrm, vtan = world_vertices(self.tables, tf)
        idx = self.tables["idx"]
        v = [vpos[idx[:, k]] for k in range(3)]
        world = ((vpos, vnrm, vtan), v, trace.Triangles(*v))
        if transforms is None:
            self._static = world
        return world

    @torch.no_grad()
    def gbuffer(self, pos, direction, *, width: int, height: int,
                aniso_taps: int = 1, transforms=None):
        """(the unquantized G-buffer of ``shade.shade``, the primary hits,
        the camera) at camera pose (pos, direction)."""
        cam = shade.camera(pos, direction, width, height)
        verts, v, tris = self._world(transforms)
        o, d = shade.camera_rays(cam, width, height, self.dtype, self.device)
        t_max = torch.full((o.shape[0],), shade.T_MAX, dtype=self.dtype,
                           device=self.device)
        hit = trace.closest_hit(tris, *v, o, d, shade.T_MIN, t_max)

        def any_hit(origin, dirs, t_min, tm):
            return trace.any_hit(tris, origin, dirs, t_min, tm)

        g = shade.shade(self.tables, verts, cam, self.lights, hit, d,
                        rows=height, aniso_taps=aniso_taps, any_hit=any_hit)
        return g, hit, cam

    @torch.no_grad()
    def frame(self, pos, direction, *, width: int, height: int,
              noise_index: int, aniso_taps: int = 1,
              transforms=None) -> dict:
        """The frame at camera pose (pos, direction): image (H, W, 3) u8,
        depth (H, W) and normal (H, W, 3) as stored, ao (H, W) the final
        AO integers, hit (H, W) bool, and two (H, W) bool masks of the
        pixels whose primary ray (`hit_undecided`) or some shadow ray
        (`shadow_undecided`) the reference cannot decide (``trace.py``)."""
        g, hit, cam = self.gbuffer(pos, direction, width=width,
                                   height=height, aniso_taps=aniso_taps,
                                   transforms=transforms)
        out = self.finish(g, cam, width, height, noise_index)
        return dict(out, hit=(hit[1] >= 0).reshape(height, width),
                    hit_undecided=hit[4].reshape(height, width),
                    shadow_undecided=g["shadow_undecided"].reshape(
                        height, width))

    def finish(self, g: dict, cam: dict, width: int, height: int,
               noise_index: int) -> dict:
        """The storage formats, GTAO, composite, LPM and the u8 store."""
        color = post.q_r11g11b10f(g["color"]).reshape(height, width, 3)
        depth = post.q_r16f(g["depth"]).reshape(height, width)
        normal = post.q_r11g11b10f(g["normal_enc"]).reshape(height, width, 3)
        consts = post.gtao_constants(width, height, cam["fovy"],
                                     cam["aspect"])
        ao = post.gtao(depth, normal, consts, self.gtao["slice_count"],
                       self.gtao["steps_per_slice"], self.gtao["denoise"],
                       noise_index)
        image = post.compose(color, ao, self.lpm)
        return dict(image=image, depth=depth, normal=normal, ao=ao)
