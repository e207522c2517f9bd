"""The public renderer API — port of ``tpurt/engine/renderer.py`` for the
static-scene frame on one device.

State kept between frames: the model residency (tpurt's ``Model`` state
machine), the flattened scene uploaded once per resident-set change, and
the camera / light / GTAO-constant tensors, re-uploaded only when their host
values change.

Every static scene traces through the BVH8 kernels (K1, K2): tpurt's
"auto" tier would pick its binary packet kernel for scenes under ~5k
triangles, but ``nodes8`` always exists for a static scene and on a GPU one
kernel serves every size.

``device="cuda"`` without a card raises; nothing moves to the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from tpurt.scene.camera import Camera
from tpurt.scene.lights import Lights
from tpurt.scene.model import Model

from ..passes.gtao import GtaoSettings, gtao_constants
from ..passes.tonemap import LpmParams, lpm_setup
from ..scene.scene import FlatScene, flatten_scene
from . import convert
from .frame import render_frame


@dataclass
class RendererConfig:
    width: int = 800
    height: int = 800
    gtao: GtaoSettings = field(default_factory=lambda: GtaoSettings(
        slice_count=9, steps_per_slice=3, denoise=1))  # ULTRA + sharp
    lpm: LpmParams = field(default_factory=LpmParams)
    enable_gtao: bool = True
    enable_tonemap: bool = True
    device: str = "cuda"


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA device is "
                           f"available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


class Renderer:
    def __init__(self, config: Optional[RendererConfig] = None):
        self.config = config or RendererConfig()
        c = self.config
        self.device = resolve_device(c.device)
        self.camera = Camera(aspect=c.width / c.height)
        self.lights = Lights()
        self.models: list = []
        self._scene: Optional[FlatScene] = None
        self._scene_device = None
        self._input_cache = {}
        self._lpm = convert.lpm_tensors(lpm_setup(c.lpm)[1], self.device)
        self._frame_idx = 0
        self.rendered_frames = 0

    # -- scene management ---------------------------------------------------

    def add_model(self, file_path, model_matrix_3x4) -> Model:
        model = Model(file_path, model_matrix_3x4)
        self.models.append(model)
        return model

    def lights_mut(self) -> Lights:
        return self.lights

    def camera_mut(self) -> Camera:
        return self.camera

    def models_mut(self):
        return self.models

    def prepare_first_frame(self):
        """Resolve residency and flatten + upload the initial scene."""
        self._update_models()
        if self._scene is None:
            raise ValueError(
                "no device-resident models — move the camera closer or add "
                "a model")

    def _update_models(self):
        changed = False
        for m in self.models:
            changed |= m.update_model_status(self.camera.pos)
            changed |= m.dirty
            m.dirty = False
        if (changed or self._scene is None) and any(
                m.is_device_resident() for m in self.models):
            self._scene = flatten_scene(self.models)
            self._scene_device = convert.scene_tensors(
                self._scene.as_pytree(), self.device)

    def _cached(self, key: str, host: dict, to_device):
        """Reuse uploaded tensors while the host values are unchanged."""
        prev = self._input_cache.get(key)
        if prev is not None:
            prev_host, prev_dev = prev
            if prev_host.keys() == host.keys() and all(
                    np.array_equal(prev_host[k], host[k]) for k in host):
                return prev_dev
        dev = to_device(host, self.device)
        self._input_cache[key] = (host, dev)
        return dev

    # -- frame loop -----------------------------------------------------------

    def render(self, block: bool = True) -> dict:
        """Render one frame; returns the output dict of device tensors."""
        c = self.config
        self._update_models()
        if self._scene is None:
            raise RuntimeError("call prepare_first_frame() first")
        cam = self._cached("camera", self.camera.uniform(),
                           convert.camera_tensors)
        lights = self._cached("lights", self.lights.shader_arrays(),
                              convert.light_tensors)
        gtao = self._cached("gtao", gtao_constants(
            c.width, c.height, self.camera.znear, self.camera.zfar,
            self.camera.fovy, self.camera.aspect), convert.gtao_tensors)
        out = render_frame(self._scene_device, cam, lights, gtao, self._lpm,
                           self._frame_idx % 64, width=c.width,
                           height=c.height, gtao_settings=c.gtao,
                           enable_gtao=c.enable_gtao,
                           enable_tonemap=c.enable_tonemap)
        self._frame_idx += 1
        self.rendered_frames += 1
        if block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def render_image(self) -> np.ndarray:
        """Render and read back the 8-bit sRGB frame."""
        return self.render()["image"].cpu().numpy()

    def stats(self) -> dict:
        c = self.config
        shadow_lights = sum(
            1 for light in self.lights.all_lights() if light.casts_shadows)
        out = dict(
            resolution=(c.width, c.height),
            rays_per_frame=c.width * c.height * (1 + shadow_lights),
            lights=self.lights.get_lights_count(),
            shadow_casting_lights=shadow_lights,
            rendered_frames=self.rendered_frames,
            models=len(self.models),
            device_resident_models=sum(
                1 for m in self.models if m.is_device_resident()),
            gtao=dict(slices=c.gtao.slice_count, steps=c.gtao.steps_per_slice,
                      denoise=c.gtao.denoise),
            device=str(self.device),
        )
        if self._scene is not None:
            out.update(tris=int(self._scene.geom["v0"].shape[0]),
                       bvh8_nodes=int(self._scene.bvh["nodes8"].shape[0]),
                       bvh8_depth=self._scene_device["depth8"],
                       primitives=self._scene.num_prims,
                       tracer_tier="bvh8")
        return out

    @property
    def scene(self) -> Optional[FlatScene]:
        return self._scene

    @property
    def scene_device(self):
        return self._scene_device
