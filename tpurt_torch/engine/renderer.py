"""The public renderer API — port of ``tpurt/engine/renderer.py`` for the
static-scene frame (``render``, ``render_stream`` with frames in flight)
and the dynamic-scene frame (``render_dynamic``) on one device, and the
static frame band-sharded over a ``torch.distributed`` mesh
(``RendererConfig.mesh``).

State kept between frames: the model residency (tpurt's ``Model`` state
machine), the flattened scene uploaded once per resident-set change (with
the dynamic scene's object tables and refit metadata, uploaded at its first
dynamic frame), the streaming-texture arena that holds the static scene's
texel rows across those changes, the camera / light / GTAO-constant
tensors in one device buffer, updated in place by one non-blocking copy
when their host values change (``convert.InputBuffer``), the static
frame's CUDA graph (``engine/frame_graph.py``) and the refit -> rebuild
trigger.

``render()``'s frame (``render_passes`` without a step hook, on one CUDA
device) is recorded once as a CUDA graph and replayed: the same calls of
``engine/frame.render_frame``, which neither frame synchronises. Every
other frame runs eagerly: with a step hook (the profilers), on the CPU,
over a mesh, and the dynamic frames.

Every static scene traces through the BVH8 kernels (K1, K2): tpurt's
"auto" tier would pick its binary packet kernel for scenes under ~5k
triangles, but ``nodes8`` always exists for a static scene and on a GPU one
kernel serves every size.

``device="cuda"`` without a card raises; nothing moves to the CPU.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..kernels import traverse_bvh8
from ..passes.gtao import (GtaoSettings, gtao_constants, gtao_debug_image,
                           noise_tables)
from ..passes.tonemap import LpmParams, lpm_setup
from ..scene.camera import Camera
from ..scene.lights import Lights
from ..scene.model import Model
from ..scene.scene import FlatScene, flatten_scene
from . import convert
from .dynamic import (REBUILD_SAH_RATIO, make_refit_data,
                      render_frame_dynamic, render_frame_dynamic_refit)
from .frame import no_step, render_frame
from .frame_graph import FrameGraph
from .texture_arena import TextureRowArena


@dataclass
class RendererConfig:
    width: int = 800
    height: int = 800
    gtao: GtaoSettings = field(default_factory=lambda: GtaoSettings(
        slice_count=9, steps_per_slice=3, denoise=1))  # ULTRA + sharp
    lpm: LpmParams = field(default_factory=LpmParams)
    enable_gtao: bool = True
    enable_tonemap: bool = True
    # anti-aliasing samples per pixel (R2-jittered; 1 = the reference)
    spp: int = 1
    # trilinear mip sampling at the ray-cone LOD (the reference's sampler
    # is trilinear, but its textures have one level: off = the reference)
    mipmaps: bool = False
    # anisotropic taps along the footprint's major axis (with mipmaps;
    # 1 = trilinear): the reference sampler's max_anisotropy=16
    aniso_taps: int = 1
    # the static scene's texel rows in one persistent buddy-managed tensor
    # (engine/texture_arena.py): a residency change uploads only the
    # joining images' rows
    texture_arena: bool = True
    device: str = "cuda"
    # a 1-D torch.distributed DeviceMesh (dist/sharding.make_mesh) to
    # band-decompose frames over, one process per rank; None = one device
    mesh: Optional[object] = None


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
        self._inputs = convert.InputBuffer(self.device)
        # GTAO's noise maps of every noise index, on the device
        self._noise = noise_tables(self.device)
        self._graph = FrameGraph()
        self._lpm = convert.lpm_tensors(lpm_setup(c.lpm)[1], self.device)
        self._frame_idx = 0
        self.rendered_frames = 0
        self._obj_device = None      # dynamic-scene object tables
        self._refit_device = None    # BVH8 refit metadata
        self._rebuild_until = -1     # rebuild frames until this index
        self.last_refit_sah_ratio = 1.0
        self._tex_arena: Optional[TextureRowArena] = None

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
            self._scene = flatten_scene(self.models,
                                        mipmaps=self.config.mipmaps)
            pt = self._scene.as_pytree()
            patch = (self._arena_texture_tables(pt)
                     if self.config.texture_arena else {})
            self._scene_device = dict(convert.scene_tensors(pt, self.device),
                                      **patch)
            self._obj_device = self._refit_device = None

    def _arena(self) -> TextureRowArena:
        if self._tex_arena is None:
            self._tex_arena = TextureRowArena(device=self.device)
        return self._tex_arena

    def _arena_texture_tables(self, pt: dict) -> dict:
        """Route the shipped texel table through the streaming arena
        (tpurt ``renderer.py:140-202``): each unique image's rows become a
        content-keyed slot of the arena's one tensor. Removes the table
        from `pt` (so scene_tensors skips it) and returns the device
        tensors that take its place: for a mip tier the arena and the
        offsets moved to the images' slots, without mips
        ``_arena_quad48``'s."""
        key = next((k for k in ("tex_mip_quad", "tex_mip_pair",
                                "tex_mip_block4") if k in pt), None)
        if key is None:
            return self._arena_quad48(pt) if "tex_quad48" in pt else {}
        off_key = key + "_offsets"
        atlas, off = pt.pop(key), np.asarray(pt.pop(off_key))  # (P, L)
        sizes = np.asarray(pt["tex_mip_sizes"])                # (P, L, 2)
        img = np.asarray(self._scene.tex_img_of_prim)          # (P,)
        h = sizes[..., 0].astype(np.int64)
        w = sizes[..., 1].astype(np.int64)
        rows = dict(tex_mip_quad=h * w,
                    tex_mip_pair=h * ((w + 1) // 2),
                    tex_mip_block4=((h + 1) // 2) * ((w + 1) // 2))[key]
        chunks, key_of_slot = {}, []
        base_of_slot = np.zeros(int(img.max()) + 1, np.int64)
        for ui in range(base_of_slot.shape[0]):
            rep = int(np.argmax(img == ui))
            base = int(off[rep, 0])
            chunk = atlas[base:base + int(rows[rep].sum())]
            k = hashlib.sha1(chunk.tobytes()).hexdigest()
            chunks[k] = chunk
            key_of_slot.append(k)
            base_of_slot[ui] = base
        arena = self._arena()
        arena_base = arena.ensure(chunks)
        slot_base = np.asarray([arena_base[k] for k in key_of_slot],
                               np.int64)
        new_off = (off.astype(np.int64) - base_of_slot[img][:, None]
                   + slot_base[img][:, None]).astype(np.int32)
        return {key: arena.atlas,
                off_key: torch.from_numpy(new_off).to(self.device)}

    def _arena_quad48(self, pt: dict) -> dict:
        """The quad rows without mips through the arena (tpurt
        ``renderer.py:204-243``): each unique image's rows at its own (h,
        w) extent, no Hmax x Wmax padding, addressed by a per-image base
        row (``passes/shade.sample_bilinear_quad(base=)``; the same
        values)."""
        quad = pt.pop("tex_quad48")                   # (U, Hmax, Wmax, 64)
        tex_size = np.asarray(self._scene.tex_size)   # (P, 2)
        img = np.asarray(self._scene.tex_img_of_prim)
        chunks, key_of_slot = {}, []
        for ui in range(quad.shape[0]):
            rep = int(np.argmax(img == ui))
            h, w = int(tex_size[rep, 0]), int(tex_size[rep, 1])
            rows = np.ascontiguousarray(quad[ui, :h, :w].reshape(h * w, -1))
            k = hashlib.sha1(rows.tobytes()).hexdigest()
            chunks[k] = rows
            key_of_slot.append(k)
        arena = self._arena()
        arena_base = arena.ensure(chunks)
        base = np.asarray([arena_base[k] for k in key_of_slot], np.int32)
        return dict(tex_quad=arena.atlas,
                    tex_quad_base=torch.from_numpy(base).to(self.device))

    # -- frame loop -----------------------------------------------------------

    def resize(self, width: int, height: int):
        """Render the next frames at `width` x `height` (tpurt's resize).
        What depends on the frame size follows: the camera's aspect, and
        with it the camera and GTAO-constant tensors, which re-upload
        because their host values change; no other state holds a size."""
        self.config.width = width
        self.config.height = height
        self.camera.set_aspect(width / height)

    def _frame_inputs(self, step=no_step):
        """The camera, light and GTAO-constant tensors of this frame: views
        of one device buffer, updated in place where a host value changed
        (``convert.InputBuffer``; its copy inside step("upload"), step as
        in ``engine/frame.py``)."""
        c = self.config
        consts = gtao_constants(c.width, c.height, self.camera.znear,
                                self.camera.zfar, self.camera.fovy,
                                self.camera.aspect)
        dev = self._inputs.update(dict(
            camera=convert.camera_arrays(self.camera.uniform()),
            lights=self.lights.shader_arrays(),
            gtao=convert.gtao_arrays(consts)), step)
        return dev["camera"], dev["lights"], dict(dev["gtao"], host=consts)

    @property
    def noise_index(self) -> int:
        """The GTAO noise index of the next render() frame."""
        return self._frame_idx % 64

    def render_passes(self, noise_index: int, step=no_step) -> dict:
        """render()'s frame at GTAO noise index `noise_index`, without
        counting it as rendered; step(name) wraps each pass and span
        (engine/frame.py). engine/profiler.py times its frames here.
        Without a step hook on one CUDA device the frame is the replay of
        its CUDA graph (``engine/frame_graph.py``), keyed by what the frame
        reads: the same outputs, in tensors of their own. With
        ``config.mesh`` every rank of the mesh calls it: each renders its
        band (``dist/sharding.render_frame_sharded``) and the bands are
        all-gathered, so every rank returns the whole frame."""
        c = self.config
        self._update_models()
        if self._scene is None:
            raise RuntimeError("call prepare_first_frame() first")
        cam, lights, gtao = self._frame_inputs(step)
        kw = dict(width=c.width, height=c.height, gtao_settings=c.gtao,
                  enable_gtao=c.enable_gtao, enable_tonemap=c.enable_tonemap,
                  spp=c.spp, aniso_taps=c.aniso_taps)
        noise = self._noise[noise_index % 64]
        if c.mesh is None:
            args = (self._scene_device, cam, lights, gtao, self._lpm)
            if step is not no_step or self.device.type != "cuda":
                return render_frame(*args, noise, step=step, **kw)
            return self._graph.frame(
                (args, kw, traverse_bvh8.call_time_switches()), noise,
                lambda maps: render_frame(*args, maps, **kw))
        from ..dist.sharding import gather_frame, render_frame_sharded

        band = render_frame_sharded(self._scene_device, cam, lights, gtao,
                                    self._lpm, noise, mesh=c.mesh,
                                    step=step, **kw)
        return gather_frame(band, c.mesh)

    def render(self, block: bool = True) -> dict:
        """Render one frame; returns the output dict of device tensors
        (``render_passes``)."""
        out = self.render_passes(self.noise_index)
        self._frame_idx += 1
        self.rendered_frames += 1
        if block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def render_dynamic(self, transforms, block: bool = True,
                       refit: bool = True, auto_rebuild: bool = True,
                       check_every: int = 16) -> dict:
        """Render one frame with per-frame instance transforms (the
        reference's animated-TLAS path, renderer.rs:637-651).

        transforms: (I, 3, 4), numpy or a tensor, replacing the scene's
        instance transforms this frame. refit=True keeps the rest-pose BVH8
        topology and refits its boxes (K1/K2, about the static frame's
        cost); refit=False rebuilds an LBVH on the device and traces it
        with K6.

        auto_rebuild: every `check_every`-th refit frame reads the refit
        quality ratio (a device sync) and, above REBUILD_SAH_RATIO,
        switches the next `check_every` frames to the rebuild path —
        tpurt's trigger (tpurt/engine/renderer.py:298-366)."""
        c = self.config
        self._update_models()
        if self._scene is None:
            raise RuntimeError("call prepare_first_frame() first")
        if self._obj_device is None:
            self._obj_device = convert.object_tensors(
                self._scene.as_object_pytree(), self.device)
            self._refit_device = convert.refit_tensors(
                make_refit_data(self._scene), self.device)
        cam, lights, gtao = self._frame_inputs()
        noise = self._noise[self._frame_idx % 64]
        if refit and auto_rebuild and self._frame_idx < self._rebuild_until:
            refit = False  # decayed tree: rebuild for this window
        kw = dict(width=c.width, height=c.height, gtao_settings=c.gtao,
                  enable_gtao=c.enable_gtao, enable_tonemap=c.enable_tonemap,
                  aniso_taps=c.aniso_taps)
        if refit:
            out = render_frame_dynamic_refit(
                self._obj_device, self._refit_device, transforms, cam,
                lights, gtao, self._lpm, noise, **kw)
            if auto_rebuild and self._frame_idx % check_every == 0:
                ratio = float(out["refit_sah_ratio"])
                self.last_refit_sah_ratio = ratio
                if ratio > REBUILD_SAH_RATIO:
                    # +1: _frame_idx increments after this frame
                    self._rebuild_until = self._frame_idx + 1 + check_every
        else:
            out = render_frame_dynamic(
                self._obj_device, transforms, cam, lights, gtao, self._lpm,
                noise, **kw)
        self._frame_idx += 1
        self.rendered_frames += 1
        if block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def render_image(self) -> np.ndarray:
        """Render and read back the 8-bit sRGB frame."""
        return self.render()["image"].cpu().numpy()

    def render_stream(self, n_frames: int, depth: int = 3):
        """Yield the outputs of `n_frames` render() frames with up to
        `depth` in flight — the reference's 3-deep FrameData pipeline
        (renderer.rs:300-318, 400-466), tpurt's bounded dispatch queue:
        frame i + depth - 1 is enqueued before frame i is yielded, so the
        host's launches overlap the card's work. Each frame records one
        CUDA event after its last pass and is yielded once that event has
        completed (no device-wide sync)."""
        from collections import deque

        q: deque = deque()

        def ready():
            out, done = q.popleft()
            if done is not None:
                done.synchronize()
            return out

        for _ in range(n_frames):
            out = self.render(block=False)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            q.append((out, done))
            if len(q) >= max(depth, 1):
                yield ready()
        while q:
            yield ready()

    def gtao_debug_image(self, mode: str = "normals", out=None):
        """(H, W, 4) float16 GTAO debug image of a render() output `out`
        (tpurt's ``Renderer.gtao_debug_image``): mode "normals", "edges"
        or "ao" (``passes/gtao.gtao_debug_image``). Renders a frame when
        `out` is not given; the noise index is that of the last rendered
        frame."""
        if out is None:
            out = self.render(block=True)
        _, _, gtao = self._frame_inputs()
        return gtao_debug_image(out["depth"], out["normal"], gtao,
                                self.config.gtao,
                                self._noise[max(self._frame_idx - 1, 0) % 64],
                                mode)

    def stats(self) -> dict:
        c = self.config
        shadow_lights = sum(
            1 for light in self.lights.all_lights() if light.casts_shadows)
        out = dict(
            resolution=(c.width, c.height),
            # tpurt's count, which leaves spp out (ROADMAP F17)
            rays_per_frame=c.width * c.height * (1 + shadow_lights),
            lights=self.lights.get_lights_count(),
            shadow_casting_lights=shadow_lights,
            rendered_frames=self.rendered_frames,
            models=len(self.models),
            device_resident_models=sum(
                1 for m in self.models if m.is_device_resident()),
            gtao=dict(slices=c.gtao.slice_count, steps=c.gtao.steps_per_slice,
                      denoise=c.gtao.denoise,
                      bent_normals=c.gtao.bent_normals),
            device=str(self.device),
        )
        if self._scene is not None:
            out.update(tris=int(self._scene.geom["v0"].shape[0]),
                       bvh_nodes=int(self._scene.bvh["aabb_min"].shape[0]),
                       bvh8_nodes=int(self._scene.bvh["nodes8"].shape[0]),
                       bvh8_depth=self._scene_device["depth8"],
                       primitives=self._scene.num_prims,
                       tracer_tier="bvh8", host_builder=self._scene.builder)
        return out

    @property
    def scene(self) -> Optional[FlatScene]:
        return self._scene

    @property
    def scene_device(self):
        return self._scene_device
