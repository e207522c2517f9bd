"""One frame of the static-scene main path — port of
``tpurt/engine/frame.py:render_frame``.

camera rays -> closest hit (K1) -> shade with one shadow trace per light
(K2) -> G-buffer quantization (B10G11R11F color and normal, R16F depth) ->
GTAO (prefilter, K3, K4) -> LPM tonemap -> sRGB u8. PyTorch runs eagerly:
the passes are ordinary calls on the frame's device. ``finish_frame`` is
the pass tail that the dynamic frames (``engine/dynamic.py``) share.

Each pass runs inside ``step(name)``, a context manager the caller may
pass: ``rays``, ``trace``, ``shade``, ``quantize_color``,
``quantize_depth_normal``, ``gtao``, ``tonemap``, in that order. The
default enters nothing; ``engine/profiler.py`` passes its timers, so the
profiled frame is the rendered one.

The traversal switches are tpurt's module constants, read at call time:
with ``kernels.traverse_bvh8.POP2_DEFAULT = True`` the primary and shadow
traces run the two-pop kernels (K7b), with ``UVP_DEFAULT = True`` the
primary trace emits the uv payload (K7c) that the shade pass reads.
``render_frame`` passes neither, so both reach ``Renderer.render()``.

tpurt's frame never fuses the shadow traces; ``render_frame_fused`` (one
K5 launch for all lights) composes the same passes with
``shade(fuse_shadows=True)``, as tpurt's ``tools/shadow_fusion_probe.py``
composes its fused frame.
"""
from __future__ import annotations

import contextlib

import torch

from ..kernels.traverse_bvh8 import trace_closest_bvh8
from ..passes.encodings import (pack_unorm8, quantize_r11g11b10f,
                                quantize_r16f)
from ..passes.gtao import GtaoSettings, ao_visibility_u8, compute_ao
from ..passes.rays import T_MAX, T_MIN, camera_rays
from ..passes.shade import shade
from ..passes.tonemap import tonemap_frame


# the frame's steps, in the order they run
STEPS = ("rays", "trace", "shade", "quantize_color", "quantize_depth_normal",
         "gtao", "tonemap")


def no_step(name: str):
    """The default step wrapper: enters nothing."""
    return contextlib.nullcontext()


def finish_frame(g: dict, gtao: dict, lpm: dict, noise_index: int, *,
                 width: int, height: int, gtao_settings: GtaoSettings,
                 enable_gtao: bool, enable_tonemap: bool,
                 step=no_step) -> dict:
    """Quantize the shaded G-buffer `g`, run GTAO and the tonemap. Returns
    dict: image (H, W, 3) u8 sRGB, color and normal (H, W, 3) f32, depth
    (H, W) f32, ao (H, W) int32 (0..~383)."""
    with step("quantize_color"):
        color = quantize_r11g11b10f(g["color"]).reshape(height, width, 3)
    with step("quantize_depth_normal"):
        depth = quantize_r16f(g["depth"]).reshape(height, width)
        normal = quantize_r11g11b10f(g["normal_enc"]).reshape(height, width,
                                                               3)

    with step("gtao"):
        if enable_gtao:
            ao = ao_visibility_u8(compute_ao(depth, normal, gtao,
                                             gtao_settings, noise_index),
                                  gtao_settings)
        else:
            ao = torch.full((height, width), 255, dtype=torch.int32,
                            device=depth.device)

    with step("tonemap"):
        if enable_tonemap:
            image = pack_unorm8(tonemap_frame(color, ao, lpm))
        else:
            image = pack_unorm8(torch.clamp(color, 0.0, 1.0))
    return dict(image=image, color=color, depth=depth, normal=normal, ao=ao)


def _frame(fuse_shadows: bool, scene: dict, camera: dict, lights: dict,
           gtao: dict, lpm: dict, noise_index: int, *, width: int,
           height: int, gtao_settings: GtaoSettings = GtaoSettings(),
           enable_gtao: bool = True, enable_tonemap: bool = True,
           step=no_step) -> dict:
    with step("rays"):
        origin, direction = camera_rays(camera, width, height)
    with step("trace"):
        hits = trace_closest_bvh8(scene, origin, direction, T_MIN, T_MAX,
                                  height=height, width=width)
    with step("shade"):
        g = shade(scene, camera, lights, hits, fuse_shadows=fuse_shadows,
                  height=height, width=width)
    return finish_frame(g, gtao, lpm, noise_index, width=width,
                        height=height, gtao_settings=gtao_settings,
                        enable_gtao=enable_gtao,
                        enable_tonemap=enable_tonemap, step=step)


def render_frame(*args, **kwargs) -> dict:
    """Render one frame: (scene, camera, lights, gtao, lpm, noise_index, *,
    width, height, gtao_settings, enable_gtao, enable_tonemap, step) -> the
    outputs of ``finish_frame``."""
    return _frame(False, *args, **kwargs)


def render_frame_fused(*args, **kwargs) -> dict:
    """``render_frame`` with every light's shadow rays in one fused trace
    (``shade(fuse_shadows=True)``); the same image bit for bit."""
    return _frame(True, *args, **kwargs)
