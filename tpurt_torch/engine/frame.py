"""One frame of the static-scene main path — port of
``tpurt/engine/frame.py:render_frame``.

camera rays -> closest hit (K1) -> shade with one shadow trace per light
(K2) -> G-buffer quantization (B10G11R11F color and normal, R16F depth) ->
GTAO (prefilter, K3, K4) -> LPM tonemap -> sRGB u8. PyTorch runs eagerly:
the passes are ordinary calls on the frame's device. ``finish_frame`` is
the pass tail that the dynamic frames (``engine/dynamic.py``) share.

Each pass runs inside ``step(name)``, a context manager the caller may
pass: ``rays``, ``trace``, ``shade``, ``quantize_color``,
``quantize_depth_normal``, ``gtao``, ``tonemap``, in that order
(``STEPS``). The same hook is the program's span API: inside the steps,
shade enters ``shade.surface`` (on a mip scene with its child
``shade.texels``, the texel fetch), ``shade.lights`` and ``shade.shadow``
(``passes/shade.py``), and every host-to-device copy on ``render()``'s
path, which synchronises the stream, runs inside a ``sync.*`` span:
``sync.camera``, ``sync.lights``, ``sync.gtao`` (``Renderer``'s uploads of
changed inputs, one span per tensor, before ``rays``) and ``sync.noise``
(GTAO's noise table, inside ``gtao``). ``SPANS`` lists every name. The
default, ``no_step``, enters nothing while the torch profiler is off and
a ``record_function`` range of the name while it records
(``utils/spans.py``); ``engine/profiler.py`` passes its timers, so the
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

``spp > 1`` is tpurt's anti-aliased frame: R2-jittered samples (K1 once
and K2 once per shadow-casting light each), their HDR colors averaged,
GTAO on the center sample's G-buffer. ``render_gbuffer`` also traces a
band of rows, and ``render_sample_hdr`` is one jittered sample of the
ground-truth accumulation (``engine/accumulate.py``).

Inside ``utils/debug.validation()`` every frame checks its float outputs
for NaN and raises on one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.traverse_bvh8 import trace_closest_bvh8
from ..passes.encodings import (divide, pack_unorm8, quantize_r11g11b10f,
                                quantize_r16f)
from ..passes.gtao import (GtaoSettings, ao_bent_normals, ao_visibility_u8,
                           compute_ao_band)
from ..passes.rays import T_MAX, T_MIN, camera_rays
from ..passes.shade import shade
from ..passes.tonemap import tonemap_frame
from ..utils.debug import check_outputs
from ..utils.spans import no_step


# the frame's steps, in the order they run
STEPS = ("rays", "trace", "shade", "quantize_color", "quantize_depth_normal",
         "gtao", "tonemap")
# every span of the static frame (``render_passes``), in the order each is
# first entered: the sync.* uploads of the camera, light and GTAO-constant
# tensors run only when their host values changed; shade.lights runs
# twice per shade call (the light-ray pre-pass and the lights' sum),
# shade.shadow once per light (once for a fused trace) and shade.texels
# once per shade call on a mip scene only
SPANS = ("sync.camera", "sync.lights", "sync.gtao", "rays", "trace", "shade",
         "shade.surface", "shade.texels", "shade.lights", "shade.shadow",
         "quantize_color", "quantize_depth_normal", "gtao", "sync.noise",
         "tonemap")


def no_gather(x):
    """The default gather of ``finish_frame``: one device holds every
    row."""
    return x


def finish_frame(g: dict, gtao: dict, lpm: dict, noise_index: int, *,
                 width: int, height: int, gtao_settings: GtaoSettings,
                 enable_gtao: bool, enable_tonemap: bool, step=no_step,
                 row_start: int = 0, num_rows=None,
                 gather=no_gather) -> dict:
    """Quantize the shaded G-buffer `g`, run GTAO and the tonemap. Returns
    dict: image (H, W, 3) u8 sRGB, color and normal (H, W, 3) f32, depth
    (H, W) f32, ao (H, W) int32 (0..~383; the packed term's visibility,
    0..255, with bent normals) and, when the settings ask for bent normals,
    bent_normals (H, W, 3) f32.

    `g` may hold a band of the frame: rows [row_start, row_start +
    num_rows) of `height`, and then every output holds those rows.
    gather(x) returns the whole frame's rows of the band's (num_rows, W,
    ...) depth or normals, which GTAO samples around the band (the
    band-sharded frame's all-gather, ``dist/sharding.py``)."""
    rows = height if num_rows is None else num_rows
    with step("quantize_color"):
        color = quantize_r11g11b10f(g["color"]).reshape(rows, width, 3)
    with step("quantize_depth_normal"):
        depth = quantize_r16f(g["depth"]).reshape(rows, width)
        normal = quantize_r11g11b10f(g["normal_enc"]).reshape(rows, width, 3)

    bent = None
    with step("gtao"):
        if enable_gtao:
            ao_term = compute_ao_band(gather(depth), gather(normal), gtao,
                                      gtao_settings, noise_index, row_start,
                                      rows, step=step)
            ao = ao_visibility_u8(ao_term, gtao_settings)
            bent = ao_bent_normals(ao_term, gtao_settings)
        else:
            ao = torch.full((rows, width), 255, dtype=torch.int32,
                            device=depth.device)

    with step("tonemap"):
        if enable_tonemap:
            image = pack_unorm8(tonemap_frame(color, ao, lpm))
        else:
            image = pack_unorm8(torch.clamp(color, 0.0, 1.0))
    out = dict(image=image, color=color, depth=depth, normal=normal, ao=ao)
    if bent is not None:
        out["bent_normals"] = bent
    check_outputs(out)
    return out


def _aa_jitters(spp: int) -> np.ndarray:
    """The R2 sub-pixel offsets of the anti-aliased frame, (spp, 2) f32:
    the plastic-constant sequence in float64, cast to f32, sample 0 at the
    pixel center (so spp=1 is the reference's frame)."""
    g = 1.32471795724474602596  # plastic constant (2-D R2 sequence)
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    idx = np.arange(spp, dtype=np.float64)
    jit = np.stack([np.mod(0.5 + a1 * idx, 1.0) - 0.5,
                    np.mod(0.5 + a2 * idx, 1.0) - 0.5], axis=1)
    jit[0] = 0.0
    return jit.astype(np.float32)


# tpurt unrolls up to this many samples and scans the rest (one compiled
# program at any spp); eager PyTorch runs every spp as the same loop, with
# the same sums
SPP_UNROLL = 4


def _gbuffer(fuse_shadows: bool, scene: dict, camera: dict, lights: dict,
             *, width: int, height: int, row_start: int = 0, num_rows=None,
             spp: int = 1, aniso_taps: int = 1, step=no_step) -> dict:
    """render_gbuffer, with the frame's shadow fusion and step wrapper: the
    spp samples' rays run in the "rays" step, their traces in "trace" and
    their shading and color sum in "shade"."""
    band = height if num_rows is None else num_rows
    jitters = [None] + [(float(jx), float(jy))
                        for jx, jy in _aa_jitters(spp)[1:]]
    with step("rays"):
        rays = [camera_rays(camera, width, height, row_start, num_rows,
                            jitter=jit) for jit in jitters]
    with step("trace"):
        hits = [trace_closest_bvh8(scene, o, d, T_MIN, T_MAX, height=band,
                                   width=width) for o, d in rays]
    with step("shade"):
        # the ray cone's spread reads the full image's height
        kw = dict(fuse_shadows=fuse_shadows, height=band, width=width,
                  aniso_taps=aniso_taps, image_rows=height, step=step)
        g = shade(scene, camera, lights, hits[0], direction=rays[0][1], **kw)
        if spp > 1:
            acc = g["color"]
            for (_, d), h in zip(rays[1:], hits[1:]):
                acc = acc + shade(scene, camera, lights, h, direction=d,
                                  **kw)["color"]
            g = dict(g, color=divide(acc, spp))
    return g


def render_gbuffer(scene: dict, camera: dict, lights: dict, *, width: int,
                   height: int, row_start: int = 0, num_rows=None,
                   spp: int = 1, aniso_taps: int = 1, step=no_step) -> dict:
    """Trace and shade the pixel grid, or the band of `num_rows` rows from
    `row_start`: the unquantized G-buffer dict(color (R*W, 3), depth
    (R*W,), normal_enc (R*W, 3)). With spp > 1 the color is the mean of
    the R2-jittered samples, summed in tpurt's order (the center sample,
    then samples 1..spp-1, then / spp); depth and normals come from the
    center sample. aniso_taps as in ``shade``; a band's ray cone spreads
    over the whole image's `height`. step as in ``render_frame``."""
    return _gbuffer(False, scene, camera, lights, width=width,
                    height=height, row_start=row_start, num_rows=num_rows,
                    spp=spp, aniso_taps=aniso_taps, step=step)


def render_sample_hdr(scene: dict, camera: dict, lights: dict, jitter, *,
                      width: int, height: int):
    """One progressive-accumulation sample: the linear HDR radiance (H, W,
    3) f32 with the sub-pixel camera jitter `jitter` (jx, jy) in [-0.5,
    0.5] pixels (``camera_rays``'s forms). ``engine/accumulate.py`` sums
    these. A mip scene samples isotropically, as tpurt's sample does."""
    origin, direction = camera_rays(camera, width, height, jitter=jitter)
    hits = trace_closest_bvh8(scene, origin, direction, T_MIN, T_MAX,
                              height=height, width=width)
    g = shade(scene, camera, lights, hits, height=height, width=width,
              direction=direction)
    return g["color"].reshape(height, width, 3)


def _frame(fuse_shadows: bool, scene: dict, camera: dict, lights: dict,
           gtao: dict, lpm: dict, noise_index: int, *, width: int,
           height: int, gtao_settings: GtaoSettings = GtaoSettings(),
           enable_gtao: bool = True, enable_tonemap: bool = True,
           spp: int = 1, aniso_taps: int = 1, step=no_step) -> dict:
    g = _gbuffer(fuse_shadows, scene, camera, lights, width=width,
                 height=height, spp=spp, aniso_taps=aniso_taps, step=step)
    return finish_frame(g, gtao, lpm, noise_index, width=width,
                        height=height, gtao_settings=gtao_settings,
                        enable_gtao=enable_gtao,
                        enable_tonemap=enable_tonemap, step=step)


def render_frame(*args, **kwargs) -> dict:
    """Render one frame: (scene, camera, lights, gtao, lpm, noise_index, *,
    width, height, gtao_settings, enable_gtao, enable_tonemap, spp,
    aniso_taps, step) -> the outputs of ``finish_frame``. spp > 1 averages
    R2-jittered HDR samples (``render_gbuffer``); GTAO reads the center
    sample's depth and normals. aniso_taps > 1 filters a mip scene's
    textures anisotropically."""
    return _frame(False, *args, **kwargs)


def render_frame_fused(*args, **kwargs) -> dict:
    """``render_frame`` with every light's shadow rays in one fused trace
    (``shade(fuse_shadows=True)``) per sample; the same image bit for
    bit."""
    return _frame(True, *args, **kwargs)
