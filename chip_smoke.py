#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (tpurt_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from tpurt_torch/csrc into tpurt_torch/_build, prints
the card's `name, power.limit`, and for the bench scene (43,200-tri box
field + ground + 8 textured cubes, 3 shadow-casting lights, GTAO ULTRA 9x3
with sharp denoise, LPM) at 800x800 and at 1920x1080 runs (phases 3 and 6
once, at 64x64):

  phase 1  each kernel against its plain PyTorch version on the card, at the
           main path's shapes: primary rays (K1 over nodes8c in 16x8 pixel
           tiles, as the frame traces them, and on consecutive rays, both
           bit-exact); the shadow rays of each
           light, t_max = 0 lanes included, traced as shade() traces them
           (K2 over nodes8c in 16x8 pixel tiles, also against the plain
           any hit over the nodes8 rows, so that the nodes8c built on the
           card is held to the rows, and on consecutive rays, all
           bit-exact); the
           frame's depth pyramid and G-buffer (K3h + K3 at the frame's
           preset and at HIGH 3x3; K3h's table within P1's tolerance of its
           plain version; K3 alone timed apart); the main pass's AO and
           edges (K4, bit-exact). Prints the mismatch counts and the
           times.
  phase 2  >= 10 frames through Renderer.render(): launch counts per frame
           (K1 1, K2 3, K8a 1, K8b 1, K3h 1, K3 1, K4 1; every frame of
           every phase launches K8a and K8b once per shade() call),
           ms/frame, Mrays/s (W*H*(1 +
           shadow lights) rays per frame), a checksum and the share of lit
           pixels.
  phase 3  a 64x64 frame of the same scene on the card against the same
           frame from the plain versions on the host.
  phase 4  the dynamic scene's kernels at the rebuild path's shapes, with
           the bench animation (every instance rotated about Y by up to
           0.5 rad): the LBVH (its rows and their compact table nodes2c)
           and the refit BVH8 (and its nodes8c) built on the card equal the
           same built on the host; K6 over nodes2c, closest hit on the
           primary rays and any hit on each light's shadow rays (t_max = 0
           lanes included), in 16x8 pixel tiles (as the rebuild frame
           traces them) and on consecutive rays, all bit-exact against the
           plain version (run once per size), with both times, the bound
           over nodes2c and the LBVH build and refit times.
  phase 5  >= 8 frames each through Renderer.render_dynamic(): refit frames
           (K1 1, K2 3, K3h 1, K3 1, K4 1, K6 0 per frame, one nodes8c and
           no nodes2c built), rebuild frames (refit=False: K6 closest 1, K6
           any 3, K3h 1, K3 1, K4 1, K1/K2 0, one nodes2c and no nodes8c
           built), and a
           scrambled sequence with check_every=1 whose K6 launches appear
           right after the check frame; ms/frame and Mrays/s per path.
  phase 6  64x64 refit and rebuild frames on the card against the plain
           versions on the host.
  phase 7  tpurt's traversal switches. On the frame's real rays: the fused
           multi-light shadow kernel (K5) and its two-pop form (K5p) over
           nodes8c, in 16x8 pixel tiles (as shade() traces them) and on
           consecutive rays, against their plain versions and against K2
           per light, timed beside K2 once per light on the same rays in
           the same tiles (K2 x 3, the yardstick); the two-pop
           closest and any kernels (K7b) over nodes8c, in 16x8 pixel tiles
           (as the pop2 frames trace them) and on consecutive rays, against
           their plain versions and against K1/K2 (t bit-equal, tri
           differing only on ties); the uv-payload kernel (K7c, K1's
           kernel with the payload, over nodes8c in 16x8 pixel tiles, as
           the uvp frame traces them, and on consecutive rays) against its
           plain version in all nine outputs and against K1's t, tri, u
           and v, timed beside K1 on the same rays in the same tiles; all
           bit-exact, with times and bounds. Then >= 10 frames (after 2
           warm-up frames) of each variant with its launches checked per frame:
           Renderer.render() with POP2_DEFAULT (K7b closest 1, K7b any 3),
           with UVP_DEFAULT (K7c 1, K2 3), the fused frame
           (render_frame_fused: K1 1, K5 1) and the fused frame with
           POP2_DEFAULT (K7b closest 1, K5p 1); each image against the
           default frame's
           (bit-identical for the payload and fused frames, >= 99.9% equal
           and <= 0.1% off by > 2 for the two-pop frames).
  phase 9  the ground-truth path, before phase 8's profilers: the
           anti-aliased frame (RendererConfig.spp = 4: K1 4, K2 12, K3h,
           K3 and K4 1 each), accumulate_samples of 8 samples (K1 1 and K2
           3 per sample) and rtao_frame with 4 samples (K1 1, K2 4), each
           with its launches checked on one call and timed by the host wall
           clock and the card-only timer. Once, at 64x64, the same on the
           card against the plain versions on the host: the spp frame and
           the mean of 4 accumulation samples from one seed (as u8) at
           phase 3's bars, an RTAO frame from one CPU generator seeded
           alike (hit masks equal, visibility equal on >= 99.5% of hit
           pixels), and the frame resized to 100x60 and back at phase 3's
           bars.
  phase 10 the GTAO variants and the output libraries, after phase 9:
           >= 5 frames each through Renderer.render() with bent normals,
           precision "half", "fp16" and bent + fp16 (launches per frame:
           K1 1, K2 3, the variant's K3h, K3 and K4 1 each, no exact one;
           ms/frame; finite, lit images; bent_normals (H, W, 3) finite);
           each variant's instantiation against its plain version on that
           frame's G-buffer (K3 edges equal, AO within 1 u8 step, per byte
           of the packed term, on <= 0.1% of pixels; K3h's fp16 table
           and the K4 variants bit-exact), timed by the
           card-only timer beside the exact K3/K4 of phase 1; the default
           frame's checksum after the variants equal to phase 2's;
           gtao_debug_image in its three modes; tonemap_frame_hdr10 on the
           frame against the same on the host (<= 1e-4).
  phase 11 the texture path, after phase 10 at 800x800 only: the mip
           tables (the per-layer atlas, quad, pair, block4) of a
           material_field(6, 6)'s images and 13x7, 5x5 and 1x1 ones,
           sampled on 2^20 seeded lanes trilinear and anisotropic with 1,
           4 and 16 taps, bit-equal across the four tiers on the card and
           each to the same function on the host; the bench frame with the
           streaming texture arena (the default) bit-equal to the slab
           frame (texture_arena=False) and to phase 2's checksum; a
           streaming sequence on the bench scene (the cubes leave, return,
           the box field leaves): each step's uploaded rows equal to its
           joining images' rows, its freed images to the leaving ones, its
           frame bit-equal to a fresh renderer's; 64x64 textured frames
           (the textures workload cut to a 3x3 field) on the card against
           the host, quad, pair and block4 (forced by the budgets) with
           aniso_taps 1 and 4, at phase 3's bars, each launching K1 1, K2
           1 per shadow light, K3h/K3/K4 1; the textures workload at
           800x800 (tpurt's tools/textures_bench.py: 292,034 tris, 144
           materials of 256x256 texels, mipmaps on): setup seconds, tier,
           texture bytes on the card, ms/frame by host wall and card-only
           timer with aniso_taps 1 and 16, Mrays/s, profile_frame's passes
           and the card's name and power limit; last, after phase 8's
           device profile, its device launches and device ms per frame
           under torch.profiler and the device-busy share.
  phase 12 the app, after phase 11 (once, at 800x800): the bench scene's
           geometry (43,298 tris: box field, ground, 8 textured cubes)
           written as a .gltf with data-URI buffers and PNG textures
           (tests/torch_gltf_writer.py) into a temporary directory and
           loaded by the app's default_scene (the reference's spot and area
           lights, both casting shadows); offline.main renders 10 frames
           (launches K1 10, K2 20, K3h/K3/K4 10; ms/frame from its own
           frame loop) and writes a PNG equal to Renderer.render_image() of
           the same scene bit for bit; one app frame launches K1 1, K2 2,
           K3h/K3/K4 1; --spp 8 --checkpoint-every 4 stopped after 4
           samples and resumed from the file equals one uninterrupted run
           (K1 8, K2 16); interactive.run_replay over record_orbit(30)
           moves the camera and its last frame is not black; the live
           server on 127.0.0.1 (an ephemeral port) serves a JPEG at
           /frame.jpg and a POST /event with key w moves the camera; the
           live loop with frames in flight (depth 2, render(block=False))
           publishes the blocking loop's frames bit for bit, compared
           before JPEG encoding, with its launches per frame; frames/s at
           depth 1 and 2.
  phase 13 the band-sharded frame (dist/sharding.py). At each size, K3
           over the three bands compute_ao_band launches for a 4-way split
           of the frame's G-buffer (H/4 rows and a halo of 2 on each side
           inside the image: the top band from row 0, an interior one, the
           bottom one to the last row) in its five instantiations: bit for
           bit the full-frame K3's rows, and the top and bottom bands
           against the plain version at K3's bar; the interior band's
           card-only ms beside the full frame's K3, with its bound (K3's
           operations scaled by the rows). Then one NCCL rank in this
           process (its band is the whole image: K3's whole-frame launch)
           and 2 and 4 gloo ranks spawned on cuda:0 (NCCL refuses two
           ranks on one GPU), each rank at both sizes: every output
           all-gathered through RendererConfig.mesh equal to the
           single-device frame bit for bit, with bent normals too; each
           rank launches K1 1, K2 3, K3h 1, K3 (band) 1, K4 1 per frame;
           ms/frame per rank count, the transport that ran, labelled as
           ranks sharing one H100 (no multi-GPU number).
  phase 14 the sharded-geometry frame (dist/geometry.py), after phase 13.
           At each size, one stop of each ring on the card at the main
           path's shapes (the band of rank 1 of 4 shards, its second
           stop): K1 with the first stop's t as t_max and K5 with the
           lanes the first stop occluded parked at t_max = 0, and the
           "xla" tier's K6 closest and any hit (max_leaf 4, the shard's
           binary tree) the same way, bit for bit against their plain
           versions and timed beside their bounds, and ring_gather's stop
           against direct indexing on the band's attribute and texel
           rows (the chunk owning most of them). Then both tiers ("bvh8":
           K1 and K5 per stop, the shading tables row-sharded; "xla": K6)
           with one NCCL rank in this process and 2 and 4 gloo ranks
           spawned on cuda:0, each rank at both sizes: the ring's t, tri
           and occlusion against the single-device K1/K2 on the band's
           rays, differing only on equal-t ties and on hits lost through
           a triangle's edge (ROADMAP F26), each such ray confirmed by
           brute force: every differing (t, tri) a real hit and every
           nearer hit on an edge, every differing occlusion a ray that
           hits only through edges; every output
           gathered by gather_frame against the single-device frame
           outside those pixels (counts printed), ring_gather against
           direct indexing, launches per rank (K1 n, K5 n or K6 closest n
           and any 3n; K3h 1, K3 over the band 1, K4 1; no K2), ms/frame
           (slowest rank) and the ring_shift calls' CUDA-event ms, as
           ranks sharing one H100 (no multi-GPU number). Last, at 800x800,
           the textures workload's "bvh8" frame over 4 gloo ranks: each
           rank's hbm_accounting beside its memory_allocated() after
           setup and beside the replicated renderer's scene tensors, its
           launches (as above, and K9's rows 1 and K9 1: the texel rows
           come through ring_gather to K9), the image at phase 3's bars
           against the single-device frame.
  phase 8  the diagnostics path. The steps probe
           (tpurt_torch/tools/steps_probe.py) on the frame's rays with the
           counts at 0: K7a closest 1 and K7a any 3 (one per light), over
           nodes8c in 16x8 pixel tiles. For each push order (sort,
           nearlast, none) the counted closest and any kernels, in tiles
           and on consecutive rays, against their plain versions (t, tri,
           counts, occlusion bit-exact), t and occlusion equal to K1/K2's,
           tri
           differing only on equal-t ties (none for sort), the counts' sums
           equal to the plain traversal's work; ms with and without
           counting; the probe's steps per ray and per warp and SIMT
           efficiency (warps of 8x4 pixels, as the kernels run them, and of
           32 consecutive pixels). The transcendental probe
           (tpurt_torch/tools/trans_equiv_probe.py, one P1 launch): P1
           within its tolerance of its plain version (cos/sin 2e-6 absolute,
           pow 2e-6 relative), bit mismatches and ULPs of kernel, plain and
           float64; P1's time beside the card-only timer's floor (an empty
           kernel timed the same way). render() and render_stream ms/frame
           at depth 1 and 3 over 10 frames each; profile_frame(r, 3)
           (render()'s launches per frame). Last, after every other phase
           of both sizes (launches after torch.profiler run slower):
           device_profile(r), kernel time per pass, the device-busy share
           (sum of device_profile / sum of profile_frame) and render()
           ms/frame right after it.

  phase 15 shade's light loop (K8a, K8b: csrc/shade_lights.cu) at each
           size with the scene's 3 lights, after phase 13's band: K8a on
           the frame's surface against the plain pre-pass (L, nc_NdotL,
           wants_shadow, t_max), K8b on K2's occlusion against the plain
           sum (rho), all bit-exact; both timed (`ms`, `cuda_ms`) beside
           their byte bound and the plain chain's ms on the card.
  phase 16 a mip scene's texel fetch (K9: csrc/mip_texels.cu) at each
           size, after phase 15: the textures workload (292,034 tris,
           144 materials of 256x256 texels) with each tier forced by the
           budgets (quad, pair, block4), its frame's hits through K1; K9
           with 1 and 16 taps against the plain chain on the card, its
           LOD, major axis and texels bit-exact, one launch a call; K9
           timed (`ms`, `cuda_ms`) beside its bound, counted as
           rtbench/metrics/k9_roofline.py counts it, and the plain chain's
           ms on the card; the rows K9 reads (mip_texel_rows, the
           sharded-geometry frame's first launch) equal to their plain
           version, K9 over those rows served by a gather hook bit-exact
           to K9 over the table, and the rows' launch timed beside its
           byte bound. The summary's entries are the workload's tier
           (pair) at 16 taps.

Phases 12, 13 and 14 run after both sizes' phases 1-11 and 15 and before
phase 8's device profile (torch.profiler).

Every kernel is timed twice: on the card alone (`ms`,
tpurt_torch/kernels/build.device_ms: the least of 3 runs, each queued
behind a spin kernel) and by CUDA events around back-to-back calls of its
wrapper after a warm-up (`cuda_ms`, the earlier method, which on short
launches also counts the wrapper's host path). The probes' full reports
come from the probes themselves, run with --out.

Every kernel's bound_ms is the larger of the bytes it must move (each
input read once, each output written once) at 3.35 TB/s and its float
operations at 67 TFLOP/s (H100 SXM peaks); traversal work is counted by
the plain versions on this run's rays, each kernel's table once (nodes8c
for every BVH8 kernel, K7c also the uvp table; K7a: its own work, with 8
bytes of counts per shadow ray; the closest hit's counts replace u and v),
GTAO and P1 work from the kernels' source.
Any failed check exits non-zero before the last line. The line before the
last is the {"kernels": [...]} summary; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs a CUDA device: without one it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FRAMES = 10
WARMUP_FRAMES = 2
DYN_FRAMES = 8
SHAPES = ((800, 800), (1920, 1080))
KERNELS = (
    ("bvh8_closest", "tpurt_torch/csrc/bvh8_closest.cu",
     "tpurt/kernels/traverse_bvh8.py:107"),
    ("bvh8_any", "tpurt_torch/csrc/bvh8_any.cu",
     "tpurt/kernels/traverse_bvh8.py:107"),
    # K3h, the noise table the main pass reads (_noise_hoist_kernel)
    ("gtao_noise", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:246"),
    ("gtao_main", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:317"),
    ("gtao_denoise", "tpurt_torch/csrc/gtao_denoise.cu",
     "tpurt/kernels/gtao_pallas.py:131"),
    # K6 replaces _packet_kernel (:161) and _packet_kernel_hbm (:357); the
    # rebuild path runs the hbm tier
    ("bvh2_closest", "tpurt_torch/csrc/bvh2_trace.cu",
     "tpurt/kernels/traverse_pallas.py:357"),
    ("bvh2_any", "tpurt_torch/csrc/bvh2_trace.cu",
     "tpurt/kernels/traverse_pallas.py:357"),
    ("bvh8_any_multi", "tpurt_torch/csrc/bvh8_multi.cu",
     "tpurt/kernels/traverse_bvh8.py:770"),
    ("bvh8_any_multi_pop2", "tpurt_torch/csrc/bvh8_multi.cu",
     "tpurt/kernels/traverse_bvh8.py:949"),
    ("bvh8_closest_pop2", "tpurt_torch/csrc/bvh8_variants.cu",
     "tpurt/kernels/traverse_bvh8.py:497"),
    ("bvh8_any_pop2", "tpurt_torch/csrc/bvh8_variants.cu",
     "tpurt/kernels/traverse_bvh8.py:497"),
    # the uv-payload outputs of _kernel_bvh8_single
    ("bvh8_closest_uvp", "tpurt_torch/csrc/bvh8_closest.cu",
     "tpurt/kernels/traverse_bvh8.py:118"),
    # K7a: step counts (and push orders), run by the steps probe
    ("bvh8_closest_steps", "tpurt_torch/csrc/bvh8_variants.cu",
     "tpurt/kernels/traverse_bvh8.py:1226"),
    ("bvh8_any_steps", "tpurt_torch/csrc/bvh8_variants.cu",
     "tpurt/kernels/traverse_bvh8.py:1226"),
    # P1, run by the transcendental probe
    ("trans_equiv", "tpurt_torch/csrc/trans_equiv.cu",
     "tools/trans_equiv_probe.py:104"),
    # the GTAO variants' instantiations, run by phase 10's frames: K3h's
    # fp16 table, K3 with bent normals, "half" (tpurt's Pallas precision),
    # fp16 and bent + fp16 (tpurt computes bent and fp16 on its XLA
    # main_pass, tpurt/passes/gtao.py:402), K4 over the packed bent term,
    # in fp16 and both (tpurt's XLA denoise_pass, :628)
    ("gtao_noise_fp16", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:246"),
    ("gtao_main_bent", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:317"),
    ("gtao_main_half", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:392"),
    ("gtao_main_fp16", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:317"),
    ("gtao_main_bent_fp16", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:317"),
    ("gtao_denoise_bent", "tpurt_torch/csrc/gtao_denoise.cu",
     "tpurt/kernels/gtao_pallas.py:131"),
    ("gtao_denoise_fp16", "tpurt_torch/csrc/gtao_denoise.cu",
     "tpurt/kernels/gtao_pallas.py:131"),
    ("gtao_denoise_bent_fp16", "tpurt_torch/csrc/gtao_denoise.cu",
     "tpurt/kernels/gtao_pallas.py:131"),
    # K3 over a band of rows, the band-sharded frame's GTAO (tpurt's
    # compute_ao_band runs main_pass_pallas with row_start / num_rows)
    ("gtao_main_band", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:317"),
    # K8a and K8b, shade's light loop around the shadow traces: no TPU
    # kernel, tpurt's loop is XLA code
    ("shade_light_rays", "tpurt_torch/csrc/shade_lights.cu",
     "none (XLA: tpurt/passes/shade.py:747)"),
    ("shade_light_sum", "tpurt_torch/csrc/shade_lights.cu",
     "none (XLA: tpurt/passes/shade.py:747)"),
    # K9, a mip scene's texel fetch, and the rows it reads where a gather
    # hook serves them (the sharded-geometry frame): no TPU kernel,
    # tpurt's fetch is XLA code
    ("mip_texels", "tpurt_torch/csrc/mip_texels.cu",
     "none (XLA: tpurt/passes/shade.py:616)"),
    ("mip_texel_rows", "tpurt_torch/csrc/mip_texels.cu",
     "none (XLA: tpurt/passes/shade.py:616)"),
)
# the frames whose launches each new kernel's summary entry reports
VARIANT_OF = {"bvh8_any_multi": "fused", "bvh8_any_multi_pop2": "fused_pop2",
              "bvh8_closest_pop2": "pop2", "bvh8_any_pop2": "pop2",
              "bvh8_closest_uvp": "uvp"}
ALL_ZERO = {name: 0 for name, _, _ in KERNELS}


def shade_calls(n):
    """K8a's and K8b's launches over n shade() calls of the bench lights."""
    return dict(shade_light_rays=n, shade_light_sum=n)


# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) ops/s
# and fp16 outside the tensor cores, twice the fp32 rate (the H100
# whitepaper's SXM5 table: 133.8 TFLOP/s), the rate of the fp16 variants'
# lpfloat operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_FP16_PER_S = 134e12
# operations per unit of work, counted in the CUDA sources (each float add,
# multiply, divide, min/max, compare, conversion and special function = 1)
OPS_SLAB = 25          # one slab test (bvh8_common.cuh slab_t + 6 planes)
OPS_TRIANGLE = 53      # one Moller-Trumbore test
OPS_RAY = 3            # the reciprocal direction
OPS_BVH8_NODE = 8 * OPS_SLAB
OPS_BVH2_NODE = 2 * OPS_SLAB + 1
OPS_PAYLOAD = 12       # w = 1 - u - v and the two interpolated uvs, per hit
# The GTAO kernels count also negations, abs, rint and the conversions
# where a value crosses between f32 and f16; integer address arithmetic is
# not counted, nor the lpfloat emulation's roundings (lp(): native f16
# arithmetic gives the same bits as f32 and one rounding, for +, -, *, /
# and sqrt, in one operation).
# gtao_main.cu's main kernel (K3) per pixel, f32: setup 127 (the screen
# position 8, the edges 64, the normal 16, the view position and vector
# 20, the radius and visibility 8, the output 11), per slice 121 (the
# direction 3, the slice plane 11, the axis 19, the projected normal 33,
# its arccos 9, the low horizons 4, the arc integral 42), per step 18, per
# side sample 51 (its position and fetch 18, the delta and its length 14,
# the horizon 19); the noise-only work, TRANS_EQUIV_OPS, is K3h's.
GTAO_MAIN_OPS = (127, 121, 18, 51)
# K3 with bent normals more, f32: per pixel 52 (the rotation 17, the
# normalization 10, the encoding 28 less the u8 store's 3), per slice 65
# (11 sinf/cosf, their arguments 8, t0v 11 and t1v 8, the local normal 3,
# the rotation 18, the accumulator 6); "half" 2 per side sample (the bf16
# round trip)
GTAO_BENT_OPS = (52, 65)
GTAO_HALF_OPS_PER_SIDE = 2
# K3 in fp16: the same operations, the lpfloat ones in f16, as (f32, f16):
# setup (62, 73) (the screen position, the edges' packing, the normal's
# decode, the view position and vector and the output stay f32, with 8
# conversions), per slice (15, 112) (each of 3 arccos keeps its f32 tail
# of 3 with 2 conversions), per step (4, 16) (the mip index, 2
# conversions), per side sample (38, 19) (the position, fetch and delta
# stay f32, with 6 conversions); with bent normals all f16 (per pixel 51:
# the encoding's 4 byte conversions take the u8 store's place; per slice
# 65). K3h in fp16 (f32, f16): per slice (4, 5) and per step (4, 5) (the
# noise's and the outputs' conversions and the step base stay f32).
GTAO_LP_OPS = ((62, 73), (15, 112), (4, 16), (38, 19))
GTAO_BENT_LP_OPS = (51, 65)
GTAO_NOISE_LP_OPS = ((4, 5), (4, 5))
# gtao_denoise.cu (K4) per pixel and pass as (f32, f16), by (bent, fp16):
# exact (71, 0) (4 symmetry products, the AO leak 20, the diagonal weights
# 16, the 9 taps 25, the divide, the store's 5; a texel's /255 and /3 are
# table reads); fp16 (5, 66) (the store stays f32);
# bent normals (165, 0): 94 more (3 more channels' taps and divides 54, the
# output 34: the visibility's scale, the normalization 10 and the encoding
# 28 less the u8 store's 5; the decode's 6 per texel); bent + fp16 (4,
# 161) (the encoding's byte conversions stay f32)
GTAO_DENOISE_WORK = {(False, False): (71, 0), (False, True): (5, 66),
                     (True, False): (165, 0), (True, True): (4, 161)}
# trans_equiv.cu and gtao_main.cu's noise kernel (K3h) per element: per
# slice 5 (add, divide, multiply, cos, sin), per step 8 (3 for the step's
# base, add, fmod, add, divide, pow)
TRANS_EQUIV_OPS = (5, 8)
# K3's budget on the card: u8 steps and the share of pixels that may differ
AO_MAX_STEP = 1
AO_MAX_FRACTION = 1e-3


class CheckFailed(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of fn() by CUDA events, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps=10):
    """A kernel wrapper's ms per call by both timers: `ms` on the card
    alone (kernels/build.device_ms: least of 3 runs queued behind a spin
    kernel) and `cuda_ms` (CUDA events around back-to-back calls after 3
    warm-up calls, the earlier method, which on short launches also counts
    the wrapper's host path)."""
    from tpurt_torch.kernels.build import device_ms

    return dict(ms=device_ms(fn, reps), cuda_ms=cuda_ms(fn, reps, warmup=3))


def add_ms(total, part):
    """Sum kernel_ms readings (the 3 lights' launches of an any hit)."""
    for k, v in part.items():
        total[k] = total.get(k, 0.0) + v
    return total


def fmt_ms(t):
    return f"{t['ms']:.4f} ms (cuda_ms {t['cuda_ms']:.4f})"


def bound(nbytes, ops, ops16=0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations' time, f32 ones over the fp32 rate and f16 ones
    (`ops16`) over the fp16 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (ops / PEAK_FP32_PER_S + ops16 / PEAK_FP16_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gtao_main_work(slices, steps, bent, precision):
    """K3's (f32, f16) operations per pixel in one instantiation."""
    def per_pixel(c):
        return c[0] + slices * (c[1] + steps * (c[2] + 2 * c[3]))

    if precision == "fp16":
        f16 = per_pixel([c[1] for c in GTAO_LP_OPS])
        if bent:
            f16 += GTAO_BENT_LP_OPS[0] + slices * GTAO_BENT_LP_OPS[1]
        return per_pixel([c[0] for c in GTAO_LP_OPS]), f16
    f32 = per_pixel(GTAO_MAIN_OPS)
    if bent:
        f32 += GTAO_BENT_OPS[0] + slices * GTAO_BENT_OPS[1]
    elif precision == "half":
        f32 += slices * steps * 2 * GTAO_HALF_OPS_PER_SIDE
    return f32, 0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def trace_work(scene, table, rays, out_bytes_per_ray, stats, node_ops):
    """(bytes, operations) of one traversal launch: its tables, rays
    (origin, direction, t_max) and outputs once; the node pops and triangle
    tests that the plain version counted on these rays."""
    n = rays[0].shape[0]
    moved = nbytes(scene[table], scene["tris"], *rays) \
        + n * out_bytes_per_ray
    ops = n * OPS_RAY + int(stats["node_tests"]) * node_ops \
        + int(stats["tri_tests"]) * OPS_TRIANGLE
    return moved, ops


def timed_once(fn):
    """Milliseconds of one call of fn() by CUDA events, and its result."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def build_renderer(width, height, device):
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    r = Renderer(RendererConfig(width=width, height=height, device=device))
    return build_bench_scene(r)


def frame_inputs(r):
    """The frame's tensors as Renderer.render() builds them."""
    from tpurt_torch.engine import convert
    from tpurt_torch.passes.gtao import gtao_constants

    c = r.config
    cam = convert.camera_tensors(r.camera.uniform(), r.device)
    lights = convert.light_tensors(r.lights.shader_arrays(), r.device)
    gtao = convert.gtao_tensors(gtao_constants(
        c.width, c.height, r.camera.znear, r.camera.zfar, r.camera.fovy,
        r.camera.aspect), r.device)
    return cam, lights, gtao


def phase1(r, label):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from tpurt_torch.kernels.gtao_denoise import (denoise_chain,
                                                  denoise_pass_plain)
    from tpurt_torch.kernels.gtao_main import (gtao_main, gtao_noise_table,
                                               main_kernel, main_pass_plain,
                                               noise_table_plain)
    from tpurt_torch.kernels.trans_equiv import ATOL_TRIG
    from tpurt_torch.kernels.traverse_bvh8 import (_trace_plain, any_kernel,
                                                   closest_kernel,
                                                   trace_any_bvh8,
                                                   trace_any_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)
    from tpurt_torch.passes.encodings import (quantize_r11g11b10f,
                                              quantize_r16f)
    from tpurt_torch.passes.gtao import noise_maps_64, prefilter_depths
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shade, shadow_rays

    c = r.config
    w, h = c.width, c.height
    scene = r.scene_device
    cam, lights, gtao = frame_inputs(r)
    out = {}

    # K1: primary rays over nodes8c, traced as the frame traces them (its
    # shape: 16x8 pixel tiles) and on consecutive rays, both bit-exact
    # against the plain version
    o, d = camera_rays(cam, w, h)
    hk = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX, height=h, width=w)
    tmx = torch.full((w * h,), T_MAX, dtype=torch.float32, device=o.device)
    hr = closest_kernel(scene, o, d, T_MIN, tmx)
    work = {}
    hp = trace_closest_plain(scene, o, d, T_MIN, T_MAX, stats=work)
    torch.cuda.synchronize()
    mism = {f"{k}{tag}": int((x[k].view(torch.int32)
                              != hp[k].view(torch.int32)).sum())
            for tag, x in (("", hk), ("_rows", hr))
            for k in ("t", "tri", "u", "v")}
    err = float((hk["t"] - hp["t"]).abs().max())
    hit_share = float((hk["tri"] >= 0).float().mean())
    t = kernel_ms(lambda: trace_closest_bvh8(scene, o, d, T_MIN, T_MAX,
                                             height=h, width=w))
    t_rows = kernel_ms(lambda: closest_kernel(scene, o, d, T_MIN, tmx))
    plain_ms = cuda_ms(lambda: trace_closest_plain(scene, o, d, T_MIN,
                                                   T_MAX), 2)
    log(f"[{label}] K1 closest: rays {w * h}, hit share {hit_share:.4f}, "
        f"bit mismatches {mism}, max |dt| {err}, node pops "
        f"{int(work['node_pops'])}, triangle tests {int(work['tri_tests'])},"
        f" max stack {work['max_stack']}, kernel (tiles) {fmt_ms(t)}, on "
        f"rows of 128 {fmt_ms(t_rows)}, plain {plain_ms:.2f} ms")
    require(sum(mism.values()) == 0, f"[{label}] K1 differs from plain")
    require(hit_share > 0.05, f"[{label}] K1 hit almost nothing")
    out["bvh8_closest"] = dict(max_abs_err=err, plain_ms=plain_ms,
                               variants=dict(rows_of_128=t_rows), **t)
    out["bvh8_closest"]["bound_ms"], out["bvh8_closest"]["bound_by"] = \
        bound(*trace_work(scene, "nodes8c", (o, d, tmx), 16, work,
                          OPS_BVH8_NODE))

    # K2: the shadow rays of every light, t_max = 0 lanes included, traced
    # as shade() traces them (the frame's shape: 16x8 pixel tiles); K2
    # reads nodes8c, against its plain version and the plain any hit over
    # the nodes8 rows (so the card's nodes8c is held to the rows), and
    # beside the same kernel on consecutive rays (bit-exact too)
    k2 = {}
    k2_plain_ms = k2_err = 0.0
    k2_mism = 0
    k2_work = [0, 0]      # bytes and operations of the 3 launches
    variants = dict(rows_of_128=dict())
    var_ms = {}
    for i, (so, sd, stmax) in enumerate(shadow_rays(scene, cam, lights, hk)):
        ok = trace_any_bvh8(scene, so, sd, SHADOW_T_MIN, stmax, height=h,
                            width=w)
        work = {}
        op = trace_any_plain(scene, so, sd, SHADOW_T_MIN, stmax, stats=work)
        over_rows = _trace_plain(scene, so, sd, SHADOW_T_MIN, stmax,
                                 any_hit=True, order="none", compact=False)
        var_occ = {k: any_kernel(scene, so, sd, SHADOW_T_MIN, stmax, **kw)
                   for k, kw in variants.items()}
        torch.cuda.synchronize()
        moved, ops = trace_work(scene, "nodes8c", (so, sd, stmax), 1, work,
                                OPS_BVH8_NODE)
        k2_work[0] += moved
        k2_work[1] += ops
        n_mis = int((ok != op).sum())
        n_rows = int((ok != over_rows).sum())
        n_var = {k: int((ok != v).sum()) for k, v in var_occ.items()}
        dead = float((stmax <= SHADOW_T_MIN).float().mean())
        t = kernel_ms(lambda: trace_any_bvh8(scene, so, sd, SHADOW_T_MIN,
                                             stmax, height=h, width=w))
        for k, kw in variants.items():
            add_ms(var_ms.setdefault(k, {}), kernel_ms(
                lambda: any_kernel(scene, so, sd, SHADOW_T_MIN, stmax, **kw)))
        p_ms = cuda_ms(lambda: trace_any_plain(scene, so, sd, SHADOW_T_MIN,
                                               stmax), 2)
        log(f"[{label}] K2 light {i}: occluded {float(ok.float().mean()):.4f},"
            f" t_max=0 lanes {dead:.4f}, mismatches vs plain {n_mis}, vs "
            f"plain over the rows {n_rows}, variants {n_var}, node pops "
            f"{int(work['node_pops'])}, max stack {work['max_stack']}, "
            f"kernel {fmt_ms(t)}, plain {p_ms:.2f} ms")
        k2_mism += n_mis + n_rows + sum(n_var.values())
        k2_err = max(k2_err, float((ok.int() - op.int()).abs().max()))
        add_ms(k2, t)
        k2_plain_ms += p_ms
    require(k2_mism == 0, f"[{label}] K2 differs from plain, the plain "
            f"trace over the rows or its variants")
    b_ms, b_by = bound(*k2_work)
    log(f"[{label}] K2, {len(variants)} variants over the 3 lights: "
        + ", ".join(f"{k} {fmt_ms(v)}" for k, v in var_ms.items()))
    out["bvh8_any"] = dict(max_abs_err=k2_err, plain_ms=k2_plain_ms,
                           bound_ms=b_ms, bound_by=b_by, variants=var_ms,
                           **k2)

    # K3h + K3: the frame's real depth pyramid and G-buffer, at the
    # frame's preset and at HIGH (another compile-time instantiation)
    g = shade(scene, cam, lights, hk)
    depth = quantize_r16f(g["depth"]).reshape(h, w)
    normal = quantize_r11g11b10f(g["normal_enc"]).reshape(h, w, 3)
    mips = prefilter_depths(depth, gtao["host"])
    noise = noise_maps_64(0, r.device)
    gvec = gtao["vec"]
    st = c.gtao.slice_count, c.gtao.steps_per_slice
    for preset in (st, (3, 3)):
        kw = dict(slice_count=preset[0], steps_per_slice=preset[1])
        ao_k, ed_k = gtao_main(mips, normal, gvec, noise, **kw)
        ao_p, ed_p = main_pass_plain(mips, normal, gvec, noise, **kw)
        table_k = gtao_noise_table(noise, gvec, **kw)
        table_p = noise_table_plain(noise, gvec, **kw)
        torch.cuda.synchronize()
        dao = (ao_k.int() - ao_p.int()).abs()
        ed_mis = int((ed_k != ed_p).sum())
        frac = float((dao > 0).float().mean())
        tab_err = float((table_k - table_p).abs().max())
        tab_mis = int((table_k.view(torch.int32)
                       != table_p.view(torch.int32)).sum())
        log(f"[{label}] K3h + K3 at {preset[0]}x{preset[1]}: AO max step "
            f"{int(dao.max())}, differing {frac:.6f}, edge mismatches "
            f"{ed_mis}, mean AO {float(ao_k.float().mean()):.2f}; K3h table "
            f"vs plain: {tab_mis} of {table_k.numel()} differ, max abs "
            f"{tab_err}")
        require(ed_mis == 0, f"[{label}] K3 edges differ")
        require(int(dao.max()) <= AO_MAX_STEP and frac <= AO_MAX_FRACTION,
                f"[{label}] K3 AO outside budget")
        # P1's cos/sin tolerance: the card's libm gives torch's bits there
        require(tab_err <= ATOL_TRIG, f"[{label}] K3h table outside "
                f"{ATOL_TRIG}")
        if preset == st:
            ao_main, ed_main, table, kw_main = ao_k, ed_k, table_k, kw
            dao_main, tab_main = float(dao.max()), tab_err
    kw = kw_main
    t_all = kernel_ms(lambda: gtao_main(mips, normal, gvec, noise, **kw))
    t_h = kernel_ms(lambda: gtao_noise_table(noise, gvec, **kw))
    t_k3 = kernel_ms(lambda: main_kernel(mips, normal, gvec, table, **kw))
    plain_ms = cuda_ms(lambda: main_pass_plain(mips, normal, gvec, noise,
                                               **kw), 3)
    plain_h_ms = cuda_ms(lambda: noise_table_plain(noise, gvec, **kw), 3)
    log(f"[{label}] K3h {fmt_ms(t_h)}; K3 {fmt_ms(t_k3)}; gtao_main (both "
        f"launches) {fmt_ms(t_all)}; plain {plain_ms:.2f} ms (table "
        f"{plain_h_ms:.2f})")
    px_ops = gtao_main_work(*st, False, "exact")[0]
    b_ms, b_by = bound(nbytes(*mips, normal, gvec, table) + 2 * w * h,
                       px_ops * w * h)
    out["gtao_main"] = dict(max_abs_err=dao_main, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            with_noise_table=t_all, **t_k3)
    per_slice, per_step = TRANS_EQUIV_OPS
    b_ms, b_by = bound(nbytes(noise, gvec, table),
                       noise[0].numel() * st[0] * (per_slice
                                                   + st[1] * per_step))
    out["gtao_noise"] = dict(max_abs_err=tab_main, plain_ms=plain_h_ms,
                             bound_ms=b_ms, bound_by=b_by, **t_h)
    ao_k, ed_k = ao_main, ed_main

    # K4: the main pass's AO and edges through the sharp chain (1 pass)
    n_pass = c.gtao.num_denoise_passes
    beta = c.gtao.denoise_blur_beta

    def plain_chain():
        a = ao_k
        for i in range(n_pass):
            final = i == n_pass - 1
            a = denoise_pass_plain(a, ed_k, beta if final else beta / 5.0,
                                   final)
        return a

    dk = denoise_chain(ao_k, ed_k, n_passes=n_pass, blur_beta=beta)
    dp = plain_chain()
    torch.cuda.synchronize()
    dd = (dk - dp).abs()
    frac = float((dd > 0).float().mean())
    t = kernel_ms(lambda: denoise_chain(ao_k, ed_k, n_passes=n_pass,
                                        blur_beta=beta), 20)
    plain_ms = cuda_ms(plain_chain, 5)
    log(f"[{label}] K4 denoise: max step {int(dd.max())}, differing "
        f"{frac:.6f}, max AO {int(dk.max())}, kernel {fmt_ms(t)}, plain "
        f"{plain_ms:.3f} ms")
    require(int(dd.max()) == 0, f"[{label}] K4 differs from plain")
    # per pass: AO and edges in (u8 each), the pass's output out (u8, the
    # last one int32)
    b_ms, b_by = bound(n_pass * 2 * w * h + (n_pass - 1) * w * h
                       + 4 * w * h, n_pass * GTAO_DENOISE_WORK[
                           (False, False)][0] * w * h)
    out["gtao_denoise"] = dict(max_abs_err=float(dd.max()),
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, **t)
    return out


# K8a's and K8b's float operations, counted in csrc/shade_lights.cu as
# the GTAO kernels' are (powf, acosf and sqrtf 1 each): K8a per pixel and
# light 18 (the length, the normalize, N.L, the want) and the L vector by
# light type, 3 for a point, spot or directional light, 92 for an area
# light (its plane 17, the barycentrics 47, a segment 25, the difference
# 3); K8b per pixel 22 (F0, Kd, the roughness, N.V and its pow) and per
# light 104 (H 13, the clamps and dots 16, the specular 31, the diffuse
# 26, the shadow 3, the sum 15), 20 more for a spot or area light's cone
# and 17 for a falloff
K8A_OPS = (18, {0: 3, 1: 3, 2: 3, 3: 92})
K8B_OPS = (22, 104, 20, 17)


def phase15_lights(r, label):
    """K8a and K8b against the plain pre-pass and sum, at the frame's shape
    with the scene's lights: bit-exact, timed beside the bound and the
    plain chain on the card."""
    from tpurt_torch.kernels.shade_lights import (RAY_KEYS, light_rays,
                                                  light_rays_plain,
                                                  light_sum, light_sum_plain)
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_closest_bvh8)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, surface

    c = r.config
    w, h = c.width, c.height
    cam, lights, _ = frame_inputs(r)
    sc = r.scene_device
    o, d = camera_rays(cam, w, h)
    surf = surface(sc, cam, trace_closest_bvh8(sc, o, d, T_MIN, T_MAX,
                                               height=h, width=w))
    n, s = o.shape[0], lights["pos"].shape[0]
    args = (surf["world_pos"], surf["N"], surf["valid"], lights)
    rays, plain = light_rays(*args), light_rays_plain(*args)
    for key in RAY_KEYS:
        require(bits_equal(rays[key], plain[key]),
                f"[{label}] K8a {key} differs from the plain pre-pass")
    occ = [trace_any_bvh8(sc, surf["world_pos"], L, SHADOW_T_MIN, t,
                          height=h, width=w)
           for L, t in zip(rays["L"], rays["t_max"])]
    rho = light_sum(surf, rays, occ, lights)
    require(bits_equal(rho, light_sum_plain(surf, plain, occ, lights)),
            f"[{label}] K8b rho differs from the plain sum")
    types = lights["light_type"].tolist()
    falloff = lights["falloff_distance"].tolist()
    ops_a = n * sum(K8A_OPS[0] + K8A_OPS[1].get(t, 0) for t in types)
    ops_b = n * (K8B_OPS[0] + sum(
        K8B_OPS[1] + (K8B_OPS[2] if t in (1, 3) else 0)
        + (K8B_OPS[3] if f > 0 else 0) for t, f in zip(types, falloff)))
    table = nbytes(*lights.values())
    # roughness and metallic: the 4 bytes of each that a pixel needs
    moved_a = table + nbytes(*args[:3], *(rays[k] for k in RAY_KEYS))
    moved_b = table + n * 8 + nbytes(
        *(surf[k] for k in ("N", "V", "albedo", "world_pos")), rays["L"],
        rays["nc_NdotL"], rays["wants_shadow"], *occ, rho)
    out = {}
    for name, what, fn, plain_fn, moved, ops in (
            ("shade_light_rays", "K8a light rays", lambda: light_rays(*args),
             lambda: light_rays_plain(*args), moved_a, ops_a),
            ("shade_light_sum", "K8b light sum",
             lambda: light_sum(surf, rays, occ, lights),
             lambda: light_sum_plain(surf, rays, occ, lights), moved_b,
             ops_b)):
        t = kernel_ms(fn)
        b_ms, by = bound(moved, ops)
        t.update(plain_ms=cuda_ms(plain_fn, 3), bound_ms=b_ms, bound_by=by,
                 max_abs_err=0.0, bytes=moved, ops=ops)
        log(f"[{label}] {what}, {s} lights: {fmt_ms(t)}, bound "
            f"{b_ms:.4f} ms ({by}: {moved / 1e6:.1f} MB, {ops / 1e9:.3f} "
            f"Gflop), plain chain {t['plain_ms']:.3f} ms; bit-exact")
        out[name] = t
    return out


# phase 16: K9's tiers and taps, and the renderers of the textures workload
# per tier (built at the first size, resized for the next)
K9_TIERS = ("quad", "pair", "block4")
K9_TAPS = (1, 16)


def k9_roofline():
    """rtbench/metrics/k9_roofline.py, whose count and rates phase 16's
    bound uses."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "k9_roofline", os.path.join(REPO, "rtbench", "metrics",
                                    "k9_roofline.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def same_bits(got, want):
    """Equal NaN masks and equal bits elsewhere (a NaN's payload may
    differ between the kernel and PyTorch's ops)."""
    import torch

    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and bits_equal(got[~nan], want[~nan]))


def phase16_texels(label, renderers):
    """K9 against the plain chain on the textures workload's hits in each
    tier, with 1 and 16 taps: bit-exact, one launch a call, timed beside
    the bound and the plain chain; K9's rows (mip_texel_rows) against
    their plain version, and K9 over those rows served by a gather hook
    against K9 over the table, the rows' launch timed beside its byte
    bound. `renderers` {tier: Renderer} is filled at the first size and
    resized after."""
    import torch

    from tpurt_torch.kernels.mip_texels import (mip_texel_rows,
                                                mip_texel_rows_plain,
                                                mip_texels, mip_texels_plain)
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import _normalize, cone_spread

    w, h = (int(x) for x in label.split("x"))
    k9 = k9_roofline()
    out, rows_out = {}, {}
    for tier in K9_TIERS:
        r = renderers.get(tier)
        if r is None:
            r = renderers[tier] = textured_renderer(w, h, "cuda", tier, 16)
        r.resize(w, h)
        sc = r.scene_device
        require(f"tex_mip_{tier}" in sc, f"[{label}] K9: {tier} not shipped")
        cam, _, _ = frame_inputs(r)
        o, d = camera_rays(cam, w, h)
        hits = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX, height=h, width=w)
        attr = sc["tri_attr"][torch.clamp_min(hits["tri"], 0).long()]
        u, v = hits["u"][:, None], hits["v"][:, None]
        wgt = 1.0 - u - v
        uv = attr[:, 3:5] * wgt + attr[:, 15:17] * u + attr[:, 27:29] * v
        normal = _normalize(attr[:, 5:8] * wgt + attr[:, 17:20] * u
                            + attr[:, 29:32] * v)
        table = sc[f"tex_mip_{tier}"]
        tables = (sc[f"tex_mip_{tier}_offsets"], sc["tex_mip_sizes"])
        for taps in K9_TAPS:
            lanes = (hits["t"], d, normal, attr, uv, cone_spread(cam, h),
                     taps)
            args = (tier, table, *tables, *lanes)
            got = counted_once(lambda: mip_texels(*args, footprint=True),
                               dict(mip_texels=1), f"[{label}] K9 {tier}")
            want = mip_texels_plain(*args, footprint=True)
            for what, a, b in zip(("texels", "lod", "duv"), got, want):
                require((a is None and b is None) or same_bits(a, b),
                        f"[{label}] K9 {tier} {taps} taps: {what} differs "
                        f"from the plain chain")
            t = kernel_ms(lambda: mip_texels(*args))
            moved, ops = k9.work(w, h, taps)
            b_ms = k9.least_ms(w, h, taps)
            by = ("bytes" if moved / k9.PEAK_BYTES_PER_S
                  >= ops / k9.PEAK_UNFUSED_PER_S else "operations")
            t.update(plain_ms=cuda_ms(lambda: mip_texels_plain(*args), 3),
                     bound_ms=b_ms, bound_by=by, max_abs_err=0.0,
                     bytes=moved, ops=ops, launches=1)
            log(f"[{label}] K9 {tier}, {taps} taps: {fmt_ms(t)}, bound "
                f"{b_ms:.4f} ms ({by}: {moved / 1e6:.1f} MB, "
                f"{ops / 1e9:.3f} G unfused, {100 * b_ms / t['ms']:.1f}%), "
                f"plain chain {t['plain_ms']:.3f} ms; bit-exact")
            out[f"{tier} {taps}"] = t

            rows_args = (tier, *tables, *lanes)
            flats = counted_once(lambda: mip_texel_rows(*rows_args),
                                 dict(mip_texel_rows=1),
                                 f"[{label}] K9 rows {tier}")
            require(torch.equal(flats, mip_texel_rows_plain(*rows_args)),
                    f"[{label}] K9 rows {tier} {taps} taps differ from "
                    f"the plain version")
            through = counted_once(
                lambda: mip_texels(tier, None, *tables, *lanes,
                                   gather=lambda f: table[f]),
                dict(mip_texels=1, mip_texel_rows=1),
                f"[{label}] K9 over gathered rows {tier}")
            require(same_bits(through, got[0]),
                    f"[{label}] K9 {tier} {taps} taps over gathered rows "
                    f"differs from K9 over the table")
            t = kernel_ms(lambda: mip_texel_rows(*rows_args))
            # the inputs once and the int32 indices out
            moved = w * h * k9.INPUT_BYTES + flats.numel() * 4
            b_ms, by = bound(moved, 0)
            t.update(plain_ms=cuda_ms(
                lambda: mip_texel_rows_plain(*rows_args), 3),
                bound_ms=b_ms, bound_by=by, max_abs_err=0.0, bytes=moved,
                launches=1)
            log(f"[{label}] K9 rows {tier}, {taps} taps: {fmt_ms(t)}, "
                f"bound {b_ms:.4f} ms ({moved / 1e6:.1f} MB, "
                f"{100 * b_ms / t['ms']:.1f}%), plain "
                f"{t['plain_ms']:.3f} ms; equal, and K9 over the gathered "
                f"rows bit-exact")
            rows_out[f"{tier} {taps}"] = t
    log(f"[{label}] K9 {card_line()}")
    return dict(mip_texels=dict(out["pair 16"], tiers=out),
                mip_texel_rows=dict(rows_out["pair 16"], tiers=rows_out))


def phase2(r, label):
    """Frames through Renderer.render(); the launch counts prove the path."""
    import torch

    from tpurt_torch.kernels import build

    c = r.config
    for _ in range(WARMUP_FRAMES):
        r.render()
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        out = r.render(block=False)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    ms = elapsed * 1000.0 / FRAMES
    rays = r.stats()["rays_per_frame"]
    image = out["image"]
    checksum = int(image.to(torch.int64).sum())
    lit = float((image.amax(dim=-1) > 0).float().mean())
    log(f"[{label}] frames {FRAMES}: launches {counts}, {ms:.3f} ms/frame, "
        f"{rays / ms / 1e3:.2f} Mrays/s ({rays} rays/frame), checksum "
        f"{checksum}, lit share {lit:.4f}")
    shadow = r.stats()["shadow_casting_lights"]
    want = dict(ALL_ZERO, bvh8_closest=FRAMES, bvh8_any=shadow * FRAMES,
                gtao_noise=FRAMES, gtao_main=FRAMES, gtao_denoise=FRAMES,
                **shade_calls(FRAMES))
    require(counts == want, f"[{label}] launch counts {counts} != {want}")
    require(tuple(image.shape) == (c.height, c.width, 3)
            and image.dtype == torch.uint8, f"[{label}] bad image")
    for key in ("color", "depth", "normal"):
        require(bool(torch.isfinite(out[key]).all()),
                f"[{label}] non-finite {key}")
    require(checksum > 0 and lit > 0.2, f"[{label}] frame is black")
    return dict(ms_per_frame=ms, mrays_per_s=rays / ms / 1e3,
                rays_per_frame=rays, launches=counts, checksum=checksum,
                lit_share=lit, noise_index=(r.noise_index - 1) % 64)


def phase3():
    """A small frame on the card against the plain versions on the host."""
    import torch

    imgs = []
    for device in ("cuda", "cpu"):
        r = build_renderer(64, 64, device)
        imgs.append(r.render()["image"].cpu().to(torch.int32))
    d = (imgs[0] - imgs[1]).abs().amax(dim=-1)
    eq = float((d == 0).float().mean())
    far = float((d > 2).float().mean())
    log(f"[64x64] card vs host plain: equal pixels {eq:.4f}, off by > 2 "
        f"{far:.4f}, max diff {int(d.max())}, lit share "
        f"{float((imgs[0].amax(-1) > 0).float().mean()):.4f}")
    # the host's pow/cos/log2 come from another math library than the card's
    require(eq >= 0.999 and far <= 1e-3,
            "64x64 frame on the card disagrees with the host")


GT_SPP = 4            # the anti-aliased frame's samples
GT_SAMPLES = 8        # accumulation samples per timed call
GT_RTAO_SAMPLES = 4   # RTAO samples per frame


def counted_once(fn, want, what):
    """Launches of one call of fn(), which must equal `want` (every other
    kernel 0); returns fn's result."""
    import torch

    from tpurt_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    require(counts == dict(ALL_ZERO, **want),
            f"{what} launched {counts}, want {want}")
    return out


def wall_and_device_ms(fn, reps):
    """fn()'s ms per call by the host wall clock (reps calls ending in one
    synchronize, after one warm-up call) and by kernels/build.device_ms
    (the card-only timer, the least of 3 runs of reps calls queued behind a
    spin kernel; on a host-bound path it waits for the host too)."""
    import torch

    from tpurt_torch.kernels.build import device_ms

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1000.0 / reps
    return dict(wall_ms=wall, ms=device_ms(fn, reps))


def phase9(r, label):
    """The ground-truth path at full width: the spp frame, accumulation
    samples and RTAO frames, their launches and times."""
    import torch

    from tpurt_torch.engine.accumulate import (accumulate_samples,
                                              init_accumulation)
    from tpurt_torch.passes.rtao import rtao_frame

    c = r.config
    w, h = c.width, c.height
    shadow = r.stats()["shadow_casting_lights"]
    cam, lights, _ = r._frame_inputs()
    out = {}

    c.spp = GT_SPP
    try:
        frame = counted_once(
            lambda: r.render(block=False),
            dict(bvh8_closest=GT_SPP, bvh8_any=GT_SPP * shadow,
                 gtao_noise=1, gtao_main=1, gtao_denoise=1,
                 **shade_calls(GT_SPP)),
            f"[{label}] spp={GT_SPP} frame")
        out["spp_frame"] = wall_and_device_ms(
            lambda: r.render(block=False), 3)
    finally:
        c.spp = 1
    image = frame["image"]
    lit = float((image.amax(dim=-1) > 0).float().mean())
    require(tuple(image.shape) == (h, w, 3) and lit > 0.2
            and bool(torch.isfinite(frame["color"]).all()),
            f"[{label}] spp={GT_SPP} frame is black or not finite")

    empty = init_accumulation(h, w, 0)
    empty.color_sum = empty.color_sum.to(r.device)

    def accumulate():
        return accumulate_samples(empty, r.scene_device, cam, lights,
                                  GT_SAMPLES, width=w, height=h)

    st = counted_once(accumulate, dict(bvh8_closest=GT_SAMPLES,
                                       bvh8_any=GT_SAMPLES * shadow,
                                       **shade_calls(GT_SAMPLES)),
                      f"[{label}] accumulate_samples({GT_SAMPLES})")
    t = wall_and_device_ms(accumulate, 2)
    out["accumulate_per_sample"] = {k: v / GT_SAMPLES for k, v in t.items()}
    mean = st.mean
    require(st.num_samples == GT_SAMPLES and mean.shape == (h, w, 3)
            and bool(torch.isfinite(mean).all())
            and float((mean.amax(dim=-1) > 1e-3).float().mean()) > 0.2,
            f"[{label}] accumulated mean is black or not finite")

    def rtao():
        return rtao_frame(r.scene_device, cam, None, width=w, height=h,
                          samples_per_frame=GT_RTAO_SAMPLES)

    vis, valid = counted_once(rtao, dict(bvh8_closest=1,
                                         bvh8_any=GT_RTAO_SAMPLES),
                              f"[{label}] rtao_frame")
    out["rtao_frame"] = wall_and_device_ms(rtao, 5)
    hit = valid
    occluded = float((vis[hit] < 1.0).float().mean())
    require(float(hit.float().mean()) > 0.3 and float(vis.min()) >= 0.0
            and float(vis.max()) <= 1.0 and bool((vis[~hit] == 1.0).all())
            and occluded > 0.0, f"[{label}] rtao frame out of range")
    out["rtao_occluded_share"] = occluded
    log(f"[{label}] ground truth: spp={GT_SPP} frame "
        f"{out['spp_frame']['wall_ms']:.3f} ms wall, "
        f"{out['spp_frame']['ms']:.3f} ms card-only timer; "
        f"accumulate_samples per sample "
        f"{out['accumulate_per_sample']['wall_ms']:.3f} / "
        f"{out['accumulate_per_sample']['ms']:.3f} ms; rtao_frame "
        f"({GT_RTAO_SAMPLES} samples) {out['rtao_frame']['wall_ms']:.3f} / "
        f"{out['rtao_frame']['ms']:.3f} ms; RTAO occluded share of hits "
        f"{occluded:.4f}")
    return out


# phase 10's variants: (name, GtaoSettings overrides) and frames per size
GTAO_VARIANT_FRAMES = (("bent", dict(bent_normals=True)),
                       ("half", dict(precision="half")),
                       ("fp16", dict(precision="fp16")),
                       ("bent_fp16", dict(bent_normals=True,
                                          precision="fp16")))
VARIANT_FRAME_COUNT = 5
# tonemap_frame_hdr10 on the card against the host (PQ's pow(x, 78.84)
# multiplies a last-bit difference of the libraries' pow by ~80)
HDR10_ATOL = 1e-4


def _ao_diff(a, b, bent):
    """Per-pixel u8 differences of two AO terms (the largest over the four
    bytes of the packed term with bent normals)."""
    import torch

    if bent:
        a = a.contiguous().view(torch.uint8).reshape(*a.shape, 4)
        b = b.contiguous().view(torch.uint8).reshape(*b.shape, 4)
        return (a.int() - b.int()).abs().amax(dim=-1)
    return (a.int() - b.int()).abs()


def phase10(r, label, default_frame, exact_kernels):
    """The GTAO variants and the output libraries: frames through
    Renderer.render() with bent normals, "half", fp16 and bent + fp16
    (launches per frame, ms/frame, outputs); each variant's K3h/K3/K4
    instantiation against its plain version on that frame's G-buffer, timed
    beside the exact K3/K4 at the same shapes; the default frame's hash
    after the variants; gtao_debug_image in its three modes;
    tonemap_frame_hdr10 on the frame against the same on the host."""
    import dataclasses

    import torch

    from tpurt_torch.engine import convert
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.gtao_denoise import (count_key as dn_key,
                                                  denoise_chain,
                                                  denoise_pass_plain)
    from tpurt_torch.kernels.gtao_main import (count_key, gtao_noise_table,
                                               main_kernel, main_pass_plain,
                                               noise_table_plain)
    from tpurt_torch.passes.gtao import (DEBUG_MODES, noise_maps_64,
                                         prefilter_depths)
    from tpurt_torch.passes.tonemap import lpm_setup_hdr10, \
        tonemap_frame_hdr10

    c = r.config
    w, h = c.width, c.height
    shadow = r.stats()["shadow_casting_lights"]
    _, _, gtao = r._frame_inputs()
    default = c.gtao
    frames, kernels = {}, {}
    exact_ms = dict(gtao_main=exact_kernels["gtao_main"]["ms"],
                    gtao_denoise=exact_kernels["gtao_denoise"]["ms"])
    try:
        for name, over in GTAO_VARIANT_FRAMES:
            st = c.gtao = dataclasses.replace(default, **over)
            bent, prec = st.bent_normals, st.precision
            main_key = count_key(bent, prec)
            noise_key = "gtao_noise_fp16" if st.fp16 else "gtao_noise"
            den_key = dn_key(bent, st.fp16)
            n_pass = st.num_denoise_passes
            r.render()
            torch.cuda.synchronize()
            build.reset_counts()
            t0 = time.perf_counter()
            for _ in range(VARIANT_FRAME_COUNT):
                out = r.render(block=False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000.0 / VARIANT_FRAME_COUNT
            counts = dict(build.launch_counts)
            n = VARIANT_FRAME_COUNT
            want = dict(ALL_ZERO, bvh8_closest=n, bvh8_any=shadow * n,
                        **{noise_key: n, main_key: n, den_key: n * n_pass},
                        **shade_calls(n))
            require(counts == want, f"[{label}] {name} frames launched "
                    f"{counts}, want {want}")
            image = out["image"]
            lit = float((image.amax(dim=-1) > 0).float().mean())
            require(lit > 0.2 and all(bool(torch.isfinite(out[k]).all())
                                      for k in ("color", "depth", "normal")),
                    f"[{label}] {name} frame is black or not finite")
            if bent:
                bn = out["bent_normals"]
                require(tuple(bn.shape) == (h, w, 3)
                        and bool(torch.isfinite(bn).all())
                        and float(bn.abs().amax()) > 0.5,
                        f"[{label}] {name} bent normals")
            else:
                require("bent_normals" not in out, f"[{label}] {name}: "
                        f"bent normals without the setting")
            frames[name] = dict(ms_per_frame=ms, launches=counts,
                                lit_share=lit,
                                checksum=int(image.to(torch.int64).sum()))

            # the instantiations on this frame's G-buffer
            mips = prefilter_depths(out["depth"], gtao["host"],
                                    fp16=st.fp16)
            normal = out["normal"]
            gvec = gtao["vec16" if st.fp16 else "vec"]
            noise = noise_maps_64(0, r.device)
            kw = dict(slice_count=st.slice_count,
                      steps_per_slice=st.steps_per_slice)
            table = gtao_noise_table(noise, gvec, fp16=st.fp16, **kw)
            ao_k, ed_k = main_kernel(mips, normal, gvec, table, bent=bent,
                                     precision=prec, **kw)
            ao_p, ed_p = main_pass_plain(mips, normal, gvec, noise,
                                         bent=bent, precision=prec, **kw)
            torch.cuda.synchronize()
            d = _ao_diff(ao_k, ao_p, bent)
            frac = float((d > 0).float().mean())
            ed_mis = int((ed_k != ed_p).sum())
            require(ed_mis == 0 and int(d.max()) <= AO_MAX_STEP
                    and frac <= AO_MAX_FRACTION,
                    f"[{label}] {main_key} outside budget: max step "
                    f"{int(d.max())}, share {frac}, edges {ed_mis}")
            t_k3 = kernel_ms(lambda: main_kernel(
                mips, normal, gvec, table, bent=bent, precision=prec, **kw))
            plain_ms = cuda_ms(lambda: main_pass_plain(
                mips, normal, gvec, noise, bent=bent, precision=prec,
                **kw), 1)
            ops32, ops16 = gtao_main_work(st.slice_count,
                                          st.steps_per_slice, bent, prec)
            b_ms, b_by = bound(nbytes(*mips, normal, gvec, table)
                               + (4 if bent else 1) * w * h + w * h,
                               ops32 * w * h, ops16 * w * h)
            kernels[main_key] = dict(max_abs_err=float(d.max()),
                                     differing_share=frac,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, launches=n, **t_k3)
            if st.fp16 and noise_key not in kernels:
                table_p = noise_table_plain(noise, gvec, fp16=True, **kw)
                tab_err = float((table - table_p).abs().max())
                # the plain version calls the same device math: equal bits
                require(tab_err == 0.0, f"[{label}] K3h fp16 table differs "
                        f"from plain by {tab_err}")
                t_h = kernel_ms(lambda: gtao_noise_table(
                    noise, gvec, fp16=True, **kw))
                (sl32, sl16), (st32, st16) = GTAO_NOISE_LP_OPS
                el = noise[0].numel() * st.slice_count
                b_ms, b_by = bound(nbytes(noise, gvec, table),
                                   el * (sl32 + st.steps_per_slice * st32),
                                   el * (sl16 + st.steps_per_slice * st16))
                kernels[noise_key] = dict(
                    max_abs_err=tab_err, launches=n, plain_ms=cuda_ms(
                        lambda: noise_table_plain(noise, gvec, fp16=True,
                                                  **kw), 3),
                    bound_ms=b_ms, bound_by=b_by, **t_h)

            if bent or st.fp16:
                def plain_chain():
                    a = ao_k
                    for i in range(n_pass):
                        final = i == n_pass - 1
                        a = denoise_pass_plain(
                            a, ed_k, st.denoise_blur_beta if final
                            else st.denoise_blur_beta / 5.0, final,
                            bent=bent, fp16=st.fp16)
                    return a

                dkw = dict(n_passes=n_pass, blur_beta=st.denoise_blur_beta,
                           bent=bent, fp16=st.fp16)
                dk = denoise_chain(ao_k, ed_k, **dkw)
                dp = plain_chain()
                torch.cuda.synchronize()
                dmis = int((dk != dp).sum())
                require(dmis == 0, f"[{label}] {den_key} differs from "
                        f"plain on {dmis} pixels")
                t_k4 = kernel_ms(lambda: denoise_chain(ao_k, ed_k, **dkw),
                                 20)
                ops32, ops16 = GTAO_DENOISE_WORK[(bent, st.fp16)]
                term = 4 if bent else 1
                b_ms, b_by = bound(n_pass * (term + 1) * w * h
                                   + (n_pass - 1) * term * w * h
                                   + 4 * w * h, n_pass * ops32 * w * h,
                                   n_pass * ops16 * w * h)
                kernels[den_key] = dict(max_abs_err=float(dmis),
                                        plain_ms=cuda_ms(plain_chain, 3),
                                        bound_ms=b_ms, bound_by=b_by,
                                        launches=n * n_pass, **t_k4)
            log(f"[{label}] {name} frames {n}: launches {counts}, "
                f"{ms:.3f} ms/frame, lit share {lit:.4f}; {main_key} "
                f"{fmt_ms(t_k3)} (exact K3 {exact_ms['gtao_main']:.4f} ms), "
                f"max step {int(d.max())}, differing {frac:.6f}, plain "
                f"{plain_ms:.2f} ms"
                + (f"; {den_key} {fmt_ms(kernels[den_key])} (exact K4 "
                   f"{exact_ms['gtao_denoise']:.4f} ms), bit-exact"
                   if den_key in kernels else ""))
    finally:
        c.gtao = default

    # the default frame after the variants: phase 2's bits
    again = r.render_passes(default_frame["noise_index"])["image"]
    checksum = int(again.to(torch.int64).sum())
    require(checksum == default_frame["checksum"], f"[{label}] default "
            f"frame checksum {checksum} != phase 2's "
            f"{default_frame['checksum']}")

    frame = r.render()
    debug = {}
    for mode in DEBUG_MODES:
        want = dict(gtao_noise=1, gtao_main=1) if mode == "ao" else {}
        img = counted_once(lambda: r.gtao_debug_image(mode, out=frame),
                           want, f"[{label}] gtao_debug_image({mode!r})")
        require(tuple(img.shape) == (h, w, 4) and img.dtype == torch.float16
                and bool(torch.isfinite(img).all())
                and float(img[..., :3].float().mean()) > 0.0,
                f"[{label}] gtao_debug_image({mode!r})")
        debug[mode] = float(img[..., :3].float().mean())

    derived = lpm_setup_hdr10()[1]
    on_card = tonemap_frame_hdr10(frame["color"], frame["ao"],
                                  convert.lpm_tensors(derived, r.device))
    on_host = tonemap_frame_hdr10(frame["color"].cpu(), frame["ao"].cpu(),
                                  convert.lpm_tensors(derived, "cpu"))
    hdr_err = float((on_card.cpu() - on_host).abs().max())
    require(hdr_err <= HDR10_ATOL and bool(torch.isfinite(on_card).all())
            and float(on_card.max()) > 0.0,
            f"[{label}] tonemap_frame_hdr10: card vs host {hdr_err}")
    hdr_ms = cuda_ms(lambda: tonemap_frame_hdr10(
        frame["color"], frame["ao"], convert.lpm_tensors(derived, r.device)),
        5)
    log(f"[{label}] default frame after the variants: checksum {checksum} "
        f"(phase 2's); gtao_debug_image mean rgb {debug}; "
        f"tonemap_frame_hdr10 card vs host max abs {hdr_err:.3g} (<= "
        f"{HDR10_ATOL}), {hdr_ms:.3f} ms")
    return dict(frames=frames, kernels=kernels, debug_image_mean=debug,
                hdr10=dict(max_abs_err=hdr_err, ms=hdr_ms))


# phase 11: the mip tiers on 2^20 seeded lanes (material_field(6, 6)'s
# textures, 16-128 texels, and these odd extents), anisotropic taps, the
# textured frames' size and count, the textures workload's frames per
# aniso_taps
TEX_LANES = 1 << 20
TEX_ODD_EXTENTS = ((13, 7), (5, 5), (1, 1))
TEX_TAPS = (1, 4, 16)
TEX_TIERS = ("atlas", "quad", "pair", "block4")
TEX_SMALL = 64
TEX_SMALL_FIELD = dict(nx=3, nz=3, subdiv=2, spacing=1.0,
                       extents=(16, 32, 64))
TEX_FRAMES = 5
# the budgets (quad, pair) that make flatten_scene pick each tier
TEX_BUDGETS = dict(quad=(1 << 40, 1 << 40), pair=(0, 1 << 40),
                   block4=(0, 0))


def tier_tables():
    """The per-layer atlas and the quad, pair and block4 tables (host
    numpy) of a material_field(6, 6)'s images and TEX_ODD_EXTENTS's,
    each image its own."""
    import numpy as np

    from tpurt_torch.scene import scene
    from tpurt_torch.scene.procedural import material_field

    model = material_field(nx=6, nz=6)
    model.update_model_status(np.zeros(3))
    flat = scene.flatten_scene([model])
    stack, sizes = flat.tex_stack, flat.tex_size
    rng = np.random.default_rng(13)
    extra = np.zeros((3 * len(TEX_ODD_EXTENTS),) + stack.shape[1:],
                     np.uint8)
    for i, (h, w) in enumerate(TEX_ODD_EXTENTS):
        extra[3 * i:3 * i + 3, :h, :w] = rng.integers(0, 256, (3, h, w, 4),
                                                      dtype=np.uint8)
    stack = np.concatenate([stack, extra])
    sizes = np.concatenate([sizes, np.asarray(TEX_ODD_EXTENTS, np.int32)])
    dedup = (np.arange(sizes.shape[0], dtype=np.int32),
             list(range(sizes.shape[0])))
    tables = {"atlas": scene.build_mip_atlas(stack, sizes, *dedup)}
    for tier in TEX_TIERS[1:]:
        tables[tier] = getattr(scene, f"build_mip_{tier}_atlas")(
            stack, sizes, *dedup)
    return tables


def tier_lanes(n_prims, levels):
    """TEX_LANES seeded (prim, uv, lod, duv) lanes: uv in [-1.5, 2.5) with
    16 lanes at +-1e4, LODs in [-2, levels + 1) (below 0 and above the
    last level), major axes up to 0.3 in uv."""
    import numpy as np

    rng = np.random.default_rng(17)
    uv = rng.uniform(-1.5, 2.5, (TEX_LANES, 2)).astype(np.float32)
    uv[:16] = rng.choice([-1e4, 1e4], (16, 2))
    return dict(prim=rng.integers(0, n_prims, TEX_LANES).astype(np.int32),
                uv=uv,
                lod=rng.uniform(-2.0, levels + 1.0,
                                TEX_LANES).astype(np.float32),
                duv=rng.uniform(-0.3, 0.3, (TEX_LANES, 2)).astype(
                    np.float32))


def sample_tier(tables, tier, lanes, taps):
    """All three layers (N, 12) of `lanes` through one tier: trilinear
    when taps is 0, else anisotropic with `taps` taps."""
    import torch

    from tpurt_torch.passes import shade

    p, uv, lod, duv = (lanes[k] for k in ("prim", "uv", "lod", "duv"))
    t = tables[tier]
    if tier == "atlas":
        if taps:
            return torch.cat([shade.sample_anisotropic(
                *t, p, layer, uv, lod, duv, taps) for layer in range(3)], 1)
        return torch.cat([shade.sample_trilinear(*t, p, layer, uv, lod)
                          for layer in range(3)], 1)
    if taps:
        return getattr(shade, f"sample_anisotropic_{tier}")(
            *t, p, uv, lod, duv, taps)
    return getattr(shade, f"sample_trilinear_{tier}")(*t, p, uv, lod)


def phase11_tiers():
    """The four tiers bit-equal to each other on the card, trilinear and
    anisotropic with 1, 4 and 16 taps, and each equal to the same function
    on the host."""
    import torch

    host = tier_tables()
    levels = host["quad"][2].shape[1]
    lanes = tier_lanes(host["quad"][2].shape[0], levels)
    on = {dev: ({k: tuple(torch.from_numpy(a).to(dev) for a in v)
                 for k, v in host.items()},
                {k: torch.from_numpy(v).to(dev) for k, v in lanes.items()})
          for dev in ("cuda", "cpu")}
    out = {}
    for taps in (0,) + TEX_TAPS:
        what = f"aniso {taps}" if taps else "trilinear"
        ref = None
        for tier in TEX_TIERS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = sample_tier(on["cuda"][0], tier, on["cuda"][1], taps)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000.0
            plain = sample_tier(on["cpu"][0], tier, on["cpu"][1], taps)
            require(bits_equal(card, plain), f"[textures] {tier} {what}: "
                    f"card differs from the host")
            if ref is None:
                ref = card
            require(bits_equal(card, ref), f"[textures] {tier} {what} "
                    f"differs from the per-layer atlas on the card")
            out[f"{tier} {what}"] = ms
    log(f"[textures] {TEX_LANES} lanes, {levels} levels: the per-layer "
        f"atlas, quad, pair and block4 bit-equal on the card, trilinear "
        f"and aniso {list(TEX_TAPS)}, each equal to the host; wall ms on "
        f"the card (one call each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def phase11_arena(r, default_frame):
    """The bench frame with the arena against the slab and phase 2's
    checksum; a streaming sequence: toggles of the models' residency, the
    rows uploaded, each frame against a fresh renderer's."""
    import hashlib

    import torch

    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.app.bench_scene import build_bench_scene

    c = r.config
    noise = default_frame["noise_index"]
    require(c.texture_arena and "tex_quad_base" in r.scene_device,
            "the default renderer does not use the arena")
    image = r.render_passes(noise)["image"]
    slab = build_bench_scene(Renderer(RendererConfig(
        width=c.width, height=c.height, texture_arena=False)))
    require("tex_quad_shape" in slab.scene_device, "slab renderer")
    require(torch.equal(image, slab.render_passes(noise)["image"]),
            "[textures] the arena frame differs from the slab frame")
    checksum = int(image.to(torch.int64).sum())
    require(checksum == default_frame["checksum"], f"[textures] arena "
            f"frame checksum {checksum} != phase 2's "
            f"{default_frame['checksum']}")
    arena_bytes = r._tex_arena.atlas.numel()
    slab_bytes = slab.scene_device["tex_quad"].numel()
    del slab

    def image_rows(scene):
        """{content key: rows} of each unique image's quad rows at its
        own extent."""
        out = {}
        for ui in range(scene.tex_quad48.shape[0]):
            rep = int((scene.tex_img_of_prim == ui).argmax())
            h, w = (int(x) for x in scene.tex_size[rep])
            rows = scene.tex_quad48[ui, :h, :w].reshape(h * w, -1)
            out[hashlib.sha1(rows.tobytes()).hexdigest()] = h * w
        return out

    s = build_bench_scene(Renderer(RendererConfig(width=c.width,
                                                  height=c.height)))
    cubes = range(2, len(s.models))
    steps = [("the 8 cubes leave", [(i, False) for i in cubes]),
             ("the 8 cubes return", [(i, True) for i in cubes]),
             ("the box field leaves", [(0, False)])]
    seq = []
    for what, flips in steps:
        before = image_rows(s.scene)
        for i, vis in flips:
            s.models[i].set_visible(vis)
        got = s.render_passes(noise)["image"]
        rows = image_rows(s.scene)
        joined = sum(n for k, n in rows.items() if k not in before)
        left = len(set(before) - set(rows))
        arena = s._tex_arena
        fresh = build_bench_scene(Renderer(RendererConfig(
            width=c.width, height=c.height)))
        for i, m in enumerate(s.models):
            fresh.models[i].set_visible(m.visible)
        want = fresh.render_passes(noise)["image"]
        log(f"[textures] streaming: {what}: {arena.last_uploaded_rows} rows "
            f"uploaded (joining images' rows {joined}), {arena.last_freed} "
            f"images freed ({left} left), arena {arena.capacity} rows")
        require(arena.last_uploaded_rows == joined and arena.last_freed ==
                left, f"[textures] streaming step {what!r}: uploaded "
                f"{arena.last_uploaded_rows} rows, freed {arena.last_freed}")
        require(torch.equal(got, want), f"[textures] streaming step "
                f"{what!r}: frame differs from a fresh renderer's")
        seq.append(dict(step=what, uploaded_rows=arena.last_uploaded_rows,
                        joining_rows=joined, freed=arena.last_freed))
        del fresh
    log(f"[textures] the bench frame with the arena equals the slab frame "
        f"and phase 2's checksum {checksum}; texel rows {arena_bytes} bytes"
        f" in the arena, {slab_bytes} in the slab")
    return dict(checksum=checksum, arena_bytes=arena_bytes,
                slab_bytes=slab_bytes, streaming=seq)


def textured_renderer(width, height, device, tier, taps, field=None):
    """The textures workload (app/textures_scene.py), its mip tier forced
    by the budgets (both large: quad)."""
    from tpurt_torch.app.textures_scene import build_textures_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.scene import scene

    saved = scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES
    try:
        if tier is not None:
            scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES = \
                TEX_BUDGETS[tier]
        return build_textures_scene(Renderer(RendererConfig(
            width=width, height=height, mipmaps=True, aniso_taps=taps,
            device=device)), field=field)
    finally:
        scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES = saved


def textured_launches(r, what):
    """One textured frame's launches: K1 once, K2 once per shadow light,
    K3h, K3, K4, K8a, K8b and K9 once each."""
    shadow = r.stats()["shadow_casting_lights"]
    counted_once(lambda: r.render_passes(r.noise_index), dict(
        bvh8_closest=1, bvh8_any=shadow, gtao_noise=1, gtao_main=1,
        gtao_denoise=1, mip_texels=1, **shade_calls(1)),
        f"[textures] {what}")


def phase11_small():
    """64x64 textured frames on the card against the host, quad, pair and
    block4 with aniso_taps 1 and 4, at phase 3's bars."""
    out = {}
    for tier in TEX_TIERS[1:]:
        for taps in (1, 4):
            rs = [textured_renderer(TEX_SMALL, TEX_SMALL, dev, tier, taps,
                                    TEX_SMALL_FIELD) for dev in ("cuda",
                                                                 "cpu")]
            require(f"tex_mip_{tier}" in rs[0].scene_device,
                    f"[textures] 64x64 {tier}: tier not shipped")
            textured_launches(rs[0], f"64x64 {tier} aniso {taps}")
            out[f"{tier} aniso {taps}"] = images_agree(
                *(r.render()["image"] for r in rs),
                f"64x64 {tier} aniso_taps={taps}", tag="textures")
    return out


def phase11_workload():
    """The textures workload at 800x800 (tpurt's tools/textures_bench.py):
    flatten and upload, tier, texture bytes, ms/frame (host wall and
    card-only) with aniso_taps 1 and 16, Mrays/s, profile_frame's
    passes. Returns the renderer for phase11_profile."""
    import torch

    from tpurt_torch.engine import profiler

    w, h = SHAPES[0]
    t0 = time.perf_counter()
    r = textured_renderer(w, h, "cuda", None, 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tier = next(t for t in TEX_TIERS[1:] if f"tex_mip_{t}" in r.scene_device)
    texel_bytes = sum(t.numel() * t.element_size()
                      for k, t in r.scene_device.items()
                      if k.startswith("tex") and isinstance(t, torch.Tensor))
    table = getattr(r.scene, f"tex_mip_{tier}")
    source = r.scene.tex_stack.nbytes
    stats = r.stats()
    rays = stats["rays_per_frame"]
    out = dict(tier=tier, tris=stats["tris"], bvh8_depth=stats["bvh8_depth"],
               setup_s=setup_s, texel_device_bytes=texel_bytes,
               tier_table_bytes=table.nbytes, source_bytes=source,
               rays_per_frame=rays, frames={})
    log(f"[textures] workload {w}x{h}: {stats['tris']} tris, BVH8 depth "
        f"{stats['bvh8_depth']}, {stats['primitives']} primitives; models, "
        f"flatten and upload {setup_s:.1f} s; tier {tier}; source texels "
        f"{source} bytes (padded stack), the {tier} table {table.nbytes} "
        f"bytes, texture tensors on the card {texel_bytes} bytes")
    for taps in (1, 16):
        r.config.aniso_taps = taps
        textured_launches(r, f"workload aniso {taps}")
        t = wall_and_device_ms(lambda: r.render(block=False), TEX_FRAMES)
        frame = r.render()
        lit = float((frame["image"].amax(dim=-1) > 0).float().mean())
        require(lit > 0.2 and bool(torch.isfinite(frame["color"]).all()),
                f"[textures] workload aniso {taps}: bad frame")
        pf = profiler.profile_frame(r, 3)
        out["frames"][str(taps)] = dict(
            wall_ms=t["wall_ms"], ms=t["ms"],
            mrays_per_s=rays / t["wall_ms"] / 1e3, lit_share=lit,
            profile_frame=pf.ms_per_pass)
        log(f"[textures] workload aniso_taps={taps}: {t['wall_ms']:.3f} "
            f"ms/frame host wall, {t['ms']:.3f} card-only, "
            f"{rays / t['wall_ms'] / 1e3:.2f} Mrays/s, lit share {lit:.4f};"
            f" profile_frame {pf.pretty()}")
    log(f"[textures] {card_line()}")
    r.config.aniso_taps = 1
    return r, out


def phase11_profile(r, out):
    """Under torch.profiler, after every other phase: the workload frame's
    CUDA kernel launches and device milliseconds per frame, and the
    device-busy share against its unprofiled host wall time
    (phase11_workload's)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for taps in (1, 16):
        r.config.aniso_taps = taps
        r.render()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                r.render(block=False)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / 2
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        require(kernels, "[textures] torch.profiler saw no device work")
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 2e3
        entry = out["frames"][str(taps)]
        busy = dev_ms / entry["wall_ms"]
        entry.update(launches_per_frame=len(kernels) / 2,
                     device_ms=dev_ms, busy_share=busy,
                     profiled_wall_ms=wall)
        log(f"[textures] workload aniso_taps={taps} under torch.profiler: "
            f"{len(kernels) / 2:.0f} device launches per frame, "
            f"{dev_ms:.3f} device ms per frame, device-busy share {busy:.4f}"
            f" of the {entry['wall_ms']:.3f} ms frame ({wall:.3f} ms/frame "
            f"under the profiler)")
    r.config.aniso_taps = 1


def images_agree(a, b, what, tag="ground truth"):
    """Phase 3's bars on two (H, W, 3) u8 images, card's and host's."""
    import torch

    a, b = a.cpu().to(torch.int32), b.cpu().to(torch.int32)
    require(a.shape == b.shape, f"{what}: shapes {a.shape} / {b.shape}")
    d = (a - b).abs().amax(dim=-1)
    eq = float((d == 0).float().mean())
    far = float((d > 2).float().mean())
    lit = float((a.amax(-1) > 0).float().mean())
    log(f"[{tag}] {what}, card vs host plain: equal pixels "
        f"{eq:.4f}, off by > 2 {far:.4f}, max diff {int(d.max())}, lit "
        f"share {lit:.4f}")
    require(eq >= 0.999 and far <= 1e-3 and lit > 0.2,
            f"{what} on the card disagrees with the host")
    return dict(equal=eq, off_by_more_than_2=far, max_diff=int(d.max()))


def phase9_small():
    """The ground-truth path at 64x64 on the card against the plain
    versions on the host: the spp frame, accumulation from one seed, RTAO
    from one CPU generator seeded alike, and a resize and back."""
    import torch

    from tpurt_torch.engine.accumulate import (accumulate_samples,
                                              init_accumulation)
    from tpurt_torch.passes.encodings import pack_unorm8
    from tpurt_torch.passes.rtao import rtao_frame

    rs = {dev: build_renderer(64, 64, dev) for dev in ("cuda", "cpu")}
    out = {}
    for r in rs.values():
        r.config.spp = GT_SPP
    out["spp_frame"] = images_agree(*(rs[d].render()["image"]
                                      for d in ("cuda", "cpu")),
                                    f"64x64 spp={GT_SPP} frame")
    for r in rs.values():
        r.config.spp = 1

    means, rtaos = [], []
    for dev in ("cuda", "cpu"):
        r = rs[dev]
        cam, lights, _ = r._frame_inputs()
        st = accumulate_samples(init_accumulation(64, 64, 3), r.scene_device,
                                cam, lights, 4, width=64, height=64)
        means.append(st.mean)
        rtaos.append(rtao_frame(r.scene_device, cam,
                                torch.Generator().manual_seed(5), width=64,
                                height=64,
                                samples_per_frame=GT_RTAO_SAMPLES))
    out["accumulate"] = images_agree(
        *(pack_unorm8(torch.clamp(m, 0.0, 1.0)) for m in means),
        "64x64 mean of 4 accumulation samples")
    out["accumulate"]["max_abs_hdr"] = float(
        (means[0].cpu() - means[1]).abs().max())
    (vis_c, valid_c), (vis_h, valid_h) = rtaos
    valid_c, vis_c = valid_c.cpu(), vis_c.cpu()
    require(torch.equal(valid_c, valid_h), "RTAO hit masks differ")
    eq = float((vis_c[valid_h] == vis_h[valid_h]).float().mean())
    log(f"[ground truth] 64x64 rtao_frame, card vs host plain from one CPU "
        f"generator: "
        f"hit masks equal, visibility equal on {eq:.4f} of hit pixels")
    require(eq >= 0.995, "RTAO on the card disagrees with the host")
    out["rtao_equal_share"] = eq

    for size, what in (((100, 60), "frame resized to 100x60"),
                       ((64, 64), "frame resized back to 64x64")):
        for r in rs.values():
            r.resize(*size)
        imgs = [rs[d].render()["image"] for d in ("cuda", "cpu")]
        require(tuple(imgs[0].shape) == (size[1], size[0], 3),
                f"{what}: shape {tuple(imgs[0].shape)}")
        out[what] = images_agree(*imgs, what)
    return out


def bits_equal(a, b):
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool((a == b).all())


def dynamic_tables(r, device):
    from tpurt_torch.engine import convert
    from tpurt_torch.engine.dynamic import make_refit_data

    return (convert.object_tensors(r.scene.as_object_pytree(), device),
            convert.refit_tensors(make_refit_data(r.scene), device))


def refit_nodes8(obj, refit, transforms):
    """The refit frame's BVH8 rows under `transforms`."""
    import torch

    from tpurt_torch.bvh.wide import LEAF8_MAX, refit_bvh8
    from tpurt_torch.engine.dynamic import world_vertices

    t = torch.as_tensor(transforms, device=obj["obj_vtx_pos"].device)
    vp = world_vertices(obj, t)[0]
    tvo = obj["tri_vertex"][refit["order"]]
    v = [vp[tvo[:, k]] for k in range(3)]
    return refit_bvh8(refit["nodes8"], refit["levels"],
                      torch.minimum(torch.minimum(v[0], v[1]), v[2]),
                      torch.maximum(torch.maximum(v[0], v[1]), v[2]),
                      LEAF8_MAX)


def phase4(r, label):
    """The dynamic scene's kernels at the rebuild path's shapes."""
    import torch

    from tpurt_torch.app.bench_scene import rotation_frames
    from tpurt_torch.bvh.lbvh import build_lbvh
    from tpurt_torch.bvh.wide import compact_bvh8
    from tpurt_torch.engine.dynamic import build_world_tables, world_vertices
    from tpurt_torch.kernels.traverse_bvh2 import (trace_any_bvh2,
                                                   trace_any_plain,
                                                   trace_closest_bvh2,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    c = r.config
    w, h = c.width, c.height
    t = rotation_frames(r.scene.transforms, DYN_FRAMES)[-1]
    obj, refit = dynamic_tables(r, r.device)
    obj_h, refit_h = dynamic_tables(r, "cpu")
    cam, lights, _ = frame_inputs(r)
    out = {}

    # the LBVH and the refit rows: card against host
    wd = build_world_tables(obj, t)
    wh = build_world_tables(obj_h, t)
    torch.cuda.synchronize()
    same = {k: bits_equal(wd["bvh"][k], wh["bvh"][k]) for k in wh["bvh"]}
    for key in ("nodes2", "nodes2c", "tris"):
        same[key] = bits_equal(wd[key], wh[key])
    n8_card, n8_host = (refit_nodes8(obj, refit, t),
                        refit_nodes8(obj_h, refit_h, t))
    n8_equal = bits_equal(n8_card, n8_host) and bits_equal(
        compact_bvh8(n8_card), compact_bvh8(n8_host))
    tables_ms = cuda_ms(lambda: build_world_tables(obj, t), 5)
    tt = torch.as_tensor(t, device=r.device)
    transform_ms = cuda_ms(lambda: world_vertices(obj, tt), 5)
    boxes = (wd["bvh"]["aabb_min"][wd["num_tris"] - 1:],
             wd["bvh"]["aabb_max"][wd["num_tris"] - 1:])
    lbvh_ms = cuda_ms(lambda: build_lbvh(*boxes), 5)
    refit_ms = cuda_ms(lambda: refit_nodes8(obj, refit, t), 5)
    tris, nodes = wd["num_tris"], wd["nodes2"].shape[0]
    log(f"[{label}] LBVH on the card: {tris} tris, {nodes} nodes, depth "
        f"bound {wd['depth2']}, equal to the host build: {same}; world "
        f"tables + LBVH {tables_ms:.3f} ms (vertex transform "
        f"{transform_ms:.3f} ms, LBVH build {lbvh_ms:.3f} ms); refit BVH8 "
        f"and its nodes8c equal to the host: {n8_equal}, transform + refit "
        f"{refit_ms:.3f} ms")
    require(all(same.values()) and n8_equal,
            f"[{label}] the card's LBVH or refit differs from the host's")
    require(nodes == 2 * tris - 1, f"[{label}] LBVH node count")
    out["lbvh"] = dict(tris=tris, nodes=nodes, tables_ms=tables_ms,
                       transform_ms=transform_ms, build_ms=lbvh_ms,
                       transform_refit_ms=refit_ms)

    # K6 closest hit: the primary rays over nodes2c, traced as the rebuild
    # frame traces them (its shape: 16x8 pixel tiles) and on consecutive
    # rays, both bit-exact against the plain version
    o, d = camera_rays(cam, w, h)
    tmx = torch.full((w * h,), T_MAX, dtype=torch.float32, device=o.device)
    hk = trace_closest_bvh2(wd, o, d, T_MIN, T_MAX, height=h, width=w)
    hr = trace_closest_bvh2(wd, o, d, T_MIN, T_MAX)
    work = {}
    plain_ms, hp = timed_once(lambda: trace_closest_plain(
        wd, o, d, T_MIN, T_MAX, stats=work))
    mism = {f"{k}{tag}": int((x[k].view(torch.int32)
                              != hp[k].view(torch.int32)).sum())
            for tag, x in (("", hk), ("_rows", hr))
            for k in ("t", "tri", "u", "v")}
    err = float((hk["t"] - hp["t"]).abs().max())
    hit_share = float((hk["tri"] >= 0).float().mean())
    t6 = kernel_ms(lambda: trace_closest_bvh2(wd, o, d, T_MIN, T_MAX,
                                              height=h, width=w))
    t6_rows = kernel_ms(lambda: trace_closest_bvh2(wd, o, d, T_MIN, T_MAX))
    b_ms, b_by = bound(*trace_work(wd, "nodes2c", (o, d, tmx), 16, work,
                                   OPS_BVH2_NODE))
    log(f"[{label}] K6 closest: rays {w * h}, hit share {hit_share:.4f}, "
        f"bit mismatches {mism}, max |dt| {err}, node pops "
        f"{int(work['node_pops'])}, triangle tests "
        f"{int(work['tri_tests'])}, kernel (tiles) {fmt_ms(t6)}, on rows of "
        f"128 {fmt_ms(t6_rows)}, plain (once) {plain_ms:.2f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    require(sum(mism.values()) == 0, f"[{label}] K6 closest differs")
    require(hit_share > 0.05, f"[{label}] K6 hit almost nothing")
    out["bvh2_closest"] = dict(max_abs_err=err, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               variants=dict(rows_of_128=t6_rows), **t6)

    # K6 any hit: every light's shadow rays, t_max = 0 lanes included,
    # traced as shade() traces them (in tiles) and on consecutive rays
    tot = dict(plain_ms=0.0, bytes=0, ops=0, mism=0)
    t6, t6_rows = {}, {}
    for i, (so, sd, stmax) in enumerate(shadow_rays(wd, cam, lights, hk)):
        ok = trace_any_bvh2(wd, so, sd, SHADOW_T_MIN, stmax, height=h,
                            width=w)
        ok_rows = trace_any_bvh2(wd, so, sd, SHADOW_T_MIN, stmax)
        work = {}
        p_ms, op = timed_once(lambda: trace_any_plain(
            wd, so, sd, SHADOW_T_MIN, stmax, stats=work))
        n_mis = int((ok != op).sum()) + int((ok_rows != op).sum())
        dead = float((stmax <= SHADOW_T_MIN).float().mean())
        t = kernel_ms(lambda: trace_any_bvh2(wd, so, sd, SHADOW_T_MIN,
                                             stmax, height=h, width=w))
        t_rows = kernel_ms(lambda: trace_any_bvh2(wd, so, sd, SHADOW_T_MIN,
                                                  stmax))
        moved, ops = trace_work(wd, "nodes2c", (so, sd, stmax), 1, work,
                                OPS_BVH2_NODE)
        log(f"[{label}] K6 any light {i}: occluded "
            f"{float(ok.float().mean()):.4f}, t_max=0 lanes {dead:.4f}, "
            f"mismatches (tiles + rows) {n_mis}, node pops "
            f"{int(work['node_pops'])}, kernel (tiles) {fmt_ms(t)}, on rows "
            f"{fmt_ms(t_rows)}, plain (once) {p_ms:.2f} ms, bound "
            f"{bound(moved, ops)[0]:.4f} ms ({bound(moved, ops)[1]})")
        tot["mism"] += n_mis
        add_ms(t6, t)
        add_ms(t6_rows, t_rows)
        tot["plain_ms"] += p_ms
        tot["bytes"] += moved
        tot["ops"] += ops
    require(tot["mism"] == 0, f"[{label}] K6 any differs from plain")
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    out["bvh2_any"] = dict(max_abs_err=float(tot["mism"]),
                           plain_ms=tot["plain_ms"], bound_ms=b_ms,
                           bound_by=b_by,
                           variants=dict(rows_of_128=t6_rows), **t6)
    return out


def run_frames(r, transforms, label, path, want, **kw):
    """Frames through Renderer.render_dynamic with the launches of every
    frame checked against `want`, and the compact node tables it built
    (one nodes8c per refit frame and no nodes2c, one nodes2c per rebuild
    frame and no nodes8c); returns ms/frame and the counts."""
    import torch

    from tpurt_torch.engine import dynamic
    from tpurt_torch.kernels import build

    counts = build.launch_counts
    build.reset_counts()
    builders = {name: getattr(dynamic, name)
                for name in ("compact_bvh8", "compact_bvh2")}
    tables = {name: 0 for name in builders}

    def counted(name):
        def build_table(nodes):
            tables[name] += 1
            return builders[name](nodes)
        return build_table

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name in builders:
        setattr(dynamic, name, counted(name))
    try:
        for t in transforms:
            before, n_tables = dict(counts), dict(tables)
            out = r.render_dynamic(t, block=False, **kw)
            step = {k: counts[k] - before[k] for k in counts}
            took = "refit" if "refit_sah_ratio" in out else "rebuild"
            built = {k: tables[k] - n_tables[k] for k in tables}
            require(step == want and took == path
                    and built == dict(compact_bvh8=int(path == "refit"),
                                      compact_bvh2=int(path == "rebuild")),
                    f"[{label}] {path} frame launched {step} on the {took} "
                    f"path and built compact tables {built}, want {want}")
        torch.cuda.synchronize()
    finally:
        for name, fn in builders.items():
            setattr(dynamic, name, fn)
    ms = (time.perf_counter() - t0) * 1000.0 / len(transforms)
    total = dict(counts)
    require(total == {k: v * len(transforms) for k, v in want.items()},
            f"[{label}] {path} launches {total}")
    image = out["image"]
    for key in ("color", "depth", "normal"):
        require(bool(torch.isfinite(out[key]).all()),
                f"[{label}] non-finite {key}")
    lit = float((image.amax(dim=-1) > 0).float().mean())
    require(lit > 0.2, f"[{label}] {path} frame is black")
    return dict(ms_per_frame=ms, launches=total, lit_share=lit,
                checksum=int(image.to(torch.int64).sum()))


def phase5(r, label):
    """Refit, rebuild and scrambled frames through render_dynamic."""
    from tpurt_torch.app.bench_scene import (BENCH_SCRAMBLE_EXTENT,
                                             rotation_frames,
                                             scrambled_transforms)
    from tpurt_torch.kernels import build

    shadow = r.stats()["shadow_casting_lights"]
    rays = r.stats()["rays_per_frame"]
    frames = rotation_frames(r.scene.transforms, DYN_FRAMES)
    r.render_dynamic(frames[0])                    # warm-up, both paths
    r.render_dynamic(frames[0], refit=False)
    refit_want = dict(ALL_ZERO, bvh8_closest=1, bvh8_any=shadow,
                      gtao_noise=1, gtao_main=1, gtao_denoise=1,
                      **shade_calls(1))
    rebuild_want = dict(ALL_ZERO, bvh2_closest=1, bvh2_any=shadow,
                        gtao_noise=1, gtao_main=1, gtao_denoise=1,
                        **shade_calls(1))
    out = {}
    for path, want, kw in (("refit", refit_want, {}),
                           ("rebuild", rebuild_want, dict(refit=False))):
        f = run_frames(r, frames, label, path, want, **kw)
        f["mrays_per_s"] = rays / f["ms_per_frame"] / 1e3
        f["last_refit_sah_ratio"] = r.last_refit_sah_ratio
        log(f"[{label}] dynamic {path} frames {DYN_FRAMES}: launches "
            f"{f['launches']}, {f['ms_per_frame']:.3f} ms/frame, "
            f"{f['mrays_per_s']:.2f} Mrays/s, lit share "
            f"{f['lit_share']:.4f}, refit ratio "
            f"{r.last_refit_sah_ratio:.4f}")
        out[path] = f

    # scrambled: every refit frame is a check frame; the ratio passes the
    # trigger, so the frame after each check rebuilds
    sc = scrambled_transforms(r.scene.transforms,
                              extent=BENCH_SCRAMBLE_EXTENT)
    counts = build.launch_counts
    build.reset_counts()
    seq = []
    for _ in range(4):
        before = dict(counts)
        frame = r.render_dynamic(sc, block=False, check_every=1)
        seq.append(("refit" if "refit_sah_ratio" in frame else "rebuild",
                    {k: counts[k] - before[k] for k in counts},
                    r.last_refit_sah_ratio))
    log(f"[{label}] scrambled, check_every=1: "
        + "; ".join(f"{p} ratio {q:.3f} K1 {c['bvh8_closest']} K6 "
                    f"{c['bvh2_closest']}+{c['bvh2_any']}"
                    for p, c, q in seq))
    require([p for p, _, _ in seq] == ["refit", "rebuild"] * 2
            and seq[0][2] > 2.0 and seq[0][1] == refit_want
            and seq[1][1] == rebuild_want and seq[3][1] == rebuild_want,
            f"[{label}] the scrambled sequence did not switch to rebuild")
    out["scrambled_ratio"] = seq[0][2]
    return out


def phase6():
    """64x64 refit and rebuild frames on the card against the host."""
    import torch

    from tpurt_torch.app.bench_scene import rotation_frames

    rs = {dev: build_renderer(64, 64, dev) for dev in ("cuda", "cpu")}
    t = rotation_frames(rs["cpu"].scene.transforms, DYN_FRAMES)[-1]
    for refit in (True, False):
        imgs = [rs[dev].render_dynamic(t, refit=refit)["image"].cpu()
                .to(torch.int32) for dev in ("cuda", "cpu")]
        d = (imgs[0] - imgs[1]).abs().amax(dim=-1)
        eq = float((d == 0).float().mean())
        far = float((d > 2).float().mean())
        path = "refit" if refit else "rebuild"
        log(f"[64x64] dynamic {path}, card vs host plain: equal pixels "
            f"{eq:.4f}, off by > 2 {far:.4f}, max diff {int(d.max())}")
        require(eq >= 0.999 and far <= 1e-3,
                f"64x64 {path} frame on the card disagrees with the host")


def phase7_kernels(r, label):
    """K5, K5p, K7b and K7c against their plain versions (and K5/K5p/K7b/K7c
    against K1/K2) on the frame's real rays, with times and bounds."""
    import torch

    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_any_bvh8_multi,
                                                   trace_any_multi_plain,
                                                   trace_any_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    c = r.config
    w, h = c.width, c.height
    scene = r.scene_device
    cam, lights, _ = frame_inputs(r)
    out = {}
    o, d = camera_rays(cam, w, h)
    hk = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX)
    rays = shadow_rays(scene, cam, lights, hk)
    origin = rays[0][0]
    dirs = torch.stack([sd for _, sd, _ in rays])
    tmaxs = torch.stack([st for _, _, st in rays])
    solo = torch.stack([trace_any_bvh8(scene, so, sd, SHADOW_T_MIN, st)
                        for so, sd, st in rays])
    # the yardstick: K2 once per light on the same rays, in the same tiles
    k2_sets = {}
    for so, sd, st in rays:
        add_ms(k2_sets, kernel_ms(lambda: trace_any_bvh8(
            scene, so, sd, SHADOW_T_MIN, st, height=h, width=w)))

    # K5 / K5p: every light's shadow rays in one launch over nodes8c, in
    # 16x8 pixel tiles (the frame's shape, as shade() traces them) and on
    # consecutive rays, both bit-exact. Both compute the same function, so
    # both are bounded by the lesser work of the one-pop and two-pop visit
    # orders (the two-pop order tests more nodes).
    plain = {}
    for pop2 in (False, True):
        work = {}
        p_ms, op = timed_once(lambda: trace_any_multi_plain(
            scene, origin, dirs, SHADOW_T_MIN, tmaxs, stats=work, pop2=pop2))
        ops = op.numel() * OPS_RAY + int(work["node_tests"]) * OPS_BVH8_NODE \
            + int(work["tri_tests"]) * OPS_TRIANGLE
        plain[pop2] = (p_ms, op, work, ops)
    least_ops = min(v[3] for v in plain.values())
    for name, pop2 in (("bvh8_any_multi", False),
                       ("bvh8_any_multi_pop2", True)):
        ok = trace_any_bvh8_multi(scene, origin, dirs, SHADOW_T_MIN, tmaxs,
                                  pop2=pop2, height=h, width=w)
        rows = trace_any_bvh8_multi(scene, origin, dirs, SHADOW_T_MIN, tmaxs,
                                    pop2=pop2)
        plain_ms, op, work, _ = plain[pop2]
        mism_plain = int((ok != op).sum()) + int((rows != op).sum())
        mism_k2 = int((ok != solo).sum())
        t = kernel_ms(lambda: trace_any_bvh8_multi(
            scene, origin, dirs, SHADOW_T_MIN, tmaxs, pop2=pop2, height=h,
            width=w))
        t_rows = kernel_ms(lambda: trace_any_bvh8_multi(
            scene, origin, dirs, SHADOW_T_MIN, tmaxs, pop2=pop2))
        moved = nbytes(scene["nodes8c"], scene["tris"], origin, dirs,
                       tmaxs) + ok.numel()
        b_ms, b_by = bound(moved, least_ops)
        log(f"[{label}] {name}: {ok.shape[0]} lights x {ok.shape[1]} rays, "
            f"occluded {float(ok.float().mean()):.4f}, mismatches vs plain "
            f"(tiles and rows) {mism_plain}, vs K2 per light {mism_k2}, "
            f"node pops {int(work['node_pops'])} (slab groups "
            f"{int(work['node_tests'])}), triangle tests "
            f"{int(work['tri_tests'])}, max stack {work['max_stack']}, "
            f"kernel (tiles) {fmt_ms(t)}, on rows of 128 {fmt_ms(t_rows)}, "
            f"K2 x {ok.shape[0]} on the same rays (tiles) {fmt_ms(k2_sets)}, "
            f"ratio {t['ms'] / k2_sets['ms']:.3f}, plain (once) "
            f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by})")
        require(mism_plain == 0 and mism_k2 == 0,
                f"[{label}] {name} differs from plain or from K2")
        out[name] = dict(max_abs_err=float(mism_plain), plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         variants=dict(rows_of_128=t_rows,
                                       k2_per_set_tiles=k2_sets), **t)

    # K7b closest: the primary rays, two pops per iteration, over nodes8c
    # in 16x8 pixel tiles (the frame's shape, as the pop2 frame traces
    # them) and on consecutive rays, both bit-exact; bounded, as K5p is, by
    # the lesser work of the two visit orders
    frame = dict(height=h, width=w)
    hp2 = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX, pop2=True, **frame)
    hp2_rows = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX, pop2=True)
    work, work1 = {}, {}
    plain_ms, pp2 = timed_once(lambda: trace_closest_plain(
        scene, o, d, T_MIN, T_MAX, stats=work, pop2=True))
    trace_closest_plain(scene, o, d, T_MIN, T_MAX, stats=work1)
    mism = {f"{k}{tag}": int((x[k].view(torch.int32)
                              != pp2[k].view(torch.int32)).sum())
            for tag, x in (("", hp2), ("_rows", hp2_rows))
            for k in ("t", "tri", "u", "v")}
    t_vs_k1 = int((hp2["t"].view(torch.int32) != hk["t"].view(torch.int32))
                  .sum())
    ties = int((hp2["tri"] != hk["tri"]).sum())
    t = kernel_ms(lambda: trace_closest_bvh8(scene, o, d, T_MIN, T_MAX,
                                             pop2=True, **frame))
    t_rows = kernel_ms(lambda: trace_closest_bvh8(scene, o, d, T_MIN, T_MAX,
                                                  pop2=True))
    primary = (o, d, torch.empty(w * h))
    moved, ops = trace_work(scene, "nodes8c", primary, 16, work,
                            OPS_BVH8_NODE)
    ops = min(ops, trace_work(scene, "nodes8c", primary, 16, work1,
                              OPS_BVH8_NODE)[1])
    b_ms, b_by = bound(moved, ops)
    log(f"[{label}] bvh8_closest_pop2: bit mismatches vs plain (tiles and "
        f"rows) {mism}, t bits differing from K1 {t_vs_k1}, tri differing "
        f"from K1 (equal-t ties) {ties}, node pops {int(work['node_pops'])} "
        f"(one pop: {int(work1['node_pops'])}), max stack "
        f"{work['max_stack']}, kernel (tiles) {fmt_ms(t)}, on rows of 128 "
        f"{fmt_ms(t_rows)}, plain (once) {plain_ms:.2f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    require(sum(mism.values()) == 0 and t_vs_k1 == 0,
            f"[{label}] K7b closest differs from plain or from K1's t")
    out["bvh8_closest_pop2"] = dict(max_abs_err=0.0, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    variants=dict(rows_of_128=t_rows), **t)

    # K7b any: every light's shadow rays, in tiles and on rows
    tot = dict(plain_ms=0.0, bytes=0, ops=0, mism=0)
    t7, t7_rows = {}, {}
    for i, (so, sd, st) in enumerate(rays):
        ok = trace_any_bvh8(scene, so, sd, SHADOW_T_MIN, st, pop2=True,
                            **frame)
        ok_rows = trace_any_bvh8(scene, so, sd, SHADOW_T_MIN, st, pop2=True)
        work, work1 = {}, {}
        p_ms, op = timed_once(lambda: trace_any_plain(
            scene, so, sd, SHADOW_T_MIN, st, stats=work, pop2=True))
        trace_any_plain(scene, so, sd, SHADOW_T_MIN, st, stats=work1)
        n_mis = int((ok != op).sum()) + int((ok_rows != op).sum()) \
            + int((ok != solo[i]).sum())
        add_ms(t7, kernel_ms(lambda: trace_any_bvh8(
            scene, so, sd, SHADOW_T_MIN, st, pop2=True, **frame)))
        add_ms(t7_rows, kernel_ms(lambda: trace_any_bvh8(
            scene, so, sd, SHADOW_T_MIN, st, pop2=True)))
        moved, ops = trace_work(scene, "nodes8c", (so, sd, st), 1, work,
                                OPS_BVH8_NODE)
        ops = min(ops, trace_work(scene, "nodes8c", (so, sd, st), 1, work1,
                                  OPS_BVH8_NODE)[1])
        tot["mism"] += n_mis
        tot["plain_ms"] += p_ms
        tot["bytes"] += moved
        tot["ops"] += ops
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    log(f"[{label}] bvh8_any_pop2, 3 lights: mismatches vs plain (tiles and "
        f"rows) and K2 {tot['mism']}, kernel (tiles) {fmt_ms(t7)}, on rows "
        f"of 128 {fmt_ms(t7_rows)}, plain (once) {tot['plain_ms']:.2f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    require(tot["mism"] == 0, f"[{label}] K7b any differs")
    out["bvh8_any_pop2"] = dict(max_abs_err=0.0, plain_ms=tot["plain_ms"],
                                bound_ms=b_ms, bound_by=b_by,
                                variants=dict(rows_of_128=t7_rows), **t7)

    # K7c: the primary rays with the uv payload, over nodes8c in 16x8 pixel
    # tiles (the frame's shape, as the uvp frame traces them) and on
    # consecutive rays, both bit-exact in all nine outputs; t, tri, u and v
    # equal to K1's; timed beside K1 in tiles on the same rays
    hu = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX, uv_payload=True,
                            **frame)
    hu_rows = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX, uv_payload=True)
    work = {}
    plain_ms, pu = timed_once(lambda: trace_closest_plain(
        scene, o, d, T_MIN, T_MAX, stats=work, uv_payload=True))
    mism = {f"{k}{tag}": int((x[k].view(torch.int32)
                              != pu[k].view(torch.int32)).sum())
            for tag, x in (("", hu), ("_rows", hu_rows)) for k in pu}
    same_hits = all(torch.equal(x[k], hk[k]) for x in (hu, hu_rows)
                    for k in hk)
    t = kernel_ms(lambda: trace_closest_bvh8(scene, o, d, T_MIN, T_MAX,
                                             uv_payload=True, **frame))
    t_rows = kernel_ms(lambda: trace_closest_bvh8(scene, o, d, T_MIN, T_MAX,
                                                  uv_payload=True))
    t_k1 = kernel_ms(lambda: trace_closest_bvh8(scene, o, d, T_MIN, T_MAX,
                                                **frame))
    moved, ops = trace_work(scene, "nodes8c", primary, 36, work,
                            OPS_BVH8_NODE)
    hits = int((hu["tri"] >= 0).sum())
    b_ms, b_by = bound(moved + nbytes(scene["uvp"]), ops + hits * OPS_PAYLOAD)
    log(f"[{label}] bvh8_closest_uvp: bit mismatches vs plain (tiles and "
        f"rows) {mism}, t/tri/u/v equal to K1's {same_hits}, kernel (tiles) "
        f"{fmt_ms(t)}, on rows of 128 {fmt_ms(t_rows)}, K1 on the same rays "
        f"(tiles) {fmt_ms(t_k1)}, ratio {t['ms'] / t_k1['ms']:.3f}, plain "
        f"(once) {plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by})")
    require(sum(mism.values()) == 0 and same_hits,
            f"[{label}] K7c differs from plain or from K1")
    out["bvh8_closest_uvp"] = dict(max_abs_err=0.0, plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   variants=dict(rows_of_128=t_rows,
                                                 k1_tiles=t_k1), **t)
    return out


def phase7_frames(r, label):
    """Frames of each traversal variant: launches checked per frame,
    ms/frame, and the image against the default frame's."""
    import torch

    from tpurt_torch.engine.frame import render_frame_fused
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels import traverse_bvh8 as tb

    c = r.config
    shadow = r.stats()["shadow_casting_lights"]
    rays = r.stats()["rays_per_frame"]
    cam, lights, gtao = frame_inputs(r)
    r._frame_idx = 0
    base = r.render()["image"]

    def rendered(noise):
        r._frame_idx = noise
        return r.render(block=False)

    def fused(noise):
        return render_frame_fused(r.scene_device, cam, lights, gtao, r._lpm,
                                  noise, width=c.width, height=c.height,
                                  gtao_settings=c.gtao)

    ao_launches = dict(gtao_noise=1, gtao_main=1, gtao_denoise=1,
                       **shade_calls(1))
    variants = (
        ("pop2", dict(POP2_DEFAULT=True), rendered,
         dict(bvh8_closest_pop2=1, bvh8_any_pop2=shadow)),
        ("uvp", dict(UVP_DEFAULT=True), rendered,
         dict(bvh8_closest_uvp=1, bvh8_any=shadow)),
        ("fused", {}, fused, dict(bvh8_closest=1, bvh8_any_multi=1)),
        ("fused_pop2", dict(POP2_DEFAULT=True), fused,
         dict(bvh8_closest_pop2=1, bvh8_any_multi_pop2=1)),
    )
    counts = build.launch_counts
    out = {}
    for name, flags, frame, launches in variants:
        want = dict(ALL_ZERO, **ao_launches, **launches)
        try:
            for key, val in flags.items():
                setattr(tb, key, val)
            for i in range(WARMUP_FRAMES):
                frame(i)
            torch.cuda.synchronize()
            build.reset_counts()
            t0 = time.perf_counter()
            for i in range(FRAMES):
                before = dict(counts)
                frame(i % 64)
                step = {k: counts[k] - before[k] for k in counts}
                require(step == want, f"[{label}] {name} frame launched "
                        f"{step}, want {want}")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000.0 / FRAMES
            total = dict(counts)
            img = frame(0)["image"]
            torch.cuda.synchronize()
        finally:
            tb.POP2_DEFAULT = tb.UVP_DEFAULT = False
        diff = (img.int() - base.int()).abs().amax(dim=-1)
        eq = float((diff == 0).float().mean())
        far = float((diff > 2).float().mean())
        log(f"[{label}] {name} frames {FRAMES}: launches {total}, "
            f"{ms:.3f} ms/frame, {rays / ms / 1e3:.2f} Mrays/s, image vs the "
            f"default frame: equal pixels {eq:.6f}, off by > 2 {far:.6f}, "
            f"max diff {int(diff.max())}")
        if name in ("uvp", "fused"):
            require(torch.equal(img, base),
                    f"[{label}] {name} image differs from the default frame")
        else:
            require(eq >= 0.999 and far <= 1e-3,
                    f"[{label}] {name} image outside budget")
        require(bool((img.amax(dim=-1) > 0).float().mean() > 0.2),
                f"[{label}] {name} frame is black")
        out[name] = dict(ms_per_frame=ms, mrays_per_s=rays / ms / 1e3,
                         launches=total, equal_pixels=eq, off_by_gt2=far)
    return out


def phase8_kernels(r, label):
    """K7a (step counts, push orders) and P1 against their plain versions
    on the frame's real rays and tpurt's probe noise, with times and
    bounds; each probe's path launched with the counts at 0."""
    import torch

    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.trans_equiv import trans_equiv, trans_equiv_plain
    from tpurt_torch.kernels.traverse_bvh8 import (PUSH_ORDERS,
                                                   trace_any_plain,
                                                   trace_closest_plain)
    from tpurt_torch.tools import steps_probe, trans_equiv_probe

    scene = r.scene_device
    primary, shadow = steps_probe.frame_rays(r)
    o, d = primary[:2]
    # the frame's (height, width): K7a in 16x8 pixel tiles, as the probe
    # traces the frame's rays
    shape = (r.config.height, r.config.width)
    k1 = steps_probe.trace(scene, primary, False)
    k2 = [steps_probe.trace(scene, rays, True) for rays in shadow]
    out = {}

    # the steps probe's path: one counted frame, K7a closest 1, any 3
    build.reset_counts()
    steps_probe.step_counts(scene, primary, shadow, shape=shape)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    want = dict(ALL_ZERO, bvh8_closest_steps=1, bvh8_any_steps=len(shadow))
    require(launches == want, f"[{label}] steps probe launched {launches}")

    # the probe's report: counts per ray and warp, ms of each order with
    # and without counting (CUDA events)
    report = steps_probe.run(r)
    orders = {}
    for order in PUSH_ORDERS:
        rep = report["push_orders"][order]
        sets = list(rep.values())
        # closest hit: counted kernel (tiles and rows) = plain, t = K1's,
        # tri only on ties
        counted = dict(count_steps=True, push_order=order)
        hk = steps_probe.trace(scene, primary, False, shape, **counted)
        hr = steps_probe.trace(scene, primary, False, **counted)
        work = {}
        plain_ms, hp = timed_once(lambda: trace_closest_plain(
            scene, o, d, *primary[2:], stats=work, count_steps=True,
            push_order=order))
        mism = sum(int((x[k].view(torch.int32) != hp[k].view(torch.int32))
                       .sum()) for x in (hk, hr)
                   for k in ("t", "tri", "u", "v"))
        t_vs_k1 = int((hk["t"].view(torch.int32)
                       != k1["t"].view(torch.int32)).sum())
        differ = hk["tri"] != k1["tri"]
        ties = int(differ.sum())
        not_ties = int((differ & ((hk["tri"] < 0) | (k1["tri"] < 0))).sum())
        sums_ok = int(hk["u"].sum()) == int(work["node_pops"]) \
            and int(hk["v"].sum()) == int(work["leaf_pops"])
        require(mism == 0 and t_vs_k1 == 0 and not_ties == 0 and sums_ok
                and (order != "sort" or ties == 0),
                f"[{label}] K7a closest ({order}): {mism} mismatches, t vs "
                f"K1 {t_vs_k1}, tri {ties} ({not_ties} not ties), sums "
                f"{sums_ok}")
        if order == "sort":
            b_ms, b_by = bound(*trace_work(scene, "nodes8c", (
                o, d, torch.empty(o.shape[0])), 16, work, OPS_BVH8_NODE))
            t_rows = kernel_ms(lambda: steps_probe.trace(scene, primary,
                                                         False, **counted))
            out["bvh8_closest_steps"] = dict(
                max_abs_err=float(mism), ms=sets[0]["ms_counting"],
                cuda_ms=cuda_ms(lambda: steps_probe.trace(
                    scene, primary, False, shape, **counted), 10, warmup=3),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                launches=launches["bvh8_closest_steps"],
                variants=dict(rows_of_128=t_rows))

        # any hit per light: counted kernel (tiles and rows) = plain,
        # occlusion = K2's; the bound adds 8 bytes of counts per ray
        tot = dict(plain_ms=0.0, bytes=0, ops=0)
        rows_ms = {}
        for rays, occ2 in zip(shadow, k2):
            ok, node, leaf = steps_probe.trace(scene, rays, True, shape,
                                               **counted)
            got_rows = steps_probe.trace(scene, rays, True, **counted)
            work = {}
            p_ms, (op, p_node, p_leaf) = timed_once(lambda: trace_any_plain(
                scene, *rays, stats=work, count_steps=True,
                push_order=order))
            n_mis = int((ok != occ2).sum()) + sum(
                int((x != y).sum()) for got in ((ok, node, leaf), got_rows)
                for x, y in zip(got, (op, p_node, p_leaf)))
            sums_ok = int(node.sum()) == int(work["node_pops"]) \
                and int(leaf.sum()) == int(work["leaf_pops"])
            require(n_mis == 0 and sums_ok,
                    f"[{label}] K7a any ({order}): {n_mis} mismatches vs "
                    f"plain and K2, sums {sums_ok}")
            moved, ops = trace_work(scene, "nodes8c", (rays[0], rays[1],
                                                       rays[3]), 1 + 8, work,
                                    OPS_BVH8_NODE)
            if order == "sort":
                add_ms(rows_ms, kernel_ms(lambda: steps_probe.trace(
                    scene, rays, True, **counted)))
            tot["plain_ms"] += p_ms
            tot["bytes"] += moved
            tot["ops"] += ops
        row = dict(closest_ms=sets[0]["ms"],
                   closest_ms_counting=sets[0]["ms_counting"],
                   any_ms=sum(x["ms"] for x in sets[1:]),
                   any_ms_counting=sum(x["ms_counting"] for x in sets[1:]),
                   closest_plain_ms=plain_ms, any_plain_ms=tot["plain_ms"],
                   closest_ties=ties)
        if order == "sort":
            b_ms, b_by = bound(tot["bytes"], tot["ops"])
            out["bvh8_any_steps"] = dict(
                max_abs_err=0.0, ms=row["any_ms_counting"],
                cuda_ms=sum(cuda_ms(lambda: steps_probe.trace(
                    scene, rays, True, shape, **counted), 10, warmup=3)
                    for rays in shadow),
                plain_ms=tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                launches=launches["bvh8_any_steps"],
                variants=dict(rows_of_128=rows_ms))
        log(f"[{label}] K7a {order}: bit-exact vs plain in tiles and on "
            f"rows, t and occlusion equal to K1/K2's, tri ties vs K1 "
            f"{ties}; closest "
            f"{row['closest_ms']:.4f} ms ({row['closest_ms_counting']:.4f} "
            f"counting), any over {len(shadow)} lights {row['any_ms']:.4f} "
            f"ms ({row['any_ms_counting']:.4f} counting); plain (once) "
            f"{plain_ms:.2f} / {tot['plain_ms']:.2f} ms")
        for name, x in rep.items():
            log(f"[{label}]   {name}: node pops {x['node_pops']}, leaf "
                f"pops {x['leaf_pops']}, warp steps {x['warp_steps']} (sum "
                f"{x['warp_steps_sum']}), SIMT efficiency "
                f"{x['simt_efficiency']:.4f} (warps of 32 consecutive rays: "
                f"{x['simt_efficiency_rows']:.4f}), {x['ms']:.4f} ms, "
                f"{x['ns_per_warp_step']:.3f} ns per warp step")
        orders[order] = row
    out["k7a_orders"] = orders

    # P1: the transcendental probe's path, one launch; kernel vs plain
    build.reset_counts()
    probe = trans_equiv_probe.run("cuda")
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    require(launches == dict(ALL_ZERO, trans_equiv=1),
            f"[{label}] transcendental probe launched {launches}")
    tol = probe["tolerance"]
    log(f"[{label}] P1: kernel vs plain {probe['kernel_vs_plain']}, kernel "
        f"vs float64 {probe['kernel_vs_float64']}, plain vs float64 "
        f"{probe['plain_vs_float64']}, tolerance {tol}, arguments equal to "
        f"the host's {probe['arguments_equal_to_host']}")
    require(all(tol[op]["outside"] == 0 for op in ("cos", "sin", "pow"))
            and probe["arguments_equal_to_host"],
            f"[{label}] P1 outside its tolerance")
    planes = trans_equiv_probe.noise_planes().cuda()
    args = (planes, trans_equiv_probe.SDP, trans_equiv_probe.SLICES,
            trans_equiv_probe.STEPS)
    n = planes[0].numel()
    rows = trans_equiv_probe.SLICES * (2 + trans_equiv_probe.STEPS)
    per_slice, per_step = TRANS_EQUIV_OPS
    b_ms, b_by = bound(nbytes(planes) + rows * n * 4, n * trans_equiv_probe
                       .SLICES * (per_slice + trans_equiv_probe.STEPS
                                  * per_step))
    t = kernel_ms(lambda: trans_equiv(*args), 20)
    # the card-only timer's floor: an empty spin kernel timed the same way
    floor_ms = build.device_ms(lambda: torch.cuda._sleep(0), 20)
    log(f"[{label}] P1 {fmt_ms(t)}, the timer's floor (an empty kernel) "
        f"{floor_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    out["trans_equiv"] = dict(
        max_abs_err=max(tol[op]["max_abs_err"] for op in ("cos", "sin",
                                                           "pow")),
        **t, plain_ms=cuda_ms(lambda: trans_equiv_plain(*args), 5),
        bound_ms=b_ms, bound_by=b_by, launches=launches["trans_equiv"],
        timer_floor_ms=floor_ms)
    return out


def frames_ms(r):
    """ms/frame of FRAMES render(block=False) frames ending in one sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        r.render(block=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / FRAMES


def phase8_profile(r, label):
    """Frames in flight and profile_frame: render() and render_stream at
    depth 1 and 3 ms/frame, then profile_frame's passes."""
    import torch

    from tpurt_torch.engine import profiler
    from tpurt_torch.kernels import build

    shadow = r.stats()["shadow_casting_lights"]
    render_ms = frames_ms(r)
    stream = {}
    for depth in (1, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for out in r.render_stream(FRAMES, depth=depth):
            pass
        stream[depth] = (time.perf_counter() - t0) * 1000.0 / FRAMES
        require(bool((out["image"].amax(dim=-1) > 0).float().mean() > 0.2),
                f"[{label}] render_stream frame is black")
    build.reset_counts()
    pf = profiler.profile_frame(r, 3)
    launches = dict(build.launch_counts)
    # one untimed frame and 3 timed ones, each render()'s kernels
    want = dict(ALL_ZERO, bvh8_closest=4, bvh8_any=4 * shadow,
                gtao_noise=4, gtao_main=4, gtao_denoise=4, **shade_calls(4))
    require(launches == want, f"[{label}] profile_frame launched {launches}")
    require(list(pf.ms_per_pass) == ["rays", "trace", "shade+shadows",
                                     "gtao", "tonemap"]
            and all(v > 0 for v in pf.ms_per_pass.values()),
            f"[{label}] profile_frame passes {pf.ms_per_pass}")
    log(f"[{label}] {FRAMES} frames each: render() {render_ms:.3f} "
        f"ms/frame, render_stream depth 1 {stream[1]:.3f}, depth 3 "
        f"{stream[3]:.3f}")
    log(f"[{label}] profile_frame (3 frames): {pf.pretty()}")
    return dict(profile_frame=pf.ms_per_pass, rays_traced=pf.rays_traced,
                render_ms_per_frame=render_ms,
                stream_ms_per_frame={str(k): v for k, v in stream.items()})


def phase8_device(r, label, prof):
    """device_profile (torch.profiler), run after every other phase: its
    kernel time per pass, the device-busy share against profile_frame, and
    render() ms/frame right after it."""
    from tpurt_torch.engine import profiler

    c = r.config
    dp = profiler.device_profile(r)
    require(list(dp.ms_per_pass) == ["trace", "shade", "gtao", "tonemap"]
            and all(v > 0 for v in dp.ms_per_pass.values()),
            f"[{label}] device_profile passes {dp.ms_per_pass}")
    require(prof["rays_traced"] == dp.rays_traced == c.width * c.height
            * (1 + r.lights.get_lights_count()),
            f"[{label}] profiler ray counts")
    busy = dp.ms_total / sum(prof["profile_frame"].values())
    after_ms = frames_ms(r)
    log(f"[{label}] device_profile (8 frames, min of 3): {dp.pretty()}; "
        f"device-busy share {busy:.4f}; render() right after it "
        f"{after_ms:.3f} ms/frame")
    prof.update(device_profile=dp.ms_per_pass, device_busy_share=busy,
                render_ms_after_profiler=after_ms)


APP_SIZE = 800
APP_FRAMES = 10
APP_SPP = 8
APP_REPLAY_FRAMES = 30
LIVE_FRAMES = 12
# K3h, K3 and K4 per app frame (K1 1, K2 one per shadow-casting light)
APP_LAUNCHES = dict(gtao_noise=1, gtao_main=1, gtao_denoise=1,
                    shade_light_rays=1, shade_light_sum=1)


def app_scene_file(tmp):
    """The bench scene's geometry written as a textured .gltf in `tmp`
    (tests/torch_gltf_writer.py: data-URI buffers, PNG textures)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_gltf_writer import CAM_DIR, CAM_POS, write_bench_gltf

    path = os.path.join(tmp, "bench.gltf")
    tris = write_bench_gltf(path)
    return path, tris, CAM_POS, CAM_DIR


def app_renderer(model, cam_pos, cam_dir):
    """The CLI's renderer (offline.main's config and default_scene)."""
    from tpurt_torch.app.offline import default_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    r = Renderer(RendererConfig(width=APP_SIZE, height=APP_SIZE))
    default_scene(r, model)
    r.camera_mut().set_pos(cam_pos)
    r.camera_mut().set_dir(cam_dir)
    r.camera_mut().set_aspect(1.0)
    r.prepare_first_frame()
    return r


def nonzero(counts):
    """The launch counts that are not 0."""
    return {k: v for k, v in counts.items() if v}


class _StampTimer:
    """offline.main's FrameTimer, recording each frame's end."""

    stamps = []

    def __init__(self, print_fn=print):
        pass

    def frame_end(self):
        _StampTimer.stamps.append(time.perf_counter())


def phase12():
    """The app on the card at 800x800 (module docstring)."""
    import json as json_
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from tpurt_torch.app import interactive, live, offline
    from tpurt_torch.kernels import build

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        model, tris, cam_pos, cam_dir = app_scene_file(tmp)
        cam = ["--cam-pos", *map(str, cam_pos), "--cam-dir",
               *map(str, cam_dir)]
        size = ["--width", str(APP_SIZE), "--height", str(APP_SIZE)]
        png = os.path.join(tmp, "frame.png")
        shadow = 2    # default_scene's spot and area lights

        # the CLI's frames, its launches and ms/frame (its own frame loop)
        timer = offline.FrameTimer
        offline.FrameTimer = _StampTimer
        _StampTimer.stamps = []
        try:
            torch.cuda.synchronize()
            build.reset_counts()
            offline.main(["--model", model, *size, *cam, "--frames",
                          str(APP_FRAMES), "--out", png])
            counts = dict(build.launch_counts)
        finally:
            offline.FrameTimer = timer
        st = _StampTimer.stamps
        cli_ms = (st[-1] - st[0]) * 1000.0 / (len(st) - 1)
        want = {k: APP_FRAMES * v for k, v in APP_LAUNCHES.items()}
        want.update(bvh8_closest=APP_FRAMES, bvh8_any=shadow * APP_FRAMES)
        require(counts == dict(ALL_ZERO, **want),
                f"[app] offline.main launched {counts}, want {want}")
        got = np.asarray(Image.open(png))
        r = app_renderer(model, cam_pos, cam_dir)
        for _ in range(APP_FRAMES):
            ref = r.render_image()
        lit = float((got.max(-1) > 0).mean())
        require(got.shape == (APP_SIZE, APP_SIZE, 3)
                and np.array_equal(got, ref),
                "[app] the CLI's PNG differs from Renderer.render_image()")
        require(lit > 0.05, f"[app] the CLI's frame is black ({lit})")
        counted_once(lambda: r.render(), dict(APP_LAUNCHES, bvh8_closest=1,
                                              bvh8_any=shadow),
                     "[app] one app frame")
        log(f"[app] bench glTF {tris} tris; offline.main {APP_FRAMES} "
            f"frames at {APP_SIZE}x{APP_SIZE}: {cli_ms:.3f} ms/frame (its "
            f"frame loop, read-back included), launches {nonzero(counts)}, "
            f"PNG equal to render_image(), lit share {lit:.4f}")
        res.update(tris=tris, cli_ms_per_frame=cli_ms, cli_launches=counts,
                   lit_share=lit)

        # accumulation: stopped at 4 samples and resumed == one run
        ckpt, whole = os.path.join(tmp, "a.npz"), os.path.join(tmp, "w.png")
        acc = ["--model", model, *size, *cam, "--checkpoint-every", "4"]
        offline.main(acc + ["--spp", "4", "--checkpoint", ckpt, "--out",
                            png])
        offline.main(acc + ["--spp", str(APP_SPP), "--checkpoint", ckpt,
                            "--out", png])
        build.reset_counts()
        offline.main(acc + ["--spp", str(APP_SPP), "--out", whole])
        counts = dict(build.launch_counts)
        resumed, once = (np.asarray(Image.open(p)) for p in (png, whole))
        require(int(np.load(ckpt)["num_samples"]) == APP_SPP
                and np.array_equal(resumed, once),
                "[app] resumed accumulation differs from one run")
        require(counts == dict(ALL_ZERO, bvh8_closest=APP_SPP,
                               bvh8_any=shadow * APP_SPP,
                               **shade_calls(APP_SPP)),
                f"[app] accumulation launched {counts}")
        log(f"[app] --spp {APP_SPP} --checkpoint-every 4: resumed after 4 "
            f"equals one run; launches {nonzero(counts)}")

        # the replay loop
        events = os.path.join(tmp, "orbit.jsonl")
        interactive.record_orbit(events, APP_REPLAY_FRAMES)
        r = app_renderer(model, cam_pos, cam_dir)
        pos0, dir0 = r.camera.pos.copy(), r.camera.dir.copy()
        build.reset_counts()
        t0 = time.perf_counter()
        img = interactive.run_replay(r, interactive.load_replay(events),
                                     APP_REPLAY_FRAMES)
        replay_ms = (time.perf_counter() - t0) * 1000.0 / APP_REPLAY_FRAMES
        counts = dict(build.launch_counts)
        lit = float((img.max(-1) > 0).mean())
        require(not np.array_equal(r.camera.pos, pos0)
                and not np.array_equal(r.camera.dir, dir0),
                "[app] the replay did not move the camera")
        require(lit > 0.05, f"[app] the replay's last frame is black ({lit})")
        require(counts["bvh8_closest"] == APP_REPLAY_FRAMES,
                f"[app] replay launched {counts}")
        log(f"[app] run_replay over record_orbit({APP_REPLAY_FRAMES}): "
            f"{replay_ms:.3f} ms/frame (blocking), camera moved, last frame "
            f"lit share {lit:.4f}, launches {nonzero(counts)}")
        res.update(replay_ms_per_frame=replay_ms)

        # the live server
        r = app_renderer(model, cam_pos, cam_dir)
        app = live.LiveApp(r, pipeline_depth=1)
        server = live.serve(app, APP_SIZE, APP_SIZE, port=0,
                            host="127.0.0.1")
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            app.render_once()
            jpg = urllib.request.urlopen(base + "/frame.jpg",
                                         timeout=30).read()
            require(jpg[:2] == b"\xff\xd8", "[app] /frame.jpg is no JPEG")
            pos0 = r.camera.pos.copy()
            req = urllib.request.Request(
                base + "/event", method="POST",
                data=json_.dumps(dict(type="key", name="w",
                                      ms=100.0)).encode())
            require(urllib.request.urlopen(req, timeout=30).status == 200,
                    "[app] POST /event refused")
            app.render_once()
            require(not np.array_equal(r.camera.pos, pos0),
                    "[app] the w event did not move the camera")
        finally:
            app.stop()
            server.shutdown()
            server.server_close()

        # frames in flight: depth 2 (render(block=False)) against the
        # blocking loop, frame for frame before JPEG encoding; frames/s
        loops = {}
        for depth in (1, 2):
            app = live.LiveApp(app_renderer(model, cam_pos, cam_dir),
                               pipeline_depth=depth)
            frames, stamps = [], []
            publish = app.publish

            def record(image, frames=frames, stamps=stamps, publish=publish):
                frames.append(image.copy())
                stamps.append(time.perf_counter())
                publish(image)

            app.publish = record
            torch.cuda.synchronize()
            build.reset_counts()
            t = threading.Thread(target=app.run, daemon=True)
            t.start()
            deadline = time.monotonic() + 120.0
            while len(stamps) < LIVE_FRAMES and time.monotonic() < deadline:
                time.sleep(0.01)
            app.stop()
            t.join(timeout=120.0)
            require(not t.is_alive() and len(frames) >= LIVE_FRAMES,
                    f"[app] live loop at depth {depth} did not finish")
            counts = dict(build.launch_counts)
            n = app.frames_rendered
            require(counts == dict(ALL_ZERO, bvh8_closest=n,
                                   bvh8_any=shadow * n,
                                   **{k: n * v for k, v in
                                      APP_LAUNCHES.items()}),
                    f"[app] live loop launched {counts} for {n} frames")
            # the first two frames warm up
            fps = (LIVE_FRAMES - 3) / (stamps[LIVE_FRAMES - 1] - stamps[2])
            loops[depth] = dict(frames=frames[:LIVE_FRAMES], fps=fps)
        same = all(np.array_equal(a, b) for a, b in
                   zip(loops[1]["frames"], loops[2]["frames"]))
        require(same, "[app] frames in flight differ from blocking frames")
        log(f"[app] live: /frame.jpg JPEG, POST /event w moved the camera; "
            f"{LIVE_FRAMES} frames at depth 2 bit-equal to depth 1; frames/s "
            f"(JPEG encoding included) depth 1 {loops[1]['fps']:.2f}, depth "
            f"2 {loops[2]['fps']:.2f}")
        res.update(live_fps={str(d): v["fps"] for d, v in loops.items()})
    return res


BAND_VARIANTS = ((False, "exact"), (True, "exact"), (False, "half"),
                 (False, "fp16"), (True, "fp16"))
RANK_COUNTS = (2, 4)
SHARDED_FRAMES = 5


def phase13_band(r, label):
    """K3 over the bands of a 4-way split with their halo, as
    compute_ao_band launches them, in every instantiation: against its
    plain version (K3's bar) and bit for bit against the same rows of the
    full-frame K3 (the top band from row 0, the bottom one to the last
    row); the interior band's card-only ms beside the full frame's, with
    its bound (K3's operations scaled by its rows)."""
    import torch

    from tpurt_torch.kernels.gtao_main import (gtao_main, gtao_noise_table,
                                               main_kernel, main_pass_plain)
    from tpurt_torch.passes.gtao import noise_maps_64, prefilter_depths

    c = r.config
    w, h = c.width, c.height
    out = r.render()
    _, _, gtao = r._frame_inputs()
    halo = c.gtao.num_denoise_passes + 1
    quarter = h // 4
    rows = quarter + 2 * halo
    bands = ((0, quarter + halo), (quarter - halo, rows),
             (h - quarter - halo, quarter + halo))
    noise = noise_maps_64(3, r.device)
    worst = dict(step=0, share=0.0)
    for bent, prec in BAND_VARIANTS:
        fp16 = prec == "fp16"
        mips = prefilter_depths(out["depth"], gtao["host"], fp16=fp16)
        args = (mips, out["normal"], gtao["vec16" if fp16 else "vec"], noise)
        kw = dict(slice_count=c.gtao.slice_count,
                  steps_per_slice=c.gtao.steps_per_slice, bent=bent,
                  precision=prec)
        ao, edges = gtao_main(*args, **kw)
        for i, (row_start, n) in enumerate(bands):
            band = dict(row_start=row_start, num_rows=n)
            b_ao, b_ed = gtao_main(*args, **band, **kw)
            idx = slice(row_start, row_start + n)
            require(torch.equal(b_ao, ao[idx]) and torch.equal(b_ed,
                                                               edges[idx]),
                    f"[{label}] K3 band {band} ({bent}, {prec}) differs from "
                    f"the full frame's rows")
            if i == 1:
                continue   # the plain version on the edge bands only
            p_ao, p_ed = main_pass_plain(*args, **band, **kw)
            d = _ao_diff(b_ao, p_ao, bent)
            step, share = int(d.max()), float((d > 0).float().mean())
            require(torch.equal(b_ed, p_ed) and step <= AO_MAX_STEP
                    and share <= AO_MAX_FRACTION,
                    f"[{label}] K3 band {band} ({bent}, {prec}) vs plain: "
                    f"step {step}, share {share}")
            worst = dict(step=max(worst["step"], step),
                         share=max(worst["share"], share))
    mips = prefilter_depths(out["depth"], gtao["host"])
    gvec = gtao["vec"]
    kw = dict(slice_count=c.gtao.slice_count,
              steps_per_slice=c.gtao.steps_per_slice)
    table = gtao_noise_table(noise, gvec, **kw)
    band = dict(row_start=quarter - halo, num_rows=rows)
    t_band = kernel_ms(lambda: main_kernel(mips, out["normal"], gvec, table,
                                           **band, **kw))
    t_full = kernel_ms(lambda: main_kernel(mips, out["normal"], gvec, table,
                                           **kw))
    plain_ms = cuda_ms(lambda: main_pass_plain(mips, out["normal"], gvec,
                                               noise, **band, **kw), 2)
    px_ops = gtao_main_work(kw["slice_count"], kw["steps_per_slice"], False,
                            "exact")[0]
    # the band's share of the pyramid and normals, the table once, the
    # band's AO and edges
    share = rows / h
    b_ms, b_by = bound(share * nbytes(*mips, out["normal"])
                       + nbytes(gvec, table) + 2 * w * rows,
                       px_ops * w * rows)
    log(f"[{label}] K3 band: {len(BAND_VARIANTS)} instantiations x 3 bands "
        f"of up to {rows} rows (halo {halo}) equal the full frame's rows; vs"
        f" plain max step {worst['step']}, share {worst['share']:.6f}; one "
        f"band {fmt_ms(t_band)} beside the full frame's K3 {fmt_ms(t_full)} "
        f"({rows}/{h} of its rows), bound {b_ms:.4f} ms ({b_by}), plain "
        f"{plain_ms:.2f} ms")
    return dict(max_abs_err=float(worst["step"]), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, rows=rows,
                full_frame_ms=t_full["ms"], **t_band)


def _bent(settings):
    import dataclasses

    return dataclasses.replace(settings, bent_normals=True)


def sharded_checks(r, mesh, label):
    """Every output of the mesh's frame against the single-device frame at
    the same noise index, default and with bent normals; one sharded
    frame's launches; ms/frame over SHARDED_FRAMES. Returns the mismatched
    outputs, the launches and the ms."""
    import torch

    from tpurt_torch.kernels import build

    c = r.config
    default = c.gtao
    bad = []
    launches = None
    try:
        for settings in (default, _bent(default)):
            c.gtao = settings
            idx = r._frame_idx
            c.mesh = None
            want = r.render()
            r._frame_idx = idx
            c.mesh = mesh
            torch.cuda.synchronize()
            build.reset_counts()
            got = r.render()
            if launches is None:
                launches = dict(build.launch_counts)
            if sorted(got) != sorted(want):
                bad.append(f"keys {sorted(got)}")
            bad += [f"{label} {k}{' bent' if settings.bent_normals else ''}"
                    for k in want if k in got
                    and not (got[k].shape == want[k].shape
                             and torch.equal(got[k], want[k]))]
        c.gtao = default
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SHARDED_FRAMES):
            r.render(block=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0 / SHARDED_FRAMES
    finally:
        c.gtao, c.mesh = default, None
    return bad, launches, ms


def rank_worker(rank, world, port, results):
    """One gloo rank on cuda:0 (spawned): the sharded frame at each size
    against the single-device frame; reports to `results`."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        from tpurt_torch.dist import make_mesh
        from tpurt_torch.dist.sharding import transport

        mesh = make_mesh()
        for w, h in SHAPES:
            r = build_renderer(w, h, "cuda")
            dist.barrier()
            bad, launches, ms = sharded_checks(r, mesh, f"{w}x{h}")
            results.put(dict(rank=rank, world=world, label=f"{w}x{h}",
                             bad=bad, launches=launches, ms=ms,
                             transport=transport(mesh, r.device)))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(target, world, timeout_s):
    """Run target(rank, world, port, queue) on `world` spawned processes;
    returns what they put on the queue (one item each per call of
    put), failing if a rank fails or the run outlasts timeout_s."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(rank, world, port, results))
             for rank in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = []
    try:
        while any(p.is_alive() for p in procs) or not results.empty():
            try:
                got.append(results.get(timeout=5.0))
            except queue.Empty:
                require(all(p.is_alive() or p.exitcode == 0 for p in procs),
                        f"a rank of {world} failed: exit codes "
                        f"{[p.exitcode for p in procs]}")
                require(time.perf_counter() - t0 < timeout_s,
                        f"{world} ranks timed out")
        for p in procs:
            p.join(timeout=60)
        require(all(p.exitcode == 0 for p in procs),
                f"ranks of {world} exited {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return got


def phase13_ranks(renderers):
    """The band-sharded frame: one NCCL rank in this process, then 2 and 4
    gloo ranks spawned on cuda:0 (NCCL refuses two ranks on one GPU), each
    at both sizes; every output against the single-device frame bit for
    bit, bent normals too; each rank's launches per frame. Returns per
    label and rank count the launches, ms/frame and transport."""
    import torch.distributed as dist

    from tpurt_torch.dist import make_mesh
    from tpurt_torch.dist.sharding import transport

    want_base = dict(ALL_ZERO, bvh8_closest=1, gtao_noise=1, gtao_denoise=1,
                     **shade_calls(1))
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        for label, r in renderers.items():
            bad, launches, ms = sharded_checks(r, mesh, label)
            shadow = r.stats()["shadow_casting_lights"]
            # one rank: its band is the whole image, K3's whole-frame launch
            want = dict(want_base, bvh8_any=shadow, gtao_main=1)
            require(not bad, f"[{label}] 1 NCCL rank differs: {bad}")
            require(launches == want, f"[{label}] 1 NCCL rank launched "
                    f"{launches}, want {want}")
            route = transport(mesh, r.device)
            log(f"[{label}] sharded frame, 1 rank, {route}: {ms:.3f} "
                f"ms/frame, outputs bit-equal to the single-device frame "
                f"(bent normals too), launches {nonzero(launches)}")
            out.setdefault(label, {})["1"] = dict(ms=ms, launches=launches,
                                                  transport=route)
    finally:
        dist.destroy_process_group()

    for world in RANK_COUNTS:
        t0 = time.perf_counter()
        got = spawn_ranks(rank_worker, world, 300)
        require(len(got) == world * len(SHAPES),
                f"{world} ranks reported {len(got)} results")
        for label, r in renderers.items():
            mine = sorted((g for g in got if g["label"] == label),
                          key=lambda g: g["rank"])
            shadow = r.stats()["shadow_casting_lights"]
            want = dict(want_base, bvh8_any=shadow, gtao_main_band=1)
            for g in mine:
                require(not g["bad"], f"[{label}] rank {g['rank']} of "
                        f"{world} differs: {g['bad']}")
                require(g["launches"] == want,
                        f"[{label}] rank {g['rank']} of {world} launched "
                        f"{g['launches']}, want {want}")
                require(g["transport"] == "gloo", f"transport {g}")
            ms = max(g["ms"] for g in mine)
            log(f"[{label}] sharded frame, {world} ranks sharing one H100, "
                f"gloo: {ms:.3f} ms/frame (slowest rank), every rank's "
                f"outputs bit-equal to the single-device frame (bent "
                f"normals too), launches per rank "
                f"{nonzero(mine[0]['launches'])}")
            out[label][str(world)] = dict(ms=ms, launches=mine[0]["launches"],
                                          transport="gloo")
        log(f"{world} gloo ranks: {time.perf_counter() - t0:.1f} s with "
            f"spawning")
    return out


# phase 14: the sharded-geometry frame (dist/geometry.py)
GEO_SHARDS = 4         # the one-stop checks: the frame's band of 4 shards
GEO_RANK_COUNTS = (2, 4)
GEO_TIERS = ("bvh8", "xla")
GEO_FRAMES = 2
# a hit within this barycentric distance of a triangle's edge is a ray
# through the edge, which two BVHs may decide differently (ROADMAP F26)
EDGE_EPS = 1e-5
# the rays of a set two BVHs may decide differently, at most (each is
# checked by brute force)
GRAZE_MAX = 4096


def geo_launches(tier, n, lights, whole):
    """A ring frame's launches per rank: K1 and K5 once per stop ("bvh8"),
    or K6 closest once and any once per light per stop ("xla"); K3h, K3
    (over the band, or the whole frame with one rank) and K4 once."""
    want = dict(ALL_ZERO, gtao_noise=1, gtao_denoise=1, **shade_calls(1))
    want["gtao_main" if whole else "gtao_main_band"] = 1
    if tier == "bvh8":
        return dict(want, bvh8_closest=n, bvh8_any_multi=n)
    return dict(want, bvh2_closest=n, bvh2_any=lights * n)


def through_edges(tris, o, d, t_min, t_max, found=None):
    """Per ray, by brute force over every triangle (the plain versions'
    Moller-Trumbore, so the same distances): whether the tracers may
    disagree on it because box culling lost a hit through a triangle's
    edge (ROADMAP F26), the only hit a box test can lose. With `found`, a
    list of (t, tri) per tracer: each tracer's (t, tri) is T_MAX or a
    brute-force hit of that triangle at that distance, and every
    brute-force hit nearer than it lies within EDGE_EPS of its triangle's
    edge. Without, occlusion: the ray hits something in (t_min, t_max) and
    every such hit lies so."""
    import torch

    from tpurt_torch.kernels.traverse_bvh8 import _moller_trumbore
    from tpurt_torch.passes.rays import T_MAX

    ids = tris[:, 9].to(torch.int32)
    out = []
    for a in range(0, o.shape[0], 32):
        b = min(a + 32, o.shape[0])
        rows = tris[None].expand(b - a, -1, -1)
        hit, t, u, v = _moller_trumbore(rows, o[a:b], d[a:b], t_min,
                                        t_max[a:b])
        edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v) <= EDGE_EPS
        if found is None:
            out.append(hit.any(1) & ~(hit & ~edge).any(1))
            continue
        ok = torch.ones(b - a, dtype=torch.bool, device=o.device)
        for tx, trix in found:
            tx, trix = tx[a:b, None], trix[a:b, None]
            real = (hit & (t == tx) & (ids[None] == trix)).any(1)
            lost = (hit & (t < tx) & ~edge).any(1)
            ok &= (real | (tx[:, 0] == T_MAX)) & ~lost
        out.append(ok)
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=o.device)


def geo_traces(r, mesh, tier, shard, row0, band, label, problems):
    """The ring's traces of this rank's band against the single-device K1
    and K2 on the same rays: t and tri bit for bit, outside equal-t ties
    and hits lost through a triangle's edge, and occlusion outside rays
    that hit only through edges (each differing ray confirmed by brute
    force, through_edges, at most GRAZE_MAX of a set); a failed check is
    appended to `problems` (ranks must reach every collective). Returns
    the band's pixel masks: ties, t off and occlusion off."""
    import torch

    from tpurt_torch.dist.geometry import ring_any, ring_closest, \
        shard_tracers
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_closest_bvh8)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    c = r.config
    w, h = c.width, c.height
    cam, lights, _ = r._frame_inputs()
    o, d = camera_rays(cam, w, h, row0, band)
    closest, any_hit = shard_tracers(shard, tier, band, w)
    got = ring_closest(closest, o, d, mesh)
    want = trace_closest_bvh8(r.scene_device, o, d, T_MIN, T_MAX,
                              height=band, width=w)
    t_off = got["t"] != want["t"]
    ties = ~t_off & (got["tri"] != want["tri"])
    tris = r.scene_device["tris"]
    n = o.shape[0]
    lanes = (t_off | ties).nonzero()[:, 0]
    if not (lanes.numel() <= GRAZE_MAX and bool(through_edges(
            tris, o[lanes], d[lanes], T_MIN, torch.full_like(
                got["t"][lanes], T_MAX),
            [(x["t"][lanes], x["tri"][lanes]) for x in (got, want)]).all())):
        problems.append(f"[{label}] {tier}: {lanes.numel()} rays' hits "
                        f"differ, not all an equal-t tie or a hit lost "
                        f"through an edge")
    rays = shadow_rays(r.scene_device, cam, lights, want, d, height=band,
                       image_rows=h)
    so = rays[0][0]
    occ = ring_any(any_hit, so, torch.stack([x[1] for x in rays]),
                   SHADOW_T_MIN, torch.stack([x[2] for x in rays]), mesh)
    occ_off = torch.zeros(n, dtype=torch.bool, device=o.device)
    for i, (_, sd, tm) in enumerate(rays):
        off = occ[i] != trace_any_bvh8(r.scene_device, so, sd, SHADOW_T_MIN,
                                       tm, height=band, width=w)
        lanes = off.nonzero()[:, 0]
        if not (lanes.numel() <= GRAZE_MAX and bool(through_edges(
                tris, so[lanes], sd[lanes], SHADOW_T_MIN,
                tm[lanes]).all())):
            problems.append(f"[{label}] {tier}: light {i}'s occlusion "
                            f"differs on {lanes.numel()} rays, not all "
                            f"through an edge")
        occ_off |= off
    return dict(ties=ties, t_off=t_off, occ_off=occ_off)


def frame_agrees(got, want, masks, label, problems):
    """The ring frame against the single-device one (whole frames, masks
    (H*W,) per pixel): depth and normals differ only where tri or t does,
    color also where an occlusion does, AO bit-equal when no geometry
    differs and else on at most AO_MAX_FRACTION of pixels, the image only
    where color or AO do (a failure is appended to `problems`). Returns
    the counts of differing pixels and rays, and AO's largest step."""
    import torch

    h, w = want["depth"].shape
    geom = (masks["ties"] | masks["t_off"]).reshape(h, w)
    shade = geom | masks["occ_off"].reshape(h, w)

    def off(k):
        return (got[k] != want[k]).reshape(h, w, -1).any(-1)

    counts = {k: int(off(k).sum()) for k in want}
    ao = off("ao")
    ok = not (off("depth") & ~geom).any() and not (off("normal")
                                                   & ~geom).any()
    ok &= not (off("color") & ~shade).any()
    ok &= not (off("image") & ~(shade | ao)).any()
    step = int((got["ao"].to(torch.int32) - want["ao"].to(torch.int32))
               .abs().max())
    ok &= (not ao.any()) if not geom.any() else (
        float(ao.float().mean()) <= AO_MAX_FRACTION)
    counts.update({k: int(v.sum()) for k, v in masks.items()},
                  ao_max_step=step)
    if not (ok and sorted(got) == sorted(want)):
        problems.append(f"[{label}] the ring frame differs beyond its rays "
                        f"through an edge and its ties: {counts}")
    return counts


def geo_rank_frames(r, mesh, label, problems):
    """This rank's ring frames of `r`'s scene in both tiers: traces
    (geo_traces), one frame's launches, every output all-gathered against
    the single-device frame (frame_agrees), ring_gather against direct
    indexing, ms/frame over GEO_FRAMES frames after the checked one (host
    wall, gathered outputs) and the ring_shift calls' summed CUDA-event
    ms per frame.
    Failed checks go to `problems`. Returns a dict per tier."""
    import torch

    from tpurt_torch.dist import (freeze_meta, gather_frame, rank_tensors,
                                  render_frame_sharded_geometry,
                                  shard_geometry, shard_tables)
    from tpurt_torch.dist import geometry
    from tpurt_torch.dist.sharding import all_gather_rows, ring_shift
    from tpurt_torch.kernels import build

    c = r.config
    n, rank = mesh.size(), mesh.get_local_rank()
    band = c.height // n
    row0 = rank * band
    want = r.render_passes(0)
    pt = r.scene.as_pytree()
    cam, lights, gtao = r._frame_inputs()
    out = {}
    for tier in GEO_TIERS:
        t0 = time.perf_counter()
        shards = shard_geometry(pt, n, tier)
        tbl, meta = shard_tables(pt, n) if tier == "bvh8" else (None, None)
        sc, shard, chunks = rank_tensors(pt, shards, tbl, rank, r.device)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        def frame():
            return render_frame_sharded_geometry(
                sc, shard, cam, lights, gtao, r._lpm, 0, width=c.width,
                height=c.height, gtao_settings=c.gtao, mesh=mesh,
                tables=tier, shade_tables=chunks,
                meta=None if meta is None else freeze_meta(meta))

        masks = geo_traces(r, mesh, tier, shard, row0, band, label,
                           problems)
        masks = {k: all_gather_rows(v.to(torch.uint8), mesh).bool()
                 for k, v in masks.items()}
        torch.cuda.synchronize()
        build.reset_counts()
        got = frame()
        torch.cuda.synchronize()
        launches = dict(build.launch_counts)
        want_l = geo_launches(tier, n, r.stats()["lights"], n == 1)
        who = f"{label} {tier} rank {rank} of {n}"
        if launches != want_l:
            problems.append(f"[{who}] launched {nonzero(launches)}, want "
                            f"{nonzero(want_l)}")
        counts = frame_agrees(gather_frame(got, mesh), want, masks, who,
                              problems)
        if tier == "bvh8":
            # ring_gather over this mesh against direct indexing
            full = torch.from_numpy(pt["tri_attr"]).to(r.device)
            idx = torch.randint(0, full.shape[0], (4096,),
                                generator=torch.Generator().manual_seed(0)
                                ).to(r.device)
            if not torch.equal(geometry.ring_gather(
                    chunks["tri_attr"], meta["attr_chunk"], idx, mesh),
                    full[idx]):
                problems.append(f"[{who}] ring_gather differs from direct "
                                f"indexing")
        spans = []

        def timed_shift(tree, m):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            res = ring_shift(tree, m)
            e.record()
            spans.append((s, e))
            return res

        torch.cuda.synchronize()
        geometry.ring_shift = timed_shift
        try:
            t0 = time.perf_counter()
            for _ in range(GEO_FRAMES):
                gather_frame(frame(), mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000.0 / GEO_FRAMES
        finally:
            geometry.ring_shift = ring_shift
        shift_ms = sum(s.elapsed_time(e) for s, e in spans) / GEO_FRAMES
        out[tier] = dict(launches=nonzero(launches), counts=counts, ms=ms,
                         ring_shift_ms=shift_ms, setup_s=setup_s)
    return out


def phase14_stops(r, label):
    """One stop of each ring on the card, at the main path's shapes (the
    band of rank 1 of GEO_SHARDS, its second stop, shard 1), against its
    plain version bit for bit: K1 with the first stop's t as t_max, K5
    with the lanes the first stop occluded parked at t_max = 0, the "xla"
    tier's K6 closest and any hit the same way over the shard's binary
    tree (leaves of MAX_LEAF), and ring_gather's stop (serve_rows) on the
    band's attribute and texel row indices against direct indexing, on the
    chunk that owns most of them. Times beside their bounds."""
    import torch

    from tpurt_torch.dist import rank_tensors, shard_geometry, shard_tables
    from tpurt_torch.dist.geometry import MAX_LEAF, serve_rows
    from tpurt_torch.kernels.traverse_bvh2 import (trace_any_bvh2,
                                                   trace_closest_bvh2)
    from tpurt_torch.kernels.traverse_bvh2 import \
        trace_any_plain as bvh2_any_plain
    from tpurt_torch.kernels.traverse_bvh2 import \
        trace_closest_plain as bvh2_closest_plain
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8_multi,
                                                   trace_any_multi_plain,
                                                   trace_closest_bvh8,
                                                   trace_closest_plain)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays, surface

    c = r.config
    w, h = c.width, c.height
    dev = r.device
    band = h // GEO_SHARDS
    pt = r.scene.as_pytree()
    shards = shard_geometry(pt, GEO_SHARDS, "bvh8")
    tbl, meta = shard_tables(pt, GEO_SHARDS)
    s0 = rank_tensors(pt, shards, None, 0, dev)[1]
    s1 = rank_tensors(pt, shards, None, 1, dev)[1]
    cam, lights, _ = r._frame_inputs()
    o, d = camera_rays(cam, w, h, band, band)
    kw = dict(height=band, width=w)
    out = {}

    # K1 at the second stop: the carried t as t_max
    carried = trace_closest_bvh8(s0, o, d, T_MIN, T_MAX, pop2=False,
                                 uv_payload=False, **kw)["t"]

    def k1():
        return trace_closest_bvh8(s1, o, d, T_MIN, carried, pop2=False,
                                  uv_payload=False, **kw)

    work = {}
    plain = trace_closest_plain(s1, o, d, T_MIN, carried, stats=work)
    got = k1()
    mism = sum(int((got[k] != plain[k]).sum()) for k in plain)
    require(mism == 0, f"[{label}] K1 with a carried t_max vs plain: {mism}")
    b_ms, b_by = bound(*trace_work(s1, "nodes8c", (o, d, carried), 16, work,
                                   OPS_BVH8_NODE))
    out["k1"] = dict(kernel_ms(k1), plain_ms=cuda_ms(
        lambda: trace_closest_plain(s1, o, d, T_MIN, carried), 2),
        bound_ms=b_ms, bound_by=b_by, rays=o.shape[0],
        improved=int((got["t"] < carried).sum()))

    # K5 at the second stop: the first stop's occluded lanes parked
    hits = trace_closest_bvh8(r.scene_device, o, d, T_MIN, T_MAX, **kw)
    rays = shadow_rays(r.scene_device, cam, lights, hits, d, height=band,
                       image_rows=h)
    so = rays[0][0]
    dirs = torch.stack([x[1] for x in rays])
    tmaxs = torch.stack([x[2] for x in rays])
    occ0 = trace_any_bvh8_multi(s0, so, dirs, SHADOW_T_MIN, tmaxs,
                                pop2=False, **kw)
    live = torch.where(occ0, 0.0, tmaxs)

    def k5():
        return trace_any_bvh8_multi(s1, so, dirs, SHADOW_T_MIN, live,
                                    pop2=False, **kw)

    work = {}
    plain = trace_any_multi_plain(s1, so, dirs, SHADOW_T_MIN, live,
                                  stats=work)
    got = k5()
    mism = int((got != plain).sum())
    require(mism == 0, f"[{label}] K5 with parked lanes vs plain: {mism}")
    ops = plain.numel() * OPS_RAY + int(work["node_tests"]) \
        * OPS_BVH8_NODE + int(work["tri_tests"]) * OPS_TRIANGLE
    b_ms, b_by = bound(nbytes(s1["nodes8c"], s1["tris"], so, dirs, live)
                       + got.numel(), ops)
    out["k5"] = dict(kernel_ms(k5), plain_ms=cuda_ms(
        lambda: trace_any_multi_plain(s1, so, dirs, SHADOW_T_MIN, live), 2),
        bound_ms=b_ms, bound_by=b_by, sets=int(dirs.shape[0]),
        parked=int(occ0.sum()))

    # the "xla" tier's K6 at the second stop: the carried t as t_max, and
    # each light's shadow rays with the first stop's occluded lanes parked
    xla = shard_geometry(pt, GEO_SHARDS, "xla")
    x0 = rank_tensors(pt, xla, None, 0, dev)[1]
    x1 = rank_tensors(pt, xla, None, 1, dev)[1]
    kw6 = dict(kw, max_leaf=MAX_LEAF)
    carried6 = trace_closest_bvh2(x0, o, d, T_MIN, T_MAX, **kw6)["t"]

    def k6():
        return trace_closest_bvh2(x1, o, d, T_MIN, carried6, **kw6)

    work = {}
    plain = bvh2_closest_plain(x1, o, d, T_MIN, carried6,
                               max_leaf=MAX_LEAF, stats=work)
    got = k6()
    mism = sum(int((got[k].view(torch.int32)
                    != plain[k].view(torch.int32)).sum()) for k in plain)
    require(mism == 0, f"[{label}] K6 closest (max_leaf {MAX_LEAF}) with a "
            f"carried t_max vs plain: {mism} bits")
    b_ms, b_by = bound(*trace_work(x1, "nodes2c", (o, d, carried6), 16,
                                   work, OPS_BVH2_NODE))
    out["k6_closest"] = dict(kernel_ms(k6), plain_ms=cuda_ms(
        lambda: bvh2_closest_plain(x1, o, d, T_MIN, carried6,
                                   max_leaf=MAX_LEAF), 2),
        bound_ms=b_ms, bound_by=b_by, rays=o.shape[0],
        improved=int((got["t"] < carried6).sum()))
    any6 = dict(plain_ms=0.0, moved=0, ops=0, parked=0)
    t6 = {}
    for sd, tm in zip(dirs, tmaxs):
        occ6 = trace_any_bvh2(x0, so, sd, SHADOW_T_MIN, tm, **kw6)
        live6 = torch.where(occ6, 0.0, tm)

        def k6a(sd=sd, live6=live6):
            return trace_any_bvh2(x1, so, sd, SHADOW_T_MIN, live6, **kw6)

        work = {}
        plain = bvh2_any_plain(x1, so, sd, SHADOW_T_MIN, live6,
                               max_leaf=MAX_LEAF, stats=work)
        mism = int((k6a() != plain).sum())
        require(mism == 0, f"[{label}] K6 any (max_leaf {MAX_LEAF}) with "
                f"parked lanes vs plain: {mism}")
        add_ms(t6, kernel_ms(k6a))
        any6["plain_ms"] += cuda_ms(lambda: bvh2_any_plain(
            x1, so, sd, SHADOW_T_MIN, live6, max_leaf=MAX_LEAF), 2)
        moved, ops = trace_work(x1, "nodes2c", (so, sd, live6), 1, work,
                                OPS_BVH2_NODE)
        any6["moved"] += moved
        any6["ops"] += ops
        any6["parked"] += int(occ6.sum())
    b_ms, b_by = bound(any6["moved"], any6["ops"])
    out["k6_any"] = dict(t6, plain_ms=any6["plain_ms"], bound_ms=b_ms,
                         bound_by=b_by, sets=int(dirs.shape[0]),
                         parked=any6["parked"])

    # ring_gather's stop on the chunk that owns most of the hit
    # triangles' attribute rows, and of the texel rows their quad fetch
    # reads
    idx = torch.clamp_min(hits["tri"], 0)
    slab = torch.from_numpy(pt["tex_quad48"].reshape(
        -1, pt["tex_quad48"].shape[-1])).to(dev)
    flats = []

    def record(flat):
        flats.append(flat)
        return slab[flat]

    full_attr = torch.from_numpy(pt["tri_attr"]).to(dev)
    surface(dict(tri_attr=full_attr), cam, hits, d, rows=h,
            quad_gather=record, quad_shape=meta["quad_shape"])
    gathered = {}
    for key, table, chunk, ix in (
            ("tri_attr", full_attr, meta["attr_chunk"], idx),
            ("quad_rows", slab, meta["quad_chunk"], flats[0])):
        owner = int(torch.bincount(ix // chunk).argmax())
        mine = torch.from_numpy(tbl[key][owner]).to(dev)
        stop = serve_rows(mine, chunk, owner, ix,
                          table.new_zeros((ix.shape[0],) + table.shape[1:]))
        own = (ix >= owner * chunk) & (ix < (owner + 1) * chunk)
        direct = torch.where(own[:, None], table[ix], torch.zeros_like(
            table[ix]))
        require(torch.equal(stop, direct), f"[{label}] ring_gather's stop "
                f"on {key} differs from direct indexing")
        gathered[key] = dict(rows=int(ix.shape[0]), chunk=owner,
                             owned=int(own.sum()), ms=cuda_ms(
                                 lambda: serve_rows(mine, chunk, owner, ix,
                                                    torch.zeros_like(stop)),
                                 10))
    out["ring_gather_stop"] = gathered
    log(f"[{label}] geometry stops (band {band} rows, shard 1 of "
        f"{GEO_SHARDS}): K1 with a carried t_max bit-equal to plain, "
        f"{out['k1']['improved']} of {o.shape[0]} rays closer, "
        f"{fmt_ms(out['k1'])} (bound {out['k1']['bound_ms']:.4f} ms, "
        f"{out['k1']['bound_by']}; plain {out['k1']['plain_ms']:.2f}); K5 "
        f"{dirs.shape[0]} sets with {out['k5']['parked']} lanes parked "
        f"bit-equal to plain, {fmt_ms(out['k5'])} (bound "
        f"{out['k5']['bound_ms']:.4f} ms, {out['k5']['bound_by']}; plain "
        f"{out['k5']['plain_ms']:.2f}); K6 closest (max_leaf {MAX_LEAF}) "
        f"with a carried t_max bit-equal to plain, "
        f"{out['k6_closest']['improved']} rays closer, "
        f"{fmt_ms(out['k6_closest'])} (bound "
        f"{out['k6_closest']['bound_ms']:.4f} ms, "
        f"{out['k6_closest']['bound_by']}; plain "
        f"{out['k6_closest']['plain_ms']:.2f}); K6 any over "
        f"{out['k6_any']['sets']} lights with {out['k6_any']['parked']} "
        f"lanes parked bit-equal to plain, {fmt_ms(out['k6_any'])} summed "
        f"(bound {out['k6_any']['bound_ms']:.4f} ms, "
        f"{out['k6_any']['bound_by']}; plain "
        f"{out['k6_any']['plain_ms']:.2f}); ring_gather's stop equal to "
        f"direct indexing: {gathered}")
    return out


def geo_rank_worker(rank, world, port, results):
    """One gloo rank on cuda:0 (spawned): the ring frames at each size
    (geo_rank_frames); reports to `results`."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        from tpurt_torch.dist import make_mesh

        mesh = make_mesh()
        for w, h in SHAPES:
            r = build_renderer(w, h, "cuda")
            dist.barrier()
            problems = []
            frames = geo_rank_frames(r, mesh, f"{w}x{h}", problems)
            results.put(dict(rank=rank, world=world, label=f"{w}x{h}",
                             frames=frames, problems=problems))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def geo_textures_worker(rank, world, port, results):
    """One gloo rank on cuda:0 (spawned) of the textures workload's
    "bvh8" ring frame at 800x800: its hbm_accounting beside its own
    torch.cuda.memory_allocated() after setup; rank 0 reports the
    gathered image."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        from tpurt_torch.dist import (freeze_meta, gather_frame,
                                      hbm_accounting, make_mesh,
                                      rank_tensors,
                                      render_frame_sharded_geometry,
                                      shard_geometry, shard_tables)
        from tpurt_torch.engine import convert
        from tpurt_torch.kernels import build
        from tpurt_torch.passes.gtao import gtao_constants

        mesh = make_mesh()
        w, h = SHAPES[0]
        t0 = time.perf_counter()
        # the host tables only: a CPU renderer flattens without the arena
        host = textured_renderer(w, h, "cpu", None, 1)
        pt = host.scene.as_pytree()
        shards = shard_geometry(pt, world, "bvh8")
        tbl, meta = shard_tables(pt, world)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        sc, shard, chunks = rank_tensors(pt, shards, tbl, rank, "cuda")
        c = host.config
        cam = convert.camera_tensors(host.camera.uniform(), "cuda")
        lights = convert.light_tensors(host.lights.shader_arrays(), "cuda")
        gtao = convert.gtao_tensors(gtao_constants(
            w, h, host.camera.znear, host.camera.zfar, host.camera.fovy,
            host.camera.aspect), "cuda")
        lpm = {k: v.to("cuda") for k, v in host._lpm.items()}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        setup_s = time.perf_counter() - t0
        acct = hbm_accounting(pt, shards, tbl, world, rank=rank)
        dist.barrier()
        build.reset_counts()
        t0 = time.perf_counter()
        band = render_frame_sharded_geometry(
            sc, shard, cam, lights, gtao, lpm, 0, width=w, height=h,
            gtao_settings=c.gtao, mesh=mesh, tables="bvh8",
            shade_tables=chunks, meta=freeze_meta(meta))
        launches = dict(build.launch_counts)
        full = gather_frame(band, mesh)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1000.0
        want = dict(geo_launches("bvh8", world, host.stats()["lights"],
                                 False), mip_texel_rows=1, mip_texels=1)
        results.put(dict(rank=rank, held=held, acct=acct, setup_s=setup_s,
                         frame_ms=frame_ms, launches=nonzero(launches),
                         want_launches=nonzero(want),
                         image=full["image"].cpu().numpy() if rank == 0
                         else None))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase14_textures(tex_r):
    """The textures workload's "bvh8" ring frame over 4 gloo ranks on the
    card (geo_textures_worker): each rank's accounted bytes beside its
    memory_allocated() after setup and beside the replicated renderer's
    tensors; the gathered image against the single-device frame at phase
    3's bars."""
    import torch

    world = GEO_RANK_COUNTS[-1]
    want = tex_r.render_passes(0)["image"]
    replicated = sum(t.numel() * t.element_size()
                     for t in tex_r.scene_device.values()
                     if isinstance(t, torch.Tensor))
    got = sorted(spawn_ranks(geo_textures_worker, world, 600),
                 key=lambda g: g["rank"])
    require(len(got) == world, f"[textures] {len(got)} ranks reported")
    for g in got:
        require(g["launches"] == g["want_launches"],
                f"[textures] ring frame rank {g['rank']} launched "
                f"{g['launches']}, want {g['want_launches']}")
    d = (torch.from_numpy(got[0]["image"]).to(torch.int32)
         - want.cpu().to(torch.int32)).abs().amax(dim=-1)
    agree = dict(equal=float((d == 0).float().mean()),
                 off_by_more_than_2=float((d > 2).float().mean()),
                 max_diff=int(d.max()))
    log(f"[geometry] textures ring frame ({world} ranks) against the "
        f"single-device frame: {agree}")
    require(agree["equal"] >= 0.999 and agree["off_by_more_than_2"] <= 1e-3,
            "[geometry] the textures ring frame disagrees with the "
            "single-device frame")
    ranks = [dict(rank=g["rank"], allocated=g["held"],
                  accounted=g["acct"]["sharded_total"],
                  per_chip=g["acct"]["sharded_per_chip"],
                  setup_s=g["setup_s"], frame_ms=g["frame_ms"])
             for g in got]
    acct = got[0]["acct"]
    log(f"[geometry] textures workload over {world} gloo ranks on one "
        f"H100: per rank allocated after setup "
        f"{[x['allocated'] for x in ranks]} bytes, accounted "
        f"{[x['accounted'] for x in ranks]}; replicated: accounted "
        f"{acct['replicated_total']} bytes, the replicated renderer's "
        f"scene tensors {replicated}; ceiling ratio "
        f"{acct['ceiling_ratio']:.3f}; first frame (slowest rank) "
        f"{max(x['frame_ms'] for x in ranks):.1f} ms")
    return dict(ranks=ranks, replicated_accounted=acct["replicated_total"],
                replicated_renderer_bytes=replicated,
                replicated_bytes=acct["replicated_bytes"],
                ceiling_ratio=acct["ceiling_ratio"], image=agree)


def phase14(renderers, tex_r):
    """The sharded-geometry frame: the one-stop checks at each size, one
    NCCL rank in this process (both tiers, both sizes), 2 and 4 gloo ranks
    spawned on cuda:0 (each rank both sizes and tiers), and the textures
    workload over 4 ranks."""
    import torch.distributed as dist

    from tpurt_torch.dist import make_mesh

    t_start = time.perf_counter()
    out = dict(stops={}, ranks={})
    for label, r in renderers.items():
        out["stops"][label] = phase14_stops(r, label)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        for label, r in renderers.items():
            problems = []
            res = geo_rank_frames(r, mesh, label, problems)
            require(not problems, f"1 NCCL rank: {problems}")
            out["ranks"].setdefault(label, {})["1"] = res
            for tier, x in res.items():
                log(f"[{label}] ring frame {tier}, 1 NCCL rank: "
                    f"{x['ms']:.3f} ms/frame, launches {x['launches']}, "
                    f"differing pixels and rays {x['counts']}")
    finally:
        dist.destroy_process_group()
    for world in GEO_RANK_COUNTS:
        t0 = time.perf_counter()
        got = spawn_ranks(geo_rank_worker, world, 400)
        problems = [p for g in got for p in g["problems"]]
        require(not problems and len(got) == world * len(SHAPES),
                f"{world} gloo ranks: {problems or len(got)}")
        for label in renderers:
            mine = sorted((g for g in got if g["label"] == label),
                          key=lambda g: g["rank"])
            mine_out = out["ranks"][label][str(world)] = {}
            for tier in GEO_TIERS:
                per = [g["frames"][tier] for g in mine]
                ms = max(x["ms"] for x in per)
                shift = max(x["ring_shift_ms"] for x in per)
                mine_out[tier] = dict(ms=ms, ring_shift_ms=shift,
                                      launches=per[0]["launches"],
                                      counts=per[0]["counts"])
                log(f"[{label}] ring frame {tier}, {world} gloo ranks "
                    f"sharing one H100 (no multi-GPU number): {ms:.3f} "
                    f"ms/frame (slowest rank), ring_shift {shift:.3f} "
                    f"ms/frame (CUDA events, slowest rank), launches per "
                    f"rank {per[0]['launches']}, differing pixels and rays"
                    f" {per[0]['counts']}")
        log(f"{world} gloo ranks (geometry): {time.perf_counter() - t0:.1f}"
            f" s with spawning")
    out["textures"] = phase14_textures(tex_r)
    seconds = time.perf_counter() - t_start
    out["seconds"] = seconds
    log(f"phase 14 (sharded geometry): {seconds:.1f} s")
    return out


def card_line():
    """The card's `name, power.limit` as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else "nvidia-smi: no output")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "tpurt_torch")):
        print("chip_smoke: tpurt_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpurt_torch.kernels import build

    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.get_lib()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({build.library_path().name})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())
    from tpurt_torch.tools.kernel_ab import ptxas_report

    report = ptxas_report(build.build_log)
    log("ptxas K1, K7c and K4: " + json.dumps(
        [k for k in report if "bvh8_closest_kernel" in k["kernel"]
         or "gtao_denoise_kernel" in k["kernel"]]))
    log("ptxas K6: " + json.dumps(
        [k for k in report if "bvh2_trace_kernel" in k["kernel"]]))
    log("ptxas K5: " + json.dumps(
        [k for k in report if "bvh8_any_multi_kernel" in k["kernel"]]))
    log("ptxas K7a and K7b: " + json.dumps(
        [k for k in report if "_variant_kernel" in k["kernel"]
         and "bvh8" in k["kernel"]]))
    # K3h and K3 in each instantiation (template <slices, steps, bent,
    # half, lp>); K4's (<bent, lp, final>) are on the K1 and K4 line
    log("ptxas K3h and K3: " + json.dumps(
        [k for k in report if "gtao_main_kernel" in k["kernel"]
         or "gtao_noise_kernel" in k["kernel"]]))

    results, renderers, k9_renderers = {}, {}, {}
    try:
        for w, h in SHAPES:
            label = f"{w}x{h}"
            t0 = time.perf_counter()
            r = build_renderer(w, h, "cuda")
            log(f"[{label}] scene ready in {time.perf_counter() - t0:.1f} s:"
                f" {r.stats()}")
            k = phase1(r, label)
            f = phase2(r, label)
            k.update(phase4(r, label))
            dyn = phase5(r, label)
            k.update(phase7_kernels(r, label))
            var = phase7_frames(r, label)
            k.update(phase8_kernels(r, label))
            gt = phase9(r, label)
            gv = phase10(r, label, f, k)
            k.update(gv["kernels"])
            k["gtao_main_band"] = phase13_band(r, label)
            k.update(phase15_lights(r, label))
            k.update(phase16_texels(label, k9_renderers))
            if (w, h) == SHAPES[0]:
                tex = dict(tiers=phase11_tiers(), arena=phase11_arena(r, f),
                           small=phase11_small())
                tex_r, tex["workload"] = phase11_workload()
            prof = phase8_profile(r, label)
            results[label] = dict(kernels=k, frame=f, dynamic=dyn,
                                  variants=var, profile=prof,
                                  ground_truth=gt, gtao_variants=gv)
            renderers[label] = r
        k9_renderers.clear()
        app = phase12()
        sharded = phase13_ranks(renderers)
        for label in renderers:
            # the 2-rank sharded frame's band launches, per rank and frame
            results[label]["kernels"]["gtao_main_band"]["launches"] = \
                sharded[label]["2"]["launches"]["gtao_main_band"]
        geometry = phase14(renderers, tex_r)
        phase3()
        phase6()
        gt_small = phase9_small()
        # torch.profiler last: launches after it run slower (PERF.md)
        for label, r in renderers.items():
            phase8_device(r, label, results[label]["profile"])
        phase11_profile(tex_r, tex["workload"])
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    head = results[f"{SHAPES[0][0]}x{SHAPES[0][1]}"]
    hd = results[f"{SHAPES[1][0]}x{SHAPES[1][1]}"]
    kernels = []
    for name, source, replaces in KERNELS:
        k, k_hd = head["kernels"][name], hd["kernels"][name]
        # launches on the main path that runs the kernel: the static frames
        # for K1-K4, the dynamic rebuild frames for K6, the variant frames
        # for K5, K5p, K7b and K7c, the probes' runs for K7a and P1
        if "launches" in k:
            launches = k["launches"]
        elif name in VARIANT_OF:
            launches = head["variants"][VARIANT_OF[name]]["launches"][name]
        elif name.startswith("bvh2"):
            launches = head["dynamic"]["rebuild"]["launches"][name]
        else:
            launches = head["frame"]["launches"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None, cuda_ms=k["cuda_ms"],
            ms_1080p=k_hd["ms"], cuda_ms_1080p=k_hd["cuda_ms"],
            plain_ms_1080p=k_hd["plain_ms"],
            bound_ms_1080p=k_hd["bound_ms"],
            max_abs_err_1080p=k_hd["max_abs_err"]))
    log(json.dumps(dict(frames={k: v["frame"] for k, v in results.items()},
                        variants={k: v["variants"]
                                  for k, v in results.items()},
                        dynamic={k: v["dynamic"]
                                 for k, v in results.items()},
                        ground_truth=dict(
                            {k: v["ground_truth"]
                             for k, v in results.items()},
                            card_vs_host_64=gt_small),
                        lbvh={k: v["kernels"]["lbvh"]
                              for k, v in results.items()},
                        profile={k: v["profile"] for k, v in results.items()},
                        k7a_orders={k: v["kernels"]["k7a_orders"]
                                    for k, v in results.items()},
                        k2_variants={k: v["kernels"]["bvh8_any"]["variants"]
                                     for k, v in results.items()},
                        k1_variants={
                            k: v["kernels"]["bvh8_closest"]["variants"]
                            for k, v in results.items()},
                        k6_variants={
                            k: {name: v["kernels"][name]["variants"]
                                for name in ("bvh2_closest", "bvh2_any")}
                            for k, v in results.items()},
                        k5_variants={
                            k: {name: v["kernels"][name]["variants"]
                                for name in ("bvh8_any_multi",
                                             "bvh8_any_multi_pop2")}
                            for k, v in results.items()},
                        k7_variants={
                            k: {name: v["kernels"][name]["variants"]
                                for name in ("bvh8_closest_pop2",
                                             "bvh8_any_pop2",
                                             "bvh8_closest_uvp",
                                             "bvh8_closest_steps",
                                             "bvh8_any_steps")}
                            for k, v in results.items()},
                        timer_floor_ms={
                            k: v["kernels"]["trans_equiv"]["timer_floor_ms"]
                            for k, v in results.items()},
                        gtao_variants={
                            k: {key: v["gtao_variants"][key] for key in
                                ("frames", "debug_image_mean", "hdr10")}
                            for k, v in results.items()},
                        k3_variant_shares={
                            k: {name: v["kernels"][name].get(
                                "differing_share") for name, _, _ in KERNELS
                                if name.startswith("gtao_main_")}
                            for k, v in results.items()},
                        k3_with_noise_table={
                            k: v["kernels"]["gtao_main"]["with_noise_table"]
                            for k, v in results.items()},
                        textures=tex, app=app, sharded=sharded,
                        geometry=geometry,
                        k3_band={k: {key: v["kernels"]["gtao_main_band"][key]
                                     for key in ("rows", "ms",
                                                 "full_frame_ms")}
                                 for k, v in results.items()})))
    log(card_line())
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
