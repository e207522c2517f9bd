#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (tpurt_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from tpurt_torch/csrc into tpurt_torch/_build, prints
the card's `name, power.limit`, and for the bench scene (43,200-tri box
field + ground + 8 textured cubes, 3 shadow-casting lights, GTAO ULTRA 9x3
with sharp denoise, LPM) at 800x800 and at 1920x1080 runs:

  phase 1  each kernel against its plain PyTorch version on the card, at the
           main path's shapes: primary rays (K1); the shadow rays of each
           light, t_max = 0 lanes included (K2); the frame's depth pyramid
           and G-buffer (K3); the main pass's AO and edges (K4). Prints the
           mismatch counts and both times (CUDA events after a warm-up).
  phase 2  >= 10 frames through Renderer.render(): launch counts per frame
           (K1 1, K2 3, K3 1, K4 1), ms/frame, Mrays/s (W*H*(1 + shadow
           lights) rays per frame), a checksum and the share of lit pixels.
  phase 3  a 64x64 frame of the same scene on the card against the same
           frame from the plain versions on the host.

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
SHAPES = ((800, 800), (1920, 1080))
KERNELS = (
    ("bvh8_closest", "tpurt_torch/csrc/bvh8_trace.cu",
     "tpurt/kernels/traverse_bvh8.py:107"),
    ("bvh8_any", "tpurt_torch/csrc/bvh8_trace.cu",
     "tpurt/kernels/traverse_bvh8.py:107"),
    ("gtao_main", "tpurt_torch/csrc/gtao_main.cu",
     "tpurt/kernels/gtao_main_pallas.py:317"),
    ("gtao_denoise", "tpurt_torch/csrc/gtao_denoise.cu",
     "tpurt/kernels/gtao_pallas.py:131"),
)
# K3/K4 budget on the card: u8 steps and the share of pixels that may differ
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
    from tpurt_torch.kernels.gtao_main import gtao_main, main_pass_plain
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
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

    # K1: primary rays
    o, d = camera_rays(cam, w, h)
    hk = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX)
    hp = trace_closest_plain(scene, o, d, T_MIN, T_MAX)
    torch.cuda.synchronize()
    mism = {k: int((hk[k].view(torch.int32) != hp[k].view(torch.int32))
                   .sum()) for k in ("t", "tri", "u", "v")}
    err = float((hk["t"] - hp["t"]).abs().max())
    hit_share = float((hk["tri"] >= 0).float().mean())
    ms = cuda_ms(lambda: trace_closest_bvh8(scene, o, d, T_MIN, T_MAX), 10,
                 warmup=3)
    plain_ms = cuda_ms(lambda: trace_closest_plain(scene, o, d, T_MIN,
                                                   T_MAX), 2)
    log(f"[{label}] K1 closest: rays {w * h}, hit share {hit_share:.4f}, "
        f"bit mismatches {mism}, max |dt| {err}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.2f} ms")
    require(sum(mism.values()) == 0, f"[{label}] K1 differs from plain")
    require(hit_share > 0.05, f"[{label}] K1 hit almost nothing")
    out["bvh8_closest"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # K2: the shadow rays of every light, t_max = 0 lanes included
    k2_ms = k2_plain_ms = k2_err = 0.0
    k2_mism = 0
    for i, (so, sd, stmax) in enumerate(shadow_rays(scene, cam, lights, hk)):
        ok = trace_any_bvh8(scene, so, sd, SHADOW_T_MIN, stmax)
        op = trace_any_plain(scene, so, sd, SHADOW_T_MIN, stmax)
        torch.cuda.synchronize()
        n_mis = int((ok != op).sum())
        dead = float((stmax <= SHADOW_T_MIN).float().mean())
        k_ms = cuda_ms(lambda: trace_any_bvh8(scene, so, sd, SHADOW_T_MIN,
                                              stmax), 10, warmup=3)
        p_ms = cuda_ms(lambda: trace_any_plain(scene, so, sd, SHADOW_T_MIN,
                                               stmax), 2)
        log(f"[{label}] K2 light {i}: occluded {float(ok.float().mean()):.4f},"
            f" t_max=0 lanes {dead:.4f}, mismatches {n_mis}, kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.2f} ms")
        k2_mism += n_mis
        k2_err = max(k2_err, float((ok.int() - op.int()).abs().max()))
        k2_ms += k_ms
        k2_plain_ms += p_ms
    require(k2_mism == 0, f"[{label}] K2 differs from plain")
    out["bvh8_any"] = dict(max_abs_err=k2_err, ms=k2_ms,
                           plain_ms=k2_plain_ms)

    # K3: the frame's real depth pyramid and G-buffer
    g = shade(scene, cam, lights, hk)
    depth = quantize_r16f(g["depth"]).reshape(h, w)
    normal = quantize_r11g11b10f(g["normal_enc"]).reshape(h, w, 3)
    mips = prefilter_depths(depth, gtao["host"])
    noise = noise_maps_64(0, r.device)
    st = c.gtao.slice_count, c.gtao.steps_per_slice
    kw = dict(slice_count=st[0], steps_per_slice=st[1])
    ao_k, ed_k = gtao_main(mips, normal, gtao["vec"], noise, **kw)
    ao_p, ed_p = main_pass_plain(mips, normal, gtao["vec"], noise, **kw)
    torch.cuda.synchronize()
    dao = (ao_k.int() - ao_p.int()).abs()
    ed_mis = int((ed_k != ed_p).sum())
    frac = float((dao > 0).float().mean())
    ms = cuda_ms(lambda: gtao_main(mips, normal, gtao["vec"], noise, **kw),
                 10, warmup=3)
    plain_ms = cuda_ms(lambda: main_pass_plain(mips, normal, gtao["vec"],
                                               noise, **kw), 3)
    log(f"[{label}] K3 main: AO max step {int(dao.max())}, differing "
        f"{frac:.6f}, edge mismatches {ed_mis}, mean AO "
        f"{float(ao_k.float().mean()):.2f}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms")
    require(ed_mis == 0, f"[{label}] K3 edges differ")
    require(int(dao.max()) <= AO_MAX_STEP and frac <= AO_MAX_FRACTION,
            f"[{label}] K3 AO outside budget")
    out["gtao_main"] = dict(max_abs_err=float(dao.max()), ms=ms,
                            plain_ms=plain_ms)

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
    ms = cuda_ms(lambda: denoise_chain(ao_k, ed_k, n_passes=n_pass,
                                       blur_beta=beta), 20, warmup=3)
    plain_ms = cuda_ms(plain_chain, 5)
    log(f"[{label}] K4 denoise: max step {int(dd.max())}, differing "
        f"{frac:.6f}, max AO {int(dk.max())}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms")
    require(int(dd.max()) <= AO_MAX_STEP and frac <= AO_MAX_FRACTION,
            f"[{label}] K4 outside budget")
    out["gtao_denoise"] = dict(max_abs_err=float(dd.max()), ms=ms,
                               plain_ms=plain_ms)
    return out


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
    want = dict(bvh8_closest=FRAMES, bvh8_any=shadow * FRAMES,
                gtao_main=FRAMES, gtao_denoise=FRAMES)
    require(counts == want, f"[{label}] launch counts {counts} != {want}")
    require(tuple(image.shape) == (c.height, c.width, 3)
            and image.dtype == torch.uint8, f"[{label}] bad image")
    for key in ("color", "depth", "normal"):
        require(bool(torch.isfinite(out[key]).all()),
                f"[{label}] non-finite {key}")
    require(checksum > 0 and lit > 0.2, f"[{label}] frame is black")
    return dict(ms_per_frame=ms, mrays_per_s=rays / ms / 1e3,
                rays_per_frame=rays, launches=counts, checksum=checksum,
                lit_share=lit)


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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.get_lib()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({build.library_path().name})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())

    results = {}
    try:
        for w, h in SHAPES:
            label = f"{w}x{h}"
            t0 = time.perf_counter()
            r = build_renderer(w, h, "cuda")
            log(f"[{label}] scene ready in {time.perf_counter() - t0:.1f} s:"
                f" {r.stats()}")
            k = phase1(r, label)
            f = phase2(r, label)
            results[label] = dict(kernels=k, frame=f)
            del r
            torch.cuda.empty_cache()
        phase3()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    head = results["800x800"]
    hd = results["1920x1080"]
    kernels = []
    for name, source, replaces in KERNELS:
        k, k_hd = head["kernels"][name], hd["kernels"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=head["frame"]["launches"][name],
            max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], ms_1080p=k_hd["ms"],
            plain_ms_1080p=k_hd["plain_ms"],
            max_abs_err_1080p=k_hd["max_abs_err"]))
    log(json.dumps(dict(frames={k: v["frame"] for k, v in results.items()})))
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
