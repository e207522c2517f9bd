"""Time K1 (BVH8 closest hit), K2 (BVH8 any hit), K3 (GTAO main pass,
with its noise table K3h where the checkout has one), K4 (GTAO denoise),
K5 and K5p (the fused multi-light any hit, one and two pops), K6
(binary-BVH closest and any hit) and K7a, K7b, K7c (the BVH8 traversal's
counted, two-pop and uv-payload variants) of several checkouts of the port
on one card, in turns, on the bench scene at 800x800 and 1920x1080, and P1
(the transcendental probe's kernel) on the probe's noise planes, through
the public entry points every checkout has.

    python tpurt_torch/tools/kernel_ab.py --repo PARENT --repo . \\
        --repo . --repo PARENT [--out PATH]

Each --repo runs in its own process, in the order given (parent, change,
change, parent compares two versions inside one call), which imports that
checkout's tpurt_torch, builds its kernels and times on the card alone
(kernels/build.device_ms):

* K1: trace_closest_bvh8(scene, origin, direction, t_min, t_max) on the
  frame's camera rays, the rays in consecutive blocks (the frame passes
  its shape as well, for pixel tiles: chip_smoke.py times both);
* K2: trace_any_bvh8(scene, origin, direction, t_min, t_max) at its
  default order on each light's shadow rays of the frame (3 launches,
  summed), the rays in consecutive blocks (the frame passes its shape as
  well, for pixel tiles: chip_smoke.py times both);
* K5 and K5p: trace_any_bvh8_multi(scene, origin, dirs, t_min, t_maxs,
  pop2=False / True) on the frame's 3 shadow sets (one launch each), the
  rays in consecutive blocks (the fused frame passes its shape as well,
  for pixel tiles: chip_smoke.py times both);
* K7a, K7b, K7c: trace_closest_bvh8(..., count_steps=True / pop2=True /
  uv_payload=True) on the camera rays and trace_any_bvh8(...,
  count_steps=True, push_order="sort" / pop2=True) on each light's shadow
  rays (3 launches, summed), the rays in consecutive blocks; K7a, K7b and
  K7c also with the frame's shape (height=, width=; pixel tiles where the
  checkout's kernels take them, consecutive rays where they do not);
* K3: gtao_main at the frame's preset (ULTRA 9x3) on the frame's depth
  pyramid and G-buffer, every launch of it (chip_smoke.py times K3h and
  K3 apart);
* K4: denoise_chain on the main pass's AO and edges at the frame's
  preset (sharp: one pass);
* K6: trace_closest_bvh2(scene, origin, direction, t_min, t_max) on the
  frame's camera rays and trace_any_bvh2(...) on each light's shadow rays
  from those hits (3 launches, summed), over the rebuild frame's LBVH at
  the bench animation's last pose (rotation_frames(transforms, 8)[-1]),
  the rays in consecutive blocks (the rebuild frame passes its shape as
  well, for pixel tiles: chip_smoke.py times both);
* P1: trans_equiv(planes, sdp, 9, 3) on tools/trans_equiv_probe's noise
  planes, once per checkout, beside the card-only timer's floor (an empty
  kernel, torch.cuda._sleep(0), timed the same way); its outputs at 9x3
  and at 1x2, 2x2 and 3x3 hashed;
* the default frame: Renderer.render() on the bench scene, by the host
  wall clock (10 frames ending in one synchronize, after one warm-up) and
  by the card-only timer (on this host-bound frame it waits for the host
  too);

and reports the ptxas registers, stack frame and spills of each kernel it
built (those of csrc/bvh8_multi.cu also on stderr, one line per
checkout), hashes of the closest hits, the occlusion masks, K5's and K5p's
masks, the AO and edges, the denoised AO, K6's hits and masks, P1's rows
and one rendered frame (so the versions can be held equal bit for bit),
and the card's name and power limit. It prints one JSON object and writes
it to --out when given.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

SHAPES = ((800, 800), (1920, 1080))


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


def _digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas_report(log: str) -> list:
    """(kernel, registers, stack frame bytes, spill store and load bytes)
    of every entry ptxas compiled."""
    out, name, frame = [], None, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            nums = [int(part.split()[0]) for part in line.split(",")]
            frame = dict(zip(("stack_bytes", "spill_stores", "spill_loads"),
                             nums))
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            out.append(dict(kernel=name, registers=regs,
                            stack_bytes=frame.get("stack_bytes"),
                            spill_stores=frame.get("spill_stores"),
                            spill_loads=frame.get("spill_loads")))
            name, frame = None, {}
    return out


def child(repo: str) -> dict:
    """The measurements of one checkout (module docstring)."""
    sys.path.insert(0, os.path.abspath(repo))
    import torch

    from tpurt_torch.app.bench_scene import (build_bench_scene,
                                             rotation_frames)
    from tpurt_torch.engine import Renderer, RendererConfig, convert
    from tpurt_torch.engine.dynamic import build_world_tables
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels import gtao_main as k3
    from tpurt_torch.kernels.build import device_ms
    from tpurt_torch.kernels.gtao_denoise import denoise_chain
    from tpurt_torch.kernels.trans_equiv import trans_equiv
    from tpurt_torch.kernels.traverse_bvh2 import (trace_any_bvh2,
                                                   trace_closest_bvh2)
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_any_bvh8_multi,
                                                   trace_closest_bvh8)
    from tpurt_torch.passes.encodings import (quantize_r11g11b10f,
                                              quantize_r16f)
    from tpurt_torch.passes.gtao import noise_maps_64, prefilter_depths
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shade, shadow_rays
    from tpurt_torch.tools import trans_equiv_probe as probe

    t0 = time.perf_counter()
    build.get_lib()
    out = dict(repo=repo, build_s=time.perf_counter() - t0,
               ptxas=ptxas_report(build.build_log),
               sizes={})
    planes = probe.noise_planes().cuda()
    p1 = [trans_equiv(planes, probe.SDP, *counts) for counts in (
        (probe.SLICES, probe.STEPS), (1, 2), (2, 2), (3, 3))]
    out.update(p1_ms=device_ms(lambda: trans_equiv(
        planes, probe.SDP, probe.SLICES, probe.STEPS), 20),
        timer_floor_ms=device_ms(lambda: torch.cuda._sleep(0), 20),
        p1_digest=_digest(*p1))
    for w, h in SHAPES:
        r = build_bench_scene(Renderer(RendererConfig(width=w, height=h,
                                                      device="cuda")))
        scene = r.scene_device
        cam, lights, gtao = r._frame_inputs()
        o, d = camera_rays(cam, w, h)
        hits = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX)
        res = dict(k1_ms=device_ms(lambda: trace_closest_bvh8(
            scene, o, d, T_MIN, T_MAX)), k2_ms=0.0)
        rays = shadow_rays(scene, cam, lights, hits)
        occ = []
        for so, sd, st in rays:
            occ.append(trace_any_bvh8(scene, so, sd, SHADOW_T_MIN, st))
            res["k2_ms"] += device_ms(lambda: trace_any_bvh8(
                scene, so, sd, SHADOW_T_MIN, st))
        # K7a "sort" counted (PERF.md's K7a rows), K7b, K7c; each also
        # with the frame's shape
        k7 = {}
        frame = dict(height=h, width=w)
        counted = dict(count_steps=True, push_order="sort")
        for key, kw in (("k7a", counted), ("k7b", dict(pop2=True)),
                        ("k7c", dict(uv_payload=True)),
                        ("k7a_tiles", dict(counted, **frame)),
                        ("k7c_tiles", dict(uv_payload=True, **frame)),
                        ("k7b_tiles", dict(pop2=True, **frame))):
            k7[key] = trace_closest_bvh8(scene, o, d, T_MIN, T_MAX, **kw)
            res[f"{key}_ms"] = device_ms(lambda: trace_closest_bvh8(
                scene, o, d, T_MIN, T_MAX, **kw))
        for key, kw in (("k7a_any", counted), ("k7b_any", dict(pop2=True)),
                        ("k7a_any_tiles", dict(counted, **frame)),
                        ("k7b_any_tiles", dict(pop2=True, **frame))):
            k7[key], res[f"{key}_ms"] = [], 0.0
            for so, sd, st in rays:
                k7[key].append(trace_any_bvh8(scene, so, sd, SHADOW_T_MIN,
                                              st, **kw))
                res[f"{key}_ms"] += device_ms(lambda: trace_any_bvh8(
                    scene, so, sd, SHADOW_T_MIN, st, **kw))
        for key, got in k7.items():
            flat = got.values() if isinstance(got, dict) else [
                x for one in got for x in (one if isinstance(one, tuple)
                                           else (one,))]
            res[f"{key}_digest"] = _digest(*flat)
        origin = rays[0][0]
        dirs = torch.stack([sd for _, sd, _ in rays])
        tmaxs = torch.stack([st for _, _, st in rays])
        for key, pop2 in (("k5", False), ("k5p", True)):
            res[f"{key}_digest"] = _digest(trace_any_bvh8_multi(
                scene, origin, dirs, SHADOW_T_MIN, tmaxs, pop2=pop2))
            res[f"{key}_ms"] = device_ms(lambda: trace_any_bvh8_multi(
                scene, origin, dirs, SHADOW_T_MIN, tmaxs, pop2=pop2))
        g = shade(scene, cam, lights, hits)
        depth = quantize_r16f(g["depth"]).reshape(h, w)
        normal = quantize_r11g11b10f(g["normal_enc"]).reshape(h, w, 3)
        mips = prefilter_depths(depth, gtao["host"])
        noise = noise_maps_64(0, r.device)
        kw = dict(slice_count=r.config.gtao.slice_count,
                  steps_per_slice=r.config.gtao.steps_per_slice)
        ao, edges = k3.gtao_main(mips, normal, gtao["vec"], noise, **kw)
        res["k3_total_ms"] = device_ms(lambda: k3.gtao_main(
            mips, normal, gtao["vec"], noise, **kw))
        dn = dict(n_passes=r.config.gtao.num_denoise_passes,
                  blur_beta=r.config.gtao.denoise_blur_beta)
        final_ao = denoise_chain(ao, edges, **dn)
        res["k4_ms"] = device_ms(lambda: denoise_chain(ao, edges, **dn), 20)
        wd = build_world_tables(
            convert.object_tensors(r.scene.as_object_pytree(), r.device),
            rotation_frames(r.scene.transforms, 8)[-1])
        hits6 = trace_closest_bvh2(wd, o, d, T_MIN, T_MAX)
        res["k6_closest_ms"] = device_ms(lambda: trace_closest_bvh2(
            wd, o, d, T_MIN, T_MAX))
        res["k6_any_ms"], occ6 = 0.0, []
        for so, sd, st in shadow_rays(wd, cam, lights, hits6):
            occ6.append(trace_any_bvh2(wd, so, sd, SHADOW_T_MIN, st))
            res["k6_any_ms"] += device_ms(lambda: trace_any_bvh2(
                wd, so, sd, SHADOW_T_MIN, st))
        r._frame_idx = 0
        image = r.render()["image"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            r.render(block=False)
        torch.cuda.synchronize()
        res.update(frame_wall_ms=(time.perf_counter() - t0) * 100.0,
                   frame_ms=device_ms(lambda: r.render(block=False)))
        res.update(hit_digest=_digest(*(hits[k] for k in ("t", "tri", "u",
                                                          "v"))),
                   denoise_digest=_digest(final_ao),
                   occ_digest=_digest(*occ), ao_digest=_digest(ao, edges),
                   k6_hit_digest=_digest(*(hits6[k] for k in ("t", "tri",
                                                              "u", "v"))),
                   k6_occ_digest=_digest(*occ6),
                   image_digest=_digest(image),
                   occluded=[int(x.sum()) for x in occ])
        out["sizes"][f"{w}x{h}"] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", action="append", default=[],
                    help="a checkout of the port, in the order to run")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write the JSON report here")
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    report = dict(card=_card(), runs=[])
    for repo in args.repo:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", repo], capture_output=True,
                              text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        report["runs"].append(run)
        print(f"ptxas bvh8_multi.cu ({repo}): " + json.dumps(
            [k for k in run["ptxas"] if "bvh8_any_multi" in k["kernel"]]),
            file=sys.stderr)
    report["card_after"] = _card()
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
