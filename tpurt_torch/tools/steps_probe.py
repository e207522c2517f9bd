"""Traversal steps per ray and per warp on the bench scene's frame (K7a).

Port of tpurt's ``tools/bvh8_steps_probe.py``. tpurt counted node and leaf
pops per 32x32 packet and divided the trace time by them. A GPU thread
owns its ray, so the port counts per ray (``count_steps=True``), and a
warp runs as long as its busiest lane. The probe traces the frame's rays
with the frame's shape, as the frame does, so the kernels run 16x8 pixel
tiles per block, and it groups the lanes as they do: a warp is 8x4 pixels
(``kernels/traverse_bvh8.tile_rays``). For the primary rays (K7a closest)
and each light's shadow rays (K7a any) it reports:

* per ray: mean, p50, p95 and max of the node pops and the leaf pops;
* per warp: the warp steps, the max over its 32 lanes of node + leaf pops,
  and their sum over the frame;
* SIMT efficiency: lane steps / (32 x warp steps); beside it, for
  comparison, the same with a warp of 32 consecutive pixels of a row (a
  launch on consecutive rays, the layout before pixel tiles);
* on the card, the ms of the trace without counting (K1 for the closest
  hit at "sort", K2 for the any hit at "none", K7a otherwise) and with
  counting (``kernels.build.device_ms``), and ns per warp step;

and the same for each push order ("sort", "nearlast", "none").

    python -m tpurt_torch.tools.steps_probe [--width W --height H] [--out PATH]

It prints one JSON object and writes it to ``--out`` when given. On a CPU
renderer (the tests) the counts come from the plain versions and no time
is reported.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..kernels.build import device_ms
from ..kernels.traverse_bvh8 import (PUSH_ORDERS, WARP_TILE, tile_rays,
                                     trace_any_bvh8, trace_closest_bvh8)
from ..passes.rays import T_MAX, T_MIN, camera_rays
from ..passes.shade import SHADOW_T_MIN, shadow_rays

WARP = 32


def frame_rays(r):
    """The frame's primary rays and each light's shadow rays (origin,
    direction, t_min, t_max), the shadow rays from K1's hits as
    Renderer.render() traces them (a mip scene's texels sampled as the
    frame samples them)."""
    c = r.config
    cam, lights, _ = r._frame_inputs()
    o, d = camera_rays(cam, c.width, c.height)
    hits = trace_closest_bvh8(r.scene_device, o, d, T_MIN, T_MAX)
    shadow = [(so, sd, SHADOW_T_MIN, st)
              for so, sd, st in shadow_rays(r.scene_device, cam, lights, hits,
                                            d, aniso_taps=c.aniso_taps,
                                            height=c.height)]
    return (o, d, T_MIN, T_MAX), shadow


def trace(scene, rays, any_hit: bool, shape=(0, 0), **kw):
    """One closest (any_hit False) or any-hit trace of `rays`; shape, the
    frame's (height, width), runs the kernels in pixel tiles."""
    fn = trace_any_bvh8 if any_hit else trace_closest_bvh8
    return fn(scene, *rays, height=shape[0], width=shape[1], **kw)


def step_counts(scene, primary, shadow, push_order="sort", shape=(0, 0)):
    """K7a on the frame's rays: one counted closest trace of the primary
    rays and one counted any-hit trace per light (shape as trace's).
    Returns [(node pops, leaf pops)] per ray set, primary first, as (N,)
    f32."""
    kw = dict(shape=shape, count_steps=True, push_order=push_order)
    h = trace(scene, primary, False, **kw)
    out = [(h["u"], h["v"])]
    for rays in shadow:
        _, node, leaf = trace(scene, rays, True, **kw)
        out.append((node, leaf))
    return out


def summary(x) -> dict:
    x = x.double()
    return dict(mean=float(x.mean()), p50=float(torch.quantile(x, 0.5)),
                p95=float(torch.quantile(x, 0.95)), max=float(x.max()))


def warp_steps(node, leaf, width: int, height: int):
    """Per warp of a launch over the H x W frame in pixel tiles (8x4
    pixels, tile_rays): the steps of its busiest lane; lanes past the
    frame's edge idle, warps with no pixel are left out."""
    steps = (node + leaf).long()
    lanes = tile_rays(width, height).reshape(-1, WARP)
    per_lane = torch.where(lanes >= 0, steps[lanes.clamp_min(0)],
                           torch.zeros_like(lanes))
    return per_lane.amax(dim=1)[(lanes >= 0).any(dim=1)]


def warp_steps_rows(node, leaf):
    """Per warp of WARP consecutive rays: the steps of its busiest lane
    (the last warp padded with idle lanes)."""
    steps = (node + leaf).long()
    pad = (-steps.numel()) % WARP
    steps = torch.cat([steps, steps.new_zeros(pad)])
    return steps.view(-1, WARP).amax(dim=1)


def _efficiency(lane_sum, warps):
    warp_sum = int(warps.sum())
    return lane_sum / (WARP * warp_sum) if warp_sum else None


def step_report(node, leaf, width: int, height: int) -> dict:
    node, leaf = node.cpu(), leaf.cpu()
    warps = warp_steps(node, leaf, width, height)
    lane_sum = int((node + leaf).sum())
    return dict(rays=node.numel(), node_pops=summary(node),
                leaf_pops=summary(leaf), node_pops_sum=int(node.sum()),
                leaf_pops_sum=int(leaf.sum()), warps=warps.numel(),
                warp_steps=summary(warps), warp_steps_sum=int(warps.sum()),
                lane_steps_sum=lane_sum,
                simt_efficiency=_efficiency(lane_sum, warps),
                simt_efficiency_rows=_efficiency(
                    lane_sum, warp_steps_rows(node, leaf)))


def run(r) -> dict:
    """The report for renderer `r`'s frame (module docstring)."""
    scene = r.scene_device
    primary, shadow = frame_rays(r)
    on_card = r.device.type == "cuda"
    c = r.config
    shape = (c.height, c.width)
    names = ["primary"] + [f"shadow_{i}" for i in range(len(shadow))]
    orders = {}
    for order in PUSH_ORDERS:
        per_set = {}
        counts = step_counts(scene, primary, shadow, order, shape)
        for i, (name, (node, leaf)) in enumerate(zip(names, counts)):
            rep = step_report(node, leaf, c.width, c.height)
            rays, any_hit = (primary, False) if i == 0 else \
                (shadow[i - 1], True)
            if on_card:
                rep["ms"] = device_ms(lambda: trace(scene, rays, any_hit,
                                                  shape, push_order=order))
                rep["ms_counting"] = device_ms(lambda: trace(
                    scene, rays, any_hit, shape, count_steps=True,
                    push_order=order))
                rep["ns_per_warp_step"] = rep["ms"] * 1e6 \
                    / rep["warp_steps_sum"] if rep["warp_steps_sum"] else None
            per_set[name] = rep
        orders[order] = per_set
    return dict(device=torch.cuda.get_device_name(r.device) if on_card
                else "cpu", resolution=[c.width, c.height],
                tris=int(scene["tris"].shape[0]), warp=WARP_TILE,
                push_orders=orders)


def main(argv=None):
    from ..app.bench_scene import build_bench_scene
    from ..engine import Renderer, RendererConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON report here")
    args = ap.parse_args(argv)
    r = build_bench_scene(Renderer(RendererConfig(
        width=args.width, height=args.height, device=args.device)))
    text = json.dumps(run(r))
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
