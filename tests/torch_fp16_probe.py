"""tpurt's fp16 GTAO main pass, eager against jitted, and the port against
both (ROADMAP F20), on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_fp16_probe.py [--out report.json]

For tests/test_torch_gtao_precision.py's three G-buffers (with and without
bent normals) it prints, in u8 steps (per byte of the packed term), the
max step, the share of pixels that differ and the RMSE of: tpurt's
``main_pass`` under ``jax.jit`` against the eager call, the port's plain
fp16 main pass against each, and tpurt's fp16 against its f32. It then
reruns the eager/jit comparison in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, and compares a whole
32x32 fp16 frame of tpurt's Renderer (a jitted ``render_frame``, GTAO 2x2)
with the port's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def main_pass_report(with_port: bool = True) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from test_torch_gtao import _gbuffer
    from test_torch_gtao_precision import CASES, NOISE_INDEX, _distance
    from tpurt.passes import gtao as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.gtao_main import main_pass_plain
    from tpurt_torch.passes import gtao

    rows = []
    for i, ((h, w), (slices, steps)) in enumerate(CASES):
        depth, normal = _gbuffer(h, w, seed=20 + i)
        consts = ref.gtao_constants(w, h, 0.1, 100.0, np.pi / 2, w / h)
        mips = ref.prefilter_depths(jnp.asarray(depth), consts, fp16=True)
        mips32 = ref.prefilter_depths(jnp.asarray(depth), consts)
        n = jnp.asarray(normal)
        for bent in (False, True):
            s = ref.GtaoSettings(slices, steps, denoise=1, bent_normals=bent,
                                 precision="fp16")
            s32 = ref.GtaoSettings(slices, steps, denoise=1,
                                   bent_normals=bent)
            eager = np.asarray(ref.main_pass(mips, n, consts, s,
                                             jnp.int32(NOISE_INDEX))[0])
            jitted = np.asarray(jax.jit(
                lambda m, nn: ref.main_pass(m, nn, consts, s,
                                            jnp.int32(NOISE_INDEX))[0])(
                mips, n))
            f32 = np.asarray(ref.main_pass(mips32, n, consts, s32,
                                           jnp.int32(NOISE_INDEX))[0])
            row = dict(shape=[h, w], preset=[slices, steps], bent=bent,
                       jit_vs_eager=_distance(jitted, eager, bent),
                       fp16_vs_f32=_distance(eager, f32, bent))
            if with_port:
                got = main_pass_plain(
                    [torch.tensor(np.asarray(m)) for m in mips],
                    torch.tensor(normal),
                    convert.gtao_tensors(consts, "cpu")["vec16"],
                    gtao.noise_maps_64(NOISE_INDEX, "cpu"),
                    slice_count=slices, steps_per_slice=steps, bent=bent,
                    precision="fp16")[0].numpy()
                got = got.view(np.uint32) if bent else got
                row.update(port_vs_eager=_distance(got, eager, bent),
                           port_vs_jit=_distance(got, jitted, bent))
            rows.append(row)
    return rows


def frame_report() -> dict:
    """tpurt's jitted fp16 frame against the port's, 32x32, GTAO 2x2."""
    import numpy as np

    from torch_ground_truth import CUBES, FIELD, SIZE
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt.passes.gtao import GtaoSettings as RefSettings
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.passes.gtao import GtaoSettings

    out = {}
    for prec in ("fp16", "exact"):
        ref_r = build_bench_scene(RefRenderer(RefConfig(
            width=SIZE, height=SIZE, tracer="bvh8",
            gtao=RefSettings(2, 2, denoise=1, precision=prec))),
            field=FIELD, cubes=CUBES)
        port_r = build_bench_scene(Renderer(RendererConfig(
            width=SIZE, height=SIZE, device="cpu",
            gtao=GtaoSettings(2, 2, denoise=1, precision=prec))),
            field=FIELD, cubes=CUBES)
        out[prec] = (np.asarray(ref_r.render()["ao"]).astype(int),
                     port_r.render()["ao"].numpy().astype(int))

    def dist(a, b):
        d = np.abs(a - b)
        return (int(d.max()), float((d > 0).mean()),
                float(np.sqrt((d.astype(float) ** 2).mean())))

    return dict(ao_fp16_tpurt_jit_vs_port=dist(*out["fp16"]),
                ao_exact_tpurt_jit_vs_port=dist(*out["exact"]),
                ao_tpurt_fp16_vs_exact=dist(out["fp16"][0],
                                            out["exact"][0]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the JSON report here")
    ap.add_argument("--jax-only", action="store_true",
                    help="(internal) only tpurt's eager/jit comparison")
    args = ap.parse_args(argv)
    if args.jax_only:
        print(json.dumps(main_pass_report(with_port=False)))
        return 0
    report = dict(main_pass=main_pass_report())
    env = dict(os.environ,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    sub = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--jax-only"], capture_output=True, text=True,
                         env=env, timeout=1200)
    report["main_pass_no_excess_precision"] = json.loads(
        sub.stdout.strip().splitlines()[-1])
    report["frame"] = frame_report()
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
