"""Do CUDA's libm and PyTorch give the same cos/sin/pow bits on the card?

Port of tpurt's ``tools/trans_equiv_probe.py``, which asked whether XLA and
Mosaic lower the GTAO noise transcendentals identically on a TPU. Here the
two lowerings are the P1 kernel (``csrc/trans_equiv.cu``: CUDA's ``cosf``,
``sinf``, ``fmodf``, ``powf``) and its plain version (``torch.cos``,
``torch.sin``, ``torch.pow`` on the same device); both are also held
against a float64 evaluation on the host of the same f32 arguments. For
each op (cos, sin, pow) it reports the bit mismatches and the largest
distance in units in the last place (ULP) of each pair, and whether the
kernel stays within ``ATOL_TRIG`` / ``RTOL_POW`` of the plain version.

    python -m tpurt_torch.tools.trans_equiv_probe [--out PATH]

Inputs are tpurt's probe's: uniform [0, 1) noise from seed 7 as two
(32, 128) planes, 9 slices x 3 steps, sample-distribution power 2.0. It
prints one JSON object and writes it to ``--out`` when given. On a CPU
device (the tests) the kernel's side is the plain version itself.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..kernels.trans_equiv import (ATOL_TRIG, RTOL_POW, arguments, row_ops,
                                   trans_equiv, trans_equiv_plain)

SLICES = 9
STEPS = 3
SEED = 7
SDP = 2.0


def noise_planes() -> torch.Tensor:
    """(2, 32, 128) f32 uniform noise: the slice and the sample plane."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.random((64, 128), dtype=np.float32)
                            .reshape(2, 32, 128).copy())


def float64_reference(planes):
    """cos/sin/pow of the f32 arguments evaluated in float64 on the host,
    rounded to f32."""
    args = arguments(planes.cpu(), SDP, SLICES, STEPS).double()
    fns = dict(cos=torch.cos, sin=torch.sin,
               pow=lambda x: torch.pow(x, SDP))
    ops = row_ops(SLICES, STEPS)
    return torch.stack([fns[op](a) for op, a in zip(ops, args)]).float()


def ulp_distance(a, b):
    """Elementwise distance of two f32 tensors in ULPs (int64), across the
    sign boundary too."""
    def ordered(x):
        i = x.detach().cpu().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def compare(x, y, ops):
    """Per op: bit mismatches and max ULP distance of x against y."""
    d = ulp_distance(x, y)
    out = {}
    for op in sorted(set(ops)):
        rows = [i for i, o in enumerate(ops) if o == op]
        sel = d[rows]
        out[op] = dict(bit_mismatches=int((sel > 0).sum()),
                       max_ulp=int(sel.max()))
    return out


def within_tolerance(kernel, plain, ops):
    """The kernel against the plain version: cos and sin within ATOL_TRIG,
    pow within RTOL_POW relative. Per op: the worst error and the count of
    elements outside."""
    out = {}
    k, p = kernel.cpu(), plain.cpu()
    for op in sorted(set(ops)):
        rows = [i for i, o in enumerate(ops) if o == op]
        err = (k[rows] - p[rows]).abs()
        if op == "pow":
            lim = RTOL_POW * p[rows].abs()
        else:
            lim = torch.full_like(err, ATOL_TRIG)
        out[op] = dict(max_abs_err=float(err.max()),
                       outside=int((err > lim).sum()))
    return out


def run(device="cuda") -> dict:
    """One probe: P1 and its plain version on `device`, both against
    float64 on the host."""
    planes = noise_planes().to(device)
    kernel = trans_equiv(planes, SDP, SLICES, STEPS)
    plain = trans_equiv_plain(planes, SDP, SLICES, STEPS)
    ref = float64_reference(planes)
    ops = row_ops(SLICES, STEPS)
    args_dev = arguments(planes, SDP, SLICES, STEPS)
    args_host = arguments(planes.cpu(), SDP, SLICES, STEPS)
    dev = torch.device(device)
    return dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        shape=list(kernel.shape), elements_per_op={
            op: ops.count(op) * planes[0].numel() for op in sorted(set(ops))},
        arguments_equal_to_host=bool(torch.equal(
            args_dev.cpu().view(torch.int32), args_host.view(torch.int32))),
        kernel_vs_plain=compare(kernel, plain, ops),
        kernel_vs_float64=compare(kernel, ref, ops),
        plain_vs_float64=compare(plain, ref, ops),
        tolerance=dict(atol_cos_sin=ATOL_TRIG, rtol_pow=RTOL_POW,
                       **within_tolerance(kernel, plain, ops)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON report here")
    args = ap.parse_args(argv)
    report = run(args.device)
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
