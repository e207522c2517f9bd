"""How PyTorch's CPU square root rounds (ROADMAP T1, T2).

    python -m tpurt_torch.tools.sqrt_probe [--processes 200] [--parallel 4]
        [--out PATH]

Starts `processes` fresh Python processes, `parallel` at a time. Each one
takes the square root of the same 4,096 f32 values (uniform in [1, 3), the
size of a 64x64 frame) twice with PyTorch's root
(``passes.encodings.torch_sqrt``) and once with ``passes.encodings.sqrt``,
and counts the roots that differ from numpy's (IEEE, correctly rounded) by
more than 1e-6 relative (a wrong root, not a rounding) and the roots that
differ in any bit. A ``torch.sqrt`` call on
the CPU goes through MKL's VML in chunks of 2,048 elements, one per thread;
the probe reports, per call, the processes with wrong roots and the
elements they hit. It prints one JSON object and writes it to --out.
Runs on the CPU only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

N = 4096
REL = 1e-6


def child() -> dict:
    import numpy as np
    import torch

    from tpurt_torch.passes.encodings import sqrt, torch_sqrt

    x = np.random.default_rng(0).uniform(1.0, 3.0, N).astype(np.float32)
    want = np.sqrt(x)
    out = {}
    for name, fn in (("torch_first", torch_sqrt),
                     ("torch_second", torch_sqrt), ("encodings", sqrt)):
        got = fn(torch.from_numpy(x.copy())).numpy()
        wrong = np.nonzero(np.abs(got - want) / want > REL)[0]
        out[name] = dict(
            wrong=int(wrong.size),
            first_wrong=int(wrong[0]) if wrong.size else None,
            last_wrong=int(wrong[-1]) if wrong.size else None,
            bits_differ=int((got.view(np.int32) != want.view(np.int32))
                            .sum()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=200)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child()))
        return 0
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo)

    def run(_):
        proc = subprocess.run(
            [sys.executable, "-m", "tpurt_torch.tools.sqrt_probe", "--child"],
            capture_output=True, text=True, env=env, cwd=repo, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr[-2000:])
        return json.loads(proc.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.parallel) as pool:
        runs = list(pool.map(run, range(args.processes)))
    report = dict(processes=len(runs), parallel=args.parallel, elements=N)
    for name in runs[0]:
        hit = [r[name] for r in runs if r[name]["wrong"]]
        report[name] = dict(
            processes_with_wrong_roots=len(hit),
            wrong_elements=sorted({(h["first_wrong"], h["last_wrong"],
                                    h["wrong"]) for h in hit}),
            bits_differ_per_call=sum(r[name]["bits_differ"] for r in runs)
            / len(runs))
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
