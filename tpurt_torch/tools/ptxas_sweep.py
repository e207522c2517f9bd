"""What ptxas makes of one kernel source under several values of a macro.

    python -m tpurt_torch.tools.ptxas_sweep bvh2_trace.cu \\
        --define K6_MIN_BLOCKS --values 4 6 8 10 12 [--out PATH]

Compiles ``tpurt_torch/csrc/<source>`` once per value with the library's
own flags (``kernels/build.NVCC_FLAGS``) and ``-D<define>=<value>``, all
compiles started together, and reports each entry's registers, stack frame
and spill bytes (``tools/kernel_ab.ptxas_report``) per value: how a launch
bound or a tile size trades registers against spills, read rather than
guessed. Needs ``nvcc``; runs no kernel. Prints one JSON object and writes
it to --out when given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path


def sweep(source: str, define: str, values) -> dict:
    from tpurt_torch.kernels import build
    from tpurt_torch.tools.kernel_ab import ptxas_report

    nvcc = build.nvcc_path()
    src = build.SRC_DIR / source
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        procs = {v: subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, f"-D{define}={v}", "-c", str(src),
             "-o", str(Path(tmp) / f"{v}.o")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for v in values}
        out = {}
        for v, proc in procs.items():
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with {define}={v}:\n{log}")
            out[str(v)] = ptxas_report(log)
    return dict(source=source, define=define, kernels=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", help="a file of tpurt_torch/csrc")
    ap.add_argument("--define", required=True, help="the macro to set")
    ap.add_argument("--values", nargs="+", required=True)
    ap.add_argument("--out", help="write the JSON report here")
    args = ap.parse_args(argv)
    text = json.dumps(sweep(args.source, args.define, args.values), indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
