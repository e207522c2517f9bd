"""Run one cell of BENCHMARK.json once on one card:

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints informational lines and, last, each
compared number beside its limit on standard error, and the result as one
JSON object on the last line of standard output. Without a card it exits
with code 2 and prints no result; a process that has loaded JAX or the JAX
package by the end exits with 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpurt")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("rtbench: no CUDA device; the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from rtbench.harness import registry
    from rtbench.harness.cell import run

    bench = registry.benchmark()
    chips = registry.cell(bench, args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"rtbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, cell = run(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=T_START, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"rtbench: the process loaded {found}", file=sys.stderr)
        return 3
    lines = list(cell.log)
    lines.append(f"card: {power_limit()}")
    for name, c in result["checks"].items():
        lines.append(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
