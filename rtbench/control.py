"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 rtbench/control.py --workload <name> --seconds <s> --seeds <n>...
        [--control <n>...] [--faults <fault>...]

For each seed, in one process: set-up and a window of `seconds` at the
cell's own load, exactly as a run makes them, and the numbers of the
sampled frames against the reference (the lower readings). For each seed
also in --control: the control, the reference computed in bfloat16 (the
precision below the configuration's float32) put in the program's place
on the same frames (the upper readings), and each fault of --faults
planted in the reference put in the program's place (``FAULTS``). One
JSON object per seed on standard output. Runs only on a card; the
benchmark's own runs never run it.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _coarser_lod():
    """The ray-cone mip LOD one level coarser, in both samplers."""
    from rtbench.reference import shade

    lod, aniso = shade.cone_lod, shade.cone_aniso
    return shade, dict(cone_lod=lambda *a: lod(*a) + 1.0,
                       cone_aniso=lambda *a: (aniso(*a)[0] + 1.0,
                                              aniso(*a)[1]))


def _low_gbuffer():
    """A G-buffer of lower precision: depth through bfloat16 in place of
    R16F, color and normals with 3 mantissa bits in place of 6 / 5."""
    import torch

    from rtbench.reference import post

    small = post._q_small_ufloat
    return post, dict(
        q_r16f=lambda x: x.to(torch.bfloat16).to(x.dtype),
        q_r11g11b10f=lambda x: torch.stack(
            [small(x[..., k], 3) for k in range(3)], -1))


FAULTS = dict(lod=_coarser_lod, gbuf=_low_gbuffer)


@contextlib.contextmanager
def planted(name: str):
    """Fault `name` of FAULTS planted in the reference while inside."""
    module, patches = FAULTS[name]()
    saved = {k: getattr(module, k) for k in patches}
    for k, v in patches.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def readings(workload, seed, seconds, control: bool, device="cuda",
             root=None, bench=None, fault=None, faults=()) -> dict:
    import torch

    from rtbench.harness import correct, registry
    from rtbench.harness.cell import Cell

    kw = {} if root is None else dict(root=root)
    cell = Cell(workload, seed, bench=bench, device=device, **kw)
    cell.setup()
    cell.window(seconds, fault)
    frames = cell.release()
    ref = cell.reference()
    low = cell.reference(torch.bfloat16) if control else None
    out = dict(workload=workload, seed=seed, program=[], control=[],
               faults={name: [] for name in faults})
    wants = []
    for j, prog in frames:
        want = cell.reference_frame(ref, j)
        wants.append(want)
        out["program"].append(correct.frame_numbers(prog, want))
        if low is not None:
            got = cell.reference_frame(low, j)
            out["control"].append(correct.frame_numbers(got, want))
    for name in faults:
        with planted(name):
            bad = cell.reference()
            for (j, _), want in zip(frames, wants):
                out["faults"][name].append(correct.frame_numbers(
                    cell.reference_frame(bad, j), want))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=FAULTS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.seconds,
                     seed in args.control,
                     faults=args.faults if seed in args.control else ())
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
