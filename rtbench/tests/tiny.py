"""Cut-down copies of the benchmark's cells for the CPU tests: the same
files (configs, traffic, limits, metrics) in a temporary folder, with the
scenes cut to a few boxes and the frames to 32 x 32. The limits are the
real cells' own."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

RTBENCH = Path(__file__).resolve().parents[1]
REPO = RTBENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny cell -> (real cell, config cuts, traffic changes)
CELLS = {
    "tiny.orbit": ("bench43k.orbit-1080", "bench43k", "orbit-1080", {}),
    "tiny.rebuild": ("bench43k.orbit-1080", "bench43k", "rebuild-800", {}),
    "tiny.aniso16": ("textures292k.orbit-aniso16-800", "textures292k",
                     "orbit-aniso16-800", {}),
    "tiny.aniso1": ("textures292k.orbit-aniso16-800", "textures292k",
                    "orbit-aniso16-800", dict(aniso_taps=1)),
}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cut_config(config: dict) -> dict:
    """The configuration with its fields cut to 3 x 3 boxes (2 x 2 for a
    material field, 16 x 16 textures) and at most 2 extra cubes."""
    c = json.loads(json.dumps(config))
    first = c["models"][0]
    if first["kind"] == "box_field":
        first["args"].update(nx=3, nz=3, subdiv=2)
    else:
        first["args"].update(nx=2, nz=2, subdiv=2, extents=[16])
    c["models"] = c["models"][:4]
    from rtbench.scenes import build_models, triangle_count

    c["triangles"] = triangle_count(build_models(c, 0))
    return c


def make_root(tmp: Path, size=(32, 32)) -> tuple:
    """A benchmark folder of the tiny cells under `tmp`: (root, bench)."""
    root = tmp / "rtbench"
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(RTBENCH / "metrics", root / "metrics")
    bench = _json(REPO / "BENCHMARK.json")
    workloads = []
    for name, (real, config, traffic, extra) in CELLS.items():
        cfg = cut_config(_json(RTBENCH / "configs" / f"{config}.json"))
        with open(root / "configs" / f"{name}.json", "w") as f:
            json.dump(cfg, f)
        tr = dict(_json(RTBENCH / "traffic" / f"{traffic}.json"), **extra)
        tr.update(width=size[0], height=size[1], warmup_frames=2)
        with open(root / "traffic" / f"{name}.json", "w") as f:
            json.dump(tr, f)
        shutil.copy(RTBENCH / "limits" / f"{real}.json",
                    root / "limits" / f"{name}.json")
        workloads.append(dict(name=name, config=name, traffic=name, chips=1,
                              why="a CPU test's cut copy of " + real))
    bench = dict(bench, workloads=workloads)
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    with open(tmp / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return root, bench
