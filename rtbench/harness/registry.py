"""Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in a file of its own, found by its name:

  configs/<config>.json      the scene and renderer settings
  traffic/<traffic>.json     resolution, entry, frames in flight, camera
                             path, animation, frames checked and profiled
  metrics/<metric>.py        a reader: ``read(trace) -> float or None``
  limits/<workload>.json     the limit of each number the check compares

``BENCHMARK.json`` at the checkout's root maps a cell's name to its
configuration and traffic and lists the metrics. ``root`` is the folder
that holds those four directories (this benchmark's by default), so tests
can point the harness at another one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> dict:
    return _json(path)


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def limits(workload: str, root: Path = ROOT) -> dict:
    return _json(root / "limits" / f"{workload}.json")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of metrics/<name>.py."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(bench: dict, workload: str) -> dict:
    """The cell's entry with its end-to-end and per-layer metrics: those
    without a ``workloads`` key and those whose list names it."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(entry, end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))
