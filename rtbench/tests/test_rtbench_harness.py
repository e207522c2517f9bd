"""The harness on the CPU: files found by name, the frame inputs from the
seed, the metrics' arithmetic, the rooflines' counts, the result line, the
refusal without a card, and runs of cut-down cells with the timed path
broken underneath, which the check has to call incorrect."""
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tiny import REPO, RTBENCH, make_root

from rtbench.harness import registry, roofline, stats
from rtbench.harness.cell import run
from rtbench.harness.path import FramePath
from rtbench.harness.traced import read_trace
from rtbench.scenes import build_models, texel_bytes, triangle_count

BENCH = registry.benchmark()


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = registry.cell(BENCH, workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(workload)
    assert config["models"] and traffic["width"] > 0 and limits
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_configs_state_their_triangles():
    for c in BENCH["configs"]:
        config = registry.config(c["name"])
        assert triangle_count(build_models(config, 7)) == config["triangles"]
        assert c["file"] == f"rtbench/configs/{c['name']}.json"


def test_new_files_need_no_edit(tmp_path):
    root = tmp_path / "rtbench"
    shutil.copytree(RTBENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = registry.config("bench43k", root)
    (root / "configs" / "newcfg.json").write_text(json.dumps(
        dict(cfg, lights=cfg["lights"][:1])))
    (root / "traffic" / "newmix.json").write_text(json.dumps(
        dict(registry.traffic("orbit-800", root), width=64)))
    (root / "limits" / "newcfg.newmix.json").write_text('{"image_rmse": 1}')
    (root / "metrics" / "frames.py").write_text(
        "def read(trace):\n    return float(trace['frames'])\n")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [dict(
        name="newcfg.newmix", config="newcfg", traffic="newmix", chips=1,
        why="x")], per_layer=BENCH["per_layer"] + [dict(
            name="frames", unit="1", better="higher", source="host_clock",
            layer="device", moves="frame_ms")])
    cell = registry.cell(bench, "newcfg.newmix")
    assert len(registry.config(cell["config"], root)["lights"]) == 1
    assert registry.traffic(cell["traffic"], root)["width"] == 64
    assert registry.limits("newcfg.newmix", root) == {"image_rmse": 1}
    assert registry.metric_reader("frames", root)({"frames": 3}) == 3.0
    assert "frames" in [m["name"] for m in cell["per_layer"]]
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("traffic", ["orbit-800", "rebuild-800"])
def test_frame_inputs_repeat_per_seed(traffic):
    tr = registry.traffic(traffic)
    base = np.tile(np.eye(3, 4, dtype=np.float32), (10, 1, 1))

    def inputs(seed):
        p = FramePath(tr, seed)
        return [(p.pose(i), p.transforms(i, base)) for i in range(50)]

    big = 2 ** 31 + 12345
    a, b, c = inputs(big), inputs(big), inputs(big + 1)
    flat = [np.concatenate([*pose, *(() if t is None else (t.ravel(),))])
            for pose, t in a]
    assert all(np.array_equal(x, y) for x, y in zip(
        flat, [np.concatenate([*pose, *(() if t is None else (t.ravel(),))])
               for pose, t in b]))
    assert not all(np.array_equal(x[0][0], y[0][0]) for x, y in zip(a, c))
    # every seed walks the same closed loop: one period's poses as a set
    p1, p2 = FramePath(tr, 1), FramePath(tr, 2)
    d = [min(np.linalg.norm(p1.pose(i)[0] - p2.pose(j)[0])
             for j in range(p2.period)) for i in range(0, p1.period, 17)]
    assert max(d) < 0.05


def test_seed_moves_heights_not_sizes():
    for c in BENCH["configs"]:
        config = registry.config(c["name"])
        m1, m2 = build_models(config, 1), build_models(config, 2 ** 31 + 9)
        assert triangle_count(m1) == triangle_count(m2)
        assert texel_bytes(m1) == texel_bytes(m2)
        assert not np.array_equal(m1[0][0][0]["positions"],
                                  m2[0][0][0]["positions"])


def test_window_metrics_on_stamps():
    calls = [0.0, 0.010, 0.020, 0.030]
    done = [0.015, 0.022, 0.040, 0.041]
    m = stats.window_metrics(0.0, calls, done)
    assert m["frame_ms"] == pytest.approx(41.0 / 4)
    gaps = [15.0, 7.0, 18.0, 1.0]
    assert m["frame_ms_p95"] == pytest.approx(float(np.percentile(gaps, 95)))
    lat = [15.0, 12.0, 20.0, 11.0]
    assert m["latency_ms_p95"] == pytest.approx(float(np.percentile(lat, 95)))


def test_percentile_matches_numpy():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 100, 1001):
        v = rng.exponential(size=n).tolist()
        for q in (0, 50, 95, 100):
            assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_idle_share_on_intervals():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 10.0)]
    assert stats.union_length(spans) == pytest.approx(5.0)
    assert stats.idle_gaps(spans, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    events = [dict(ph="X", cat="user_annotation", name="rtbench.frame",
                   ts=0.0, dur=4.0),
              dict(ph="X", cat="user_annotation", name="rtbench.frame",
                   ts=4.0, dur=4.0),
              dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize",
                   ts=6.5, dur=2.0)]
    events += [dict(ph="X", cat="kernel", name=f"void k{i}<1>(int)",
                    ts=s, dur=e - s) for i, (s, e) in enumerate(spans)]
    t = read_trace(events)
    assert t["window_s"] == pytest.approx(10e-6)
    assert t["busy_s"] == pytest.approx(5e-6)
    idle = registry.metric_reader("device_idle_share")(t)
    assert idle == pytest.approx(50.0)
    assert t["breakdown"]["idle_gaps"][0] == ["cudaStreamSynchronize",
                                              pytest.approx(3e-6)]
    assert t["breakdown"]["device_ops"][0][0] == "k0<1>"


def test_k3_k4_counts_by_hand():
    w, h = 16, 8
    work = roofline.kernel_work(w, h, 9, 3, 1, {})
    n = w * h
    k3_ops = (127 + 9 * (121 + 3 * (18 + 2 * 51))) * n
    mips = (16 * 8 + 8 * 4 + 4 * 2 + 2 * 1 + 1 * 0) * 4
    k3_bytes = mips + 12 * n + 2 * n
    assert work["k3"] == pytest.approx(
        max(k3_ops / 67e12, k3_bytes / 3.35e12) * 1e3)
    assert work["k4"] == pytest.approx(
        max(71 * n / 67e12, (2 * n + 4 * n) / 3.35e12) * 1e3)
    trace = dict(kernel_least_ms=work, kernels=[
        ("void (anonymous namespace)::gtao_main_kernel<false>()", 1e-6)] * 2)
    assert roofline.share("k3", trace) == pytest.approx(
        100 * work["k3"] / 1e-3)
    assert roofline.share("k1", trace) is None


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(RTBENCH / "run.py"), "--workload",
         "bench43k.orbit-1080", "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout == ""


def _run(tiny, workload, trace=False, fault=None, seconds=0.3):
    root, bench = tiny
    import time

    return run(workload, 2 ** 31 + 77, seconds, trace, t_start=
               time.perf_counter(), device="cpu", root=root, bench=bench,
               fault=fault)[0]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny, trace):
    res = _run(tiny, "tiny.orbit", trace)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2
    names = set(res["metrics"])
    if trace:
        assert {"enqueue_ms", "pass_ms.shade"} <= names
    else:
        assert names == {"frame_ms", "frame_ms_p95", "latency_ms_p95",
                         "device_mem_gib", "setup_s"}
    for c in res["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


def _stale():
    prev = {}

    def fault(j, out):
        got = prev.get("out", out)
        prev["out"] = out
        return got
    return fault


def _half(j, out):
    out = dict(out)
    h = out["image"].shape[0] // 2
    out["image"] = out["image"].clone()
    out["image"][h:] = 0
    out["depth"] = out["depth"].clone()
    out["depth"][h:] = 10000.0
    return out


def _altered(j, out):
    return dict(out, image=torch.clamp(out["image"].to(torch.int32) + 8, 0,
                                       255).to(torch.uint8))


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("workload", ["tiny.orbit", "tiny.rebuild"])
def test_broken_timed_path_is_incorrect(tiny, workload, fault):
    f = dict(stale=_stale(), half=_half, altered=_altered)[fault]
    res = _run(tiny, workload, fault=f)
    assert res["correct"] is False
    assert res["failed"] >= 1


def test_control_fails_the_limits(tiny):
    """The control: the reference in bfloat16 in the program's place."""
    root, bench = tiny
    sys.path.insert(0, str(RTBENCH))
    from control import readings
    from rtbench.harness import correct

    for workload in ("tiny.orbit", "tiny.aniso16"):
        r = readings(workload, 5, 0.3, True, device="cpu", root=root,
                     bench=bench)
        limits = registry.limits(workload, root)
        ok_prog, _ = correct.verdict(correct.worst(r["program"]), limits)
        ok_ctl, _ = correct.verdict(correct.worst(r["control"]), limits)
        assert ok_prog and not ok_ctl


@pytest.mark.gpu
def test_one_short_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(RTBENCH / "run.py"), "--workload",
         "bench43k.orbit-1080", "--seed", str(2 ** 31 + 3), "--seconds", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
