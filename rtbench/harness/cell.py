"""One run of one cell: set-up, warm-up, the measured window (or the traced
one), the check against the plain reference, and the result line.

Set-up builds the scene from the seed, the renderer, its first flatten and
upload, and warms up with the cell's own frames through the cell's own
call (``warmup_frames`` of the traffic mix), so that every kernel is built
and every shape seen before the window. ``setup_s`` runs from the
process's start to the window's start.

The window is the same in every cell: before each call the frame's camera
pose is set (and, with an animation, its transforms handed to the call),
then the cell's entry runs with up to ``depth`` frames in flight
(``window.py``). The camera path stays within the residency distance of
every model (checked over a whole period before the window), and the
resident set may not change in the window (checked after it).

A traced run measures no end-to-end metric. Its window calls
``Renderer.render_passes`` with a CUDA event pair per pass (the rebuild
cell's ``render_dynamic`` has no step hook and runs as it is), stamps each
call on the host clock, and then profiles ``profile_frames`` more frames
with ``torch.profiler``.
"""
from __future__ import annotations

import gc
import time
from pathlib import Path

import torch

from ..scenes import build_models, triangle_count
from . import correct, program, registry, roofline
from .path import FramePath
from .traced import FRAME_RANGE, PassEvents, profile_frames
from .window import Sample, run_frames

TRACE_DIR = Path(__file__).resolve().parents[2] / ".rtbench_trace"


class Cell:
    def __init__(self, workload: str, seed: int, *, root=registry.ROOT,
                 bench=None, device="cuda"):
        bench = registry.benchmark() if bench is None else bench
        self.spec = registry.cell(bench, workload)
        self.seed = int(seed)
        self.config = registry.config(self.spec["config"], root)
        self.traffic = registry.traffic(self.spec["traffic"], root)
        self.limits = registry.limits(workload, root)
        self.device = torch.device(device)
        self.log = []

    def say(self, msg: str):
        self.log.append(msg)

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        tr = self.traffic
        self.models = build_models(self.config, self.seed)
        tris = triangle_count(self.models)
        if tris != self.config["triangles"]:
            raise RuntimeError(f"{tris} triangles, the configuration states "
                               f"{self.config['triangles']}")
        self.path = FramePath(tr, self.seed)
        r = program.build_renderer(self.config, tr, self.models,
                                   self.path.pose(0), str(self.device))
        far = program.out_of_reach(
            r, [self.path.pose(i) for i in range(self.path.period)])
        if far:
            raise RuntimeError(f"the camera path leaves the residency "
                               f"distance: {far[:3]}")
        self.renderer = r
        self.rays_per_frame = r.stats()["rays_per_frame"]
        self.base = (program.rest_transforms(r)
                     if tr.get("animation") else None)
        self.dynamic = tr["entry"] == "render_dynamic"
        if tr["entry"] not in ("render", "render_dynamic"):
            raise ValueError(f"unknown entry {tr['entry']!r}")
        self.next_frame = 0
        before = program.launch_counts()
        warm = int(tr["warmup_frames"])
        run_frames(self._render_call(), warm, int(tr["depth"]), self.device,
                   timed=False)
        self.sync()
        self.scene0 = r.scene
        after = program.launch_counts()
        self.say("kernel launches per warm-up frame (the path): " + ", ".join(
            f"{k} {(after[k] - before[k]) / warm:g}" for k in sorted(after)
            if after[k] != before[k]))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prepare(self, k: int):
        program.set_pose(self.renderer, self.path.pose(k))
        return self.path.transforms(k, self.base)

    def _render_call(self, fault=None):
        """call(j) of the cell's entry for frames from self.next_frame."""
        first = self.next_frame
        r = self.renderer

        def call(j):
            k = first + j
            tf = self._prepare(k)
            if self.dynamic:
                out = r.render_dynamic(tf, refit=False, block=False)
            else:
                out = r.render(block=False)
            self.next_frame = k + 1
            return out if fault is None else fault(j, out)
        return call

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float, fault=None) -> dict:
        """The untraced window: the end-to-end metrics' stamps."""
        tr = self.traffic
        self.noise0 = self.renderer.noise_index
        self.first = self.next_frame
        self.sample = Sample(int(tr["check_frames"]), self.seed)
        start, calls, done, _ = run_frames(
            self._render_call(fault), seconds, int(tr["depth"]),
            self.device, timed=True, on_done=self.sample.offer)
        self._after_window()
        return dict(start=start, calls=calls, done=done)

    def traced_window(self, seconds: float, fault=None) -> dict:
        """The traced window (pass events, enqueue times) and the profiled
        frames after it."""
        tr = self.traffic
        r = self.renderer
        self.noise0 = r.noise_index
        self.first = self.next_frame
        self.sample = Sample(int(tr["check_frames"]), self.seed)
        passes = {}
        if self.dynamic:
            call = self._render_call(fault)
        else:
            def call(j):
                k = self.first + j
                self._prepare(k)
                ev = PassEvents(self.device)
                out = r.render_passes((self.noise0 + j) % 64, ev.step)
                self.next_frame = k + 1
                out = out if fault is None else fault(j, out)
                return dict(out, _events=ev)

        def done(j, out):
            ev = out.pop("_events", None)
            if ev is not None:
                for name, ms in ev.ms().items():
                    passes.setdefault(name, []).append(ms)
            self.sample.offer(j, out)

        _, _, _, enqueue = run_frames(call, seconds, int(tr["depth"]),
                                      self.device, timed=True, on_done=done)
        self._after_window()
        n_window = self.next_frame - self.first
        prof = self._profile(n_window)
        return dict(enqueue_ms=[e * 1e3 for e in enqueue], pass_ms=passes,
                    frames=n_window, **prof)

    def _profile(self, n_window: int) -> dict:
        from torch.profiler import record_function

        tr = self.traffic
        r = self.renderer
        first = self.next_frame
        noise0 = (self.noise0 + n_window) % 64

        def call(j):
            with record_function(FRAME_RANGE):
                k = first + j
                tf = self._prepare(k)
                if self.dynamic:
                    return r.render_dynamic(tf, refit=False, block=False)
                return r.render_passes((noise0 + j) % 64)

        def run():
            run_frames(call, int(tr["profile_frames"]), int(tr["depth"]),
                       self.device, timed=False)
            self.sync()

        if self.device.type != "cuda":
            run()
            return {}
        prof = profile_frames(run, TRACE_DIR)
        c = self.config["renderer"]["gtao"]
        n_pass = max(int(c["denoise"]) - 1, 0) + 1
        tables = (dict(bvh2_tris=self.config["triangles"]) if self.dynamic
                  else {k: r.scene_device[k].numel()
                        * r.scene_device[k].element_size()
                        for k in ("nodes8c", "tris")})
        prof["kernel_least_ms"] = roofline.kernel_work(
            int(tr["width"]), int(tr["height"]), int(c["slice_count"]),
            int(c["steps_per_slice"]), n_pass, tables)
        return prof

    def _after_window(self):
        self.sync()
        if self.renderer.scene is not self.scene0:
            raise RuntimeError("the resident set changed in the window")

    # -- the check ----------------------------------------------------------------

    def release(self) -> list:
        """Free the program's state; returns the sampled frames [(j,
        outputs)] in window order."""
        frames = sorted(self.sample.items, key=lambda f: f[0])
        self.renderer = None
        self.sample = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return frames

    def reference(self, dtype=torch.float32):
        from ..reference.frame import Reference

        rc = self.config["renderer"]
        return Reference(self.models, self.config["lights"],
                         mipmaps=bool(rc["mipmaps"]), gtao=rc["gtao"],
                         device=self.device, dtype=dtype)

    def reference_frame(self, ref, j: int) -> dict:
        """The reference's frame for window frame j: its pose, noise index
        and transforms."""
        tr = self.traffic
        k = self.first + j
        pos, direction = self.path.pose(k)
        return ref.frame(pos, direction, width=int(tr["width"]),
                         height=int(tr["height"]),
                         noise_index=(self.noise0 + j) % 64,
                         aniso_taps=int(tr["aniso_taps"]),
                         transforms=self.path.transforms(k, self.base))

    def check(self) -> tuple:
        """Free the program's state, then compare the sampled frames with
        the reference's: (correct, checks, numbers per frame)."""
        frames = self.release()
        ref = self.reference()
        per_frame = [dict(correct.frame_numbers(out, self.reference_frame(
            ref, j)), frame=self.first + j) for j, out in frames]
        ok, checks = correct.verdict(correct.worst(per_frame), self.limits)
        return ok, checks, per_frame


def device_info(device) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", root=registry.ROOT, bench=None,
        fault=None) -> tuple:
    """One run: (the result line's object, checks last; the cell, whose
    ``log`` holds the lines for standard error). fault(j, outputs), the
    tests' hook, replaces each window frame's outputs."""
    cell = Cell(workload, seed, root=root, bench=bench, device=device)
    cell.setup()
    setup_s = time.perf_counter() - t_start
    if trace:
        measured = cell.traced_window(seconds, fault)
        attempted = measured["frames"]
    else:
        measured = cell.window(seconds, fault)
        attempted = len(measured["done"])
    dev = device_info(cell.device)
    metrics = {}
    if trace:
        measured["roofline_share"] = lambda k: roofline.share(k, measured)
        if "busy_s" in measured:
            dev.update(busy_s=measured["busy_s"],
                       window_s=measured["window_s"])
        for m in cell.spec["per_layer"]:
            value = registry.metric_reader(m["name"], root)(measured)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        from .stats import window_metrics

        e2e = window_metrics(measured["start"], measured["calls"],
                             measured["done"])
        e2e["device_mem_gib"] = dev["memory_peak_bytes"] / 2 ** 30
        e2e["setup_s"] = setup_s
        for m in cell.spec["end_to_end"]:
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
        cell.say(f"frames {attempted}, setup_s {setup_s:.3f}, "
                 f"Mrays/s {cell.rays_per_frame / e2e['frame_ms'] / 1e3:.2f}")
    t_check = time.perf_counter()
    ok, checks, per_frame = cell.check()
    cell.say(f"check took {time.perf_counter() - t_check:.2f} s")
    for f in per_frame:
        cell.say("checked frame " + ", ".join(
            f"{k} {v:.6g}" for k, v in f.items()))
    result = dict(correct=ok, attempted=attempted,
                  failed=sum(1 for f in per_frame if not all(
                      f[k] <= checks[k]["limit"] for k in checks)),
                  metrics=metrics, device=dev)
    if trace and "breakdown" in measured:
        result["breakdown"] = measured["breakdown"]
    result["checks"] = checks
    return result, cell
