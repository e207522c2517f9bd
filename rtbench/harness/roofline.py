"""The yardstick of the kernels' rooflines: the published peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W) and the
operations and bytes each hand-written kernel of the frame needs, counted
from the frame's shapes.

A kernel's least time is the larger of its operations over the peak rate
and its bytes over the memory rate; its roofline share is that least time
over the time the device trace gives it. Bytes count each input read once
and each output written once.

* K1 (``bvh8_closest_kernel``), K2 (``bvh8_any_kernel``, one launch per
  shadow-casting light), K6 closest and any hit (``bvh2_trace_kernel``):
  the node and triangle tables once, each ray's origin, direction and
  t_max (28 bytes) and its outputs (16 bytes for a closest hit: t, tri, u,
  v; 1 for an any hit). No operations are counted: they depend on the
  traversal, and the benchmark counts no traversal of its own, so the
  bound is the bytes'.
* K3 (``gtao_main_kernel``): chip_smoke.py's count of the kernel's f32
  operations per pixel (``GTAO_MAIN_OPS``), and its
  depth MIPs, normals and two bytes of output per pixel.
* K4 (``gtao_denoise_kernel``): chip_smoke.py's ``GTAO_DENOISE_WORK`` (71
  operations per pixel and pass) and its bytes: per pass the AO and edges
  in, a byte out, the last pass's int32 out.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# chip_smoke.py: K3's f32 operations per pixel (setup, per slice, per
# step, per side sample) and K4's per pixel and pass
GTAO_MAIN_OPS = (127, 121, 18, 51)
GTAO_DENOISE_OPS = 71

RAY_BYTES = 28          # origin, direction, t_max
CLOSEST_OUT_BYTES = 16  # t, tri, u, v
ANY_OUT_BYTES = 1       # occlusion
BVH2_ROW_BYTES = 64     # nodes2c: one (16,) f32 row per internal node
TRI_ROW_BYTES = 48      # tris: one (12,) f32 row per triangle


def least_ms(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S) * 1e3


def gtao_main_ops(slices: int, steps: int) -> int:
    setup, per_slice, per_step, per_side = GTAO_MAIN_OPS
    return setup + slices * (per_slice + steps * (per_step + 2 * per_side))


def kernel_work(width: int, height: int, slices: int, steps: int,
                denoise_passes: int, tables: dict) -> dict:
    """{kernel: least ms of one launch} for a frame of width x height.
    `tables`: bytes of the static frame's node and triangle tables
    (``nodes8c``, ``tris``) and/or the rebuilt tree's triangle count
    (``bvh2_tris``)."""
    n = width * height
    out = {}
    if "nodes8c" in tables:
        tb = tables["nodes8c"] + tables["tris"]
        out["k1"] = least_ms(tb + n * (RAY_BYTES + CLOSEST_OUT_BYTES))
        out["k2"] = least_ms(tb + n * (RAY_BYTES + ANY_OUT_BYTES))
    if "bvh2_tris" in tables:
        t = tables["bvh2_tris"]
        tb = t * BVH2_ROW_BYTES + t * TRI_ROW_BYTES
        out["k6"] = least_ms(tb + n * (RAY_BYTES + CLOSEST_OUT_BYTES))
        out["k6_any"] = least_ms(tb + n * (RAY_BYTES + ANY_OUT_BYTES))
    mip_px = sum((height >> k) * (width >> k) for k in range(5))
    out["k3"] = least_ms(mip_px * 4 + n * 12 + n * 2,
                         gtao_main_ops(slices, steps) * n)
    p = denoise_passes
    out["k4"] = least_ms(p * 2 * n + (p - 1) * n + 4 * n,
                         p * GTAO_DENOISE_OPS * n)
    return out


# each roofline's kernel in a device trace: a fragment of its name
KERNEL_NAMES = {
    "k1": "bvh8_closest_kernel",
    "k2": "bvh8_any_kernel",
    "k3": "gtao_main_kernel",
    "k4": "gtao_denoise_kernel",
    "k6": "bvh2_trace_kernel<false",
    "k6_any": "bvh2_trace_kernel<true",
}


def share(kernel: str, trace: dict):
    """The roofline share (%) of `kernel` over the profiled frames, or None
    when no launch of it was traced."""
    work = trace.get("kernel_least_ms", {})
    if kernel not in work:
        return None
    frag = KERNEL_NAMES[kernel]
    launches = [d for name, d in trace["kernels"] if frag in name]
    if not launches:
        return None
    return 100.0 * work[kernel] * len(launches) / (sum(launches) * 1e3)
