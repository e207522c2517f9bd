"""k9_roofline: the least time of one K9 launch (the texel fetch,
``mip_texels_kernel``) over its mean traced time, in %; None where no
launch was traced.

The least time is the larger of the fetch's bytes at 3.35 TB/s
(``harness/roofline.py``'s peak) and its f32 operations at 33.5 T a
second: the H100 SXM's 67 TFLOP/s counts a fused multiply-add as two
operations, and the port's kernels are built without fused multiply-adds
(``--fmad=false``), so every operation is one instruction of the 132 SMs'
128 f32 lanes a clock. Both are counted from the task and not from the
kernel that does it, for a frame of the cell's width x height at its taps:

* bytes: each pixel's inputs, read once (hit t, ray direction, shading
  normal, the triangle's three corners and three uvs, the interpolated uv
  and the primitive: 100 bytes) and its 48-byte output (12 f32). The
  texel rows are not counted: how many are distinct depends on the view,
  and a count of them could read over 100%.
* operations: the filter's f32 arithmetic as the per-layer definition
  ``passes/shade.sample_trilinear`` does it, with what the three layers
  share counted once: the LOD's two levels and fraction once a pixel
  (``LOD_OPS``); per tap, its uv (``TAP_OPS``, with more than one tap);
  per tap and level, the texel coordinates and lerp weights
  (``COORD_OPS``) and each of the 12 channels' bilinear lerp
  (``BILINEAR_OPS``); per tap and channel, the lerp between the levels
  (``TRILERP_OPS``); the running sum's additions and the division by the
  taps. The footprint's arithmetic, once a pixel, is not counted.

The cell is the one ``BENCHMARK.json`` lists the metric for, its size read
from its traffic file in the benchmark folder that holds this reader. A
second cell needs the harness to size K9 for the traced cell
(``harness/roofline.kernel_work``); until then the reader refuses to
guess.
"""
from pathlib import Path

from rtbench.harness import registry

KERNEL = "mip_texels_kernel"
NAME = "k9_roofline"
# the benchmark folder this reader belongs to (the harness's `root`)
ROOT = Path(__file__).resolve().parents[1]
PEAK_BYTES_PER_S = 3.35e12
# f32 instructions a second, none fused: 132 SMs x 128 lanes x 1.98 GHz
PEAK_UNFUSED_PER_S = 33.5e12
CHANNELS = 12                      # three layers of four
# bytes a pixel: t 4, direction 12, normal 12, corners 36, uvs 24, the
# interpolated uv 8, the primitive 4; the output 48
INPUT_BYTES = 100
OUTPUT_BYTES = 48
# _lod_levels: the clamp, the floor, the fraction; _trilerp's 1 - frac
LOD_OPS = 4
# uv + duv * f: two products, two sums
TAP_OPS = 4
# _texel_coords: px and py (a product and a difference each), two
# floors, fx and fy; _bilerp's 1 - fx and 1 - fy
COORD_OPS = 4 + 2 + 2 + 2
# _bilerp per channel: four products and two sums along x, the products
# by 1 - fy and fy and their sum, the division by 255
BILINEAR_OPS = 10
# _trilerp per channel: two products, a sum
TRILERP_OPS = 3


def pixel_ops(taps: int) -> int:
    """The filter's f32 operations for one pixel at `taps` taps."""
    per_tap = (2 * (COORD_OPS + CHANNELS * BILINEAR_OPS)
               + CHANNELS * TRILERP_OPS)
    if taps <= 1:
        return LOD_OPS + per_tap
    # the sum's taps - 1 additions and the division, per channel
    return (LOD_OPS + taps * (per_tap + TAP_OPS)
            + CHANNELS * (taps - 1) + CHANNELS)


def work(width: int, height: int, taps: int) -> tuple:
    """(bytes, f32 operations) of one launch over width x height pixels."""
    n = width * height
    return n * (INPUT_BYTES + OUTPUT_BYTES), n * pixel_ops(taps)


def least_ms(width: int, height: int, taps: int) -> float:
    nbytes, ops = work(width, height, taps)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_UNFUSED_PER_S) * 1e3


def cell_size(root: Path = ROOT) -> tuple:
    """(width, height, taps) of the one cell BENCHMARK.json lists this
    metric for; raises when it lists none or several."""
    bench = registry.benchmark(root.parent / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    cells = entry.get("workloads", [])
    if len(cells) != 1:
        raise ValueError(f"{NAME}: sized for one listed cell, BENCHMARK.json "
                         f"lists {cells or 'every cell'}; size K9 in "
                         f"harness/roofline.kernel_work instead")
    traffic = registry.traffic(registry.cell(bench, cells[0])["traffic"],
                               root)
    return (int(traffic["width"]), int(traffic["height"]),
            int(traffic["aniso_taps"]))


def read(trace):
    launches = [d for name, d in trace.get("kernels", []) if KERNEL in name]
    if not launches:
        return None
    return 100.0 * least_ms(*cell_size()) / (1e3 * sum(launches)
                                              / len(launches))
