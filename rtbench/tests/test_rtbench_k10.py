"""The K10 reader (metrics/k10_ms.py) on synthetic device traces: no
launch of ``shade_surface_kernel`` reads None (the parent, whose surface
is the torch chain), and with the kernel and its epilogue traced the
reading is their summed time over the kernel's launches, one a frame."""
import pytest

from tiny import REPO  # noqa: F401  (puts the checkout on sys.path)

from rtbench.harness import registry

K10 = ("void (anonymous namespace)::shade_surface_kernel<0, false>(Hits, "
       "Quad, Out, int, float)")
K10_MIP = ("void (anonymous namespace)::shade_surface_kernel<2, false>("
           "Hits, Quad, Out, int, float)")
NMAP = ("void (anonymous namespace)::shade_surface_nmap_kernel<0>(float "
        "const*, unsigned char const*, float const*, Out, int)")
K9 = ("void (anonymous namespace)::mip_texels_kernel<1>(Hits, Tier, int, "
      "int, float*, float*, float*)")


def _trace(*kernels):
    return dict(kernels=list(kernels), busy_s=1.0, window_s=2.0)


def test_no_launch_reads_none():
    read = registry.metric_reader("k10_ms")
    assert read(_trace()) is None
    assert read({}) is None
    assert read(_trace(("at::native::vectorized_gather_kernel<16, long>",
                        2.5e-3), (K9, 1.4e-3))) is None


@pytest.mark.parametrize("frames", [1, 3])
def test_sum_over_the_main_launches(frames):
    read = registry.metric_reader("k10_ms")
    quad = [(K10, 4e-4)] * frames + [("bvh8_any_kernel<48>", 5e-3)]
    assert read(_trace(*quad)) == pytest.approx(0.4)
    mip = [(K10_MIP, 3e-4), (K9, 1.4e-3), (NMAP, 1e-4)] * frames
    assert read(_trace(*mip)) == pytest.approx(0.4)


def test_listed_for_both_cells():
    """k10_ms is read in both cells, and moves frame_ms."""
    metric = next(m for m in registry.benchmark()["per_layer"]
                  if m["name"] == "k10_ms")
    assert metric["moves"] == "frame_ms"
    assert metric["workloads"] == ["bench43k.orbit-1080",
                                   "textures292k.orbit-aniso16-1080"]
