"""The K9 readers (metrics/k9_ms.py, metrics/k9_roofline.py) on synthetic
device traces: no launch of ``mip_texels_kernel`` reads None (the parent
of the kernel, an untextured cell), a known duration reads its mean and
the hand-computed roofline share, the counts behind the share, and the
roofline reader's refusal where BENCHMARK.json does not name its one
cell."""
import pytest

from tiny import REPO  # noqa: F401  (puts the checkout on sys.path)

from rtbench.harness import registry

CELL = "textures292k.orbit-aniso16-1080"
K9 = ("void (anonymous namespace)::mip_texels_kernel<1>(Hits, Tier, int, "
      "int, float*, float*, float*)")
# K9's row indices for a gather hook: not the fetch's launch
ROWS = ("void (anonymous namespace)::mip_texel_rows_kernel<1>(Hits, Tier, "
        "int, int, int*)")


def _trace(*kernels):
    return dict(kernels=list(kernels), busy_s=1.0, window_s=2.0)


@pytest.mark.parametrize("name", ["k9_ms", "k9_roofline"])
def test_no_launch_reads_none(name):
    read = registry.metric_reader(name)
    assert read(_trace()) is None
    assert read(_trace(("bvh8_closest_kernel<48, false>", 1e-3),
                       ("gtao_main_kernel<9, 3>", 2e-4))) is None
    assert read({}) is None


def test_k9_ms_is_the_mean_launch():
    read = registry.metric_reader("k9_ms")
    got = read(_trace((K9, 1.0e-3), ("bvh8_any_kernel<48>", 5e-3),
                      (ROWS, 9e-3), (K9, 1.5e-3)))
    assert got == pytest.approx(1.25)


def _reader_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "k9_roofline", registry.ROOT / "metrics" / "k9_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k9_roofline_by_hand():
    """1920 x 1080 at 16 taps: 148 bytes and 4 + 16 x (2 x (10 + 12 x 10)
    + 12 x 3 + 4) + 12 x 15 + 12 = 4,996 operations a pixel; operations
    bound it (0.3092 ms at 33.5 T unfused operations a second beside
    0.0916 ms of bytes at 3.35 TB/s)."""
    traffic = registry.traffic(registry.cell(registry.benchmark(),
                                             CELL)["traffic"])
    assert (traffic["width"], traffic["height"],
            traffic["aniso_taps"]) == (1920, 1080, 16)
    n = 1920 * 1080
    ops = n * 4996
    nbytes = n * 148
    least = max(nbytes / 3.35e12, ops / 33.5e12) * 1e3
    assert least == pytest.approx(ops / 33.5e12 * 1e3)
    assert least == pytest.approx(0.30925, rel=1e-4)
    assert _reader_module().cell_size() == (1920, 1080, 16)
    read = registry.metric_reader("k9_roofline")
    got = read(_trace((K9, 1.0e-3), ("bvh8_any_kernel<48>", 5e-3),
                      (K9, 1.0e-3)))
    assert got == pytest.approx(100.0 * least / 1.0)


def test_k9_counts_by_tap():
    """One tap is the trilinear fetch alone: the LOD's 4 operations, 2 x
    130 for the levels' bilinear samples and 36 for the lerp between
    them, with no uv offset, sum or division; 4 taps add each tap's uv,
    3 sums and the division per channel."""
    mod = _reader_module()
    assert mod.pixel_ops(1) == 300
    assert mod.pixel_ops(4) == 4 + 4 * 300 + 3 * 12 + 12
    assert mod.work(10, 10, 1) == (100 * 148, 100 * 300)
    assert mod.work(10, 10, 16) == (100 * 148, 100 * 4996)


@pytest.mark.parametrize("cells", [[], [CELL, "bench43k.orbit-1080"]])
def test_k9_roofline_refuses_to_guess_the_cell(tmp_path, cells):
    """Listed for no cell (every cell) or for two, the reader cannot tell
    which cell's size a trace has, and raises instead of reading one."""
    import json
    import shutil

    root = tmp_path / "rtbench"
    shutil.copytree(registry.ROOT / "metrics", root / "metrics")
    shutil.copytree(registry.ROOT / "traffic", root / "traffic")
    bench = registry.benchmark()
    for m in bench["per_layer"]:
        if m["name"] == "k9_roofline":
            if cells:
                m["workloads"] = cells
            else:
                m.pop("workloads")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    read = registry.metric_reader("k9_roofline", root)
    assert read(_trace()) is None
    with pytest.raises(ValueError, match="k9_roofline"):
        read(_trace((K9, 1.0e-3)))
