"""The whole frame: the port's Renderer against tpurt's at 64x64 on a cut
bench scene (3x3 box field, ground plane, 2 textured cubes, the bench's
three shadow-casting lights, GTAO ULTRA + sharp denoise, LPM).

tpurt runs with ``tracer="bvh8"`` (on the CPU its "auto" never reaches the
Pallas kernels), which also routes GTAO through its Pallas main pass and
denoise chain, all in interpret mode. The port runs its plain versions.

Tolerances, from what differs between the two programs: rays differ in the
last bits (XLA:CPU contracts parts of them into FMAs), and the shading
transcendentals (pow, acos) come from different libraries. The frames
measure bit-identical on this scene; the bars leave room for a single
flipped hit or rounding: depth and normal bits equal on >= 99.9% of
pixels, the image u8 equal on >= 99.9% and never off by more than 2.
"""
import numpy as np
import pytest

from torch_parity import same_host_builder  # noqa: F401

SIZE = 64
FIELD = dict(nx=3, nz=3, subdiv=2)
CUBES = 2


@pytest.fixture(scope="module")
def frames():
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    ref_r = build_bench_scene(
        RefRenderer(RefConfig(width=SIZE, height=SIZE, tracer="bvh8")),
        field=FIELD, cubes=CUBES)
    ref = {k: np.asarray(v) for k, v in ref_r.render().items()}
    port_r = build_bench_scene(
        Renderer(RendererConfig(width=SIZE, height=SIZE, device="cpu")),
        field=FIELD, cubes=CUBES)
    got = {k: v.numpy() for k, v in port_r.render().items()}
    return dict(ref=ref, got=got, ref_r=ref_r, port_r=port_r)


def test_image_matches(frames):
    ref, got = frames["ref"]["image"], frames["got"]["image"]
    assert got.shape == ref.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int)).max(-1)
    assert (d == 0).mean() >= 0.999, (d == 0).mean()
    assert d.max() <= 2, d.max()
    assert (got.max(-1) > 0).mean() > 0.3  # not a black frame


@pytest.mark.parametrize("key", ["depth", "normal"])
def test_gbuffer_bits_match(key, frames):
    ref, got = frames["ref"][key], frames["got"][key]
    assert got.shape == ref.shape and got.dtype == np.float32
    same = (got.view(np.uint32) == ref.view(np.uint32))
    if same.ndim == 3:
        same = same.all(-1)
    assert same.mean() >= 0.999, same.mean()


def test_color_and_ao_close(frames):
    ref, got = frames["ref"], frames["got"]
    np.testing.assert_allclose(got["color"], ref["color"], rtol=1e-3,
                               atol=1e-5)
    d = np.abs(got["ao"].astype(int) - ref["ao"].astype(int))
    assert (d > 0).mean() <= 1e-3 and d.max() <= 1
    assert got["ao"].max() > 255  # the unclamped final range


def test_renderer_surface(frames):
    port_r, ref_r = frames["port_r"], frames["ref_r"]
    s, rs = port_r.stats(), ref_r.stats()
    for k in ("resolution", "rays_per_frame", "lights",
              "shadow_casting_lights", "models", "device_resident_models",
              "tris", "primitives", "bvh_nodes", "gtao"):
        assert s[k] == rs[k], k
    assert s["gtao"]["bent_normals"] is False
    assert s["tracer_tier"] == "bvh8" and s["device"] == "cpu"
    img = port_r.render_image()
    assert isinstance(img, np.ndarray) and img.shape == (SIZE, SIZE, 3)
    # the next frame uses the next noise index, like tpurt's
    np.testing.assert_array_equal(img, np.asarray(ref_r.render_image()))
