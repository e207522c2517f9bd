"""Mip-mapped frames: the port's Renderer with ``mipmaps=True`` against
tpurt's at 32x32 on the textures workload cut to size
(``app/textures_scene.py``: a 3x3 material_field with 16-64 texel
textures, the ground plane, sun and spot lights, GTAO ULTRA + sharp), in
two configurations: the quad tier with ``aniso_taps=1`` and the pair tier
(both packages' quad budget patched to 0) with ``aniso_taps=4``. tpurt
runs its default tracer (on the CPU its XLA tracer; the texture path does
not depend on it), with its streaming arena on, as is the port's.

Bars: tests/test_torch_frame.py's for the image (u8 equal on >= 99.9%,
never off by more than 2), the normals (bits equal on >= 99.9%) and the
color (rtol 1e-3, atol 1e-5; the texture path's output). Depth and AO
follow the rays' last bits (ROADMAP F7, as in tests/test_torch_aa.py):
one row of this 32-pixel frame lies on an R16F rounding boundary, so
depth is held to one R16F step with bits equal on >= 99%, and AO to one
u8 step on <= 1% of pixels. Measured in both configurations: color and
normals bit-equal, the image off by 1 on one pixel, depth one step off on
6 pixels of one row, AO one step off on 5 pixels.

The port's banded ``render_gbuffer`` (two bands) equals its whole frame
bit for bit: the ray cone reads the whole image's height.
"""
import numpy as np
import pytest
import torch

from torch_parity import same_host_builder  # noqa: F401

SIZE = 32
FIELD = dict(nx=3, nz=3, subdiv=2, spacing=1.0, extents=(16, 32, 64))
CASES = {"quad-1": ("quad", 1), "pair-4": ("pair", 4)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _renderers(tier: str, taps: int):
    import tpurt.scene.scene as ref_scene
    import tpurt_torch.scene.scene as port_scene
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt_torch.app.textures_scene import build_textures_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    saved = [(m, m.MIP_QUAD_BUDGET_BYTES) for m in (ref_scene, port_scene)]
    try:
        if tier == "pair":
            for m, _ in saved:
                m.MIP_QUAD_BUDGET_BYTES = 0
        ref = build_textures_scene(RefRenderer(RefConfig(
            width=SIZE, height=SIZE, mipmaps=True, aniso_taps=taps)),
            field=FIELD)
        port = build_textures_scene(Renderer(RendererConfig(
            width=SIZE, height=SIZE, mipmaps=True, aniso_taps=taps,
            device="cpu")), field=FIELD)
    finally:
        for m, budget in saved:
            m.MIP_QUAD_BUDGET_BYTES = budget
    return ref, port


@pytest.fixture(scope="module", params=sorted(CASES))
def frames(request):
    tier, taps = CASES[request.param]
    ref_r, port_r = _renderers(tier, taps)
    assert f"tex_mip_{tier}" in port_r.scene_device
    ref = {k: np.asarray(v) for k, v in ref_r.render().items()}
    got = {k: v.numpy() for k, v in port_r.render().items()}
    return dict(ref=ref, got=got, port_r=port_r)


def test_image_and_texture_path_match(frames):
    ref, got = frames["ref"], frames["got"]
    d = np.abs(got["image"].astype(int) - ref["image"].astype(int)).max(-1)
    print(f"image differs on {int((d > 0).sum())} pixels, by at most "
          f"{d.max()}")
    assert got["image"].shape == (SIZE, SIZE, 3)
    assert (d == 0).mean() >= 0.999 and d.max() <= 2
    assert (got["image"].max(-1) > 0).mean() > 0.3
    np.testing.assert_allclose(got["color"], ref["color"], rtol=1e-3,
                               atol=1e-5)
    same = (got["normal"].view(np.uint32)
            == ref["normal"].view(np.uint32)).all(-1)
    assert same.mean() >= 0.999


def test_depth_and_ao_within_a_step(frames):
    ref, got = frames["ref"], frames["got"]
    same = got["depth"].view(np.uint32) == ref["depth"].view(np.uint32)
    steps = np.abs(got["depth"].astype(np.float16).view(np.int16).astype(int)
                   - ref["depth"].astype(np.float16).view(np.int16))
    ao = np.abs(got["ao"].astype(int) - ref["ao"].astype(int))
    print(f"depth differs on {int((~same).sum())} pixels, AO on "
          f"{int((ao > 0).sum())}")
    assert same.mean() >= 0.99 and steps.max() <= 1
    assert (ao > 0).mean() <= 0.01 and ao.max() <= 1


def test_bands_equal_the_whole_frame(frames):
    from tpurt_torch.engine.frame import render_gbuffer

    r = frames["port_r"]
    cam, lights, _ = r._frame_inputs()
    kw = dict(width=SIZE, height=SIZE, aniso_taps=r.config.aniso_taps)
    whole = render_gbuffer(r.scene_device, cam, lights, **kw)
    bands = [render_gbuffer(r.scene_device, cam, lights, row_start=s,
                            num_rows=SIZE // 2, **kw)
             for s in (0, SIZE // 2)]
    for key in ("color", "depth", "normal_enc"):
        assert torch.equal(torch.cat([b[key] for b in bands]), whole[key])
