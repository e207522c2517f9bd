"""``gtao_debug_image`` (the debug build's RGBA16F target) against tpurt's,
in its three modes, as a function on a seeded G-buffer (exact, bent and
fp16 settings for "ao") and as ``Renderer.gtao_debug_image`` on the cut
bench scene's 32x32 frame.

Budgets: f16 images equal, except "ao", whose value is the main pass's
visibility: within one f16 step of 1/510 (one u8 step of the working term,
halved and offset by 0.5, lands in the f16 spacing of [0.5, 1)) on <=
0.1% of pixels (the main pass's budget, F7; measured: equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gtao import _gbuffer
from torch_parity import same_host_builder  # noqa: F401

SETTINGS = {"exact": {}, "bent": dict(bent_normals=True),
            "fp16": dict(precision="fp16")}


def _assert_image(got, want, mode):
    assert got.dtype == np.float16 and got.shape == want.shape
    if mode != "ao":
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert d.max() <= 1 / 510 + 2 ** -11, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


@pytest.mark.parametrize("mode,variant", [("normals", "exact"),
                                          ("edges", "exact"),
                                          ("edges", "fp16"),
                                          ("ao", "exact"), ("ao", "bent"),
                                          ("ao", "fp16")])
def test_debug_image_matches(mode, variant):
    from tpurt.passes import gtao as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.passes import gtao

    h, w = 40, 48
    depth, normal = _gbuffer(h, w, seed=7)
    consts = ref.gtao_constants(w, h, 0.1, 100.0, np.pi / 2, w / h)
    kw = dict(slice_count=3, steps_per_slice=3, **SETTINGS[variant])
    want = np.asarray(ref.gtao_debug_image(
        jnp.asarray(depth), jnp.asarray(normal), consts,
        ref.GtaoSettings(**kw), jnp.int32(9), mode))
    got = gtao.gtao_debug_image(torch.tensor(depth), torch.tensor(normal),
                                convert.gtao_tensors(consts, "cpu"),
                                gtao.GtaoSettings(**kw),
                                gtao.noise_maps_64(9, "cpu"), mode).numpy()
    _assert_image(got, want, mode)
    assert got[..., :3].std() > 0


def test_debug_image_refuses_unknown_mode():
    from tpurt_torch.passes import gtao

    with pytest.raises(ValueError):
        gtao.gtao_debug_image(torch.ones(8, 8), torch.ones(8, 8, 3),
                              None, gtao.GtaoSettings(),
                              gtao.noise_maps_64(0, "cpu"), "depth")


@pytest.fixture(scope="module")
def renderers():
    from torch_ground_truth import renderers as make

    ref_r, port_r = make()
    out = ref_r.render(), port_r.render()
    return ref_r, port_r, out


@pytest.mark.parametrize("mode", ["normals", "edges", "ao"])
def test_renderer_debug_image(mode, renderers):
    """Renderer.gtao_debug_image after a frame (noise index max(frame - 1,
    0) % 64), given tpurt's frame's depth and normals (the two frames'
    depths differ by one R16F step on a few pixels, tests/test_torch_aa.py),
    and not given a frame."""
    ref_r, port_r, (ref_out, _) = renderers
    want = np.asarray(ref_r.gtao_debug_image(mode, out=ref_out))
    same = {k: torch.tensor(np.asarray(ref_out[k]))
            for k in ("depth", "normal")}
    got = port_r.gtao_debug_image(mode, out=same).numpy()
    _assert_image(got, want, mode)
    if mode == "ao":
        fresh = port_r.gtao_debug_image(mode).numpy()
        assert fresh.shape == got.shape and port_r.rendered_frames == 2
