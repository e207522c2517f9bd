"""Jittered and banded camera rays, the R2 anti-aliasing offsets and the
banded G-buffer: the port against tpurt, and the bands against the whole
frame.

Tolerances: the rays' origins equal, directions within 2e-7 (ROADMAP F7:
XLA:CPU folds the NDC division into a reciprocal multiply and contracts
parts of the products into FMAs); the jitters bit for bit (both are the
same float64 numpy cast to f32); the bands bit for bit (the port against
itself: every op is per ray).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ground_truth import SIZE, renderers
from torch_parity import camera

JITTERS = [None, (0.25, -0.3125), (-0.49, 0.4375)]
BANDS = [(0, None), (0, 12), (12, 20)]


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("jitter", JITTERS)
def test_camera_rays_match(jitter, band):
    from tpurt.passes.rays import camera_rays as ref_rays
    from tpurt_torch.engine import convert
    from tpurt_torch.passes.rays import camera_rays

    h, w = 32, 40
    row_start, num_rows = band
    uni = camera(w, h).uniform()
    jit = None if jitter is None else np.asarray(jitter, np.float32)
    o_r, d_r = ref_rays({k: jnp.asarray(v) for k, v in uni.items()}, w, h,
                        row_start=row_start, num_rows=num_rows,
                        jitter=None if jit is None else jnp.asarray(jit))
    cam = convert.camera_tensors(uni, "cpu")
    o_p, d_p = camera_rays(cam, w, h, row_start, num_rows,
                           jitter=None if jit is None else tuple(
                               float(v) for v in jit))
    rows = h if num_rows is None else num_rows
    assert d_p.shape == o_p.shape == (rows * w, 3)
    np.testing.assert_array_equal(o_p.numpy(), np.asarray(o_r))
    assert np.abs(d_p.numpy() - np.asarray(d_r)).max() <= 2e-7
    if jit is not None:
        # a 2-element tensor gives the floats' rays
        o_t, d_t = camera_rays(cam, w, h, row_start, num_rows,
                               jitter=torch.from_numpy(jit))
        assert torch.equal(o_t, o_p) and torch.equal(d_t, d_p)


@pytest.mark.parametrize("spp", [1, 3, 9])
def test_aa_jitters_bit_equal(spp):
    from tpurt.engine.frame import _aa_jitters as ref_jitters
    from tpurt_torch.engine.frame import SPP_UNROLL, _aa_jitters

    got, ref = _aa_jitters(spp), np.asarray(ref_jitters(spp))
    assert got.dtype == ref.dtype == np.float32 and got.shape == (spp, 2)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert not got[0].any() and SPP_UNROLL == 4
    assert (np.abs(got) <= 0.5).all()


@pytest.fixture(scope="module")
def port_r():
    return renderers()[1]


@pytest.mark.parametrize("spp", [1, 3])
def test_gbuffer_bands_equal_whole(port_r, spp):
    """The G-buffer traced as two bands of rows, concatenated, equals the
    whole frame's bit for bit (each band's traces run their own 16x8
    tiles; the band rows' y uses the whole image's height)."""
    from tpurt_torch.engine.frame import render_gbuffer

    scene = port_r.scene_device
    cam, lights, _ = port_r._frame_inputs()
    kw = dict(width=SIZE, height=SIZE, spp=spp)
    whole = render_gbuffer(scene, cam, lights, **kw)
    parts = [render_gbuffer(scene, cam, lights, row_start=r0, num_rows=n,
                            **kw) for r0, n in ((0, 12), (12, SIZE - 12))]
    for key in ("color", "depth", "normal_enc"):
        got = torch.cat([p[key] for p in parts])
        assert got.shape == whole[key].shape
        assert torch.equal(got.view(torch.int32),
                           whole[key].view(torch.int32)), key
    assert (whole["depth"] < 9999.0).float().mean() > 0.3
