"""The slice as a whole, tpurt's traversal switches through
``Renderer.render()``: ``POP2_DEFAULT`` (K7b closest and any) and
``UVP_DEFAULT`` (K7c) against tpurt's frames composed from its passes with
``pop2=True`` / ``uv_payload=True``, and against the port's default frame
(tests/torch_frames.py has the composition and the bars).
"""
import numpy as np
import pytest

import torch_frames as tf
from torch_parity import same_host_builder  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    ref_r, port_r = tf.renderers()
    mp = pytest.MonkeyPatch()
    try:
        got = dict(default=tf.port_render(port_r, mp),
                   pop2=tf.port_render(port_r, mp, POP2_DEFAULT=True),
                   uvp=tf.port_render(port_r, mp, UVP_DEFAULT=True))
    finally:
        mp.undo()
    ref = dict(pop2=tf.ref_frame(ref_r, pop2=True),
               uvp=tf.ref_frame(ref_r, uv_payload=True))
    return dict(ref=ref, got=got, port_r=port_r)


@pytest.mark.parametrize("variant", ["pop2", "uvp"])
def test_variant_matches_tpurt(variant, frames):
    ref, grazing = frames["ref"][variant]
    tf.check_image(frames["got"][variant], ref, grazing)


def test_uvp_frame_equals_default_frame(frames):
    np.testing.assert_array_equal(frames["got"]["uvp"],
                                  frames["got"]["default"])


def test_pop2_frame_matches_default_frame(frames):
    tf.check_image(frames["got"]["pop2"], frames["got"]["default"])


def test_switches_are_restored(frames):
    from tpurt_torch.kernels import traverse_bvh8 as tb

    assert tb.POP2_DEFAULT is False and tb.UVP_DEFAULT is False
    assert "texu" not in tb.trace_closest_bvh8(
        frames["port_r"].scene_device,
        *[x[:4] for x in _rays(frames["port_r"])], 0.001, 10000.0)


def _rays(port_r):
    from tpurt_torch.engine import convert
    from tpurt_torch.passes.rays import camera_rays

    c = port_r.config
    cam = convert.camera_tensors(port_r.camera.uniform(), "cpu")
    return camera_rays(cam, c.width, c.height)
