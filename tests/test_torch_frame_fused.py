"""The slice as a whole, fused shadows: the port's fused-shadow frame (one
K5 launch for all lights) against tpurt's frame composed from its passes,
and against the port's default frame (tests/torch_frames.py has the
composition and the bars). The fused frame with ``POP2_DEFAULT`` is in
tests/test_torch_frame_switches.py, beside the other two-pop frame.
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
                   fused=tf.port_fused_frame(port_r))
    finally:
        mp.undo()
    return dict(ref=tf.ref_frame(ref_r, fuse_shadows=True), got=got)


def test_fused_frame_matches_tpurt(frames):
    ref, grazing = frames["ref"]
    tf.check_image(frames["got"]["fused"], ref, grazing)


def test_fused_frame_equals_default_frame(frames):
    np.testing.assert_array_equal(frames["got"]["fused"],
                                  frames["got"]["default"])
