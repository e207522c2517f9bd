"""The slice as a whole, fused shadows with two pops: the port's fused
frame with ``POP2_DEFAULT`` set (K7b closest, K5p) against tpurt's frame
composed from its passes with ``pop2=True`` and ``fuse_shadows=True``, and
against the port's default frame (tests/torch_frames.py has the
composition and the bars).
"""
import pytest

import torch_frames as tf
from torch_parity import same_host_builder  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    from tpurt_torch.kernels import traverse_bvh8 as tb

    ref_r, port_r = tf.renderers()
    mp = pytest.MonkeyPatch()
    try:
        default = tf.port_render(port_r, mp)
        with mp.context() as m:
            m.setattr(tb, "POP2_DEFAULT", True)
            got = tf.port_fused_frame(port_r)
    finally:
        mp.undo()
    assert tb.POP2_DEFAULT is False
    return dict(ref=tf.ref_frame(ref_r, pop2=True, fuse_shadows=True),
                got=got, default=default)


def test_fused_pop2_frame_matches_tpurt(frames):
    ref, grazing = frames["ref"]
    tf.check_image(frames["got"], ref, grazing)


def test_fused_pop2_frame_matches_default_frame(frames):
    tf.check_image(frames["got"], frames["default"])
