"""The band-sharded frame (dist/sharding.py on torch.distributed) with 2
and 4 gloo ranks on the CPU, each rank a spawned process
(``tests/torch_dist_worker.py``) on a 40x36 frame of the cut bench scene,
so that 4 ranks trace bands of 9 rows from rows that are no multiple of 8.

* Each rank's band, and every rank's whole frame through
  ``RendererConfig.mesh`` and ``render()`` or ``render_passes()`` (the
  profilers' frame, every step entered), equal the port's single-device
  frame bit for bit in every output (spp 2, no tonemap, bent normals,
  two denoise passes);
* the 4-rank frame against tpurt's ``render_frame_sharded`` on
  ``tpurt.dist.make_mesh(4)`` (conftest.py's 8-device CPU platform), at
  the frame bars of test_torch_frame.py (tpurt traces with its XLA tracer
  here, ROADMAP F2): u8 image equal on >= 99.9% of pixels, never off by
  more than 2; depth and normal bits equal on >= 99.9%; AO within 1 step
  on <= 0.1%.
"""
import numpy as np
import pytest

import torch_dist_worker as worker


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    for world in (2, 4):
        worker.spawn(worker.frame_worker, world, str(out))
    return {world: dict(np.load(out / f"frame{world}.npz"))
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_frame_equals_single_device(frames, world):
    """Checked inside every rank (frame_worker); here the default frame
    rank 0 gathered."""
    got = frames[world]
    assert got["image"].shape == (worker.H, worker.W, 3)
    assert (got["image"].max(-1) > 0).mean() > 0.3


def test_world_sizes_agree(frames):
    for k in frames[2]:
        np.testing.assert_array_equal(frames[2][k], frames[4][k], err_msg=k)


def test_refusals():
    worker.spawn(worker.refusal_worker, 2)


def test_against_tpurt_sharded(frames):
    import jax

    from tpurt.dist import make_mesh, render_frame_sharded
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt.passes.gtao import gtao_constants
    from tpurt_torch.app.bench_scene import build_bench_scene

    assert len(jax.devices()) >= 4
    r = build_bench_scene(RefRenderer(RefConfig(
        width=worker.W, height=worker.H)), field=worker.FIELD,
        cubes=worker.CUBES)
    c = r.config
    consts = gtao_constants(c.width, c.height, r.camera.znear,
                            r.camera.zfar, r.camera.fovy, r.camera.aspect)
    ref = render_frame_sharded(
        r.scene.as_pytree(), r.camera.uniform(), r.lights.shader_arrays(),
        consts, r._lpm_derived, np.int32(0), width=c.width, height=c.height,
        gtao_settings=c.gtao, mesh=make_mesh(4))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = frames[4]
    assert sorted(got) == sorted(ref)
    d = np.abs(got["image"].astype(int) - ref["image"].astype(int)).max(-1)
    assert (d == 0).mean() >= 0.999 and d.max() <= 2, ((d == 0).mean(),
                                                        d.max())
    for key in ("depth", "normal"):
        same = got[key].view(np.uint32) == ref[key].view(np.uint32)
        assert same.reshape(same.shape[0], same.shape[1], -1).all(
            -1).mean() >= 0.999, key
    d = np.abs(got["ao"].astype(int) - ref["ao"].astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
