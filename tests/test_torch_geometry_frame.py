"""The sharded-geometry frame (``dist/geometry.py``) with 2 and 4 gloo
ranks on the CPU, each rank a spawned process
(``tests/torch_geometry_worker.py``), on a 40x36 frame of the cut bench
scene (446 tris, 3 shadow-casting lights, so K5's tour carries S = 3
sets; bands of 18 and 9 rows), the kernels' plain versions tracing:

* in both tiers, for the default scene, its quad rows in the arena's
  layout ("bvh8") and mip scenes in the quad and pair tiers (their texel
  rows through ``ring_gather`` in "bvh8"): on every rank the ring's t
  equals the single-device K1 trace bit for bit on the band's rays, tri
  differs only where t is equal, the ring's occlusion equals the K2 trace
  of every light; every output gathered by ``gather_frame`` equals the
  single-device frame. Measured: no equal-t tie falls in any of these
  frames, so every output is bit-equal everywhere (the counts are
  asserted);
* the 4-rank frames against tpurt's
  ``render_frame_sharded_geometry(tables="xla")`` on ``make_mesh(4)``
  (conftest.py's 8-device CPU platform), at ``test_torch_dist.py``'s
  bars: tpurt traces that tier with its XLA tracer, which may pick other
  triangles on equal-t ties (F9, F19). tpurt's "bvh8" tier runs its Pallas
  kernels in interpret mode (127.8 s for this frame) and is not run here.
"""
import numpy as np
import pytest

import torch_geometry_worker as worker

LABELS = ("default_bvh8", "default_xla", "default_bvh8_arena",
          "mip_quad_bvh8", "mip_quad_xla", "mip_pair_bvh8", "mip_pair_xla")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    out = tmp_path_factory.mktemp("geometry")
    got = {}
    for world in (2, 4):
        worker.spawn(worker.frame_worker, world, str(out))
        flat = np.load(out / f"frames{world}.npz")
        report = np.load(out / f"report{world}.npy", allow_pickle=True)
        got[world] = dict(report=report.item(), frames={
            label: {k.split("/")[1]: flat[k] for k in flat.files
                    if k.split("/")[0] == label} for label in LABELS})
    return got


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", LABELS)
def test_frame_equals_single_device(frames, world, label):
    """Checked inside every rank (frame_worker); here the counts rank 0
    gathered: no tie, no output pixel off."""
    report = frames[world]["report"][label]
    assert report == dict(ties=0, image=0, color=0, depth=0, normal=0,
                          ao=0), report
    image = frames[world]["frames"][label]["image"]
    assert image.shape == (worker.H, worker.W, 3)
    assert (image.max(-1) > 0).mean() > 0.3


def test_world_sizes_agree(frames):
    for label in LABELS:
        a, b = frames[2]["frames"][label], frames[4]["frames"][label]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(label, k))


def test_against_tpurt_xla_tier(frames):
    import jax

    from tpurt.dist import make_mesh
    from tpurt.dist.geometry import (render_frame_sharded_geometry,
                                     shard_geometry)
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt.passes.gtao import gtao_constants
    from tpurt_torch.app.bench_scene import build_bench_scene

    assert len(jax.devices()) >= 4
    r = build_bench_scene(RefRenderer(RefConfig(
        width=worker.W, height=worker.H)), field=worker.FIELD,
        cubes=worker.CUBES)
    c = r.config
    scene = r.scene.as_pytree()
    consts = gtao_constants(c.width, c.height, r.camera.znear,
                            r.camera.zfar, r.camera.fovy, r.camera.aspect)
    ref = render_frame_sharded_geometry(
        scene, shard_geometry(scene, 4), r.camera.uniform(),
        r.lights.shader_arrays(), consts, r._lpm_derived, np.int32(0),
        width=c.width, height=c.height, gtao_settings=c.gtao,
        mesh=make_mesh(4))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for label in ("default_bvh8", "default_xla"):
        got = frames[4]["frames"][label]
        assert sorted(got) == sorted(ref)
        d = np.abs(got["image"].astype(int)
                   - ref["image"].astype(int)).max(-1)
        assert (d == 0).mean() >= 0.999 and d.max() <= 2, (
            label, (d == 0).mean(), d.max())
        for key in ("depth", "normal"):
            same = got[key].view(np.uint32) == ref[key].view(np.uint32)
            assert same.reshape(same.shape[0], same.shape[1], -1).all(
                -1).mean() >= 0.999, (label, key)
        d = np.abs(got["ao"].astype(int) - ref["ao"].astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, label
