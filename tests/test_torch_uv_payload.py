"""K7c (the closest hit's uv payload) and its table: the port's
``flatten_scene`` builds tpurt's ``geom["uvp"]``; the payload planes of the
port's plain K7c against tpurt's ``trace_closest_bvh8(uv_payload=True)``
(Pallas in interpret mode, ``fat=1``); the shade pass fed the payload
against the shade pass without it. On the cut bench scene at 40x48, which
is procedural (tpurt's own tests/test_uv_payload.py needs BoxTextured).

Tolerances: ``uvp`` equal bit for bit; against tpurt, on lanes with equal
``tri``, ``img``/``texh``/``texw`` equal and ``texu``/``texv`` within 2e-6
(XLA:CPU contracts tpurt's interpolation and its u/v into FMAs); within the
port, the payload equals the ``tri_attr``-fed texture coordinate bit for
bit, so the shaded G-buffers are bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import same_host_builder  # noqa: F401

H, W = 40, 48
FIELD = dict(nx=3, nz=3, subdiv=2)
PAYLOAD = ("texu", "texv", "img", "texh", "texw")


@pytest.fixture(scope="module")
def frame():
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt.kernels.traverse_bvh8 import trace_closest_bvh8 as ref_trace
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig, convert
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays

    ref_r = build_bench_scene(RefRenderer(RefConfig(width=W, height=H,
                                                    tracer="bvh8")),
                              field=FIELD, cubes=2)
    port_r = build_bench_scene(Renderer(RendererConfig(width=W, height=H,
                                                       device="cpu")),
                               field=FIELD, cubes=2)
    scene = port_r.scene_device
    cam = convert.camera_tensors(port_r.camera.uniform(), "cpu")
    o, d = camera_rays(cam, W, H)
    geom = ref_r.scene.as_pytree()["geom"]
    ref = ref_trace(ref_r.scene.as_pytree()["bvh"], geom, jnp.asarray(o),
                    jnp.asarray(d), T_MIN, T_MAX, height=H, width=W,
                    max_leaf=32, interpret=True, uv_payload=True, fat=1,
                    when_push=False)
    return dict(ref_r=ref_r, port_r=port_r, scene=scene, cam=cam,
                lights=convert.light_tensors(port_r.lights.shader_arrays(),
                                             "cpu"),
                ref={k: np.asarray(v) for k, v in ref.items()},
                hits=trace_closest_bvh8(scene, o, d, T_MIN, T_MAX),
                uvp_hits=trace_closest_bvh8(scene, o, d, T_MIN, T_MAX,
                                            uv_payload=True))


def test_uvp_table_equals_tpurt(frame):
    ref = np.asarray(frame["ref_r"].scene.geom["uvp"])
    got = frame["port_r"].scene.geom["uvp"]
    assert got.shape == ref.shape == (frame["scene"]["num_tris"], 9)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(frame["scene"]["uvp"].numpy(), got)
    # several images and extents, not a constant table
    assert len(np.unique(got[:, 6])) > 1 and got[:, 7:9].min() >= 1


def test_payload_planes_agree_with_tpurt(frame):
    ref, got = frame["ref"], {k: v.numpy()
                              for k, v in frame["uvp_hits"].items()}
    assert set(got) == set(ref)
    same = ref["tri"] == got["tri"]
    assert same.mean() >= 0.999
    hit = same & (got["tri"] >= 0)
    assert hit.sum() > 100 and (got["tri"] < 0).any()
    for k in ("img", "texh", "texw"):
        np.testing.assert_array_equal(got[k][same], ref[k][same])
    for k in ("texu", "texv"):
        assert np.abs(got[k][hit] - ref[k][hit]).max() <= 2e-6
    miss = got["tri"] < 0
    for k, val in zip(PAYLOAD, (0, 0, 0, 1, 1)):
        assert (got[k][miss] == val).all() and (ref[k][miss & same] == val
                                                ).all()


def test_payload_equals_attr_tex_coord(frame):
    """The payload is the tri_attr-fed texture coordinate, image slot and
    extents of the winning triangle, bit for bit; the hit itself is K1's."""
    hits, uh = frame["hits"], frame["uvp_hits"]
    for k in hits:
        assert torch.equal(uh[k], hits[k])
    hit = hits["tri"] >= 0
    attr = frame["scene"]["tri_attr"][hits["tri"][hit].long()]
    u, v = hits["u"][hit][:, None], hits["v"][hit][:, None]
    w = 1.0 - u - v
    tex = attr[:, 3:5] * w + attr[:, 15:17] * u + attr[:, 27:29] * v
    for i, k in enumerate(("texu", "texv")):
        assert torch.equal(uh[k][hit].view(torch.int32),
                           tex[:, i].contiguous().view(torch.int32))
    assert torch.equal(uh["img"][hit], attr[:, 39])
    assert torch.equal(uh["texh"][hit], attr[:, 37])
    assert torch.equal(uh["texw"][hit], attr[:, 38])


@pytest.mark.parametrize("fuse_shadows", [False, True])
def test_shade_fed_payload_is_bit_identical(frame, fuse_shadows):
    from tpurt_torch.passes.shade import shade

    args = (frame["scene"], frame["cam"], frame["lights"])
    base = shade(*args, frame["hits"], fuse_shadows=fuse_shadows)
    fed = shade(*args, frame["uvp_hits"], fuse_shadows=fuse_shadows)
    for k in base:
        assert torch.equal(fed[k].view(torch.int32),
                           base[k].view(torch.int32)), k
    assert (base["color"].amax(-1) > 0).float().mean() > 0.3
