"""Ray-traced AO: the port's ``passes/rtao.py`` on the CPU against tpurt's
(its XLA tracer over the binary BVH, ROADMAP F19) with tpurt's
``jax.random`` uniforms handed to the port's draw function, and the
port's own sampler's statistics.

Bars: ``_onb`` and ``_cosine_dirs`` within 1e-6 of tpurt's (cos and sin
come from other libraries). The frame, 32x32 with 8 samples and rays of
0.5 from tests/torch_parity.py's camera over the cut bench scene: ``valid``
equal exactly; the visibility equal on >= 99.5% of hit pixels with mean
|dvis| <= 0.001. A pixel may differ where its primary hit lands on
another triangle (K1's BVH8 and tpurt's binary tracer break equal-t ties
apart, F9) or a direction passes within a few ULPs of an occluder's edge;
one such pixel costs 1/8 of a sample there, 0.0002 of the mean. Measured:
every hit pixel equal (a third of them occluded), here and at rays of
0.2, 1.0, 2.0 and 4.0 and another camera, so the bars are tightened from
99% and 0.01 to what leaves room for about three such pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ground_truth import SIZE, Feed, ref_planes, renderers
from torch_parity import CAM_DIR, CAM_POS, same_host_builder  # noqa: F401

SAMPLES = 8
RAYS_LENGTH = 0.5


def unit_normals(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]     # both ONB branches
    return v


def test_onb_matches_tpurt():
    from tpurt.passes.rtao import _onb as ref_onb
    from tpurt_torch.passes.rtao import _onb

    n = unit_normals(4096, 0)
    t, bt = _onb(torch.from_numpy(n))
    rt, rbt = ref_onb(jnp.asarray(n))
    np.testing.assert_allclose(t.numpy(), np.asarray(rt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(rbt), rtol=0,
                               atol=1e-6)
    # orthonormal
    dots = [(t * bt).sum(-1), (t * torch.from_numpy(n)).sum(-1)]
    assert max(float(d.abs().max()) for d in dots) < 1e-5


def test_cosine_dirs_match_tpurt(monkeypatch):
    from tpurt.passes.rtao import _cosine_dirs as ref_dirs
    from tpurt_torch.passes import rtao

    n = unit_normals(4096, 1)
    key = jax.random.PRNGKey(3)
    u1 = np.array(jax.random.uniform(key, (4096,)))
    u2 = np.array(jax.random.uniform(jax.random.fold_in(key, 1), (4096,)))
    monkeypatch.setattr(rtao, "_uniform_planes", Feed(
        [(torch.from_numpy(u1), torch.from_numpy(u2))]))
    got = rtao._cosine_dirs(None, torch.from_numpy(n), (4096,))
    ref = np.asarray(ref_dirs(key, jnp.asarray(n), (4096,)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_cosine_dirs_statistics():
    """The port's own generator: unit directions in the normal's
    hemisphere, mean n.d within 4 sigma of 2/3 (cosine-weighted:
    E[n.d] = 2/3, Var = 1/18)."""
    from tpurt_torch.passes.rtao import _cosine_dirs

    n = torch.from_numpy(unit_normals(20000, 2))
    g = torch.Generator().manual_seed(9)
    d = _cosine_dirs(g, n, (20000,))
    cos = (d * n).sum(-1)
    assert float((d.norm(dim=-1) - 1).abs().max()) < 1e-5
    assert float(cos.min()) >= -1e-6
    sigma = (1.0 / 18.0 / 20000) ** 0.5
    assert abs(float(cos.mean()) - 2.0 / 3.0) <= 4 * sigma
    # a seed repeats, another does not
    again = _cosine_dirs(torch.Generator().manual_seed(9), n, (20000,))
    other = _cosine_dirs(torch.Generator().manual_seed(10), n, (20000,))
    assert torch.equal(d, again) and not torch.equal(d, other)


@pytest.fixture(scope="module")
def frames():
    from tpurt.passes.rtao import rtao_frame as ref_rtao
    from tpurt_torch.passes import rtao

    ref_r, port_r = renderers()
    for r in (ref_r, port_r):
        r.camera_mut().set_pos(CAM_POS)
        r.camera_mut().set_dir(CAM_DIR / np.linalg.norm(CAM_DIR))
    key = jax.random.PRNGKey(4)
    cam = {k: jnp.asarray(v) for k, v in ref_r.camera.uniform().items()}
    ref_vis, ref_valid = ref_rtao(ref_r.scene_device, cam, key, width=SIZE,
                                  height=SIZE, samples_per_frame=SAMPLES,
                                  total_rays_length=RAYS_LENGTH)
    planes = [tuple(torch.from_numpy(p) for p in
                    ref_planes(key, s, (SIZE * SIZE,)))
              for s in range(SAMPLES)]
    feed = Feed(planes)
    saved = rtao._uniform_planes
    rtao._uniform_planes = feed
    try:
        pcam, _, _ = port_r._frame_inputs()
        vis, valid = rtao.rtao_frame(port_r.scene_device, pcam, None,
                                     width=SIZE, height=SIZE,
                                     samples_per_frame=SAMPLES,
                                     total_rays_length=RAYS_LENGTH)
    finally:
        rtao._uniform_planes = saved
    assert feed.calls == SAMPLES
    return dict(ref=(np.asarray(ref_vis), np.asarray(ref_valid)),
                got=(vis.numpy(), valid.numpy()))


def test_rtao_frame_matches_tpurt(frames):
    ref_vis, ref_valid = frames["ref"]
    vis, valid = frames["got"]
    assert vis.shape == valid.shape == (SIZE, SIZE)
    assert vis.dtype == np.float32 and valid.dtype == bool
    np.testing.assert_array_equal(valid, ref_valid)
    hit = valid
    assert hit.mean() > 0.3
    # off the geometry: fully visible
    assert (vis[~hit] == 1.0).all() and (ref_vis[~hit] == 1.0).all()
    d = np.abs(vis - ref_vis)[hit]
    print(f"visibility equal on {(d == 0).mean():.4f} of hit pixels, mean "
          f"|dvis| {d.mean():.2e}, occluded {(ref_vis[hit] < 1).mean():.4f}")
    assert (d == 0).mean() >= 0.995, (d == 0).mean()
    assert d.mean() <= 0.001, d.mean()
    # the scene has occlusion to compare
    assert (ref_vis[hit] < 1.0).mean() > 0.2
    assert 0.0 <= vis.min() and vis.max() <= 1.0


def test_rtao_generator_on_host(frames):
    """One CPU generator, seeded alike, gives the same frame twice: the
    draws are made on the generator's device and moved to the frame's."""
    from tpurt_torch.passes.rtao import rtao_frame

    port_r = renderers()[1]
    pcam, _, _ = port_r._frame_inputs()
    a, b = (rtao_frame(port_r.scene_device, pcam,
                       torch.Generator().manual_seed(1), width=SIZE,
                       height=SIZE) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[0].min()) >= 0.0
