"""GTAO with bent normals: the port's plain K3 and K4 bent instantiations
and the frame's ``bent_normals`` against tpurt, whose bent pass is its XLA
``main_pass`` / ``denoise_pass`` (Pallas never runs it).

Inputs come from numpy seeds (tests/test_torch_gtao.py's G-buffer).
Budgets: the encoding, its decoding, the per-pass denoise and the frame
tail's visibility bit-exact, its bent-normal normalization within 2.4e-7;
the main pass's packed term within 1 u8 step per byte on <= 0.1% of
pixels (tpurt's GTAO budget, F7; measured: equal);
the rotation from -z within 1e-6; a whole 32x32 frame of the cut bench
scene (procedural, ROADMAP F1; tpurt with tracer="bvh8", F2) with its
``bent_normals`` within 2e-2 (tpurt's own golden bound,
tests/test_golden_extra.py:43) and its image within
tests/test_torch_aa.py's bars.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gtao import _gbuffer
from torch_parity import same_host_builder  # noqa: F401

NOISE_INDEX = 5
CASES = [((32, 32), (2, 2)), ((64, 64), (9, 3)), ((40, 48), (3, 3))]


def _bytes(packed):
    """(..., 4) u8 of uint32 words (numpy uint32 or int32 bits)."""
    return np.asarray(packed).view(np.uint8).reshape(*np.shape(packed), 4)


def _assert_bytes_budget(got, ref, max_step=1, max_frac=1e-3):
    d = np.abs(_bytes(got).astype(int) - _bytes(ref).astype(int)).max(-1)
    assert d.max() <= max_step, f"max u8 step {d.max()} > {max_step}"
    assert (d > 0).mean() <= max_frac, \
        f"differing share {(d > 0).mean():.5f} > {max_frac}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_decode_bit_exact(seed):
    """encode/decode_visibility_bent_normal against tpurt, with values
    outside [0, 1] and [-1, 1] (clipped alike)."""
    from tpurt.passes import gtao as ref
    from tpurt_torch.passes import gtao

    rng = np.random.default_rng(seed)
    vis = rng.uniform(-0.2, 1.3, 4096).astype(np.float32)
    bn = rng.uniform(-1.2, 1.2, (4096, 3)).astype(np.float32)
    want = np.asarray(ref.encode_visibility_bent_normal(jnp.asarray(vis),
                                                        jnp.asarray(bn)))
    got = gtao.encode_visibility_bent_normal(torch.tensor(vis),
                                             torch.tensor(bn)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    v_r, bn_r = ref.decode_visibility_bent_normal(jnp.asarray(want))
    v_g, bn_g = gtao.decode_visibility_bent_normal(torch.tensor(got))
    np.testing.assert_array_equal(v_g.numpy(), np.asarray(v_r))
    np.testing.assert_array_equal(bn_g.numpy(), np.asarray(bn_r))
    s_r = ref.GtaoSettings(bent_normals=True)
    s_g = gtao.GtaoSettings(bent_normals=True)
    np.testing.assert_array_equal(
        gtao.ao_visibility_u8(torch.tensor(got), s_g).numpy(),
        np.asarray(ref.ao_visibility_u8(jnp.asarray(want), s_r)))
    # the normalization: XLA's jitted norm sums the squares in its own
    # order (measured: 1 ULP on 7% of components)
    np.testing.assert_allclose(
        gtao.ao_bent_normals(torch.tensor(got), s_g).numpy(),
        np.asarray(ref.ao_bent_normals(jnp.asarray(want), s_r)), rtol=0,
        atol=2.4e-7)


def test_rot_from_minus_z():
    """_rot_from_minus_z (the plain version's rotation) against tpurt's,
    near-identity targets included, within 1e-6."""
    from tpurt.passes import gtao as ref
    from tpurt_torch.passes import gtao

    rng = np.random.default_rng(3)
    to = rng.normal(size=(2000, 3))
    to[:10] = [0.0, 0.0, -1.0]
    to[10:20] = [1e-5, 0.0, 1.0]
    to = (to / np.linalg.norm(to, axis=-1, keepdims=True)).astype(np.float32)
    v = rng.normal(size=(2000, 3)).astype(np.float32)
    want = np.asarray(ref._rot_from_minus_z(jnp.asarray(to))(jnp.asarray(v)))
    got = gtao._rot_from_minus_z(torch.tensor(to))(torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:10], v[:10])


@pytest.fixture(scope="module")
def main_results():
    from tpurt.passes import gtao as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.gtao_main import gtao_main
    from tpurt_torch.passes import gtao

    out = {}
    for i, ((h, w), (slices, steps)) in enumerate(CASES):
        depth, normal = _gbuffer(h, w, seed=10 + i)
        consts = ref.gtao_constants(w, h, 0.1, 100.0, np.pi / 2, w / h)
        settings = ref.GtaoSettings(slices, steps, denoise=1,
                                    bent_normals=True)
        mips = ref.prefilter_depths(jnp.asarray(depth), consts)
        ao, edges = ref.main_pass(mips, jnp.asarray(normal), consts,
                                  settings, jnp.int32(NOISE_INDEX))
        got_ao, got_edges = gtao_main(
            [torch.tensor(np.asarray(m)) for m in mips], torch.tensor(normal),
            convert.gtao_tensors(consts, "cpu")["vec"],
            gtao.noise_maps_64(NOISE_INDEX, "cpu"), slice_count=slices,
            steps_per_slice=steps, bent=True)
        out[(h, w)] = dict(ref=(np.asarray(ao), np.asarray(edges)),
                           got=(got_ao.numpy(), got_edges.numpy()),
                           settings=settings)
    return out


@pytest.mark.parametrize("shape", [c[0] for c in CASES])
def test_main_pass_bent_matches(shape, main_results):
    r = main_results[shape]
    (ao, edges), (got_ao, got_edges) = r["ref"], r["got"]
    assert got_ao.dtype == np.int32 and got_ao.shape == shape
    np.testing.assert_array_equal(got_edges, edges)
    _assert_bytes_budget(got_ao, ao)
    assert len(np.unique(_bytes(got_ao)[..., 0])) > 8  # a real bent field


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("shape", [c[0] for c in CASES])
def test_denoise_pass_bent_bit_exact(shape, final, main_results):
    """One denoise pass of tpurt's main pass output (final: vis x 1.5)."""
    from tpurt.passes import gtao as ref
    from tpurt_torch.kernels.gtao_denoise import denoise_pass_plain

    r = main_results[shape]
    ao, edges = r["ref"]
    s = r["settings"]
    blur = s.denoise_blur_beta if final else s.denoise_blur_beta / 5.0
    want = np.asarray(ref.denoise_pass(jnp.asarray(ao), jnp.asarray(edges),
                                       s, final_apply=final))
    got = denoise_pass_plain(torch.tensor(ao.view(np.int32)),
                             torch.tensor(edges), blur, final, bent=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_denoise_chain_bent_matches():
    """The 3-pass (soft) chain on a random packed term, bit-exact."""
    from tpurt.passes import gtao as ref
    from tpurt_torch.kernels.gtao_denoise import denoise_chain

    rng = np.random.default_rng(4)
    ao = rng.integers(0, 2 ** 32, (37, 50), dtype=np.uint64).astype(np.uint32)
    edges = rng.integers(0, 256, (37, 50), dtype=np.uint8)
    s = ref.GtaoSettings(1, 2, denoise=3, bent_normals=True)
    want = jnp.asarray(ao)
    n = s.num_denoise_passes
    for i in range(n):
        want = ref.denoise_pass(want, jnp.asarray(edges), s,
                                final_apply=i == n - 1)
    got = denoise_chain(torch.tensor(ao.view(np.int32)), torch.tensor(edges),
                        n_passes=n, blur_beta=s.denoise_blur_beta, bent=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.fixture(scope="module")
def bent_frames():
    """A 32x32 bent-normal frame of the cut bench scene from each package
    (GTAO 2x2, sharp)."""
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt.passes.gtao import GtaoSettings as RefSettings
    from torch_ground_truth import CUBES, FIELD, SIZE
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.passes.gtao import GtaoSettings

    ref_r = build_bench_scene(RefRenderer(RefConfig(
        width=SIZE, height=SIZE, tracer="bvh8",
        gtao=RefSettings(2, 2, denoise=1, bent_normals=True))),
        field=FIELD, cubes=CUBES)
    port_r = build_bench_scene(Renderer(RendererConfig(
        width=SIZE, height=SIZE, device="cpu",
        gtao=GtaoSettings(2, 2, denoise=1, bent_normals=True))),
        field=FIELD, cubes=CUBES)
    ref = {k: np.asarray(v) for k, v in ref_r.render().items()}
    got = {k: v.numpy() for k, v in port_r.render().items()}
    return ref, got, port_r


def test_bent_frame_matches_tpurt(bent_frames):
    from test_torch_aa import check_frame

    ref, got, port_r = bent_frames
    assert set(got) == set(ref)
    bn, bn_ref = got["bent_normals"], ref["bent_normals"]
    assert bn.shape == bn_ref.shape == (32, 32, 3) and bn.dtype == np.float32
    err = np.abs(bn - bn_ref).max()
    assert err <= 2e-2, f"bent_normals max abs {err} > 2e-2"
    assert np.abs(got["ao"].astype(int) - ref["ao"].astype(int)).max() <= 1
    check_frame(got, ref)
    assert port_r.stats()["gtao"]["bent_normals"] is True
