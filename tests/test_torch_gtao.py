"""GTAO: the port's plain K3 (main pass) and K4 (denoise chain) against
tpurt's Pallas kernels in interpret mode and its XLA passes.

Inputs are made with numpy from a seed. The reference's own budgets
(tests/test_gtao_pallas.py) are 2 u8 steps on <= 2% of pixels for the main
pass and 1 step on <= 0.1% for the denoise chain: mip selection rounds at
level boundaries, and XLA:CPU's transcendentals and FMA contraction can
move single samples. The port measures equal here, so the main pass is
held to 1 step on <= 0.1% with edges equal, and the pyramid to equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

NOISE_INDEX = 5
CASES = [((64, 64), (9, 3)), ((40, 48), (3, 3))]


def _gbuffer(h, w, seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 20.0, (h, w)).astype(np.float32)
    # a smooth slope on half the image so the horizon search sees real
    # surfaces, not only noise
    yy, xx = np.mgrid[0:h, 0:w]
    half = w // 2
    depth[:, :half] = 3.0 + 0.05 * xx[:, :half] + 0.02 * yy[:, :half]
    n = rng.normal(size=(h, w, 3))
    n[..., 2] = -np.abs(n[..., 2])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return depth, (n * 0.5 + 0.5).astype(np.float32)


def _assert_budget(got, ref, max_step, max_frac):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= max_step, f"max u8 diff {d.max()}"
    assert (d > 0).mean() <= max_frac, f"diff fraction {(d > 0).mean():.5f}"


@pytest.fixture(scope="module")
def main_results():
    from tpurt.kernels.gtao_main_pallas import consts_to_vec, main_pass_pallas
    from tpurt.passes import gtao as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.gtao_main import gtao_main
    from tpurt_torch.passes import gtao

    out = {}
    for i, ((h, w), (slices, steps)) in enumerate(CASES):
        depth, normal = _gbuffer(h, w, seed=i)
        consts = ref.gtao_constants(w, h, 0.1, 100.0, np.pi / 2, w / h)
        settings = ref.GtaoSettings(slices, steps, denoise=1)
        mips = ref.prefilter_depths(jnp.asarray(depth), consts)
        xla_ao, xla_edges = ref.main_pass(mips, jnp.asarray(normal), consts,
                                          settings, jnp.int32(NOISE_INDEX))
        pal_ao, pal_edges = main_pass_pallas(
            mips, jnp.asarray(normal), consts_to_vec(consts),
            ref.noise_maps_64(jnp.int32(NOISE_INDEX)), width=w, height=h,
            slice_count=slices, steps_per_slice=steps, interpret=True,
            precision="exact", schedule="batch", noise_hoist=True,
            thin_zero=True)
        port_mips = gtao.prefilter_depths(torch.tensor(depth), consts)
        got_ao, got_edges = gtao_main(
            [torch.tensor(np.asarray(m)) for m in mips], torch.tensor(normal),
            convert.gtao_tensors(consts, "cpu")["vec"],
            gtao.noise_maps_64(NOISE_INDEX, "cpu"), slice_count=slices,
            steps_per_slice=steps)
        out[(h, w)] = dict(
            ref_mips=[np.asarray(m) for m in mips],
            port_mips=[m.numpy() for m in port_mips],
            xla=(np.asarray(xla_ao), np.asarray(xla_edges)),
            pallas=(np.asarray(pal_ao), np.asarray(pal_edges)),
            got=(got_ao.numpy(), got_edges.numpy()))
    return out


SHAPES = [c[0] for c in CASES]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("against", ["pallas", "xla"])
def test_main_pass_matches(shape, against, main_results):
    r = main_results[shape]
    ref_ao, ref_edges = r[against]
    got_ao, got_edges = r["got"]
    assert got_ao.dtype == np.uint8 and got_ao.shape == shape
    np.testing.assert_array_equal(got_edges, ref_edges)
    _assert_budget(got_ao, ref_ao, 1, 1e-3)
    assert 0 < got_ao.mean() < 255


@pytest.mark.parametrize("shape", SHAPES)
def test_prefilter_matches(shape, main_results):
    """The R16F depth pyramid (plain tensor ops, as tpurt's XLA)."""
    r = main_results[shape]
    for m_got, m_ref in zip(r["port_mips"], r["ref_mips"]):
        np.testing.assert_array_equal(m_got, m_ref)


@pytest.mark.parametrize("denoise", [1, 2, 3])
@pytest.mark.parametrize("shape", [(64, 128), (50, 70)])
def test_denoise_chain_matches(denoise, shape):
    from tpurt.kernels.gtao_pallas import denoise_chain_pallas
    from tpurt.passes.gtao import GtaoSettings as RefSettings
    from tpurt.passes.gtao import denoise_pass as ref_pass
    from tpurt_torch.kernels.gtao_denoise import denoise_chain
    from tpurt_torch.passes.gtao import GtaoSettings

    rng = np.random.default_rng(denoise)
    ao = rng.integers(0, 256, shape, dtype=np.uint8)
    edges = rng.integers(0, 256, shape, dtype=np.uint8)
    settings = GtaoSettings(1, 2, denoise=denoise)
    n = settings.num_denoise_passes
    ref = denoise_chain_pallas(jnp.asarray(ao), jnp.asarray(edges),
                               n_passes=n,
                               blur_beta=settings.denoise_blur_beta,
                               interpret=True)
    got = denoise_chain(torch.tensor(ao), torch.tensor(edges), n_passes=n,
                        blur_beta=settings.denoise_blur_beta).numpy()
    assert got.shape == shape and got.max() > 255  # unclamped final range
    _assert_budget(got, np.asarray(ref), 1, 1e-3)
    xla = jnp.asarray(ao)
    rs = RefSettings(1, 2, denoise=denoise)
    for i in range(n):
        xla = ref_pass(xla, jnp.asarray(edges), rs, final_apply=(i == n - 1))
    _assert_budget(got, np.asarray(xla), 1, 1e-3)
