"""The HDR10 output path and ffx_a.h's transfer functions against tpurt, on
seeded inputs: ``lpm_setup_hdr10`` (and the other LPM prefabs) with the
control block bit-equal and the derived floats equal; ``lpm_filter`` under
each prefab's config within 2e-6 (tpurt's einsum and pow come from
XLA:CPU, the port's from PyTorch's CPU kernels); each transfer function
within 1e-6 relative, except PQ (``a_to_pq`` and ``tonemap_frame_hdr10``):
within 2e-5, as pow(x, 78.84) multiplies a last-bit difference of its
argument by ~80 (measured: 1.4e-5 relative, 1.07e-5 absolute).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TRANSFERS = ["a_to_709", "a_from_709", "a_to_pq", "a_from_pq", "a_to_srgb",
             "a_from_srgb", "a_to_two", "a_from_two"]
PREFABS = ["HDR10RAW_709", "709_P3", "HDR10RAW_2020", "709_709"]


def _seeded(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("nits", [1000.0, 400.0])
def test_lpm_setup_hdr10_bit_equal(nits):
    from tpurt.passes import tonemap as ref
    from tpurt_torch.passes import tonemap

    ctl_r, der_r = ref.lpm_setup_hdr10(display_max_nits=nits)
    ctl, der = tonemap.lpm_setup_hdr10(display_max_nits=nits)
    np.testing.assert_array_equal(ctl, ctl_r)
    assert der.keys() == der_r.keys()
    for k in der:
        np.testing.assert_array_equal(der[k], der_r[k])
    assert tonemap.lpm_hdr10_raw_scalar(nits) == ref.lpm_hdr10_raw_scalar(
        nits)


@pytest.mark.parametrize("prefab", PREFABS)
def test_prefab_filter_matches(prefab):
    from tpurt.passes import tonemap as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.passes import tonemap

    config = getattr(ref, f"LPM_CONFIG_{prefab}")
    colors = getattr(ref, f"LPM_COLORS_{prefab}")
    assert getattr(tonemap, f"LPM_CONFIG_{prefab}") == config
    assert getattr(tonemap, f"LPM_COLORS_{prefab}") == colors
    ctl_r, der_r = ref.lpm_setup(config=config, colors=colors, scale_c=0.1)
    ctl, der = tonemap.lpm_setup(config=config, colors=colors, scale_c=0.1)
    np.testing.assert_array_equal(ctl, ctl_r)
    color = _seeded((4096, 3), 1, 0.0, 40.0)
    want = np.asarray(ref.lpm_filter(jnp.asarray(color), der_r,
                                     config=config))
    got = tonemap.lpm_filter(torch.tensor(color),
                             convert.lpm_tensors(der, "cpu"),
                             config=config).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_tonemap_frame_hdr10_matches():
    from tpurt.passes import tonemap as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.passes import tonemap

    color = _seeded((48, 40, 3), 2, 0.0, 30.0)
    ao = np.random.default_rng(3).integers(0, 384, (48, 40)).astype(np.int32)
    _, der = ref.lpm_setup_hdr10()
    want = np.asarray(ref.tonemap_frame_hdr10(
        jnp.asarray(color), jnp.asarray(ao.astype(np.uint16)), der))
    got = tonemap.tonemap_frame_hdr10(
        torch.tensor(color), torch.tensor(ao),
        convert.lpm_tensors(tonemap.lpm_setup_hdr10()[1], "cpu")).numpy()
    assert got.shape == (48, 40, 3) and np.isfinite(got).all()
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.max() > 0.3
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", TRANSFERS)
def test_transfer_function_matches(name):
    from tpurt.passes import tonemap as ref
    from tpurt_torch.passes import tonemap

    x = np.concatenate([_seeded(4000, 4, -0.1, 1.2),
                        np.array([0.0, 1.0, 0.018, 0.081, 0.04045],
                                 np.float32)])
    want = np.asarray(getattr(ref, name)(jnp.asarray(x)))
    got = getattr(tonemap, name)(torch.tensor(x)).numpy()
    rtol = 2e-5 if name == "a_to_pq" else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("name,arg", [("a_to_gamma", 1 / 2.2),
                                      ("a_from_gamma", 2.2)])
def test_gamma_transfers_match(name, arg):
    from tpurt.passes import tonemap as ref
    from tpurt_torch.passes import tonemap

    x = _seeded(4000, 5, -0.1, 1.2)
    want = np.asarray(getattr(ref, name)(jnp.asarray(x), arg))
    got = getattr(tonemap, name)(torch.tensor(x), arg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
