"""tpurt's legacy tonemap curves (``passes/tonemaps_legacy.py``: Lottes,
Uchimura with its defaults and other parameters, ACES fitted with the
reference's transposed matrices, ACES film) against the port's on seeded
HDR inputs in [0, 20], plus tests/test_tonemaps_legacy.py's anchors.
Budget: within 2e-6 relative + 1e-7 absolute (pow and exp from XLA:CPU
against PyTorch's CPU kernels; ACES fitted's matrix products are XLA dots
against left-to-right sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CURVES = [("tonemap_lottes", {}), ("tonemap_uchimura", {}),
          ("tonemap_uchimura", dict(P=2.0, a=1.2, m=0.3, l=0.5, c=1.1,
                                    b=0.01)),
          ("aces_film", {})]


def _hdr(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 20.0, shape).astype(
        np.float32)


@pytest.mark.parametrize("name,kw", CURVES,
                         ids=["lottes", "uchimura", "uchimura_params",
                              "aces_film"])
def test_curve_matches(name, kw):
    from tpurt.passes import tonemaps_legacy as ref
    from tpurt_torch.passes import tonemaps_legacy

    x = np.concatenate([_hdr(5000, 0), np.float32([0.0, 0.18, 0.3])])
    want = np.asarray(getattr(ref, name)(jnp.asarray(x), **kw))
    got = getattr(tonemaps_legacy, name)(torch.tensor(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_aces_fitted_matches():
    from tpurt.passes import tonemaps_legacy as ref
    from tpurt_torch.passes import tonemaps_legacy

    x = _hdr((64, 48, 3), 1)
    want = np.asarray(ref.aces_fitted(jnp.asarray(x)))
    got = tonemaps_legacy.aces_fitted(torch.tensor(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    grey = tonemaps_legacy.aces_fitted(torch.full((1, 3), 0.18)).numpy()
    assert (grey > 0.0).all() and (grey < 1.0).all()


def test_lottes_midpoint():
    from tpurt_torch.passes.tonemaps_legacy import tonemap_lottes

    assert abs(float(tonemap_lottes(torch.tensor(0.18))) - 0.267) < 1e-3
