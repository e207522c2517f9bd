"""Every public function and constant of tpurt's ``passes/color_spaces.py``
against the port's, on seeded inputs (the spirit of
tests/test_color_spaces.py: the same formulas, epsilons and quirks).

Inputs: rgb and the other 3-vectors uniform in [0.02, 1], hues in [0, 1],
XYZ and xyY as tpurt maps such rgb (in gamut).
Budget: within 2e-5 relative + 2e-6 absolute — tpurt's matrix products
are XLA dots (einsum) and its pow XLA's, the port's sums run left to
right and its pow is PyTorch's; the chains amplify a last-bit difference
through a division by small chroma. Measured maxima are printed.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.passes import color_spaces as ref


def _public():
    return sorted(n for n, f in inspect.getmembers(ref, inspect.isfunction)
                  if not n.startswith("_") and f.__module__ == ref.__name__)


NAMES = _public()


def _input(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("hue_to"):
        return rng.uniform(0.0, 1.0, 3000).astype(np.float32)
    x = rng.uniform(0.02, 1.0, (3000, 3)).astype(np.float32)
    # XYZ and xyY inputs are images of in-gamut rgb: out of gamut, the
    # chains' hsl/hcy divide by ~0 and amplify any last-bit difference
    # without bound
    if name.startswith("xyz_to"):
        x = np.asarray(ref.rgb_to_xyz(jnp.asarray(x)))
    elif name.startswith("xyY_to"):
        x = np.asarray(ref.rgb_to_xyY(jnp.asarray(x)))
    return x


def test_every_function_is_ported():
    from tpurt_torch.passes import color_spaces

    assert len(NAMES) >= 70
    missing = [n for n in NAMES if not callable(getattr(color_spaces, n,
                                                        None))]
    assert not missing, missing


def test_constants_match():
    from tpurt_torch.passes import color_spaces

    for name in ("HCV_EPSILON", "HSL_EPSILON", "HCY_EPSILON", "SRGB_GAMMA",
                 "SRGB_INVERSE_GAMMA", "SRGB_ALPHA"):
        assert getattr(color_spaces, name) == getattr(ref, name)
    for name in ("RGB_2_XYZ", "XYZ_2_RGB", "LUMA_COEFFS", "_HCY_WTS"):
        np.testing.assert_array_equal(
            np.asarray(getattr(color_spaces, name), np.float32),
            np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("name", NAMES)
def test_function_matches(name):
    from tpurt_torch.passes import color_spaces

    x = _input(name)
    want = np.asarray(getattr(ref, name)(jnp.asarray(x)))
    got = getattr(color_spaces, name)(torch.tensor(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want)
    print(f"{name}: max abs {err.max():.3g}")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
