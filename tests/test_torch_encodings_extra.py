"""The rest of tpurt's ``passes/encodings.py`` in the port:
``unpack_unorm8``, XeGTAO's R11G11B10 unorm packing (the uint32 word held
as int32 bits) and ``srgb_inverse_approx``, against tpurt on seeded
inputs. Bit-exact, except srgb_inverse_approx (pow from another library:
within 1e-6 relative).
"""
import jax.numpy as jnp
import numpy as np
import torch


def test_unpack_unorm8_bit_exact():
    from tpurt.passes import encodings as ref
    from tpurt_torch.passes import encodings

    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        encodings.unpack_unorm8(torch.tensor(x)).numpy(),
        np.asarray(ref.unpack_unorm8(jnp.asarray(x))))


def test_r11g11b10_pack_unpack_bit_exact():
    from tpurt.passes import encodings as ref
    from tpurt_torch.passes import encodings

    v = np.random.default_rng(0).uniform(-0.2, 1.2, (5000, 3)).astype(
        np.float32)
    want = np.asarray(ref.r11g11b10_unorm_pack(jnp.asarray(v)))
    got = encodings.r11g11b10_unorm_pack(torch.tensor(v)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)
    np.testing.assert_array_equal(
        encodings.r11g11b10_unorm_unpack(torch.tensor(got)).numpy(),
        np.asarray(ref.r11g11b10_unorm_unpack(jnp.asarray(want))))


def test_srgb_inverse_approx():
    from tpurt.passes import encodings as ref
    from tpurt_torch.passes import encodings

    x = np.random.default_rng(1).uniform(-0.1, 1.1, 5000).astype(np.float32)
    np.testing.assert_allclose(
        encodings.srgb_inverse_approx(torch.tensor(x)).numpy(),
        np.asarray(ref.srgb_inverse_approx(jnp.asarray(x))), rtol=1e-6,
        atol=0)
