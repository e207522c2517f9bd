"""The port's ``utils/image_metrics.py`` against tpurt's: every function on
u8 and f32 pairs (equal floats: both are the same numpy), and the CLI's
exit codes on PNGs (PIL, which only the CLI imports)."""
import numpy as np
import pytest

FUNCS = ("rmse", "psnr", "max_abs")


def pairs():
    rng = np.random.default_rng(0)
    a8 = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    b8 = a8.copy()
    b8[3, 5] = 255 - b8[3, 5]
    af = rng.uniform(0.0, 4.0, (16, 24, 3)).astype(np.float32)
    return dict(u8=(a8, b8), f32=(af, af + np.float32(0.01)),
                u8_equal=(a8, a8.copy()), f32_equal=(af, af.copy()))


@pytest.mark.parametrize("kind", sorted(pairs()))
def test_metrics_equal_tpurt(kind):
    from tpurt.utils import image_metrics as ref
    from tpurt_torch.utils import image_metrics as port

    a, b = pairs()[kind]
    for name in FUNCS:
        assert getattr(port, name)(a, b) == getattr(ref, name)(a, b), name
    assert port.diff_report(a, b) == ref.diff_report(a, b)
    np.testing.assert_array_equal(port.to_float(a), ref.to_float(a))
    if kind.endswith("equal"):
        assert port.rmse(a, b) == 0.0 and port.psnr(a, b) == float("inf")
    else:
        assert 0 < port.rmse(a, b) and np.isfinite(port.psnr(a, b))


def test_shape_mismatch_raises():
    from tpurt_torch.utils.image_metrics import rmse

    with pytest.raises(ValueError):
        rmse(np.zeros((2, 2, 3)), np.zeros((2, 3, 3)))


def test_cli_exit_codes(tmp_path, capsys):
    from PIL import Image

    from tpurt_torch.utils.image_metrics import main

    a = np.zeros((8, 8, 3), np.uint8)
    b = a.copy()
    b[0, 0] = 255
    paths = {}
    for name, img in (("a", a), ("b", b), ("a2", a.copy())):
        paths[name] = str(tmp_path / f"{name}.png")
        Image.fromarray(img).save(paths[name])
    assert main([paths["a"], paths["a2"]]) == 0
    assert "PASS" in capsys.readouterr().out
    # rmse sqrt(1/64) = 0.125 > 0.01, and <= a threshold of 0.2
    assert main([paths["a"], paths["b"]]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert main([paths["a"], paths["b"], "--threshold", "0.2"]) == 0
