"""The port's correctly rounded square root (``passes/encodings.sqrt``),
which the camera rays take (ROADMAP T1, T2).

PyTorch's CPU ``sqrt`` goes through MKL's VML: it is not correctly rounded,
and on the first call of a process that two threads share it has returned
wrong roots on one thread's chunk (``tpurt_torch/tools/sqrt_probe.py``).
``encodings.sqrt`` must equal numpy's IEEE root bit for bit on the CPU,
whatever the call's size, and the camera rays' norm must be that root.
"""
import numpy as np
import pytest
import torch


def _values():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(0.0, 10.0, 200_000), 10.0 ** rng.uniform(-38, 38, 50_000),
        np.float32(2.0) ** -np.arange(126, 150, dtype=np.float32),
        [0.0, -0.0, np.inf, -1.0, np.nan, np.finfo(np.float32).max]])
    return x.astype(np.float32)


@pytest.mark.parametrize("n", [1, 4095, 4096, 250_030])
def test_sqrt_is_ieee(n):
    from tpurt_torch.passes.encodings import sqrt

    x = _values()[-n:]
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = sqrt(torch.from_numpy(x.copy()))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_camera_rays_normalize_with_the_ieee_root(monkeypatch):
    """camera_rays divides by encodings.sqrt's root of its squared norm:
    with the identity view, a ray's x is the target's x over numpy's root,
    bit for bit."""
    from tpurt_torch.passes import encodings, rays

    seen = []

    def recording(x):
        seen.append(x)
        return encodings.sqrt(x)

    monkeypatch.setattr(rays, "sqrt", recording)
    cam = dict(view_inv=torch.eye(4), proj_inv=torch.tensor(
        [[1.2, 0, 0, 0], [0, 0.8, 0, 0], [0, 0, 0, -1.0], [0, 0, -4.9, 5.1]],
        dtype=torch.float32))
    _, d = rays.camera_rays(cam, 64, 64)
    assert len(seen) == 1 and seen[0].shape == (64, 64)
    x = (np.arange(64, dtype=np.float32) + np.float32(0.5)) \
        / np.float32(64.0) * np.float32(2.0) - np.float32(1.0)
    tx = np.float32(1.2) * np.broadcast_to(x, (64, 64))
    want = tx / np.sqrt(seen[0].numpy())
    np.testing.assert_array_equal(d[:, 0].numpy().view(np.int32),
                                  want.reshape(-1).view(np.int32))


def _root_calls(path):
    """(line, text) of every PyTorch square root in a source file: the
    ``torch.sqrt`` / ``torch.rsqrt`` functions named anywhere, imported
    from torch, or called as tensor methods (``x.sqrt()``)."""
    import ast

    names = {"sqrt", "sqrt_", "rsqrt", "rsqrt_"}
    modules = {"np", "numpy", "math", "cmath"}
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "torch":
            found += [(node.lineno, f"from {node.module} import {a.name}")
                      for a in node.names if a.name in names]
        elif isinstance(node, ast.Attribute) and node.attr in names:
            base = node.value
            if isinstance(base, ast.Name) and base.id in modules:
                continue
            found.append((node.lineno, ast.unparse(node)))
    return found


def test_no_torch_sqrt_outside_encodings():
    """Risk T2: every square root of the port and of chip_smoke.py goes
    through passes/encodings.sqrt (numpy's IEEE root on the CPU), the one
    module that names PyTorch's own."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    files = sorted((repo / "tpurt_torch").rglob("*.py")) \
        + [repo / "chip_smoke.py"]
    allowed = repo / "tpurt_torch" / "passes" / "encodings.py"
    assert allowed in files and len(files) >= 40
    found = {str(f.relative_to(repo)): _root_calls(f) for f in files
             if f != allowed}
    assert not {f: c for f, c in found.items() if c}
    assert [text for _, text in _root_calls(allowed)] == ["torch.sqrt"]
