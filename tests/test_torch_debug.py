"""``utils/debug.py``: ``validate_scene`` and ``validate_camera`` raise on
the same broken inputs as tpurt's (each package's scene and camera built
from one host scene, then broken alike), pass on sound ones, and check the
port's own dtypes and devices; ``validation()`` keeps tpurt's signature and
makes frames rendered inside it raise on a NaN output.
"""
import numpy as np
import pytest
import torch

from torch_parity import same_host_builder  # noqa: F401


@pytest.fixture(scope="module")
def scene():
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    r = build_bench_scene(Renderer(RendererConfig(
        width=16, height=16, device="cpu")), field=dict(nx=2, nz=2,
                                                        subdiv=1), cubes=2)
    r.prepare_first_frame()
    return r


def _break_geom_nan(pt):
    pt["geom"]["v0"][3, 1] = np.nan


def _break_tri_id(pt):
    pt["geom"]["tri_id"][0] = pt["geom"]["tri_id"][1]


def _break_attr_prim(pt):
    pt["tri_attr"][5, 36] = -1.0


def _break_attr_nan(pt):
    pt["tri_attr"][2, 7] = np.inf


BREAKS = {"none": None, "geom_nan": _break_geom_nan,
          "tri_id": _break_tri_id, "attr_prim": _break_attr_prim,
          "attr_nonfinite": _break_attr_nan}


def _pytree(r):
    import copy

    return copy.deepcopy(r.scene.as_pytree())


@pytest.mark.parametrize("kind", sorted(BREAKS))
def test_validate_scene_raises_like_tpurt(kind, scene):
    from tpurt.utils.debug import validate_scene as ref_validate
    from tpurt_torch.engine import convert
    from tpurt_torch.utils.debug import validate_scene

    pt = _pytree(scene)
    # tpurt's check reads the primitive count from tex_size
    pt["tex_size"] = scene.scene.tex_size
    if BREAKS[kind] is not None:
        BREAKS[kind](pt)
    port = convert.scene_tensors(pt, "cpu")
    if kind == "none":
        ref_validate(pt)
        validate_scene(port)
        return
    with pytest.raises(AssertionError):
        ref_validate(pt)
    with pytest.raises(AssertionError):
        validate_scene(port)


def test_validate_scene_checks_dtype_and_device(scene):
    from tpurt_torch.utils.debug import ValidationError, validate_scene

    good = dict(scene.scene_device)
    for key, bad in (("tris", good["tris"].double()),
                     ("tex_quad", good["tex_quad"].float()),
                     ("tri_attr", good["tri_attr"].to("meta"))):
        with pytest.raises(ValidationError):
            validate_scene(dict(good, **{key: bad}))
    with pytest.raises(ValidationError):
        validate_scene(dict(good, nodes8c=good["nodes8c"][:, :48]))


CAMERA_BREAKS = {
    "none": lambda c: None,
    "nan_view": lambda c: c["view"].__setitem__((0, 0), np.nan),
    "shape": lambda c: c.__setitem__("proj", c["proj"][:3]),
    "inverse": lambda c: c.__setitem__("view_inv", c["view_inv"] * 2.0),
    "pos": lambda c: c.__setitem__("camera_pos", c["camera_pos"][:2]),
}


@pytest.mark.parametrize("kind", sorted(CAMERA_BREAKS))
def test_validate_camera_raises_like_tpurt(kind, scene):
    from tpurt.utils.debug import validate_camera as ref_validate
    from tpurt_torch.engine import convert
    from tpurt_torch.utils.debug import validate_camera

    cam = {k: np.array(v) for k, v in scene.camera.uniform().items()}
    CAMERA_BREAKS[kind](cam)
    port = convert.camera_tensors(cam, "cpu")
    if kind == "none":
        ref_validate(cam)
        validate_camera(port)
        return
    with pytest.raises(AssertionError):
        ref_validate(cam)
    with pytest.raises(AssertionError):
        validate_camera(port)


def test_validate_camera_checks_dtype(scene):
    from tpurt_torch.engine import convert
    from tpurt_torch.utils.debug import ValidationError, validate_camera

    cam = convert.camera_tensors(scene.camera.uniform(), "cpu")
    with pytest.raises(ValidationError):
        validate_camera(dict(cam, view=cam["view"].double()))


def test_validation_scope_raises_on_nan(scene, monkeypatch):
    """Inside validation() a frame with a NaN output raises; outside, and
    with nan_checks=False, it renders; eager is accepted."""
    from tpurt_torch.engine import frame
    from tpurt_torch.utils import debug

    with debug.validation():
        assert debug.nan_checks_enabled()
        scene.render()           # a sound frame passes
    assert not debug.nan_checks_enabled()

    real = frame.quantize_r11g11b10f

    def poisoned(x):
        out = real(x)
        return out.masked_fill(torch.zeros_like(out, dtype=torch.bool)
                               .index_fill_(0, torch.tensor([0]), True),
                               float("nan"))

    monkeypatch.setattr(frame, "quantize_r11g11b10f", poisoned)
    scene.render()               # no checks outside the scope
    with debug.validation(nan_checks=True, eager=True):
        with pytest.raises(FloatingPointError):
            scene.render()
    with debug.validation(nan_checks=False):
        scene.render()
