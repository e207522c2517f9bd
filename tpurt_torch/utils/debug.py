"""Validation layer — port of ``tpurt/utils/debug.py``.

* ``validation(nan_checks, eager)``: a context manager with tpurt's
  signature. tpurt sets JAX's ``jax_debug_nans`` (raise where an operation
  makes a NaN) and, with ``eager``, ``jax_disable_jit``. PyTorch has no
  such flags, so here ``nan_checks`` makes every frame rendered inside the
  scope (``engine/frame.finish_frame``) check its float outputs and raise
  ``FloatingPointError`` on a NaN; infinities stay legal, as tpurt leaves
  ``jax_debug_infs`` off. ``eager`` does nothing: PyTorch always runs
  eagerly.
* ``validate_scene`` / ``validate_camera``: structural checks of the
  port's scene tensors (``engine/convert.scene_tensors``) and camera
  tensors (``convert.camera_tensors``) — shapes, dtypes, one device,
  finite geometry, index ranges — raising ``ValidationError`` (an
  ``AssertionError``, as tpurt's checks raise).
"""
from __future__ import annotations

import contextlib

import torch

_nan_checks = False


class ValidationError(AssertionError):
    pass


def _require(cond, msg: str):
    if not cond:
        raise ValidationError(msg)


@contextlib.contextmanager
def validation(nan_checks: bool = True, eager: bool = False):
    """Enable the debug validation mode within a scope (module
    docstring); `eager` is accepted for tpurt's callers and does
    nothing."""
    del eager
    global _nan_checks
    old = _nan_checks
    _nan_checks = nan_checks
    try:
        yield
    finally:
        _nan_checks = old


def nan_checks_enabled() -> bool:
    return _nan_checks


def check_outputs(out: dict, what: str = "frame"):
    """Inside ``validation(nan_checks=True)``: raise FloatingPointError
    when a float tensor of `out` holds a NaN (one device sync per
    tensor)."""
    if not _nan_checks:
        return
    for key, t in out.items():
        if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(
                torch.isnan(t).any()):
            raise FloatingPointError(f"{what}: NaN in {key!r}")


def _finite(t) -> bool:
    return bool(torch.isfinite(t).all())


# the scene's texel row tables (u8) and its texel index tables (int32)
_U8_TABLES = ("tex_quad", "tex_mip_quad", "tex_mip_pair", "tex_mip_block4")
_I32_TABLES = ("tex_quad_base", "tex_mip_sizes", "tex_mip_quad_offsets",
               "tex_mip_pair_offsets", "tex_mip_block4_offsets")


def _texel_rows(scene: dict, attr):
    """The texel tables' shapes, and the rows' image indices in range."""
    if "tex_mip_sizes" in scene:
        sizes = scene["tex_mip_sizes"]
        _require(sizes.ndim == 3 and sizes.shape[2] == 2,
                 "scene.tex_mip_sizes must be (P, L, 2)")
        _require(bool((sizes >= 1).all()), "mip extents must be >= 1")
        _require(bool((attr[:, 36] < sizes.shape[0]).all()),
                 "tri_attr primitive index out of range")
        return
    rows = scene["tex_quad"]
    _require(rows.ndim == 2, "texture rows shape")
    if "tex_quad_base" in scene:      # the streaming arena's layout
        base = scene["tex_quad_base"]
        images = base.shape[0]
        _require(bool(((base >= 0) & (base < rows.shape[0])).all()),
                 "texture row base out of range")
    else:
        shape = scene["tex_quad_shape"]
        images = shape[0]
        _require(tuple(rows.shape) == (shape[0] * shape[1] * shape[2],
                                       shape[3]), "texture rows shape")
    if attr.shape[1] == 40:
        img = attr[:, 39]
        _require(bool(((img >= 0) & (img < images)).all()),
                 "tri_attr image index out of range")


def validate_scene(scene: dict):
    """Invariant checks of the port's static scene tensors (raises
    ValidationError)."""
    nodes8, tris, attr = scene["nodes8"], scene["tris"], scene["tri_attr"]
    device = nodes8.device
    for key, t in scene.items():
        if isinstance(t, torch.Tensor):
            _require(t.device == device, f"scene.{key} is on {t.device}, "
                     f"the scene on {device}")
            want = (torch.uint8 if key in _U8_TABLES else torch.int32
                    if key in _I32_TABLES else torch.float32)
            _require(t.dtype == want, f"scene.{key} is {t.dtype}, not "
                     f"{want}")
    m, t = nodes8.shape[0], int(scene["num_tris"])
    _require(nodes8.ndim == 2 and nodes8.shape[1] == 128,
             "scene.nodes8 rows must be 128 lanes")
    _require(tuple(scene["nodes8c"].shape) == (m, 56),
             "scene.nodes8c must be (M, 56)")
    _require(tris.ndim == 2 and tris.shape == (max(t, 1), 12),
             "scene.tris must be (max(num_tris, 1), 12)")
    child = nodes8[:, 48:56]
    first, count = nodes8[:, 56:64], nodes8[:, 64:72]
    _require(bool(((child >= -1) & (child < m)).all()),
             "child link out of range")
    _require(bool(((first + count <= t) & (first >= 0)).all()),
             "leaf range out of bounds")
    _require(_finite(tris[:t, :9]), "triangle vertices non-finite")
    ids = torch.sort(tris[:t, 9]).values
    _require(torch.equal(ids, torch.arange(t, dtype=ids.dtype,
                                           device=device)),
             "tri_id must be a permutation")
    _require(attr.ndim == 2 and attr.shape[0] == t
             and attr.shape[1] in (39, 40), "tri_attr row shape")
    _require(_finite(attr), "tri_attr non-finite")
    _require(bool((attr[:, 36] >= 0).all()),
             "tri_attr primitive index out of range")
    _texel_rows(scene, attr)
    if "uvp" in scene:
        _require(tuple(scene["uvp"].shape) == (t, 9), "uvp row shape")


def validate_camera(camera: dict):
    """Shape, dtype, device and invariant checks of the camera tensors."""
    device = camera["view"].device
    for key in ("view", "view_inv", "proj", "proj_inv"):
        c = camera[key]
        _require(tuple(c.shape) == (4, 4), f"camera.{key} shape")
        _require(c.dtype == torch.float32 and c.device == device,
                 f"camera.{key} must be float32 on {device}")
        _require(_finite(c), f"camera.{key} non-finite")
    vi = camera["view"].double() @ camera["view_inv"].double()
    _require(torch.allclose(vi, torch.eye(4, dtype=torch.float64,
                                          device=device), atol=1e-4),
             "view * view_inv != I")
    pos = camera["camera_pos"]
    _require(tuple(pos.shape) == (3,) and pos.dtype == torch.float32
             and pos.device == device, "camera.camera_pos shape")
