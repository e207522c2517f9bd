"""Shade's surface reconstruction (K10): each hit's shading point, TBN basis
and material terms in one launch.

:func:`shade_surface` gives ``passes/shade.surface``'s dict (valid,
world_pos, N, V, albedo, roughness, metallic) for a batch of primary hits.
On CUDA tensors it is one launch of ``csrc/shade_surface.cu`` where the
texels come from the scene's quad rows; where a step of the fetch runs
outside the kernel it is a pre-pass and an epilogue around that step:

* a mip scene (``tex_mip_sizes``): the pre-pass writes the attr rows, the
  world normal, the uv and the cone's spread that K9
  (``kernels/mip_texels``, inside the span ``shade.texels``) reads, and
  ``shade_surface_nmap_kernel`` applies the normal map, pow and ORM to
  K9's (N, 12) texels: three launches;
* the sharded-geometry ``quad_gather`` hook on a scene without mips: the
  pre-pass writes each lane's flat quad row index and lerp weights, the
  hook serves the rows, and the epilogue lerps them and finishes.

The ``attr_rows`` hook's rows are read in place of the ``tri_attr``
gather, and the closest-hit uv payload, where the hits carry it, in place
of the attr row's image and uv. The kernels pick their work from these
inputs alone. On CPU tensors ``passes/shade.surface_plain`` runs instead,
the torch chain bit-equal to the kernels on the card. tpurt has no kernel
here: its surface reconstruction is XLA code
(``tpurt/passes/shade.py:573-745``).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.spans import no_step
from . import build
from .traverse_bvh8 import PAYLOAD_KEYS

# the pre-pass's modes and the epilogue's texel sources, by the kernels'
# indices (csrc/shade_surface.cu)
MODES = ("quad", "rows", "mip")
SOURCES = ("texels", "rows")
# tri_attr's columns (passes/shade.py surface_plain) and the texel rows
ATTR_COLUMNS = 40
ROW_BYTES = 64

_P = ctypes.c_void_p
_SURFACE_ARGS = ([ctypes.c_int] * 2 + [_P] * 9 + [ctypes.c_longlong]
                 + [_P] * 4 + [ctypes.c_longlong] * 2 + [_P] * 15
                 + [ctypes.c_int, ctypes.c_float, _P])
_NMAP_ARGS = [ctypes.c_int] + [_P] * 10 + [ctypes.c_int, _P]


def _shade():
    # passes/shade.py imports this module for its surface; the plain chain
    # and K9's call are shade's
    from ..passes import shade

    return shade


def _require(name: str, cond: bool, what: str):
    if not cond:
        raise ValueError(f"{name}: {what}")


def _check(name: str, tensors: dict, shapes: dict, device, cuda: bool):
    """Each tensor of its (shape, dtype) (None in a shape: any extent) and
    on `device`; on the card also contiguous."""
    for key, t in tensors.items():
        shape, dtype = shapes[key]
        ok = (isinstance(t, torch.Tensor) and t.dim() == len(shape)
              and all(want is None or got == want
                      for got, want in zip(t.shape, shape)))
        _require(name, ok and t.dtype == dtype and t.device == device,
                 f"{key} must be {shape} {dtype} on {device}, got "
                 + (f"{tuple(t.shape)} {t.dtype} on {t.device}"
                    if isinstance(t, torch.Tensor) else type(t).__name__))
    if cuda:
        build.require_cuda(name, tensors, device)


def _aligned(t):
    """`t` contiguous and on 16 bytes (the kernels' vector loads)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _inputs(scene, camera, hits, direction, rows, attr_rows, quad_gather,
            quad_shape):
    """The checks on every device; returns (n, device, the quad slab's
    shape or None)."""
    name = "shade_surface"
    tri = hits["tri"]
    _require(name, isinstance(tri, torch.Tensor) and tri.dim() == 1,
             "hits['tri'] must be (N,)")
    n, dev = tri.shape[0], tri.device
    cuda = dev.type == "cuda"
    f1 = ((n,), torch.float32)
    tensors = dict(tri=tri, u=hits["u"], v=hits["v"],
                   camera_pos=camera["camera_pos"])
    shapes = dict(tri=((n,), torch.int32), u=f1, v=f1,
                  camera_pos=((3,), torch.float32))
    if attr_rows is not None:
        tensors["attr_rows"] = attr_rows
        shapes["attr_rows"] = ((n, ATTR_COLUMNS), torch.float32)
    else:
        tensors["tri_attr"] = scene["tri_attr"]
        shapes["tri_attr"] = ((None, ATTR_COLUMNS), torch.float32)
    shape = None
    if "tex_mip_sizes" in scene:
        _require(name, direction is not None and rows > 0,
                 "a mip scene needs the primary rays' direction and the "
                 "image's rows")
        tensors.update(direction=direction, proj=camera["proj"])
        shapes.update(direction=((n, 3), torch.float32),
                      proj=((4, 4), torch.float32))
    else:
        if "texu" in hits:
            tensors.update({k: hits[k] for k in PAYLOAD_KEYS})
            shapes.update({k: f1 for k in PAYLOAD_KEYS})
        if quad_gather is None:
            tensors["tex_quad"] = scene["tex_quad"]
            shapes["tex_quad"] = ((None, ROW_BYTES), torch.uint8)
        else:
            _require(name, callable(quad_gather),
                     "quad_gather must be callable")
        if "tex_quad_base" in scene:
            tensors["tex_quad_base"] = scene["tex_quad_base"]
            shapes["tex_quad_base"] = ((None,), torch.int32)
        else:
            shape = (scene.get("tex_quad_shape") if quad_shape is None
                     else quad_shape)
            _require(name, shape is not None and len(shape) == 4,
                     f"the quad slab's shape must be (U, H, W, 64), got "
                     f"{shape}")
    _check(name, tensors, shapes, dev, cuda)
    return n, dev, shape


def shade_surface(scene: dict, camera: dict, hits: dict, direction=None, *,
                  aniso_taps: int = 1, rows: int = 0, attr_rows=None,
                  quad_gather=None, quad_shape=None, step=no_step) -> dict:
    """``passes/shade.surface``'s outputs, with its arguments: valid (N,)
    bool, world_pos, N, V, albedo (N, 3) f32, roughness, metallic (N,) f32.
    hits holds tri (N,) int32, u and v (N,) f32 and, optionally, the uv
    payload's texu, texv, img, texh, texw (N,) f32. Refuses other shapes
    and dtypes on every device, and tensors on another device or
    non-contiguous on the card."""
    n, dev, shape = _inputs(scene, camera, hits, direction, rows, attr_rows,
                            quad_gather, quad_shape)
    shade = _shade()
    if dev.type != "cuda":
        return shade.surface_plain(
            scene, camera, hits, direction, aniso_taps=aniso_taps, rows=rows,
            attr_rows=attr_rows, quad_gather=quad_gather,
            quad_shape=quad_shape, step=step)
    mip = "tex_mip_sizes" in scene
    mode = "mip" if mip else "quad" if quad_gather is None else "rows"

    def f32(*size):
        return torch.empty(size, dtype=torch.float32, device=dev)

    out = dict(valid=torch.empty((n,), dtype=torch.bool, device=dev),
               world_pos=f32(n, 3), V=f32(n, 3), N=f32(n, 3),
               albedo=f32(n, 3), roughness=f32(n), metallic=f32(n))
    tmp = dict.fromkeys(("normal", "tangent", "binormal", "uv", "attr",
                         "spread", "flat", "weights"))
    if mode != "quad":
        tmp.update(normal=f32(n, 3), tangent=f32(n, 3), binormal=f32(n, 3))
    if mode == "mip":
        tmp.update(uv=f32(n, 2), attr=f32(n, ATTR_COLUMNS), spread=f32(1))
    if mode == "rows":
        tmp.update(flat=torch.empty((n,), dtype=torch.int64, device=dev),
                   weights=f32(n, 2))
    attr = _aligned(scene["tri_attr"] if attr_rows is None else attr_rows)
    quad = scene["tex_quad"] if mode == "quad" else None
    base = None if mip else scene.get("tex_quad_base")
    h, w = (shape[1], shape[2]) if shape is not None else (0, 0)
    pay = ([hits[k] for k in PAYLOAD_KEYS] if not mip and "texu" in hits
           else [None] * len(PAYLOAD_KEYS))
    proj11 = camera["proj"][1, 1] if mip else None

    def p(t):
        return None if t is None else build.ptr(t)

    fn = build.function("tpurt_shade_surface", _SURFACE_ARGS)
    build.check(fn(MODES.index(mode), int(attr_rows is not None),
                   p(hits["tri"]), p(hits["u"]), p(hits["v"]),
                   *map(p, pay), p(attr), attr.stride(0),
                   p(camera["camera_pos"]), p(proj11), p(quad), p(base), h,
                   w, *(p(out[k]) for k in ("valid", "world_pos", "V", "N",
                                            "albedo", "roughness",
                                            "metallic")),
                   *map(p, tmp.values()), n, float(rows),
                   build.stream_of(out["N"])), "tpurt_shade_surface")
    build.launch_counts["shade_surface"] += 1
    if mode == "quad":
        return out
    if mode == "mip":
        with step("shade.texels"):
            texels = shade._mip_texels(scene, hits, direction, tmp["attr"],
                                       tmp["normal"], tmp["uv"],
                                       tmp["spread"], aniso_taps,
                                       gather=quad_gather)
        _nmap("texels", out, tmp, texels=_aligned(texels))
    else:
        served = quad_gather(tmp["flat"])
        _check("shade_surface", dict(rows=served),
               dict(rows=((n, ROW_BYTES), torch.uint8)), dev, False)
        _nmap("rows", out, tmp, rows=_aligned(served))
    return out


def _nmap(src: str, out: dict, tmp: dict, texels=None, rows=None):
    """The epilogue: N, albedo, roughness and metallic from K9's texels or
    from the served quad rows and the pre-pass's weights."""
    def p(t):
        return None if t is None else build.ptr(t)

    fn = build.function("tpurt_shade_surface_nmap", _NMAP_ARGS)
    build.check(fn(SOURCES.index(src), p(texels), p(rows), p(tmp["weights"]),
                   p(tmp["normal"]), p(tmp["tangent"]), p(tmp["binormal"]),
                   p(out["N"]), p(out["albedo"]), p(out["roughness"]),
                   p(out["metallic"]), out["N"].shape[0],
                   build.stream_of(out["N"])), "tpurt_shade_surface_nmap")
    build.launch_counts["shade_surface_nmap"] += 1
