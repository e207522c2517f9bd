"""A mip scene's texel fetch (K9): the ray-cone footprint and every tap's
trilinear sample of the three packed layers in one launch.

:func:`mip_texels` gives the (N, 12) [albedo4 | orm4 | normal4] texels of
a batch of primary hits through the scene's mip tier ("quad", "pair" or
"block4", the one ``flatten_scene`` ships): the footprint as
``passes/shade.ray_cone_lod`` (1 tap) or ``ray_cone_aniso`` (more)
computes it, then ``sample_trilinear_<tier>`` or ``sample_anisotropic_
<tier>`` at it. On CUDA tensors it is one launch of ``csrc/mip_texels.cu``;
with a `gather` hook serving the tier's rows (the sharded-geometry frame's
ring) it is two: :func:`mip_texel_rows`, the index of every row the filter
reads, and the filter over the rows the hook returns for them. On CPU
tensors :func:`mip_texels_plain` and :func:`mip_texel_rows_plain` run
instead, the torch chain that ``passes/shade.py`` ran and its row
indices, bit-equal to the kernels on the card. tpurt has no kernel here:
its fetch is XLA code (``tpurt/passes/shade.py:616-694``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# the tiers the kernel is instantiated for, by its tier index
TIERS = ("quad", "pair", "block4")
# the rows one bilinear sample reads in each tier (csrc rows_per_sample)
ROWS_PER_SAMPLE = {"quad": 1, "pair": 2, "block4": 4}
ROW_BYTES = 64
# tri_attr columns the footprint reads (passes/shade.py surface): the
# corners' positions and uvs and, at 36, the primitive
ATTR_COLUMNS = 37


def _shade():
    # passes/shade.py imports this module for its fetch; the plain chain
    # is shade's samplers and ray cones
    from ..passes import shade

    return shade


def _footprint_plain(sizes, t, direction, normal, attr, spread, taps: int):
    """(prim, lod, duv): the primitive of each tri_attr row and its
    footprint, ``ray_cone_lod`` with taps <= 1 (duv None), else
    ``ray_cone_aniso`` with max_aniso 16; extents from level 0 of the
    primitive's chain."""
    shade = _shade()
    prim = attr[:, 36].to(torch.int32)
    tex_hw = sizes[prim.long(), 0].to(torch.float32)
    cone = (t, direction, normal, attr[:, 0:3], attr[:, 12:15],
            attr[:, 24:27], attr[:, 3:5], attr[:, 15:17], attr[:, 27:29],
            tex_hw[:, 1], tex_hw[:, 0], spread)
    if taps > 1:
        return (prim, *shade.ray_cone_aniso(*cone, max_aniso=16))
    return prim, shade.ray_cone_lod(*cone), None


def mip_texels_plain(tier: str, table, offsets, sizes, t, direction,
                     normal, attr, uv, spread, taps: int, *,
                     footprint: bool = False, gather=None):
    """Plain PyTorch version of K9 on any device, the torch chain: the
    footprint (``_footprint_plain``) and the tier's trilinear sample at
    it, or its `taps` anisotropic taps. `gather` as ``passes/shade.
    _gather_rows``'s, in place of `table`. With footprint=True returns
    (texels, lod, duv), duv None for one tap."""
    shade = _shade()
    prim, lod, duv = _footprint_plain(sizes, t, direction, normal, attr,
                                      spread, taps)
    if taps > 1:
        out = getattr(shade, f"sample_anisotropic_{tier}")(
            table, offsets, sizes, prim, uv, lod, duv, taps, gather=gather)
    else:
        out = getattr(shade, f"sample_trilinear_{tier}")(
            table, offsets, sizes, prim, uv, lod, gather=gather)
    return (out, lod, duv) if footprint else out


def mip_texel_rows_plain(tier: str, offsets, sizes, t, direction, normal,
                         attr, uv, spread, taps: int):
    """Plain PyTorch version of the rows the fetch reads, on any device:
    (N, taps, 2, ROWS_PER_SAMPLE[tier]) int32 global row indices of the
    tier's table, per lane, tap (uv' as ``passes/shade._anisotropic``
    spreads it), level (the lower first, ``_lod_levels``) and the row of
    the tier's bilinear sample (``_mip_quad_flat_index``,
    ``_pair_corners``, ``_block4_corners``), in the order the samplers
    gather them."""
    shade = _shade()
    prim, lod, duv = _footprint_plain(sizes, t, direction, normal, attr,
                                      spread, taps)
    levels = shade._lod_levels(lod, sizes.shape[1])[:2]

    def rows(q, level):
        if tier == "quad":
            return [shade._mip_quad_flat_index(offsets, sizes, prim, q,
                                               level)[0]]
        if tier == "pair":
            return list(shade._pair_corners(offsets, sizes, prim, q,
                                            level)[:2])
        return shade._block4_corners(offsets, sizes, prim, q, level)[0]

    taps = max(int(taps), 1)
    per_tap = []
    for i in range(taps):
        q = uv if taps == 1 else uv + duv * ((i + 0.5) / taps - 0.5)
        per_tap.append(torch.stack([torch.stack(rows(q, level), -1)
                                    for level in levels], -2))
    return torch.stack(per_tap, 1).to(torch.int32)


def _require(name: str, cond: bool, what: str):
    if not cond:
        raise ValueError(f"{name}: {what}")


def _check(name: str, tensors: dict, shapes: dict, device):
    """Each tensor of its (shape, dtype) (None in a shape: any extent), on
    `device`, and contiguous."""
    for key, t in tensors.items():
        shape, dtype = shapes[key]
        ok = t.dim() == len(shape) and all(
            want is None or got == want for got, want in zip(t.shape, shape))
        _require(name, ok and t.dtype == dtype,
                 f"{key} must be {shape} {dtype}, got {tuple(t.shape)} "
                 f"{t.dtype}")
    build.require_cuda(name, tensors, device)


def _check_rows(name: str, key: str, rows, count, device):
    """(count, 64) u8 rows (count None: any) on `device`, contiguous and on
    16 bytes (the kernel loads them in 16-byte words)."""
    _check(name, {key: rows}, {key: ((count, ROW_BYTES), torch.uint8)},
           device)
    _require(name, rows.data_ptr() % 16 == 0, f"{key} must start on 16 "
             f"bytes")


_HITS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
         + [ctypes.c_void_p] * 2)
_TEXELS_ARGS = ([ctypes.c_int] + _HITS + [ctypes.c_void_p, ctypes.c_int]
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 4)
_ROWS_ARGS = ([ctypes.c_int] + _HITS + [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)


def _check_hits(name, tier, offsets, sizes, t, direction, normal, attr,
                uv, spread):
    """The checks both wrappers make on every device; returns `spread` as
    a one-element f32 tensor on the hits' device."""
    n, dev = t.shape[0], t.device
    f3 = ((n, 3), torch.float32)
    _check(name, dict(t=t, direction=direction, normal=normal, uv=uv),
           dict(t=((n,), torch.float32), direction=f3, normal=f3,
                uv=((n, 2), torch.float32)), dev)
    _require(name, attr.dim() == 2 and attr.shape[0] == n
             and attr.shape[1] >= ATTR_COLUMNS
             and attr.dtype == torch.float32 and attr.stride(1) == 1
             and attr.device == dev, f"attr must be ({n}, >= "
             f"{ATTR_COLUMNS}) float32 rows on {dev}, got "
             f"{tuple(attr.shape)} {attr.dtype} on {attr.device}")
    _require(name, tier in TIERS, f"unknown tier {tier!r}")
    _require(name, offsets.dim() == 2, f"offsets must be (P, L), got "
             f"{tuple(offsets.shape)}")
    p, levels = offsets.shape
    _check(name, dict(offsets=offsets, sizes=sizes),
           dict(offsets=((p, levels), torch.int32),
                sizes=((p, levels, 2), torch.int32)), dev)
    if not isinstance(spread, torch.Tensor):
        spread = torch.full((), float(spread), dtype=torch.float32,
                            device=dev)
    _require(name, spread.numel() == 1 and spread.dtype == torch.float32
             and spread.device == dev, f"spread must be one float32 on "
             f"{dev}")
    return spread


def _entry(tier, offsets, t, direction, normal, attr, uv, spread, taps):
    """Both C entries' arguments before the tables (the tier index, the
    hits' pointers, attr's row stride) and after them (levels, n, taps)."""
    p = build.ptr
    return ([TIERS.index(tier), p(t), p(direction), p(normal), p(attr),
             attr.stride(0), p(uv), p(spread)],
            [offsets.shape[1], t.shape[0], taps])


def mip_texel_rows(tier: str, offsets, sizes, t, direction, normal, attr,
                   uv, spread, taps: int):
    """The global index of every row of the tier's table that
    :func:`mip_texels` reads for these hits: (N, taps, 2,
    ROWS_PER_SAMPLE[tier]) int32, per lane, tap, level (the lower first)
    and the bilinear sample's row. Inputs as :func:`mip_texels`'s. One
    launch on CUDA tensors, :func:`mip_texel_rows_plain` on CPU tensors.
    Refuses what :func:`mip_texels` refuses."""
    spread = _check_hits("mip_texel_rows", tier, offsets, sizes, t,
                         direction, normal, attr, uv, spread)
    if t.device.type != "cuda":
        return mip_texel_rows_plain(tier, offsets, sizes, t, direction,
                                    normal, attr, uv, spread, taps)
    taps = max(int(taps), 1)
    flats = torch.empty((t.shape[0], taps, 2, ROWS_PER_SAMPLE[tier]),
                        dtype=torch.int32, device=t.device)
    hits, shape = _entry(tier, offsets, t, direction, normal, attr, uv,
                         spread, taps)
    p = build.ptr
    fn = build.function("tpurt_mip_texel_rows", _ROWS_ARGS)
    build.check(fn(*hits, p(offsets), p(sizes), *shape, p(flats),
                   build.stream_of(t)), "tpurt_mip_texel_rows")
    build.launch_counts["mip_texel_rows"] += 1
    return flats


def mip_texels(tier: str, table, offsets, sizes, t, direction, normal,
               attr, uv, spread, taps: int, *, footprint: bool = False,
               gather=None):
    """The (N, 12) f32 texels of N primary hits through the mip `tier`'s
    rows `table` (R, 64) u8, `offsets` (P, L) and `sizes` (P, L, 2)
    int32: t (N,) f32, direction and normal (N, 3) f32, attr (N, >= 37)
    f32 tri_attr rows (their columns contiguous; corners, uvs and the
    primitive as ``passes/shade.surface`` lays them out), uv (N, 2) f32
    the interpolated uv, spread the cone's spread angle (a one-element f32
    tensor or a float), taps <= 1 trilinear, else anisotropic. With
    `gather` (global row indices (M,) int64 -> (M, 64) u8 rows) in place
    of `table` (None), the hook serves the rows that
    :func:`mip_texel_rows` names. With footprint=True returns (texels,
    lod (N,), duv (N, 2) or None for one tap). Refuses other shapes,
    dtypes, devices and non-contiguous inputs on every device."""
    name = "mip_texels"
    dev = t.device
    spread = _check_hits(name, tier, offsets, sizes, t, direction, normal,
                         attr, uv, spread)
    if gather is None:
        _check_rows(name, "table", table, None, dev)
    else:
        _require(name, table is None, "pass either table or gather")
    if dev.type != "cuda":
        return mip_texels_plain(tier, table, offsets, sizes, t, direction,
                                normal, attr, uv, spread, taps,
                                footprint=footprint, gather=gather)
    taps = max(int(taps), 1)
    if gather is not None:
        flats = mip_texel_rows(tier, offsets, sizes, t, direction, normal,
                               attr, uv, spread, taps)
        table = gather(flats.reshape(-1).long())
        if table.data_ptr() % 16:
            table = table.clone()
        _check_rows(name, "the gathered rows", table, flats.numel(), dev)
    n = t.shape[0]
    out = torch.empty((n, 12), dtype=torch.float32, device=dev)
    lod = duv = None
    if footprint:
        lod = torch.empty((n,), dtype=torch.float32, device=dev)
        if taps > 1:
            duv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    hits, shape = _entry(tier, offsets, t, direction, normal, attr, uv,
                         spread, taps)
    p = build.ptr
    fn = build.function("tpurt_mip_texels", _TEXELS_ARGS)
    build.check(fn(*hits, p(table), int(gather is not None), p(offsets),
                   p(sizes), *shape, p(out),
                   *[None if x is None else p(x) for x in (lod, duv)],
                   build.stream_of(out)), "tpurt_mip_texels")
    build.launch_counts["mip_texels"] += 1
    return (out, lod, duv) if footprint else out
