"""Primary-hit shading — port of ``tpurt/passes/shade.py:shade`` on its
``tri_attr`` tables and texel tiers, with its per-light and fused shadows.

Per hit: one ``tri_attr`` row gives the three corners' position, uv,
normal and tangent; barycentric interpolation; Gram-Schmidt TBN; then the
albedo, ORM and normal-map texels, all three layers at once:

* without mips, one quad row gives the whole 2x2 bilinear footprint
  (``sample_bilinear_quad``), from the (U, H, W, 64) slab or from the
  streaming arena's per-image rows (``tex_quad_base``). When the
  closest-hit trace emitted the uv payload (hit keys ``texu``, ``texv``,
  ``img``, ``texh``, ``texw``: ``trace_closest_bvh8(uv_payload=True)``),
  the quad index reads them instead of the ``tri_attr`` row (tpurt
  ``shade.py:703-708``); the values are bit-equal;
* a mip scene (``tex_mip_sizes``) samples its tier (block4, pair or quad,
  the one ``flatten_scene`` ships) trilinearly at the ray-cone LOD of the
  primary ray (``ray_cone_lod``), or with ``aniso_taps > 1`` taps along
  the cone's elliptical footprint (``ray_cone_aniso``), tpurt
  ``shade.py:616-694``: on the card one launch of K9
  (``kernels/mip_texels.mip_texels``) for the footprint and every tap
  (two where the sharded-geometry ``gather=`` hook serves the rows), on
  CPU tensors the tier samplers below. It reads no uv payload, as tpurt
  takes this branch first. The per-layer atlas's samplers
  (``sample_trilinear``, ``sample_anisotropic``) and
  ``sample_bilinear`` over the padded stack are the plain definitions the
  tiers and the quad rows are held to; no frame reads them.

On the card the whole reconstruction, from the ``tri_attr`` row to the
material terms, is K10 (``kernels/shade_surface``): one launch without
mips, a pre-pass and an epilogue around K9 on a mip scene or around the
``quad_gather`` hook's rows; on CPU tensors ``surface_plain``, the torch
chain below, bit-equal to it.

Every gather index is in range by construction, as tpurt's arithmetic
makes it: texel coordinates wrap by ``torch.remainder`` with the level's
extent, LODs clamp to [0, L-1] (a NaN LOD, only from non-finite inputs,
takes level 0 as XLA's conversion does), miss lanes read triangle 0.
Outputs the unquantized G-buffer: color, view depth, encoded view normal.

The light schedule (tpurt ``shade.py:747-804``): a pre-pass builds every
light's L vector and shadow ray (lanes that need no ray get ``t_max = 0``),
``kernels/shade_lights.light_rays`` (K8a, one launch for every light on
the card); then each light's any-hit trace; then one sum of every light's
GGX + Burley BRDF, shadow attenuation and radiance in index order,
``light_sum`` (K8b, one launch). On CPU tensors both are the plain chain
of ``passes/light.py`` and ``passes/brdf.py``. With ``fuse_shadows=True``,
the BVH8 tables and more than one light, one fused multi-set trace (K5,
``trace_any_bvh8_multi``) covers every light instead of the per-light
traces, bit-equal to them. tpurt's frame never sets it; a fused frame is
``engine/frame.render_frame_fused``. tpurt's ``light_eval="hoist"`` /
``"batch"`` schedules, which only steer XLA's scheduling and give the
loop's bits, are not ported.

``tables`` picks the shadow tracer as tpurt's ``pallas_tables`` /
``max_leaf`` do (``tpurt/passes/shade.py:526-528, 867-872``): "bvh8" for
the BVH8 rows (K2: static and refit frames), "bvh2" for a binary BVH (K6
any-hit, leaves of up to ``max_leaf`` triangles: the rebuild frames, which
never fuse). tpurt's sharded-geometry hooks (``shade``'s ``attr_rows``,
``quad_gather``, ``quad_shape``, ``shadow_trace_fn`` and
``shadow_trace_multi_fn``, the samplers' ``gather=``) let
``dist/geometry.py`` serve the shading tables and the shadow rays through
its ring; with none set the frame is unchanged.
"""
from __future__ import annotations

import torch

from ..kernels.mip_texels import mip_texels
from ..kernels.shade_lights import light_rays, light_sum
from ..kernels.shade_surface import shade_surface
from ..kernels.traverse_bvh2 import trace_any_bvh2
from ..kernels.traverse_bvh8 import trace_any_bvh8, trace_any_bvh8_multi
from ..utils.spans import no_step
from .encodings import divide, rdivide, sqrt

SHADOW_T_MIN = 0.01
MISS_DEPTH = 10000.0


def _dot(a, b):
    """Left-to-right 3-term dot product: the same sum on every device (a
    library reduction may order the three terms differently)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _norm(v):
    return sqrt(_dot(v, v))[..., None]


def _normalize(v, eps=1e-20):
    return v / torch.clamp_min(_norm(v), eps)


def _texel_coords(hw, uv):
    """The bilinear footprint of `uv` in images of extents hw (N, 2) int32
    (h, w): the REPEAT-wrapped top-left texel (x0i, y0i) int32 and the lerp
    weights fx, fy (N, 1) f32 (tpurt's order of operations)."""
    h = hw[:, 0]
    w = hw[:, 1]
    px = uv[:, 0] * w.to(torch.float32) - 0.5
    py = uv[:, 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    return h, w, x0i, y0i, fx, fy


def _bilerp(t00, t10, t01, t11, fx, fy):
    out = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
           + (t01 * (1 - fx) + t11 * fx) * fy)
    return divide(out, 255.0)


def sample_bilinear(tex_stack, tex_size, prim, layer: int, uv,
                    images_per_prim: int = 3):
    """Bilinear REPEAT fetch from the padded per-primitive stack:
    tex_stack (P*images_per_prim, H, W, C) u8, tex_size (P, 2) int32, prim
    (N,), uv (N, 2). Returns (N, C) f32 in [0, 1]; images_per_prim=1
    addresses the packed 12-channel stack."""
    hw = tex_size[prim.long()]
    _, _, x0i, y0i, fx, fy = _texel_coords(hw, uv)
    x1i = torch.remainder(x0i + 1, hw[:, 1])
    y1i = torch.remainder(y0i + 1, hw[:, 0])
    img = (prim.long() * images_per_prim + layer)

    def tap(yi, xi):
        return tex_stack[img, yi.long(), xi.long()].to(torch.float32)

    return _bilerp(tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i),
                   tap(y1i, x1i), fx, fy)


def _quad_lerp(row, fx, fy):
    row = row.to(torch.float32)
    return _bilerp(row[:, 0:12], row[:, 12:24], row[:, 24:36],
                   row[:, 36:48], fx, fy)


def _gather_rows(table, flats, gather=None):
    """The rows of `table` at each index vector of `flats`; with `gather`
    (rows by flat global index from a row-sharded table, tpurt's sharded
    injection, ``dist/geometry.py``) all of them in one call, one ring
    tour, and `table` unused."""
    if gather is None:
        return [table[f.long()] for f in flats]
    return list(gather(torch.cat(flats).long()).split(flats[0].shape[0]))


def sample_bilinear_quad(quad, quad_shape, hw, img, uv, *, base=None,
                         gather=None):
    """Bilinear REPEAT fetch from quad rows: each 64-byte u8 row carries
    its texel's 2x2 footprint across the 3 packed layers (bytes 0..47).
    hw: (N, 2) f32 (h, w) extents; img: (N,) unique-image slot. `quad` is
    the (U*H*W, 64) slab of shape quad_shape (U, H, W, 64) (tpurt's
    ``shape=``), or, with `base` (U,) int32 (the streaming arena,
    ``engine/texture_arena.py``), rows laid out at each image's own extent
    from base[img]: flat = base[img] + y*w + x, the same values. `gather`
    as ``_gather_rows``'s, in place of `quad`."""
    h, w, x0i, y0i, fx, fy = _texel_coords(hw.to(torch.int32), uv)
    if base is not None:
        flat = base[img.long()] + y0i * w + x0i
    else:
        _, H, W, _ = quad_shape
        flat = (img.long() * H + y0i) * W + x0i
    return _quad_lerp(_gather_rows(quad, [flat], gather)[0], fx, fy)


def _lod_levels(lod, levels: int):
    """Clamp a LOD to [0, levels-1]: (l0 int32, l1 int32, frac (N, 1)).
    A NaN LOD (only from non-finite inputs) takes level 0, as XLA's
    float-to-int conversion gives it; every other lane is unchanged."""
    lod = torch.clamp(lod, 0.0, float(levels - 1))
    l0 = torch.floor(lod)
    frac = (lod - l0)[:, None]
    l0i = torch.nan_to_num(l0).to(torch.int32)
    l1i = torch.clamp_max(l0i + 1, levels - 1)
    return l0i, l1i, frac


def _trilerp(s0, s1, frac):
    return s0 * (1 - frac) + s1 * frac


def _sample_mip_bilinear(atlas, offsets, sizes, prim, layer: int, uv,
                         level):
    """Bilinear REPEAT fetch of one layer at an integer mip `level` (per
    lane) from the per-layer atlas: atlas (N, 4) u8, offsets (P*3, L)
    int32, sizes (P, L, 2) int32."""
    prim = prim.long()
    level = level.long()
    h, w, x0i, y0i, fx, fy = _texel_coords(sizes[prim, level], uv)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    base = offsets[prim * 3 + layer, level]

    def tap(yi, xi):
        return atlas[(base + yi * w + xi).long()].to(torch.float32)

    return _bilerp(tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i),
                   tap(y1i, x1i), fx, fy)


def sample_trilinear(atlas, offsets, sizes, prim, layer: int, uv, lod):
    """Trilinear fetch of one layer: bilinear at the two mip levels around
    the clamped `lod`, lerped by its fraction (the reference's LINEAR /
    LINEAR / LINEAR sampler)."""
    l0i, l1i, frac = _lod_levels(lod, sizes.shape[1])
    return _trilerp(
        _sample_mip_bilinear(atlas, offsets, sizes, prim, layer, uv, l0i),
        _sample_mip_bilinear(atlas, offsets, sizes, prim, layer, uv, l1i),
        frac)


def _mip_quad_flat_index(qoffsets, sizes, prim, uv, level):
    """The quad tier's row index and lerp weights at integer `level`."""
    prim = prim.long()
    level = level.long()
    _, w, x0i, y0i, fx, fy = _texel_coords(sizes[prim, level], uv)
    return qoffsets[prim, level] + y0i * w + x0i, fx, fy


def sample_trilinear_quad(qatlas, qoffsets, sizes, prim, uv, lod, *,
                          gather=None):
    """Trilinear fetch of all three layers through the quad tier: two row
    gathers, bit-equal to sample_trilinear per layer; (N, 12) [albedo4 |
    orm4 | normal4]. With `gather` both levels' rows come in one call."""
    l0i, l1i, frac = _lod_levels(lod, sizes.shape[1])
    f0, fx0, fy0 = _mip_quad_flat_index(qoffsets, sizes, prim, uv, l0i)
    f1, fx1, fy1 = _mip_quad_flat_index(qoffsets, sizes, prim, uv, l1i)
    r0, r1 = _gather_rows(qatlas, [f0, f1], gather)
    return _trilerp(_quad_lerp(r0, fx0, fy0), _quad_lerp(r1, fx1, fy1),
                    frac)


def _pair_corners(poffsets, sizes, prim, uv, level):
    """The pair tier's two row indices (columns x0 and (x0+1)%w, the same
    row when x0 is even), their x parities and the lerp weights:
    (flat0, flat1, x0par, x1par, fx, fy)."""
    prim = prim.long()
    level = level.long()
    _, w, x0i, y0i, fx, fy = _texel_coords(sizes[prim, level], uv)
    x1i = torch.remainder(x0i + 1, w)
    bw = (w + 1) // 2
    base = poffsets[prim, level] + y0i * bw
    return (base + x0i // 2, base + x1i // 2, x0i & 1, x1i & 1, fx, fy)


def _pair_lerp(row0, row1, x0par, x1par, fx, fy):
    """Each column's top and bottom texels by parity from its pair row,
    then the quad tier's bilinear expression."""
    r0 = row0.to(torch.float32)
    r1 = row1.to(torch.float32)

    def col(r, par, half):
        return torch.where((par == 1)[:, None], r[:, half + 12:half + 24],
                           r[:, half:half + 12])

    return _bilerp(col(r0, x0par, 0), col(r1, x1par, 0), col(r0, x0par, 24),
                   col(r1, x1par, 24), fx, fy)


def sample_trilinear_pair(pr, poffsets, sizes, prim, uv, lod, *,
                          gather=None):
    """Trilinear fetch through the pair tier: four row gathers (two
    columns at two levels), bit-equal to the quad tier. With `gather` the
    four come in one call."""
    l0i, l1i, frac = _lod_levels(lod, sizes.shape[1])
    c0 = _pair_corners(poffsets, sizes, prim, uv, l0i)
    c1 = _pair_corners(poffsets, sizes, prim, uv, l1i)
    rows = _gather_rows(pr, [c0[0], c0[1], c1[0], c1[1]], gather)
    return _trilerp(_pair_lerp(rows[0], rows[1], *c0[2:]),
                    _pair_lerp(rows[2], rows[3], *c1[2:]), frac)


def _block4_corners(boffsets, sizes, prim, uv, level):
    """The block4 tier's row index and slot of each bilinear corner, in
    quad-row order [t00, t10, t01, t11]: (flats, slots, fx, fy)."""
    prim = prim.long()
    level = level.long()
    h, w, x0i, y0i, fx, fy = _texel_coords(sizes[prim, level], uv)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    bw = (w + 1) // 2
    base = boffsets[prim, level]
    corners = [(y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i)]
    flats = [base + (yi // 2) * bw + (xi // 2) for yi, xi in corners]
    slots = [(yi & 1) * 2 + (xi & 1) for yi, xi in corners]
    return flats, slots, fx, fy


def _block4_lerp(rows, slots, fx, fy):
    """Each corner's 12 texel bytes by slot from its block row, then the
    quad tier's bilinear expression."""
    taps = []
    for row, slot in zip(rows, slots):
        rb = row.to(torch.float32)
        v = rb[:, 0:12]
        for k in range(1, 4):
            v = torch.where((slot == k)[:, None], rb[:, 12 * k:12 * (k + 1)],
                            v)
        taps.append(v)
    return _bilerp(*taps, fx, fy)


def sample_trilinear_block4(b4, boffsets, sizes, prim, uv, lod, *,
                            gather=None):
    """Trilinear fetch through the block4 tier: eight row gathers (four
    corners at two levels), bit-equal to the quad tier. With `gather` the
    eight come in one call."""
    l0i, l1i, frac = _lod_levels(lod, sizes.shape[1])
    f0, s0, fx0, fy0 = _block4_corners(boffsets, sizes, prim, uv, l0i)
    f1, s1, fx1, fy1 = _block4_corners(boffsets, sizes, prim, uv, l1i)
    rows = _gather_rows(b4, f0 + f1, gather)
    return _trilerp(_block4_lerp(rows[:4], s0, fx0, fy0),
                    _block4_lerp(rows[4:], s1, fx1, fy1), frac)


def _anisotropic(trilinear, uv, duv_major, taps: int):
    """`taps` trilinear fetches trilinear(uv') spread along the footprint's
    major axis (uv' = uv + duv_major * f, f in (-1/2, 1/2)), averaged."""
    acc = None
    for i in range(taps):
        f = (i + 0.5) / taps - 0.5
        s = trilinear(uv + duv_major * f)
        acc = s if acc is None else acc + s
    return divide(acc, taps)


def sample_anisotropic(atlas, offsets, sizes, prim, layer: int, uv,
                       lod_minor, duv_major, taps: int):
    """Anisotropic filtering of one layer through the per-layer atlas:
    `taps` trilinear taps at the minor-axis LOD, averaged."""
    return _anisotropic(lambda q: sample_trilinear(
        atlas, offsets, sizes, prim, layer, q, lod_minor), uv, duv_major,
        taps)


def sample_anisotropic_quad(qatlas, qoffsets, sizes, prim, uv, lod_minor,
                            duv_major, taps: int, *, gather=None):
    """Anisotropic filtering through the quad tier (`gather` per tap)."""
    return _anisotropic(lambda q: sample_trilinear_quad(
        qatlas, qoffsets, sizes, prim, q, lod_minor, gather=gather), uv,
        duv_major, taps)


def sample_anisotropic_pair(pr, poffsets, sizes, prim, uv, lod_minor,
                            duv_major, taps: int, *, gather=None):
    """Anisotropic filtering through the pair tier (`gather` per tap)."""
    return _anisotropic(lambda q: sample_trilinear_pair(
        pr, poffsets, sizes, prim, q, lod_minor, gather=gather), uv,
        duv_major, taps)


def sample_anisotropic_block4(b4, boffsets, sizes, prim, uv, lod_minor,
                              duv_major, taps: int, *, gather=None):
    """Anisotropic filtering through the block4 tier (`gather` per tap)."""
    return _anisotropic(lambda q: sample_trilinear_block4(
        b4, boffsets, sizes, prim, q, lod_minor, gather=gather), uv,
        duv_major, taps)


def _cross(a, b):
    """a x b of (N, 3) rows as products and one difference per component:
    the same roundings on every device (a library kernel may fuse them)."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def _texel_density(p0, p1, p2, uv0, uv1, uv2, tex_w, tex_h):
    """Texels per world unit of a triangle's texture mapping, and its
    edges e1, e2 and uv edges duv1, duv2."""
    e1 = p1 - p0
    e2 = p2 - p0
    world_area = 0.5 * _norm(_cross(e1, e2))[:, 0]
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    uv_area = 0.5 * torch.abs(duv1[:, 0] * duv2[:, 1]
                              - duv1[:, 1] * duv2[:, 0])
    tpw = sqrt(uv_area * tex_w * tex_h / torch.clamp_min(world_area, 1e-12))
    return tpw, e1, e2, duv1, duv2


def ray_cone_lod(t, direction, N, p0, p1, p2, uv0, uv1, uv2, tex_w, tex_h,
                 spread):
    """Texture LOD from the ray-cone footprint (Akenine-Moeller et al.,
    "Texture Level of Detail Strategies for Real-Time Ray Tracing"): the
    cone's diameter at the hit over the surface's obliquity (bounded at
    4x), in texels of the triangle's mapping, as log2."""
    cone_diam = t * spread
    cos_in = torch.abs(_dot(N, direction))
    footprint = cone_diam / torch.clamp_min(cos_in, 0.25)
    tpw = _texel_density(p0, p1, p2, uv0, uv1, uv2, tex_w, tex_h)[0]
    return torch.log2(torch.clamp_min(footprint * tpw, 1e-6))


def ray_cone_aniso(t, direction, N, p0, p1, p2, uv0, uv1, uv2, tex_w, tex_h,
                   spread, max_aniso: int = 16):
    """The elliptical ray-cone footprint for anisotropic filtering (the
    reference sampler's max_anisotropy=16): the minor axis is the cone's
    diameter, the major one that over |N.D| (at most max_aniso times it)
    along D projected into the surface. Returns (lod_minor, duv_major):
    the minor axis's mip level and the major axis's whole extent in uv
    space; a degenerate triangle (det/(g11*g22) <= 1e-8) gets duv 0."""
    cone_diam = t * spread
    d_dot_n = _dot(N, direction)
    cos_in = torch.abs(d_dot_n)
    tpw, e1, e2, duv1, duv2 = _texel_density(p0, p1, p2, uv0, uv1, uv2,
                                             tex_w, tex_h)
    lod_minor = torch.log2(torch.clamp_min(cone_diam * tpw, 1e-6))

    proj = direction - d_dot_n[:, None] * N
    pdir = proj / torch.clamp_min(_norm(proj), 1e-20)
    aniso = torch.clamp(rdivide(1.0, torch.clamp_min(cos_in, 1e-4)), 1.0,
                        float(max_aniso))
    major_len = cone_diam * aniso

    # pdir = a*e1 + b*e2 in the triangle's plane (a 2x2 Gram system), then
    # duv = a*duv1 + b*duv2
    g11 = _dot(e1, e1)
    g12 = _dot(e1, e2)
    g22 = _dot(e2, e2)
    r1 = _dot(pdir, e1)
    r2 = _dot(pdir, e2)
    det = g11 * g22 - g12 * g12
    ok = (det > 1e-8 * g11 * g22)[:, None]
    inv_det = rdivide(1.0, torch.clamp_min(det, 1e-30))
    a = (r1 * g22 - r2 * g12) * inv_det
    b = (g11 * r2 - g12 * r1) * inv_det
    duv_per_world = a[:, None] * duv1 + b[:, None] * duv2
    duv_major = torch.where(ok, duv_per_world * major_len[:, None],
                            torch.zeros_like(duv_per_world))
    return lod_minor, duv_major


# the mip tiers a scene may ship, in tpurt's order of precedence
_MIP_TIERS = ("block4", "pair", "quad")


def _mip_texels(scene, hits, direction, attr, world_normal, tex_coord,
                spread, aniso_taps: int, gather=None):
    """The three layers (N, 12) through the scene's mip tier at the
    ray-cone LOD (tpurt ``shade.py:616-694``): anisotropic with
    aniso_taps > 1, else trilinear, through ``kernels/mip_texels``'s K9
    (the torch chain on CPU tensors). Extents come from level 0 of the
    hit primitive's chain, read with its corners and uvs from the
    ``tri_attr`` rows `attr`. The tier is the one whose offsets the scene
    holds; with `gather` its rows come from there and the scene need not
    hold the table."""
    tier = next(t for t in _MIP_TIERS if f"tex_mip_{t}_offsets" in scene)
    key = f"tex_mip_{tier}"
    return mip_texels(tier, scene[key] if gather is None else None,
                      scene[key + "_offsets"], scene["tex_mip_sizes"],
                      hits["t"], direction, world_normal, attr, tex_coord,
                      spread, aniso_taps, gather=gather)


def cone_spread(camera: dict, rows: int):
    """The pixel cone's spread angle, 2 / (proj[1][1] * rows), from the
    full image height `rows` (proj[1][1] = 1 / tan(fovy / 2))."""
    return rdivide(2.0, camera["proj"][1, 1] * rows)


def surface(scene: dict, camera: dict, hits: dict, direction=None, *,
            aniso_taps: int = 1, rows: int = 0, attr_rows=None,
            quad_gather=None, quad_shape=None, step=no_step) -> dict:
    """Reconstruct the shading point of each hit: position, shading normal
    N, view vector V and the material terms. A mip scene (its
    ``tex_mip_sizes``) samples its tier at the ray-cone LOD of the primary
    rays' `direction`, over an image of `rows` rows, inside the span
    ``shade.texels``, and reads no uv payload (tpurt takes that branch
    first); otherwise one quad row, from the payload when the trace
    emitted it. attr_rows, quad_gather and quad_shape are ``shade``'s
    sharded-table hooks. On the card K10 (``kernels/shade_surface``), on
    CPU tensors :func:`surface_plain`."""
    return shade_surface(scene, camera, hits, direction,
                         aniso_taps=aniso_taps, rows=rows,
                         attr_rows=attr_rows, quad_gather=quad_gather,
                         quad_shape=quad_shape, step=step)


def surface_plain(scene: dict, camera: dict, hits: dict, direction=None, *,
                  aniso_taps: int = 1, rows: int = 0, attr_rows=None,
                  quad_gather=None, quad_shape=None, step=no_step) -> dict:
    """:func:`surface` as the torch chain, on any device: the plain
    version of K10 (and of K9 on CPU tensors), bit-equal to it on the
    card."""
    tri = hits["tri"]
    valid = tri >= 0
    tidx = torch.clamp_min(tri, 0).long()

    u = hits["u"][:, None]
    v = hits["v"][:, None]
    w = 1.0 - u - v

    attr = (scene["tri_attr"][tidx] if attr_rows is None
            else attr_rows)                            # (N, 40)
    p0, p1, p2 = attr[:, 0:3], attr[:, 12:15], attr[:, 24:27]
    uv0, uv1, uv2 = attr[:, 3:5], attr[:, 15:17], attr[:, 27:29]
    n0, n1, n2 = attr[:, 5:8], attr[:, 17:20], attr[:, 29:32]
    t0, t1, t2 = attr[:, 8:12], attr[:, 20:24], attr[:, 32:36]

    world_pos = p0 * w + p1 * u + p2 * v
    tex_coord = uv0 * w + uv1 * u + uv2 * v
    world_normal = _normalize(n0 * w + n1 * u + n2 * v)
    world_tangent = _normalize(t0[:, :3] * w + t1[:, :3] * u + t2[:, :3] * v)
    world_tangent = _normalize(
        world_tangent
        - _dot(world_tangent, world_normal)[:, None] * world_normal)
    world_binormal = _cross(world_normal, world_tangent) * t0[:, 3:4]

    if "tex_mip_sizes" in scene:
        if direction is None or rows <= 0:
            raise ValueError("a mip scene needs the primary rays' "
                             "direction and the image's rows")
        spread = cone_spread(camera, rows)
        with step("shade.texels"):
            packed = _mip_texels(scene, hits, direction, attr,
                                 world_normal, tex_coord, spread,
                                 aniso_taps, gather=quad_gather)
    else:
        quad = scene["tex_quad"] if quad_gather is None else None
        shape = scene.get("tex_quad_shape") if quad_shape is None \
            else quad_shape
        if "texu" in hits:
            # the closest-hit trace's uv payload: the quad gather no
            # longer waits on the tri_attr row
            hw = torch.stack([hits["texh"], hits["texw"]], dim=-1)
            img = hits["img"].to(torch.int32)
            uv = torch.stack([hits["texu"], hits["texv"]], dim=-1)
        else:
            hw, img, uv = attr[:, 37:39], attr[:, 39].to(torch.int32), \
                tex_coord
        packed = sample_bilinear_quad(quad, shape, hw, img, uv,
                                      base=scene.get("tex_quad_base"),
                                      gather=quad_gather)

    def fetch(layer):
        return packed[:, layer * 4:layer * 4 + 4]

    nmap = fetch(2)
    N_ts = _normalize(nmap[:, :3] * 2.0 - 1.0)
    N = _normalize(N_ts[:, 0:1] * world_tangent
                   + N_ts[:, 1:2] * world_binormal
                   + N_ts[:, 2:3] * world_normal)

    orm = fetch(1)
    return dict(valid=valid, world_pos=world_pos.contiguous(), N=N,
                V=_normalize(camera["camera_pos"][None, :] - world_pos),
                albedo=torch.pow(fetch(0)[:, :3], 2.2),
                roughness=orm[:, 1], metallic=orm[:, 2])


def _rows(hits: dict, height: int, image_rows: int) -> int:
    """The image's full height for the ray cone (tpurt
    ``shade.py:619-620``): image_rows, else height, else the side of a
    square image of the hits."""
    return image_rows or height or int(round(float(
        hits["t"].shape[0]) ** 0.5))


def shadow_rays(scene: dict, camera: dict, lights: dict, hits: dict,
                direction=None, *, aniso_taps: int = 1, height: int = 0,
                image_rows: int = 0):
    """(origin, direction, t_max) of every light's shadow rays, exactly as
    shade() traces them (with shade()'s texture arguments)."""
    surf = surface(scene, camera, hits, direction, aniso_taps=aniso_taps,
                   rows=_rows(hits, height, image_rows))
    rays = light_rays(surf["world_pos"], surf["N"], surf["valid"], lights)
    return [(surf["world_pos"], L, t_max)
            for L, t_max in zip(rays["L"], rays["t_max"])]


def shadow_tracer(tables: str, max_leaf: int = 1):
    """The any-hit tracer of a table kind: (scene, origin, direction,
    t_min, t_max, height=, width=) -> (N,) bool."""
    if tables == "bvh8":
        return trace_any_bvh8
    if tables == "bvh2":
        return lambda *args, height=0, width=0: trace_any_bvh2(
            *args, max_leaf=max_leaf, height=height, width=width)
    raise ValueError(f"unknown shadow tables {tables!r}")


def shade(scene: dict, camera: dict, lights: dict, hits: dict,
          tables: str = "bvh8", max_leaf: int = 1,
          fuse_shadows: bool = False, height: int = 0, width: int = 0, *,
          direction=None, aniso_taps: int = 1, image_rows: int = 0,
          attr_rows=None, quad_gather=None, quad_shape=None,
          shadow_trace_fn=None, shadow_trace_multi_fn=None, step=no_step):
    """Shade one batch of primary hits; returns dict(color (N, 3),
    depth (N,), normal_enc (N, 3)). fuse_shadows as in the module
    docstring (tpurt's parameter and default); height and width, tpurt's
    too, the frame's shape when the hits are its pixels in row order (0
    otherwise), go to the shadow traces (per light or fused). A mip scene
    needs the primary rays' `direction`; aniso_taps > 1 filters
    anisotropically, and image_rows, the full image's height where
    `height` is a band of it, sets the ray cone's spread (tpurt's
    parameters).

    tpurt's sharded-table hooks (``dist/geometry.py``), none set by
    default: attr_rows (N, 40) replaces the ``tri_attr`` gather;
    quad_gather(flat) serves texel rows by flat global index in place of
    the scene's texel table (``tex_quad`` or the mip tier, whose offsets
    the scene still holds), with quad_shape the slab's (U, H, W, 64);
    shadow_trace_fn(origin, dir, t_min, t_max) -> (N,) bool replaces each
    light's shadow trace, and shadow_trace_multi_fn(origin, dirs, t_min,
    t_maxs) -> (S, N) bool, when set, every light's in one call.

    step(name) as in ``engine/frame.py``: the surface reconstruction runs
    inside ``shade.surface`` (a mip scene's texel fetch inside its child
    ``shade.texels``), the light-ray pre-pass (K8a) and the lights'
    sum (K8b) inside ``shade.lights`` (twice per call, before and after
    the shadow traces), and each shadow trace call (per light, the fused
    K5 or the sharded hooks) inside ``shade.shadow``; the G-buffer encode
    is shade's own."""
    trace_any = shadow_tracer(tables, max_leaf)
    with step("shade.surface"):
        surf = surface(scene, camera, hits, direction, aniso_taps=aniso_taps,
                       rows=_rows(hits, height, image_rows),
                       attr_rows=attr_rows, quad_gather=quad_gather,
                       quad_shape=quad_shape, step=step)
    world_pos = surf["world_pos"]
    with step("shade.lights"):
        # every light's L vector and shadow ray first, so that all shadow
        # rays can go out in one fused launch
        rays = light_rays(world_pos, surf["N"], surf["valid"], lights)
    dirs, t_maxs = list(rays["L"]), list(rays["t_max"])

    if shadow_trace_multi_fn is not None:
        with step("shade.shadow"):
            occluded = shadow_trace_multi_fn(world_pos, dirs, SHADOW_T_MIN,
                                             t_maxs)
    elif fuse_shadows and shadow_trace_fn is None and tables == "bvh8" \
            and len(dirs) > 1:
        with step("shade.shadow"):
            occluded = trace_any_bvh8_multi(scene, world_pos, dirs,
                                            SHADOW_T_MIN, t_maxs,
                                            height=height, width=width)
    else:
        occluded = []
        for L, t_max in zip(dirs, t_maxs):
            with step("shade.shadow"):
                if shadow_trace_fn is not None:
                    occluded.append(shadow_trace_fn(world_pos, L,
                                                    SHADOW_T_MIN, t_max))
                else:
                    occluded.append(trace_any(scene, world_pos, L,
                                              SHADOW_T_MIN, t_max,
                                              height=height, width=width))

    with step("shade.lights"):
        rho = light_sum(surf, rays, occluded, lights)
    return _shade_outputs(rho, surf["valid"], camera, world_pos, surf["N"])


def _shade_outputs(rho, valid, camera, world_pos, N):
    """G-buffer encode: color, view depth -(view * P).z, view normal *0.5+0.5
    with y and z negated."""
    out_color = torch.where(valid[:, None], rho, torch.zeros_like(rho))

    view = camera["view"]

    def row(i, p):
        return p[:, 0] * view[i, 0] + p[:, 1] * view[i, 1] \
            + p[:, 2] * view[i, 2]

    view_z = row(2, world_pos) + view[2, 3]
    out_depth = torch.where(valid, -view_z,
                            torch.full_like(view_z, MISS_DEPTH))

    normal_view = torch.stack([row(0, N), -row(1, N), -row(2, N)], dim=-1)
    normal_enc = _normalize(normal_view) * 0.5 + 0.5
    out_normal = torch.where(valid[:, None], normal_enc,
                             torch.full_like(normal_enc, 0.5))
    return dict(color=out_color, depth=out_depth, normal_enc=out_normal)
