"""The texture samplers of ``passes/shade.py`` against tpurt's, called
eagerly on the same tables and seeded lanes: ``sample_bilinear`` (the
per-layer and the packed stack), ``sample_bilinear_quad`` (slab and arena
addressing), trilinear and anisotropic (1, 4 and 16 taps) sampling through
the per-layer atlas and the quad, pair and block4 tiers, and the ray-cone
LOD and footprint.

The lanes: uniform uv in [-1.5, 2.5), LODs in [-2, 9) (below 0 and above
the last level, L - 1 = 7 here), major axes up to 0.3 in uv, and the edge
lanes uv = +-1e4, primitive 0 (the frame's miss lanes read triangle 0),
LOD -1e3 and +1e3 and a NaN LOD (only non-finite inputs give one; tpurt's
float-to-int conversion takes level 0, and so does the port's). Given
equal inputs every sampler is bit-equal to tpurt's (NaN where tpurt gives
NaN), and the four tiers to each other.

The ray cone is held to a stated bound, not bit for bit: tpurt's eager
``jnp.linalg.norm`` is a jitted XLA reduction (F20's kind) that differs
from the port's left-to-right sum in the last bit on ~11% of lanes, and
XLA's log2 from PyTorch's by one ULP. The LOD is held to 4 ULP of
max(|lod|, 1) (log2 of a value near 1 is near 0, where ULPs shrink;
measured 1.5). The major axis comes out of a 2x2 Gram solve, which scales
those last-bit differences by its condition, 1 / sin^2 of the angle
between the triangle's edges (det / (g11 g22), down to tpurt's 1e-8
cutoff): each component is held to 8 ULP of max(|duv|, 1) / sin^2
(measured 1.06 here; with 4,096 lanes 2.7, where one lane with sin^2 =
1.8e-4 differed by 652 ULP).

PyTorch runs on one CPU thread in this module (restored after): its
small eager ops slow down by two orders of magnitude when the test
workers' thread pools contend for the cores.
"""
import numpy as np
import pytest
import torch

N = 1024
TIERS = ("quad", "pair", "block4")
LOD_ULPS = 4
DUV_ULPS = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tables():
    """Every table of one set of images, in both packages' form: the
    textures of a material_field (16-128) and tpurt's odd extents
    (tests/test_block4.py:30-32)."""
    import jax.numpy as jnp

    from tpurt_torch.scene import scene

    rng = np.random.default_rng(21)
    sizes = [(16, 16), (32, 32), (64, 64), (128, 128), (8, 32), (13, 7),
             (5, 5), (1, 1)]
    hmax = max(h for h, _ in sizes)
    wmax = max(w for _, w in sizes)
    stack = np.zeros((len(sizes) * 3, hmax, wmax, 4), np.uint8)
    for p, (h, w) in enumerate(sizes):
        stack[p * 3:p * 3 + 3, :h, :w] = rng.integers(0, 256, (3, h, w, 4),
                                                      dtype=np.uint8)
    tex_size = np.asarray(sizes, np.int32)
    dedup = (np.arange(len(sizes), dtype=np.int32), list(range(len(sizes))))
    host = {"atlas": scene.build_mip_atlas(stack, tex_size, *dedup)}
    for tier in TIERS:
        host[tier] = getattr(scene, f"build_mip_{tier}_atlas")(
            stack, tex_size, *dedup)
    stack12 = np.concatenate([stack[0::3], stack[1::3], stack[2::3]], axis=3)
    host.update(stack=stack, stack12=stack12, tex_size=tex_size)

    prim = rng.integers(0, len(sizes), N).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    lod = rng.uniform(-2.0, 9.0, N).astype(np.float32)
    duv = rng.uniform(-0.3, 0.3, (N, 2)).astype(np.float32)
    prim[:16] = 0
    uv[:4] = [[1e4, -1e4], [-1e4, 1e4], [1e4, 1e4], [-1e4, -1e4]]
    lod[4:8] = [-1e3, 1e3, np.nan, 7.0]
    lanes = dict(prim=prim, uv=uv, lod=lod, duv=duv)

    def conv(tree, f):
        if isinstance(tree, dict):
            return {k: conv(v, f) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(conv(v, f) for v in tree)
        return f(tree)

    return dict(
        ref=conv(dict(host, **lanes), jnp.asarray),
        port=conv(dict(host, **lanes), torch.from_numpy),
        levels=host["quad"][2].shape[1])


def _bits_equal(got, want, what):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32), err_msg=what)


def test_lanes_cover_the_edges(tables):
    lod = tables["port"]["lod"]
    assert float(lod[4]) < 0 and float(lod[5]) > tables["levels"] - 1
    assert bool(torch.isnan(lod[6]))


@pytest.mark.parametrize("packed", [False, True])
def test_sample_bilinear(tables, packed):
    from tpurt.passes import shade as ref
    from tpurt_torch.passes import shade

    r, p = tables["ref"], tables["port"]
    key, per, layers = (("stack12", 1, [0]) if packed
                        else ("stack", 3, [0, 1, 2]))
    for layer in layers:
        _bits_equal(
            shade.sample_bilinear(p[key], p["tex_size"], p["prim"], layer,
                                  p["uv"], images_per_prim=per),
            ref.sample_bilinear(r[key], r["tex_size"], r["prim"], layer,
                                r["uv"], images_per_prim=per),
            f"{key} layer {layer}")


def test_sample_bilinear_quad_slab_and_arena(tables):
    """The non-mip quad rows, (U, Hmax, Wmax, 64) slab and the arena's
    per-image layout (base=), against tpurt's and against their plain
    definition, ``sample_bilinear`` over the packed 12-channel stack."""
    import jax.numpy as jnp

    from tpurt.passes import shade as ref
    from tpurt_torch.passes import shade

    h = tables["port"]
    stack12, tex_size = h["stack12"].numpy(), h["tex_size"].numpy()
    u, hmax, wmax = stack12.shape[:3]
    slab = np.zeros((u, hmax, wmax, 64), np.uint8)
    flat, base = [], []
    for i, (hh, ww) in enumerate(tex_size):
        reg = stack12[i, :hh, :ww]
        slab[i, :hh, :ww, :48] = np.concatenate(
            [reg, np.roll(reg, -1, 1), np.roll(reg, -1, 0),
             np.roll(np.roll(reg, -1, 0), -1, 1)], axis=2)
        base.append(sum(len(f) for f in flat) + 3)  # a gap before each
        flat.append(np.zeros((3, 64), np.uint8))
        flat.append(slab[i, :hh, :ww].reshape(-1, 64))
    flat = np.concatenate(flat)
    base = np.asarray(base, np.int32)
    img = h["prim"]
    hw = h["tex_size"][img.long()].to(torch.float32)
    want = ref.sample_bilinear_quad(jnp.asarray(slab), jnp.asarray(hw),
                                    jnp.asarray(img), jnp.asarray(h["uv"]))
    _bits_equal(shade.sample_bilinear_quad(
        torch.from_numpy(slab.reshape(-1, 64)), slab.shape, hw, img,
        h["uv"]), want, "slab")
    _bits_equal(shade.sample_bilinear(h["stack12"], h["tex_size"], img, 0,
                                      h["uv"], images_per_prim=1),
                want, "the packed stack")
    _bits_equal(shade.sample_bilinear_quad(
        torch.from_numpy(flat), None, hw, img, h["uv"],
        base=torch.from_numpy(base)), want, "arena")
    _bits_equal(shade.sample_bilinear_quad(
        torch.from_numpy(flat), None, hw, img, h["uv"],
        base=torch.from_numpy(base)), ref.sample_bilinear_quad(
        jnp.asarray(flat), jnp.asarray(hw), jnp.asarray(img),
        jnp.asarray(h["uv"]), base=jnp.asarray(base)), "tpurt's arena")


def test_trilinear_per_layer_atlas(tables):
    from tpurt.passes import shade as ref
    from tpurt_torch.passes import shade

    r, p = tables["ref"], tables["port"]
    for layer in range(3):
        _bits_equal(
            shade.sample_trilinear(*p["atlas"], p["prim"], layer, p["uv"],
                                   p["lod"]),
            ref.sample_trilinear(*r["atlas"], r["prim"], layer, r["uv"],
                                 r["lod"]), f"layer {layer}")


@pytest.mark.parametrize("tier", TIERS)
def test_trilinear_tier(tables, tier):
    from tpurt.passes import shade as ref
    from tpurt_torch.passes import shade

    r, p = tables["ref"], tables["port"]
    got = getattr(shade, f"sample_trilinear_{tier}")(
        *p[tier][:2], p[tier][2], p["prim"], p["uv"], p["lod"])
    _bits_equal(got, getattr(ref, f"sample_trilinear_{tier}")(
        *r[tier][:2], r[tier][2], r["prim"], r["uv"], r["lod"]), tier)
    # the tiers and the per-layer atlas fetch the same texel bytes
    layers = torch.cat([shade.sample_trilinear(
        *p["atlas"], p["prim"], layer, p["uv"], p["lod"])
        for layer in range(3)], dim=1)
    _bits_equal(got, layers.numpy(), f"{tier} vs the per-layer atlas")


@pytest.mark.parametrize("taps", [1, 4, 16])
@pytest.mark.parametrize("tier", ("atlas",) + TIERS)
def test_anisotropic(tables, tier, taps):
    from tpurt.passes import shade as ref
    from tpurt_torch.passes import shade

    r, p = tables["ref"], tables["port"]
    if tier == "atlas":
        got = torch.cat([shade.sample_anisotropic(
            *p["atlas"], p["prim"], layer, p["uv"], p["lod"], p["duv"],
            taps) for layer in range(3)], dim=1)
        want = np.concatenate([np.asarray(ref.sample_anisotropic(
            *r["atlas"], r["prim"], layer, r["uv"], r["lod"], r["duv"],
            taps)) for layer in range(3)], axis=1)
    else:
        got = getattr(shade, f"sample_anisotropic_{tier}")(
            *p[tier], p["prim"], p["uv"], p["lod"], p["duv"], taps)
        want = getattr(ref, f"sample_anisotropic_{tier}")(
            *r[tier], r["prim"], r["uv"], r["lod"], r["duv"], taps)
        quad = shade.sample_anisotropic_quad(
            *p["quad"], p["prim"], p["uv"], p["lod"], p["duv"], taps)
        _bits_equal(got, quad.numpy(), f"{tier} vs quad")
    _bits_equal(got, want, f"{tier}, {taps} taps")
    if taps == 1:
        # one tap at the center is the trilinear fetch
        tri = torch.cat([shade.sample_trilinear(
            *p["atlas"], p["prim"], layer, p["uv"], p["lod"])
            for layer in range(3)], dim=1)
        _bits_equal(got, tri.numpy(), f"{tier} one tap vs trilinear")


def _ulps(got, want):
    """|got - want| in ULPs of max(|want|, 1), per element (per lane of a
    (N, 2) pair: of max(|want|.max(1), 1))."""
    got = got.numpy().astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    scale = np.abs(want) if want.ndim == 1 else np.abs(want).max(
        1, keepdims=True)
    return np.abs(got - want) / (np.maximum(scale, 1.0) * 2.0 ** -23)


@pytest.fixture(scope="module")
def cones():
    """Seeded hits: triangles, normals, view directions, distances and
    extents, as float32 arrays."""
    rng = np.random.default_rng(8)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    tex = rng.choice([16.0, 32.0, 64.0, 256.0], (N, 2)).astype(np.float32)
    return [rng.uniform(0.05, 60.0, N).astype(np.float32), unit(N), unit(N),
            *[rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3)],
            *[rng.uniform(-2.0, 2.0, (N, 2)).astype(np.float32)
              for _ in range(3)], tex[:, 0], tex[:, 1]]


def test_ray_cone_lod_within_ulps(cones):
    import jax.numpy as jnp

    from tpurt.passes import shade as ref
    from tpurt_torch.passes import shade

    spread = np.float32(0.0025)
    got = shade.ray_cone_lod(*map(torch.from_numpy, cones), spread)
    want = ref.ray_cone_lod(*map(jnp.asarray, cones), spread)
    u = _ulps(got, want)
    print(f"ray_cone_lod: max {u.max():.2f} ULP of max(|lod|, 1), "
          f"{(u > 0).mean():.3f} of lanes differ")
    assert u.max() <= LOD_ULPS


def test_ray_cone_aniso_within_ulps(cones):
    import jax.numpy as jnp

    from tpurt.passes import shade as ref
    from tpurt_torch.passes import shade

    spread = np.float32(0.0025)
    lod, duv = shade.ray_cone_aniso(*map(torch.from_numpy, cones), spread)
    rlod, rduv = ref.ray_cone_aniso(*map(jnp.asarray, cones), spread)
    e1, e2 = (cones[k].astype(np.float64) - cones[3] for k in (4, 5))
    g11, g22 = (e1 * e1).sum(1), (e2 * e2).sum(1)
    sin2 = (g11 * g22 - (e1 * e2).sum(1) ** 2) / (g11 * g22)
    u_lod = _ulps(lod, rlod)
    u_duv = _ulps(duv, rduv).max(1) * sin2
    print(f"ray_cone_aniso: lod max {u_lod.max():.2f} ULP, duv max "
          f"{u_duv.max():.2f} ULP x sin^2")
    assert u_lod.max() <= LOD_ULPS and u_duv.max() <= DUV_ULPS
    # the clamps: anisotropy 1..16 times the cone's diameter
    assert bool(torch.isfinite(duv).all())


def test_degenerate_triangle_falls_back_isotropic():
    """tpurt's tests/test_mipmaps.py:254: near-collinear edges make the
    Gram solve blow up, and the major axis falls back to 0 in both."""
    import jax.numpy as jnp

    from tpurt.passes import shade as ref
    from tpurt_torch.passes import shade

    s2 = 1.0 / np.sqrt(2.0)
    args = [np.asarray(a, np.float32) for a in (
        [2.0], [[s2, s2, 0.0]], [[0.0, -1.0, 0.0]], [[0.0, 0.0, 0.0]],
        [[1.0, 0.0, 0.0]], [[2.0, 0.0, 1e-9]], [[0.0, 0.0]], [[1.0, 0.0]],
        [[0.0, 1.0]], [256.0], [256.0])]
    lod, duv = shade.ray_cone_aniso(*map(torch.from_numpy, args), 0.002)
    rlod, rduv = ref.ray_cone_aniso(*map(jnp.asarray, args), 0.002)
    assert bool(torch.isfinite(lod).all())
    assert float(torch.linalg.vector_norm(duv)) < 1e-6
    np.testing.assert_array_equal(duv.numpy(), np.asarray(rduv))
    assert _ulps(lod, rlod).max() <= LOD_ULPS
