"""K9's wrappers (``kernels/mip_texels.py``) on the CPU, port only: the
plain path against the torch chain with the sharded-geometry ``gather=``
hook serving the rows, the rows ``mip_texel_rows`` names against those
the chain asks the hook for, the three tiers against each other, the
footprint ``mip_texels`` returns against ``ray_cone_lod`` and
``ray_cone_aniso``, and the refusals. The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 16).

The lanes are ``tests/test_torch_texture_sampling.py``'s: the images of a
material_field (16-128 texels) and odd extents, uniform uv in [-1.5,
2.5), LODs in [-2, 9), major axes up to 0.3 in uv, and the edge lanes uv
= +-1e4, primitive 0, LOD -1e3, +1e3 and NaN. The footprint lanes add
seeded triangles, normals, directions and distances, with a miss (the
frame's lane of triangle 0 at t = T_MAX), a NaN distance (a NaN LOD),
distances of 0 and 1e30 (LODs below 0 and above the last level) and
degenerate triangles (collinear, and two equal corners: the major axis
falls back to 0). Given equal inputs every result is bit-equal.

PyTorch runs on one CPU thread in this module (restored after), as in the
other texture tests.
"""
import numpy as np
import pytest
import torch

N = 1024
TIERS = ("quad", "pair", "block4")
TAPS = (1, 4, 16)
SPREAD = 0.0025


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tables():
    """Each tier's (rows, offsets, sizes) of one set of images, and the
    lanes (prim, uv, lod, duv)."""
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
    out = {tier: tuple(map(torch.from_numpy, getattr(
        scene, f"build_mip_{tier}_atlas")(stack, tex_size, *dedup)))
        for tier in TIERS}
    prim = rng.integers(0, len(sizes), N).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    lod = rng.uniform(-2.0, 9.0, N).astype(np.float32)
    duv = rng.uniform(-0.3, 0.3, (N, 2)).astype(np.float32)
    prim[:16] = 0
    uv[:4] = [[1e4, -1e4], [-1e4, 1e4], [1e4, 1e4], [-1e4, -1e4]]
    lod[4:8] = [-1e3, 1e3, np.nan, 7.0]
    out["lanes"] = {k: torch.from_numpy(v) for k, v in
                    dict(prim=prim, uv=uv, lod=lod, duv=duv).items()}
    return out


@pytest.fixture(scope="module")
def hits(tables):
    """The footprint's inputs: t, direction, normal, (N, 40) tri_attr rows
    (corners, uvs, the lanes' primitive) and the interpolated uv."""
    rng = np.random.default_rng(8)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    t = rng.uniform(0.05, 60.0, N).astype(np.float32)
    attr = np.zeros((N, 40), np.float32)
    for k in range(3):
        attr[:, 12 * k:12 * k + 3] = rng.normal(size=(N, 3))
        attr[:, 12 * k + 3:12 * k + 5] = rng.uniform(-2.0, 2.0, (N, 2))
    attr[:, 36] = tables["lanes"]["prim"].numpy()
    t[0] = 10000.0                      # a miss: triangle 0 at T_MAX
    t[16:19] = [np.nan, 0.0, 1e30]
    attr[20:22, 0:3] = 0.0              # collinear corners
    attr[20:22, 12:15] = [1.0, 0.0, 0.0]
    attr[20:22, 24:27] = [2.0, 0.0, 1e-9]
    attr[22, 12:15] = attr[22, 0:3]     # two equal corners
    return dict(t=torch.from_numpy(t), direction=torch.from_numpy(unit(N)),
                normal=torch.from_numpy(unit(N)),
                attr=torch.from_numpy(attr), uv=tables["lanes"]["uv"])


def _bits_equal(got, want, what):
    got, want = got.numpy(), want.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32), err_msg=what)


def _scene(tables, tier):
    rows, offsets, sizes = tables[tier]
    return {f"tex_mip_{tier}": rows, f"tex_mip_{tier}_offsets": offsets,
            "tex_mip_sizes": sizes}


def _args(tables, tier, hits, taps):
    return (tier, *tables[tier], hits["t"], hits["direction"],
            hits["normal"], hits["attr"], hits["uv"], SPREAD, taps)


def _without_table(args):
    """mip_texels' arguments as mip_texel_rows takes them."""
    return (args[0], *args[2:])


@pytest.mark.parametrize("taps", TAPS)
@pytest.mark.parametrize("tier", TIERS)
def test_plain_path_equals_the_gather_chain(tables, hits, tier, taps):
    """shade's fetch without a hook (the wrapper, which takes
    mip_texels_plain on CPU tensors) against the same fetch with the
    sharded-geometry gather hook serving the rows (the torch chain)."""
    from tpurt_torch.kernels import build
    from tpurt_torch.passes.shade import _mip_texels

    scene = _scene(tables, tier)
    rows = scene[f"tex_mip_{tier}"]
    spread = torch.tensor(SPREAD, dtype=torch.float32)
    build.reset_counts()
    got = _mip_texels(scene, hits, hits["direction"], hits["attr"],
                      hits["normal"], hits["uv"], spread, taps)
    assert build.launch_counts["mip_texels"] == 0
    served = []

    def gather(flat):
        served.append(flat.shape[0])
        return rows[flat]

    want = _mip_texels(scene, hits, hits["direction"], hits["attr"],
                       hits["normal"], hits["uv"], spread, taps,
                       gather=gather)
    assert served, "the hook served no rows"
    assert got.shape == (N, 12) and bool(torch.isnan(got[16]).all())
    _bits_equal(got, want, f"{tier}, {taps} taps")


@pytest.mark.parametrize("taps", TAPS)
@pytest.mark.parametrize("tier", TIERS)
def test_rows_are_those_the_chain_gathers(tables, hits, tier, taps):
    """mip_texel_rows names, per tap, the rows the torch chain asks the
    gather hook for, in its order (level, then the sample's row, then the
    lane), and they lie in the table."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.mip_texels import (ROWS_PER_SAMPLE,
                                                mip_texel_rows)
    from tpurt_torch.passes.shade import _mip_texels

    scene = _scene(tables, tier)
    rows = scene[f"tex_mip_{tier}"]
    asked = []

    def gather(flat):
        asked.append(flat)
        return rows[flat]

    _mip_texels(scene, hits, hits["direction"], hits["attr"],
                hits["normal"], hits["uv"],
                torch.tensor(SPREAD, dtype=torch.float32), taps,
                gather=gather)
    build.reset_counts()
    got = mip_texel_rows(*_without_table(_args(tables, tier, hits, taps)))
    assert build.launch_counts["mip_texel_rows"] == 0
    k = ROWS_PER_SAMPLE[tier]
    assert got.dtype == torch.int32 and got.shape == (N, taps, 2, k)
    assert len(asked) == taps
    for i, flat in enumerate(asked):
        assert torch.equal(got[:, i].reshape(N, 2 * k).t().reshape(-1),
                           flat.to(torch.int32)), (tier, taps, i)
    assert int(got.min()) >= 0 and int(got.max()) < rows.shape[0]


@pytest.mark.parametrize("taps", TAPS)
@pytest.mark.parametrize("tier", TIERS[1:])
def test_tiers_equal_each_other(tables, hits, tier, taps):
    """The whole fetch from the footprint lanes, and the tier's samplers
    at the lanes' given LODs and axes, through pair and block4 against
    quad."""
    from tpurt_torch.kernels.mip_texels import mip_texels
    from tpurt_torch.passes import shade

    lanes = tables["lanes"]

    def at(t):
        if taps > 1:
            return getattr(shade, f"sample_anisotropic_{t}")(
                *tables[t], lanes["prim"], lanes["uv"], lanes["lod"],
                lanes["duv"], taps)
        return getattr(shade, f"sample_trilinear_{t}")(
            *tables[t], lanes["prim"], lanes["uv"], lanes["lod"])

    given = [at(t) for t in ("quad", tier)]
    assert bool(torch.isnan(given[0][6]).all())
    _bits_equal(given[1], given[0], f"{tier} vs quad at given LODs, {taps} "
                f"taps")
    whole = [mip_texels(*_args(tables, t, hits, taps))
             for t in ("quad", tier)]
    _bits_equal(whole[1], whole[0], f"{tier} vs quad, {taps} taps")


@pytest.mark.parametrize("taps", TAPS)
def test_footprint_is_the_ray_cone(tables, hits, taps):
    """footprint=True returns ray_cone_lod's LOD (one tap) or
    ray_cone_aniso's LOD and major axis, and the texels are the tier's
    sampler at them; a degenerate triangle's axis is 0."""
    from tpurt_torch.kernels.mip_texels import mip_texels
    from tpurt_torch.passes import shade

    rows, offsets, sizes = tables["pair"]
    attr = hits["attr"]
    prim = attr[:, 36].to(torch.int32)
    hw = sizes[prim.long(), 0].to(torch.float32)
    cone = (hits["t"], hits["direction"], hits["normal"], attr[:, 0:3],
            attr[:, 12:15], attr[:, 24:27], attr[:, 3:5], attr[:, 15:17],
            attr[:, 27:29], hw[:, 1], hw[:, 0], SPREAD)
    got, lod, duv = mip_texels(*_args(tables, "pair", hits, taps),
                               footprint=True)
    if taps == 1:
        want_lod = shade.ray_cone_lod(*cone)
        want = shade.sample_trilinear_pair(rows, offsets, sizes, prim,
                                           hits["uv"], want_lod)
        assert duv is None
    else:
        want_lod, want_duv = shade.ray_cone_aniso(*cone, max_aniso=16)
        want = shade.sample_anisotropic_pair(rows, offsets, sizes, prim,
                                             hits["uv"], want_lod, want_duv,
                                             taps)
        _bits_equal(duv, want_duv, "duv")
        assert float(duv[20:23].abs().max()) == 0.0
    _bits_equal(lod, want_lod, "lod")
    assert bool(torch.isnan(lod[16])) and float(lod[17]) < 0
    assert float(lod[18]) > sizes.shape[1]
    _bits_equal(got, want, "the fetch at the footprint")


def _refusals(tables, hits):
    """(what, call) pairs that the wrappers must refuse."""
    from tpurt_torch.kernels.mip_texels import mip_texel_rows, mip_texels

    args = _args(tables, "quad", hits, 4)
    rows, offsets, sizes = tables["quad"]

    def swap(i, value):
        return tuple(value if k == i else a for k, a in enumerate(args))

    strided = torch.stack([hits["normal"], hits["normal"]], -1)[..., 0]
    return [
        ("a tier the kernel does not know", lambda: mip_texels(
            *swap(0, "atlas"))),
        ("direction of 4 columns", lambda: mip_texels(
            *swap(5, torch.zeros(N, 4)))),
        ("t in float64", lambda: mip_texels(
            *swap(4, hits["t"].double()))),
        ("a normal on another device", lambda: mip_texels(
            *swap(6, torch.empty(N, 3, device="meta")))),
        ("a strided normal", lambda: mip_texels(*swap(6, strided))),
        ("attr with strided columns", lambda: mip_texels(
            *swap(7, hits["attr"].t().contiguous().t()))),
        ("attr without the primitive column", lambda: mip_texels(
            *swap(7, hits["attr"][:, :36].contiguous()))),
        ("sizes of another shape", lambda: mip_texels(
            *swap(3, sizes[:, :-1].contiguous()))),
        ("rows of 48 bytes", lambda: mip_texels(
            *swap(1, rows[:, :48].contiguous()))),
        ("two spreads", lambda: mip_texels(
            *swap(9, torch.full((2,), SPREAD)))),
        ("a table and a gather hook", lambda: mip_texels(
            *args, gather=lambda flat: rows[flat])),
        ("the rows of uv in float64", lambda: mip_texel_rows(
            *_without_table(swap(8, hits["uv"].double())))),
    ]


@pytest.mark.parametrize("case", range(12))
def test_wrappers_refuse(tables, hits, case):
    from tpurt_torch.kernels import build

    what, call = _refusals(tables, hits)[case]
    build.reset_counts()
    with pytest.raises(ValueError):
        call()
    assert build.launch_counts["mip_texels"] == 0, what
    assert build.launch_counts["mip_texel_rows"] == 0, what


def test_refusal_cases_are_all_run(tables, hits):
    assert len(_refusals(tables, hits)) == 12
