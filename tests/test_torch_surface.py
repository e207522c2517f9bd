"""K10's wrapper (``kernels/shade_surface.py``), port only.

On the CPU: ``shade_surface`` refuses wrong shapes and dtypes before
anything runs, and on CPU tensors it is ``passes/shade.surface_plain``
(the torch chain) with no launch, in every path: the quad rows of the
slab and of the streaming arena, the closest-hit uv payload, a mip
scene, and the sharded-geometry ``attr_rows`` and ``quad_gather`` hooks.

On the card (marked ``gpu``, skipped without one: a CUDA kernel has no
CPU mode): K10 against the chain on the card, bit for bit in every
output, on a frame's hits with every 17th lane a miss (``tri = -1``),
over all lanes and over a count that is not a multiple of the block, in
the same paths, a mip scene in each tier at 1 and 16 taps; one launch per
call without mips, three on a mip scene (K10, K9, the epilogue), two
with the ``quad_gather`` hook on a scene without mips.

PyTorch runs on one CPU thread in this module (restored after), as in the
other texture tests.
"""
import pytest
import torch

SURFACE_KEYS = ("valid", "world_pos", "N", "V", "albedo", "roughness",
                "metallic")
# the cut textures workload (tests/test_torch_mip_frame.py's) and the
# budgets (quad, pair) that make flatten_scene pick each tier
MIP_FIELD = dict(nx=3, nz=3, subdiv=2, spacing=1.0, extents=(16, 32, 64))
MIP_BUDGETS = dict(quad=(1 << 40, 1 << 40), pair=(0, 1 << 40),
                   block4=(0, 0))
# (scene, hits, hook) of every path; "mip-<tier>-<taps>" a mip scene
PATHS = ("slab", "arena", "payload", "attr_rows", "quad_gather",
         "arena_gather")
MIP_PATHS = tuple(f"mip-{tier}-{taps}" for tier in ("quad", "pair", "block4")
                  for taps in (1, 16))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bench(device, size, arena):
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    w, h = size
    return build_bench_scene(Renderer(RendererConfig(
        width=w, height=h, texture_arena=arena, device=device)),
        field=dict(nx=3, nz=3, subdiv=2), cubes=3)


def _mip(device, size, tier, taps):
    from tpurt_torch.app.textures_scene import build_textures_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.scene import scene

    w, h = size
    saved = scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES
    try:
        scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES = \
            MIP_BUDGETS[tier]
        r = build_textures_scene(Renderer(RendererConfig(
            width=w, height=h, mipmaps=True, aniso_taps=taps,
            device=device)), field=MIP_FIELD)
    finally:
        scene.MIP_QUAD_BUDGET_BYTES, scene.MIP_PAIR_BUDGET_BYTES = saved
    assert f"tex_mip_{tier}" in r.scene_device
    return r


def _case(path, device, size):
    """(renderer, scene, camera, hits, surface kwargs) of a path: a
    frame's hits with every 17th lane a miss."""
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays

    mip = path.startswith("mip-")
    if mip:
        _, tier, taps = path.split("-")
        r = _mip(device, size, tier, int(taps))
    else:
        r = _bench(device, size, path not in ("slab", "quad_gather"))
    sc = r.scene_device
    cam = convert.camera_tensors(r.camera.uniform(), r.device)
    w, h = size
    o, d = camera_rays(cam, w, h)
    hits = trace_closest_bvh8(sc, o, d, T_MIN, T_MAX,
                              uv_payload=path == "payload")
    hits["tri"][::17] = -1
    kw = {}
    if mip:
        kw = dict(direction=d, rows=h, aniso_taps=int(taps))
    if path == "attr_rows":
        kw["attr_rows"] = sc["tri_attr"][torch.clamp_min(hits["tri"],
                                                         0).long()]
    if path in ("quad_gather", "arena_gather"):
        table = sc["tex_quad"]
        kw["quad_gather"] = lambda flat: table[flat]
    return r, sc, cam, hits, kw


def _same_bits(got, want):
    """Equal NaN masks and equal bits elsewhere (a NaN's payload may
    differ between the kernel and PyTorch's ops)."""
    if got.dtype != torch.float32:
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


def _counts(**nonzero):
    from tpurt_torch.kernels import build

    return {k: nonzero.get(k, 0) for k in build.launch_counts}


@pytest.mark.parametrize("path", PATHS + ("mip-pair-4",))
def test_cpu_tensors_take_the_plain_chain(path):
    """On CPU tensors shade_surface is surface_plain, bit for bit, with no
    launch."""
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.shade_surface import shade_surface
    from tpurt_torch.passes.shade import surface, surface_plain

    _, sc, cam, hits, kw = _case(path, "cpu", (24, 20))
    build.reset_counts()
    got = shade_surface(sc, cam, hits, **kw)
    via = surface(sc, cam, hits, **kw)
    assert build.launch_counts == _counts()
    want = surface_plain(sc, cam, hits, **kw)
    assert set(got) == set(SURFACE_KEYS)
    assert bool(want["valid"].any()) and not bool(want["valid"].all())
    for key in SURFACE_KEYS:
        assert _same_bits(got[key], want[key]), (path, key)
        assert _same_bits(via[key], want[key]), (path, key)


def _refusals(sc, mip_sc, cam, hits, d):
    """(what, call) pairs that shade_surface must refuse."""
    from tpurt_torch.kernels.shade_surface import shade_surface

    n = hits["tri"].shape[0]

    def with_hits(**change):
        return lambda: shade_surface(sc, cam, dict(hits, **change))

    return [
        ("tri in int64", with_hits(tri=hits["tri"].long())),
        ("u in float64", with_hits(u=hits["u"].double())),
        ("v of another length", with_hits(v=hits["v"][:-1])),
        ("texu in float64 beside the payload", with_hits(
            **{k: torch.zeros(n) for k in ("texv", "img", "texh", "texw")},
            texu=torch.zeros(n, dtype=torch.float64))),
        ("attr rows of 36 columns", lambda: shade_surface(
            sc, cam, hits, attr_rows=torch.zeros(n, 36))),
        ("a tri_attr table in float64", lambda: shade_surface(
            dict(sc, tri_attr=sc["tri_attr"].double()), cam, hits)),
        ("a camera position of 4", lambda: shade_surface(
            sc, dict(cam, camera_pos=torch.zeros(4)), hits)),
        ("quad rows of 48 bytes", lambda: shade_surface(
            dict(sc, tex_quad=sc["tex_quad"][:, :48]), cam, hits)),
        ("an arena base in int64", lambda: shade_surface(
            dict(sc, tex_quad_base=sc["tex_quad_base"].long()), cam, hits)),
        ("a mip scene without the rays' direction", lambda: shade_surface(
            mip_sc, cam, hits, rows=20)),
        ("a mip scene without the image's rows", lambda: shade_surface(
            mip_sc, cam, hits, d)),
        ("a direction of 4 columns", lambda: shade_surface(
            mip_sc, cam, hits, torch.zeros(n, 4), rows=20)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_wrapper_refuses(case):
    from tpurt_torch.kernels import build

    _, sc, cam, hits, _ = _case("arena", "cpu", (24, 20))
    mip_sc = _mip("cpu", (24, 20), "pair", 1).scene_device
    from tpurt_torch.passes.rays import camera_rays

    _, d = camera_rays(cam, 24, 20)
    refusals = _refusals(sc, mip_sc, cam, hits, d)
    assert len(refusals) == 12
    what, call = refusals[case]
    build.reset_counts()
    with pytest.raises(ValueError):
        call()
    assert build.launch_counts == _counts(), what


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("path", PATHS + MIP_PATHS)
def test_k10_bit_identical(path):
    """K10 against surface_plain on the card, every output bit-equal, on
    all 7,680 lanes and on the first 7,643; the launches per call."""
    _on_card()
    from tpurt_torch.kernels import build
    from tpurt_torch.kernels.shade_surface import shade_surface
    from tpurt_torch.passes.shade import surface_plain

    _, sc, cam, hits, kw = _case(path, "cuda", (96, 80))
    whole = hits["tri"].shape[0]
    if path.startswith("mip-"):
        want_counts = _counts(shade_surface=1, mip_texels=1,
                              shade_surface_nmap=1)
    elif "quad_gather" in kw:
        want_counts = _counts(shade_surface=1, shade_surface_nmap=1)
    else:
        want_counts = _counts(shade_surface=1)
    for n in (whole, whole - 37):
        h = {k: v[:n] for k, v in hits.items()}
        args = dict(kw)
        if "attr_rows" in args:
            args["attr_rows"] = args["attr_rows"][:n]
        if "direction" in args:
            args["direction"] = args["direction"][:n]
        build.reset_counts()
        got = shade_surface(sc, cam, h, **args)
        torch.cuda.synchronize()
        assert build.launch_counts == want_counts, (path, n)
        want = surface_plain(sc, cam, h, **args)
        assert bool(want["valid"].any()) and not bool(want["valid"].all())
        for key in SURFACE_KEYS:
            assert _same_bits(got[key], want[key]), (path, n, key)
