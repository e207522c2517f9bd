"""K3h (the GTAO noise table) and K3 split around it: the port's plain
versions against the main pass as it computed the noise-only quantities
inline (tests/torch_gtao_inline.py) and against tpurt's
``main_pass_pallas`` (Pallas in interpret mode, with its own noise hoist).

Tolerances: the split plain version (``noise_table_plain`` plus
``main_body_plain``) bit-equal to the inline one for all four presets of
``tpurt/passes/gtao.py:53-56`` (it computes the same f32 expressions on the
64x64 noise maps instead of per pixel); each table plane bit-equal to its
expression evaluated per pixel; against tpurt's Pallas kernel,
tests/test_torch_gtao.py's budget (edges equal, AO within 1 u8 step on
<= 0.1% of pixels).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gtao import _assert_budget, _gbuffer
from torch_gtao_inline import main_pass_inline

NOISE_INDEX = 11
# (slice_count, steps_per_slice): LOW, MEDIUM, HIGH, ULTRA
PRESETS = [(1, 2), (2, 2), (3, 3), (9, 3)]
# frames: one wider than the 64-texel noise period, one not a multiple of
# the kernel's 16x8 tile
SHAPES = [(72, 96), (40, 56)]


def _inputs(h, w, seed):
    from tpurt.passes import gtao as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.passes import gtao

    depth, normal = _gbuffer(h, w, seed)
    consts = ref.gtao_constants(w, h, 0.1, 100.0, np.pi / 2, w / h)
    mips = gtao.prefilter_depths(torch.tensor(depth), consts)
    return dict(consts=consts, depth=depth, normal=normal, mips=mips,
                normal_t=torch.tensor(normal),
                gvec=convert.gtao_tensors(consts, "cpu")["vec"],
                noise=gtao.noise_maps_64(NOISE_INDEX, "cpu"))


@pytest.fixture(scope="module")
def frames():
    return {shape: _inputs(*shape, seed=i) for i, shape in enumerate(SHAPES)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: f"{p[0]}x{p[1]}")
def test_split_equals_inline(frames, shape, preset):
    """noise_table_plain + main_body_plain give the inline version's bits."""
    from tpurt_torch.kernels.gtao_main import gtao_main, main_pass_plain

    f = frames[shape]
    kw = dict(slice_count=preset[0], steps_per_slice=preset[1])
    args = (f["mips"], f["normal_t"], f["gvec"], f["noise"])
    want_ao, want_edges = main_pass_inline(*args, **kw)
    got_ao, got_edges = main_pass_plain(*args, **kw)
    assert torch.equal(got_edges, want_edges)
    assert torch.equal(got_ao, want_ao)
    assert 0 < float(got_ao.float().mean()) < 255
    # the wrapper on CPU tensors is the plain version
    for a, b in zip(gtao_main(*args, **kw), (got_ao, got_edges)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: f"{p[0]}x{p[1]}")
def test_table_equals_inline_expressions(frames, preset):
    """Each plane of the table, read at a pixel's noise texel, equals the
    expression the inline version computes for that pixel: cos and sin of
    the slice angle, the step's pow (before min_s is added)."""
    from tpurt_torch.kernels.gtao_main import (PI, gtao_noise_table,
                                               noise_table_plain,
                                               table_planes)
    from tpurt_torch.passes.encodings import divide

    slices, steps = preset
    f = frames[SHAPES[0]]
    h, w = SHAPES[0]
    table = noise_table_plain(f["noise"], f["gvec"], slice_count=slices,
                              steps_per_slice=steps)
    assert table.shape == (table_planes(slices, steps), 64, 64)
    assert table.dtype == torch.float32
    assert torch.equal(gtao_noise_table(f["noise"], f["gvec"],
                                        slice_count=slices,
                                        steps_per_slice=steps), table)
    yi, xi = torch.arange(h) % 64, torch.arange(w) % 64
    noise_slice = f["noise"][0][yi][:, xi]
    noise_sample = f["noise"][1][yi][:, xi]
    sdp = f["gvec"][7]
    plane = 0
    for si in range(slices):
        phi = divide(si + noise_slice, slices) * PI
        want = [torch.cos(phi), torch.sin(phi)]
        for st in range(steps):
            step_noise = torch.fmod(
                noise_sample + (si + st * steps) * 0.6180339887498948482,
                1.0)
            want.append(torch.pow(divide(st + step_noise, steps), sdp))
        for expr in want:
            got = table[plane][yi][:, xi]
            assert torch.equal(got.view(torch.int32),
                               expr.view(torch.int32)), (si, plane)
            plane += 1
    assert plane == table_planes(slices, steps)


@pytest.mark.parametrize("preset", [(1, 2), (2, 2)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
def test_split_within_budget_of_pallas(frames, preset):
    """The presets tests/test_torch_gtao.py does not run, against tpurt's
    main_pass_pallas with its noise hoist (interpret mode)."""
    from tpurt.kernels.gtao_main_pallas import consts_to_vec, main_pass_pallas
    from tpurt.passes import gtao as ref
    from tpurt_torch.kernels.gtao_main import main_pass_plain

    h, w = SHAPES[1]
    f = frames[(h, w)]
    slices, steps = preset
    ref_mips = ref.prefilter_depths(jnp.asarray(f["depth"]), f["consts"])
    pal_ao, pal_edges = main_pass_pallas(
        ref_mips, jnp.asarray(f["normal"]), consts_to_vec(f["consts"]),
        ref.noise_maps_64(jnp.int32(NOISE_INDEX)), width=w, height=h,
        slice_count=slices, steps_per_slice=steps, interpret=True,
        precision="exact", schedule="batch", noise_hoist=True,
        thin_zero=True)
    got_ao, got_edges = main_pass_plain(
        f["mips"], f["normal_t"], f["gvec"], f["noise"], slice_count=slices,
        steps_per_slice=steps)
    np.testing.assert_array_equal(got_edges.numpy(), np.asarray(pal_edges))
    _assert_budget(got_ao.numpy(), np.asarray(pal_ao), 1, 1e-3)


def test_counts_are_checked(frames):
    from tpurt_torch.kernels.gtao_main import gtao_main, gtao_noise_table

    f = frames[SHAPES[1]]
    with pytest.raises(ValueError, match="slice_count"):
        gtao_main(f["mips"], f["normal_t"], f["gvec"], f["noise"],
                  slice_count=0, steps_per_slice=3)
    with pytest.raises(ValueError, match="noise"):
        gtao_noise_table(f["noise"][0], f["gvec"], slice_count=1,
                         steps_per_slice=2)
