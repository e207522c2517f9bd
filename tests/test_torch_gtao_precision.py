"""GTAO precisions: ``precision="half"`` and ``"fp16"`` of the port's plain
K3h/K3/K4 and prefilter against tpurt on the CPU, and GtaoSettings' fields.

* "half" rounds each fetched horizon depth to bf16. tpurt honours it only
  on its Pallas main pass (its CPU Renderer takes the XLA pass, which
  ignores it: ROADMAP F21), so the port is held to
  ``main_pass_pallas(interpret=True, precision="half")``: edges equal, AO
  within 1 u8 step on <= 0.1% of pixels (measured: equal); and it must
  differ from the port's "exact" on these inputs.
* "fp16" is held to tpurt's eager fp16 (``main_pass`` called op by op, as
  tests/test_gtao.py runs it; ROADMAP F20 for the jitted frame). Budget:
  at most a quarter of tpurt's own fp16-vs-f32 distance on the same inputs,
  in the share of pixels that differ and in RMSE (u8 steps; per byte of
  the packed term with bent normals), and never more than 1 step per
  byte. Measured: the prefilter and the denoise pass equal; the main pass
  equal without bent normals, with them 1 byte on 0.02% of the 64x64
  pixels; tpurt's fp16-vs-f32 distance is 26-53% of pixels, RMSE
  0.48-1.15. The port's fp16 must differ from its f32.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gtao import _gbuffer

NOISE_INDEX = 5
CASES = [((32, 32), (2, 2)), ((64, 64), (9, 3)), ((40, 48), (3, 3))]


def _u8(a, bent):
    a = np.asarray(a)
    if bent:
        return a.view(np.uint8).reshape(*a.shape, 4).astype(int)
    return a.astype(int)[..., None]


def _distance(a, b, bent):
    """(max step, share of pixels differing, RMSE in u8 steps)."""
    d = np.abs(_u8(a, bent) - _u8(b, bent))
    return (int(d.max()), float((d.max(-1) > 0).mean()),
            float(np.sqrt((d.astype(float) ** 2).mean())))


def test_settings_fields_and_refusals():
    """The port's GtaoSettings fields equal tpurt's of the same names, and
    fp16 and the derived properties match; tpurt's TPU route fields
    (pallas_*, schedule, noise_hoist, thin_zero: bit-identical routes) are
    no fields here; tpurt's diagnostic precisions and unknown ones
    raise."""
    from tpurt.passes.gtao import GtaoSettings as RefSettings
    from tpurt_torch.passes.gtao import GtaoSettings

    for kw in (dict(), dict(bent_normals=True, precision="fp16"),
               dict(slice_count=3, steps_per_slice=3, precision="half",
                    denoise=3)):
        ref, got = RefSettings(**kw), GtaoSettings(**kw)
        fields = dataclasses.asdict(got)
        assert fields == {k: v for k, v in dataclasses.asdict(ref).items()
                          if k in fields}
        for prop in ("fp16", "denoise_blur_beta", "num_denoise_passes"):
            assert getattr(got, prop) == getattr(ref, prop)
    for route in ("pallas_main", "pallas_denoise", "schedule",
                  "noise_hoist", "thin_zero"):
        assert hasattr(RefSettings(), route)
        with pytest.raises(TypeError):
            GtaoSettings(**{route: getattr(RefSettings(), route)})
    for mode in ("debug_nofetch", "debug_sharedsel", "debug_noconds"):
        with pytest.raises(NotImplementedError):
            GtaoSettings(precision=mode)
    with pytest.raises(ValueError):
        GtaoSettings(precision="bf16")


@pytest.fixture(scope="module")
def half_results():
    from tpurt.kernels.gtao_main_pallas import consts_to_vec, main_pass_pallas
    from tpurt.passes import gtao as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.gtao_main import gtao_main
    from tpurt_torch.passes import gtao

    out = {}
    for i, ((h, w), (slices, steps)) in enumerate(CASES[:2]):
        depth, normal = _gbuffer(h, w, seed=30 + i)
        consts = ref.gtao_constants(w, h, 0.1, 100.0, np.pi / 2, w / h)
        mips = ref.prefilter_depths(jnp.asarray(depth), consts)
        want = main_pass_pallas(
            mips, jnp.asarray(normal), consts_to_vec(consts),
            ref.noise_maps_64(jnp.int32(NOISE_INDEX)), width=w, height=h,
            slice_count=slices, steps_per_slice=steps, interpret=True,
            precision="half", schedule="batch", noise_hoist=True,
            thin_zero=True)
        args = ([torch.tensor(np.asarray(m)) for m in mips],
                torch.tensor(normal),
                convert.gtao_tensors(consts, "cpu")["vec"],
                gtao.noise_maps_64(NOISE_INDEX, "cpu"))
        kw = dict(slice_count=slices, steps_per_slice=steps)
        out[(h, w)] = dict(
            want=[np.asarray(x) for x in want],
            got=[x.numpy() for x in gtao_main(*args, precision="half",
                                              **kw)],
            exact=gtao_main(*args, **kw)[0].numpy())
    return out


@pytest.mark.parametrize("shape", [c[0] for c in CASES[:2]])
def test_half_matches_pallas_interpret(shape, half_results):
    r = half_results[shape]
    np.testing.assert_array_equal(r["got"][1], r["want"][1])
    step, share, _ = _distance(r["got"][0], r["want"][0], False)
    assert step <= 1 and share <= 1e-3, (step, share)
    _, share_exact, _ = _distance(r["got"][0], r["exact"], False)
    assert share_exact > 0.05, f"half equals exact on {1 - share_exact}"


@pytest.fixture(scope="module")
def fp16_results():
    """Per case and bent: tpurt's eager fp16 and f32 main pass, the port's
    fp16 and f32 plain main pass, and the prefilters."""
    from tpurt.passes import gtao as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.gtao_main import gtao_main
    from tpurt_torch.passes import gtao

    out = {}
    for i, ((h, w), (slices, steps)) in enumerate(CASES):
        depth, normal = _gbuffer(h, w, seed=20 + i)
        consts = ref.gtao_constants(w, h, 0.1, 100.0, np.pi / 2, w / h)
        g = convert.gtao_tensors(consts, "cpu")
        mips = {p: ref.prefilter_depths(jnp.asarray(depth), consts,
                                        fp16=p == "fp16")
                for p in ("fp16", "exact")}
        port_mips = {p: gtao.prefilter_depths(torch.tensor(depth), consts,
                                              fp16=p == "fp16")
                     for p in ("fp16", "exact")}
        for bent in (False, True):
            res = dict(ref_mips=mips["fp16"], port_mips=port_mips["fp16"])
            for p in ("fp16", "exact"):
                s = ref.GtaoSettings(slices, steps, denoise=1,
                                     bent_normals=bent, precision=p)
                res[f"ref_{p}"] = [np.asarray(x) for x in ref.main_pass(
                    mips[p], jnp.asarray(normal), consts, s,
                    jnp.int32(NOISE_INDEX))]
                got = gtao_main(port_mips[p], torch.tensor(normal),
                                g["vec16" if p == "fp16" else "vec"],
                                gtao.noise_maps_64(NOISE_INDEX, "cpu"),
                                slice_count=slices, steps_per_slice=steps,
                                bent=bent, precision=p)
                res[f"got_{p}"] = [x.numpy() for x in got]
                res[f"settings_{p}"] = s
            out[((h, w), bent)] = res
    return out


FP16_KEYS = [(c[0], bent) for c in CASES for bent in (False, True)]
FP16_IDS = [f"{h}x{w}-{'bent' if b else 'ao'}" for (h, w), b in FP16_KEYS]


@pytest.mark.parametrize("key", FP16_KEYS[::2], ids=FP16_IDS[::2])
def test_fp16_prefilter_bit_exact(key, fp16_results):
    r = fp16_results[key]
    for got, want in zip(r["port_mips"], r["ref_mips"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("key", FP16_KEYS, ids=FP16_IDS)
def test_fp16_main_pass_within_budget(key, fp16_results):
    r = fp16_results[key]
    bent = key[1]
    got, want = r["got_fp16"], r["ref_fp16"]
    np.testing.assert_array_equal(got[1], want[1])
    step, share, rmse = _distance(got[0].view(np.uint32) if bent else got[0],
                                  want[0], bent)
    _, ref_share, ref_rmse = _distance(want[0], r["ref_exact"][0], bent)
    print(f"{key}: port vs tpurt eager fp16: max {step}, share {share:.5f},"
          f" RMSE {rmse:.4f}; tpurt fp16 vs f32: share {ref_share:.4f}, "
          f"RMSE {ref_rmse:.4f}")
    assert step <= 1, f"max step {step} > 1"
    assert share <= ref_share / 4, (share, ref_share)
    assert rmse <= ref_rmse / 4, (rmse, ref_rmse)
    # the port's fp16 is not its f32
    _, port_share, _ = _distance(got[0], r["got_exact"][0], bent)
    assert port_share > 0.05, f"fp16 equals f32 on {1 - port_share}"


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("key", FP16_KEYS, ids=FP16_IDS)
def test_fp16_denoise_pass_bit_exact(key, final, fp16_results):
    """One fp16 denoise pass of tpurt's fp16 main pass output."""
    from tpurt.passes import gtao as ref
    from tpurt_torch.kernels.gtao_denoise import denoise_pass_plain

    r = fp16_results[key]
    bent = key[1]
    s = r["settings_fp16"]
    ao, edges = r["ref_fp16"]
    blur = s.denoise_blur_beta if final else s.denoise_blur_beta / 5.0
    want = np.asarray(ref.denoise_pass(jnp.asarray(ao), jnp.asarray(edges),
                                       s, final_apply=final))
    got = denoise_pass_plain(torch.tensor(ao.view(np.int32) if bent else ao),
                             torch.tensor(edges), blur, final, bent=bent,
                             fp16=True).numpy()
    np.testing.assert_array_equal(got.view(np.uint32) if bent else got, want)
