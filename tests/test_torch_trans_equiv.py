"""P1 (the transcendental probe): the port's plain version against tpurt's
noise-hoist kernel ``_noise_hoist_planes`` (Pallas in interpret mode),
which evaluates the same expressions as tpurt's probe kernel, on the same
seeded noise maps; and the probe's report.

Tolerance: cos and sin within 2e-6 absolute, pow within 2e-6 relative
(``kernels/trans_equiv.ATOL_TRIG`` / ``RTOL_POW``): tpurt's side is XLA:CPU's
cos/sin/pow, the port's torch's CPU kernels, two math libraries; each
failure message carries the mismatch counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

SLICES, STEPS = 9, 3


def _packets(m):
    """A (64, 64) map in tpurt's packet layout: (32, 128), each (8, 128)
    block one 32x32 tile (tpurt/kernels/traverse_pallas._to_packets)."""
    return m.reshape(2, 32, 2, 32).transpose(0, 2, 1, 3).reshape(32, 128)


@pytest.mark.parametrize("seed,sdp", [(0, 2.0), (1, 1.3)])
def test_plain_matches_tpurt_hoist(seed, sdp):
    from tpurt.kernels.gtao_main_pallas import _CK, _noise_hoist_planes
    from tpurt_torch.kernels.trans_equiv import (ATOL_TRIG, RTOL_POW,
                                                 row_ops, trans_equiv)

    rng = np.random.default_rng(seed)
    maps = rng.random((2, 64, 64), dtype=np.float32)
    vec = np.zeros(len(_CK), np.float32)
    vec[_CK.index("sample_distribution_power")] = sdp
    ref = np.asarray(_noise_hoist_planes(jnp.asarray(maps), jnp.asarray(vec),
                                         SLICES, STEPS, interpret=True))
    planes = torch.tensor(np.stack([_packets(m) for m in maps]))
    got = trans_equiv(planes, sdp, SLICES, STEPS).numpy()
    rows = SLICES * (2 + STEPS)
    assert got.shape == (rows, 32, 128)
    # tpurt's re-layout: (rows, 4 quadrant variants, 8, 128) -> (4, rows*8,
    # 128)
    got = got.reshape(rows, 4, 8, 128).transpose(1, 0, 2, 3).reshape(
        4, rows, 8, 128)
    ref = ref.reshape(4, rows, 8, 128)
    ops = np.array(row_ops(SLICES, STEPS))
    report = {}
    for op in ("cos", "sin", "pow"):
        g, r = got[:, ops == op], ref[:, ops == op]
        lim = RTOL_POW * np.abs(r) if op == "pow" else ATOL_TRIG
        report[op] = dict(bit_mismatches=int((g.view(np.int32)
                                              != r.view(np.int32)).sum()),
                          outside=int((np.abs(g - r) > lim).sum()),
                          max_abs=float(np.abs(g - r).max()))
    assert all(v["outside"] == 0 for v in report.values()), report


def test_probe_report_on_cpu():
    """The probe's report: on a CPU device the kernel's side is the plain
    version; both stay within 1 ULP of float64 on every op."""
    from tpurt_torch.tools import trans_equiv_probe as probe

    rep = probe.run("cpu")
    n = 32 * 128
    assert rep["shape"] == [SLICES * (2 + STEPS), 32, 128]
    assert rep["elements_per_op"] == dict(cos=SLICES * n, sin=SLICES * n,
                                          pow=SLICES * STEPS * n)
    assert rep["arguments_equal_to_host"]
    for op in ("cos", "sin", "pow"):
        assert rep["kernel_vs_plain"][op] == dict(bit_mismatches=0,
                                                  max_ulp=0)
        assert rep["plain_vs_float64"][op]["max_ulp"] <= 1, rep
        assert rep["tolerance"][op]["outside"] == 0


def test_ulp_distance_and_arguments():
    """ULPs count across zero; the arguments follow tpurt's expressions."""
    from tpurt_torch.kernels.trans_equiv import PI, arguments
    from tpurt_torch.tools.trans_equiv_probe import ulp_distance

    tiny = torch.tensor([np.float32(1e-45)])
    assert int(ulp_distance(tiny, -tiny)) == 2
    assert int(ulp_distance(torch.tensor([1.0]),
                            torch.tensor([np.nextafter(np.float32(1.0),
                                                       np.float32(2.0))])
                            )) == 1
    planes = torch.tensor([[[0.25]], [[0.75]]])
    args = arguments(planes, 2.0, slice_count=2, steps_per_slice=2)
    f32 = np.float32
    phi1 = f32(f32(f32(1.0) + f32(0.25)) / f32(2.0)) * f32(PI)
    assert float(args[4, 0, 0]) == float(phi1)
    base = f32(f32(1 + 1 * 2) * f32(0.6180339887498948482))
    s0 = f32(f32(np.fmod(f32(f32(0.75) + base), f32(1.0)) + f32(1.0))
             / f32(2.0))
    assert float(args[7, 0, 0]) == float(s0)


def test_refuses_bad_planes():
    from tpurt_torch.kernels.trans_equiv import trans_equiv

    with pytest.raises(ValueError, match="planes"):
        trans_equiv(torch.zeros(3, 32, 128), 2.0)
    with pytest.raises(ValueError, match="planes"):
        trans_equiv(torch.zeros(2, 32, 128, dtype=torch.float64), 2.0)
