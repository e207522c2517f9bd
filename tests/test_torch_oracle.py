"""The <= 1% RMSE gate (BASELINE.md) of the port against the independent
numpy oracle (tests/oracle.py: the reference's GLSL re-derived, brute-force
intersection, no tpurt code; tests/oracle_post.py: XeGTAO and LPM
re-derived), on the configs 1-4 analogues of tpurt's
tests/test_oracle_rmse.py and tests/test_oracle_full_pipeline.py
(tests/torch_oracle_scenes.py), 128x128.

The oracle reads tpurt's ``FlatScene.as_full_pytree()`` of the same
procedural scene (the port may not import tpurt; its tests may); the port
renders its own flattened copy. Bars, tpurt's: the port's
``render_sample_hdr`` at zero jitter within 1% of peak RMSE; its
``render_gbuffer`` hit mask off on <= 0.5% of pixels, depth within 1% of
the depth range + 1e-3, encoded normals within 0.01 at the 99.9th
percentile; guards that the oracle frame has hits, lit pixels and (config
1) shadowed pixels, so an empty frame cannot pass. Config 4, the whole
frame (shade, XeGTAO at tiers low and ultra with denoise 0 and 1, LPM,
u8) against oracle_render + oracle_post_process within 1% RMSE through
the port's image_metrics.rmse, with tpurt's guards: hits on > 30% of
pixels, and the oracle's AO both darker than 200 and above 260 somewhere.
"""
import math

import numpy as np
import pytest

from torch_oracle_scenes import SIZE, TIERS, build, oracle_gbuffer
from torch_parity import same_host_builder  # noqa: F401

# (config, least hit share, least lit share), tpurt's
GUARDS = {1: (0.15, 0.05), 2: (0.15, 0.05), 3: (0.15, 0.05)}


@pytest.mark.parametrize("config", sorted(GUARDS))
def test_sample_hdr_within_one_percent(config):
    from tpurt_torch.engine.frame import render_gbuffer, render_sample_hdr
    from tpurt_torch.utils.image_metrics import rmse

    ref_r = build("tpurt", config)
    port_r = build("tpurt_torch", config)
    for a, b in ((ref_r.camera.uniform(), port_r.camera.uniform()),
                 (ref_r.lights.shader_arrays(),
                  port_r.lights.shader_arrays())):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    ref = oracle_gbuffer(ref_r)
    hit = ref["depth"] < 9999.0
    min_hit, min_lit = GUARDS[config]
    assert hit.mean() > min_hit, f"scene too empty: {hit.mean():.2%} hits"
    lit = (ref["color"].sum(-1) > 1e-3).mean()
    assert lit > min_lit, f"scene too dark: {lit:.2%} lit"
    if config == 1:
        # the occluder shadows part of the face
        assert (hit & (ref["color"].sum(-1) < 0.02)).mean() > 0.01

    cam, lights, _ = port_r._frame_inputs()
    scene = port_r.scene_device
    ours = render_sample_hdr(scene, cam, lights, (0.0, 0.0), width=SIZE,
                             height=SIZE).numpy().astype(np.float64)
    scale = float(ref["color"].max())
    assert scale > 0
    rel = rmse(ours, ref["color"]) / scale
    print(f"config {config}: RMSE {rel:.3e} of peak")
    assert rel <= 0.01, f"RMSE {rel:.4%} of peak exceeds the 1% gate"
    err = ours - ref["color"]
    assert abs(math.sqrt(float(np.mean(err * err))) / scale - rel) < 1e-6

    g = render_gbuffer(scene, cam, lights, width=SIZE, height=SIZE)
    depth = g["depth"].numpy().astype(np.float64).reshape(SIZE, SIZE)
    nenc = g["normal_enc"].numpy().astype(np.float64).reshape(SIZE, SIZE, 3)
    our_hit = depth < 9999.0
    assert (our_hit != hit).mean() <= 5e-3, "hit masks diverge"
    both = hit & our_hit
    d_err = np.abs(depth - ref["depth"])[both]
    d_scale = float(ref["depth"][both].max())
    assert d_err.max() <= 0.01 * d_scale + 1e-3, d_err.max()
    n_err = np.abs(nenc - ref["normal_enc"])[both]
    assert np.quantile(n_err, 0.999) <= 0.01, np.quantile(n_err, 0.999)


@pytest.fixture(scope="module")
def config4():
    ref_r = build("tpurt", 4)
    return dict(ref_r=ref_r, port_r=build("tpurt_torch", 4),
                ref=oracle_gbuffer(ref_r))


@pytest.mark.parametrize("denoise", [0, 1])
@pytest.mark.parametrize("tier", ["low", "ultra"])
def test_whole_frame_within_one_percent(config4, tier, denoise):
    from oracle_post import (oracle_gtao_consts, oracle_post_process,
                             xegtao_full)
    from tpurt_torch.engine.frame import render_frame
    from tpurt_torch.passes.gtao import GtaoSettings, noise_maps_64
    from tpurt_torch.passes.tonemap import LpmParams, lpm_setup
    from tpurt_torch.utils.image_metrics import rmse

    noise_index = 7
    slices, steps = TIERS[tier]
    port_r, ref = config4["port_r"], config4["ref"]
    cam, lights, gtao = port_r._frame_inputs()
    out = render_frame(port_r.scene_device, cam, lights, gtao, port_r._lpm,
                       noise_maps_64(noise_index, "cpu"), width=SIZE,
                       height=SIZE,
                       gtao_settings=GtaoSettings(slices, steps,
                                                  denoise=denoise))
    ours = out["image"].numpy()

    c = port_r.camera
    oc = oracle_gtao_consts(SIZE, SIZE, c.fovy, c.aspect)
    ctl, _ = lpm_setup(LpmParams())
    theirs = oracle_post_process(ref["color"], ref["depth"],
                                 ref["normal_enc"], oc, ctl, slices, steps,
                                 denoise, noise_index)
    assert ours.dtype == theirs.dtype == np.uint8
    assert (ref["depth"] < 9999.0).mean() > 0.3
    assert (ours.max(-1) > 0).mean() > 0.3      # not a black frame
    ao = xegtao_full(ref["depth"].astype(np.float32),
                     ref["normal_enc"].astype(np.float32), oc, slices, steps,
                     denoise, noise_index)
    assert ao.min() < 200 and int(ao.max()) > 260, \
        "scene has neither dark creases nor >1.0 open-surface AO"
    err = rmse(ours, theirs)
    print(f"config 4, {tier}, denoise {denoise}: RMSE {err:.3e}")
    assert err <= 0.01, f"config-4 RMSE {err:.4%} exceeds the 1% gate"
