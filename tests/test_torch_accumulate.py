"""Progressive accumulation and its checkpoints: the port's
``engine/accumulate.py`` on the CPU against tpurt's (Pallas in interpret
mode, ``pallas_tables="bvh8"``) on tests/torch_frames.py's cut bench scene
at 32x32, with tpurt's ``jax.random`` jitters handed to the port's draw
function, and the port's own sampler on its own.

Bars: the sums within tests/test_torch_frame.py's HDR color bar (rtol
1e-3, atol 1e-5; the rays differ in the last bits, ROADMAP F7); the
port's own runs (seeds, save/load) bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ground_truth import SIZE, Feed, ref_inputs, ref_jitters, \
    renderers
from torch_parity import same_host_builder  # noqa: F401

SEED = 5
KW = dict(width=SIZE, height=SIZE)


@pytest.fixture(scope="module")
def scenes():
    ref_r, port_r = renderers()
    cam, lights = ref_inputs(ref_r)
    pcam, plights, _ = port_r._frame_inputs()
    return dict(ref=(ref_r.scene_device, cam, lights),
                port=(port_r.scene_device, pcam, plights))


@pytest.fixture(scope="module")
def ref_states(scenes):
    """tpurt's states after 3 samples from PRNGKey(SEED), both forms."""
    from tpurt.engine import accumulate as ref

    out = {}
    for name in ("accumulate_samples", "accumulate_samples_scan"):
        st = getattr(ref, name)(ref.init_accumulation(SIZE, SIZE, SEED),
                                *scenes["ref"], 3, pallas_tables="bvh8",
                                **KW)
        out[name] = st
    return out


@pytest.mark.parametrize("jitter", [(0.0, 0.0), (0.3125, -0.40625)])
def test_render_sample_hdr_matches(scenes, jitter):
    """One accumulation sample against tpurt's (the function its
    accumulation jits, compiled once for both tests here)."""
    from tpurt.engine.frame import render_sample_hdr as ref_sample
    from tpurt_torch.engine.frame import render_sample_hdr

    ref = np.asarray(ref_sample(*scenes["ref"],
                                jnp.asarray(jitter, jnp.float32),
                                pallas_tables="bvh8", **KW))
    got = render_sample_hdr(*scenes["port"], jitter, **KW).numpy()
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5)
    assert (ref.sum(-1) > 1e-3).mean() > 0.3  # lit


def feed(draws):
    return Feed([torch.from_numpy(j) for j in draws])


@pytest.mark.parametrize("name, draws", [("accumulate_samples", 2),
                                         ("accumulate_samples_scan", 3)])
def test_sums_match_tpurt(scenes, ref_states, monkeypatch, name, draws):
    """tpurt's draw orders: the loop draws nothing for the first sample of
    an empty state, the scan draws every sample's jitter and drops the
    first (ROADMAP F18)."""
    from tpurt_torch.engine import accumulate

    jit = feed(ref_jitters(SEED, draws))
    monkeypatch.setattr(accumulate, "_uniform_jitter", jit)
    st = getattr(accumulate, name)(accumulate.init_accumulation(
        SIZE, SIZE, SEED), *scenes["port"], 3, **KW)
    ref = ref_states[name]
    assert jit.calls == draws and st.num_samples == ref.num_samples == 3
    got = st.color_sum.numpy()
    np.testing.assert_allclose(got, np.asarray(ref.color_sum), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(ref.mean),
                               rtol=1e-3, atol=1e-5)
    assert (got.sum(-1) > 1e-3).mean() > 0.3   # lit


def test_loop_and_scan_draw_differently(scenes, monkeypatch):
    """From an empty state the two forms take different jitters from one
    seed; from a non-empty state both draw every sample."""
    from tpurt_torch.engine import accumulate

    counts = {}
    for name in ("accumulate_samples", "accumulate_samples_scan"):
        for start in (0, 1):
            jit = feed(ref_jitters(SEED, 2))
            monkeypatch.setattr(accumulate, "_uniform_jitter", jit)
            st = accumulate.init_accumulation(SIZE, SIZE, SEED)
            st.num_samples = start
            getattr(accumulate, name)(st, *scenes["port"], 2, **KW)
            counts[name, start] = jit.calls
    assert counts == {("accumulate_samples", 0): 1,
                      ("accumulate_samples", 1): 2,
                      ("accumulate_samples_scan", 0): 2,
                      ("accumulate_samples_scan", 1): 2}


def test_first_sample_is_the_center(scenes):
    from tpurt_torch.engine.accumulate import (accumulate_samples,
                                              init_accumulation)
    from tpurt_torch.engine.frame import render_sample_hdr

    st = accumulate_samples(init_accumulation(SIZE, SIZE, 0),
                            *scenes["port"], 1, **KW)
    one = render_sample_hdr(*scenes["port"], (0.0, 0.0), **KW)
    assert st.num_samples == 1 and torch.equal(st.color_sum, one)
    assert torch.equal(st.mean, one)


def test_own_sampler_seed_and_range():
    from tpurt_torch.engine.accumulate import _uniform_jitter, \
        init_accumulation

    a, b = init_accumulation(4, 4, 3), init_accumulation(4, 4, 3)
    draws = torch.stack([_uniform_jitter(a.key) for _ in range(2000)])
    assert torch.equal(draws, torch.stack([_uniform_jitter(b.key)
                                           for _ in range(2000)]))
    assert draws.dtype == torch.float32 and draws.shape == (2000, 2)
    assert float(draws.min()) >= -0.5 and float(draws.max()) < 0.5
    assert abs(float(draws.mean())) < 0.02       # ~ 9 sigma of 2e-3
    c = init_accumulation(4, 4, 4)
    assert not torch.equal(_uniform_jitter(c.key), draws[0])


def test_same_seed_same_sum_and_state_untouched(scenes):
    from tpurt_torch.engine.accumulate import (accumulate_samples,
                                              init_accumulation)

    st = init_accumulation(SIZE, SIZE, 11)
    key_before = st.key.get_state()
    a = accumulate_samples(st, *scenes["port"], 3, **KW)
    b = accumulate_samples(st, *scenes["port"], 3, **KW)
    assert torch.equal(st.key.get_state(), key_before)
    assert torch.equal(a.color_sum, b.color_sum)
    assert torch.equal(a.key.get_state(), b.key.get_state())


@pytest.mark.parametrize("name", ["accumulate_samples",
                                  "accumulate_samples_scan"])
def test_checkpoint_round_trip_bit_exact(scenes, tmp_path, name):
    """4 samples, save, load, 2 more: the sum of 6 uninterrupted samples,
    bit for bit."""
    from tpurt_torch.engine import accumulate

    run = getattr(accumulate, name)
    whole = run(accumulate.init_accumulation(SIZE, SIZE, 2),
                *scenes["port"], 6, **KW)
    first = run(accumulate.init_accumulation(SIZE, SIZE, 2),
                *scenes["port"], 4, **KW)
    accumulate.save_checkpoint(str(tmp_path / "acc"), first)
    resumed = accumulate.load_checkpoint(str(tmp_path / "acc"))
    assert resumed.num_samples == 4
    assert torch.equal(resumed.color_sum, first.color_sum)
    rest = run(resumed, *scenes["port"], 2, **KW)
    assert rest.num_samples == whole.num_samples == 6
    assert torch.equal(rest.color_sum.view(torch.int32),
                       whole.color_sum.view(torch.int32))
    assert torch.equal(rest.key.get_state(), whole.key.get_state())


def test_tpurt_checkpoint_resumes(scenes, ref_states, tmp_path):
    """A checkpoint tpurt wrote loads with its sum and count, its key
    [hi, lo] seeds the generator with hi * 2**32 + lo, and two more
    samples continue the same mean."""
    from tpurt.engine.accumulate import save_checkpoint as ref_save
    from tpurt_torch.engine import accumulate
    from tpurt_torch.engine.frame import render_sample_hdr

    ref = ref_states["accumulate_samples"]
    path = str(tmp_path / "from_tpurt.npz")
    ref_save(path, ref)
    st = accumulate.load_checkpoint(path)
    assert st.num_samples == 3
    np.testing.assert_array_equal(st.color_sum.numpy(),
                                  np.asarray(ref.color_sum))
    hi, lo = (int(w) for w in np.asarray(ref.key))
    assert torch.equal(st.key.get_state(),
                       accumulate._generator((hi << 32) | lo).get_state())

    probe = accumulate._generator((hi << 32) | lo)
    jitters = [accumulate._uniform_jitter(probe) for _ in range(2)]
    more = accumulate.accumulate_samples(st, *scenes["port"], 2, **KW)
    want = st.color_sum
    for jit in jitters:
        want = want + render_sample_hdr(*scenes["port"], jit, **KW)
    assert more.num_samples == 5 and torch.equal(more.color_sum, want)
    # the mean moved on from tpurt's 3 samples, not from zero
    assert float((more.mean - st.mean).abs().mean()) < 0.5 * float(
        st.mean.abs().mean())


def test_key_word_order():
    """PRNGKey(s) is [0, s] for s < 2**32, so its file seeds s."""
    key = np.asarray(jax.random.PRNGKey(77))
    assert key.dtype == np.uint32 and key.tolist() == [0, 77]


def test_bare_path_gets_npz(scenes, tmp_path):
    from tpurt_torch.engine import accumulate

    st = accumulate.accumulate_samples(
        accumulate.init_accumulation(SIZE, SIZE, 0), *scenes["port"], 1,
        **KW)
    bare = tmp_path / "sub" / "ckpt"
    accumulate.save_checkpoint(str(bare), st)
    assert (tmp_path / "sub" / "ckpt.npz").exists() and not bare.exists()
    for path in (str(bare), str(bare) + ".npz"):
        back = accumulate.load_checkpoint(path)
        assert back.num_samples == 1
        assert torch.equal(back.color_sum, st.color_sum)
    assert accumulate._ckpt_path("a.npz") == "a.npz"
    assert accumulate.load_checkpoint(str(tmp_path / "missing")) is None
