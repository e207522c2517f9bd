"""GTAO over a band of rows (the band-sharded frame's GTAO): K3's plain
version over bands of the image, compute_ao_band against compute_ao and
against tpurt's compute_ao_band.

Inputs: the G-buffer of a 40x36 frame of the cut bench scene rendered by
the port on the CPU (depth and the encoded normals), and numpy-seeded
G-buffers for tpurt. Bars:

* K3's plain version over a band (bands that start at row 0 and end at
  row H - 1 included) equals the same rows of the whole-image pass bit for
  bit, in all five instantiations: each pixel is computed alike, only the
  rows differ; a band that leaves the image is refused;
* compute_ao_band on every band of a 4-way split equals the rows of
  compute_ao bit for bit, for 0 to 3 denoise passes;
* against tpurt's compute_ao_band, test_torch_gtao.py's budget: 1 u8 step
  on <= 0.1% of pixels (the port measures equal). With two or more denoise
  passes tpurt's first and last rows leave its own compute_ao (ROADMAP
  F22): that is shown, and held only with one pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H = 40, 36
NOISE_INDEX = 5
VARIANTS = [(False, "exact"), (True, "exact"), (False, "half"),
            (False, "fp16"), (True, "fp16")]
VARIANT_IDS = ["exact", "bent", "half", "fp16", "bent_fp16"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gbuffer():
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    r = build_bench_scene(Renderer(RendererConfig(
        width=W, height=H, device="cpu")), field=dict(nx=3, nz=3, subdiv=2),
        cubes=2)
    out = r.render()
    _, _, gtao = r._frame_inputs()
    return out["depth"], out["normal"], gtao


@pytest.mark.parametrize("bent,precision", VARIANTS, ids=VARIANT_IDS)
def test_plain_k3_band_equals_whole_image_rows(gbuffer, bent, precision):
    from tpurt_torch.kernels.gtao_main import main_pass_plain
    from tpurt_torch.passes.gtao import noise_maps_64, prefilter_depths

    depth, normal, gtao = gbuffer
    fp16 = precision == "fp16"
    mips = prefilter_depths(depth, gtao["host"], fp16=fp16)
    args = (mips, normal, gtao["vec16" if fp16 else "vec"],
            noise_maps_64(NOISE_INDEX, "cpu"))
    kw = dict(slice_count=3, steps_per_slice=3, bent=bent,
              precision=precision)
    ao, edges = main_pass_plain(*args, **kw)
    assert ao.shape == (H, W)
    for row_start, rows in ((0, 12), (9, 9), (23, 13), (0, H), (35, 1)):
        band_ao, band_edges = main_pass_plain(*args, row_start=row_start,
                                              num_rows=rows, **kw)
        idx = slice(row_start, row_start + rows)
        assert band_ao.shape == (rows, W) and band_ao.dtype == ao.dtype
        assert torch.equal(band_ao, ao[idx]), (row_start, rows)
        assert torch.equal(band_edges, edges[idx]), (row_start, rows)


def test_band_rows_refusals():
    from tpurt_torch.kernels.gtao_main import band_rows

    assert band_rows(36, 0, None) == (0, 36)
    assert band_rows(36, 31, 5) == (31, 5)
    for row_start, rows in ((0, 0), (36, 4), (-4, 4), (-1, 5), (33, 4),
                            (3, None)):
        with pytest.raises(ValueError):
            band_rows(36, row_start, rows)


@pytest.mark.parametrize("denoise,over", [
    (0, {}), (1, {}), (2, dict(bent_normals=True)),
    (3, dict(precision="fp16")), (1, dict(precision="half")),
    (2, dict(bent_normals=True, precision="fp16"))],
    ids=["exact-0", "exact-1", "bent-2", "fp16-3", "half-1", "bent_fp16-2"])
def test_compute_ao_band_equals_compute_ao(gbuffer, denoise, over):
    from tpurt_torch.passes.gtao import (GtaoSettings, compute_ao,
                                         compute_ao_band, noise_maps_64)

    depth, normal, gtao = gbuffer
    s = GtaoSettings(3, 3, denoise=denoise, **over)
    noise = noise_maps_64(NOISE_INDEX, "cpu")
    full = compute_ao(depth, normal, gtao, s, noise)
    band = H // 4
    for k in range(4):
        got = compute_ao_band(depth, normal, gtao, s, noise, k * band, band)
        assert torch.equal(got, full[k * band:(k + 1) * band]), k
    with pytest.raises(ValueError):
        compute_ao_band(depth, normal, gtao, s, noise, H - 2, band)


def _seeded_gbuffer(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = (3.0 + 0.05 * xx + 0.02 * yy).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.2] = 1.5
    n = rng.normal(size=(h, w, 3))
    n[..., 2] = -np.abs(n[..., 2])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return depth, (n * 0.5 + 0.5).astype(np.float32)


@pytest.mark.parametrize("denoise", [1, 2])
def test_compute_ao_band_against_tpurt(denoise):
    from tpurt.passes import gtao as ref
    from tpurt_torch.engine import convert
    from tpurt_torch.passes import gtao

    depth, normal = _seeded_gbuffer(H, W, seed=denoise)
    consts = ref.gtao_constants(W, H, 0.1, 100.0, np.pi / 2, W / H)
    band = H // 4
    port_s = gtao.GtaoSettings(3, 3, denoise=denoise)
    ref_s = ref.GtaoSettings(3, 3, denoise=denoise)
    tensors = convert.gtao_tensors(consts, "cpu")
    d_t, n_t = torch.tensor(depth), torch.tensor(normal)
    # jitted once per setting (tpurt's row_start may be traced), so the
    # four bands cost one compile instead of eager op-by-op dispatch
    ref_band_fn = jax.jit(
        lambda d, n, row: ref.compute_ao_band(d, n, consts, ref_s,
                                              jnp.int32(NOISE_INDEX), row,
                                              band))
    ref_full = np.asarray(jax.jit(
        lambda d, n: ref.compute_ao(d, n, consts, ref_s,
                                    jnp.int32(NOISE_INDEX)))(
        jnp.asarray(depth), jnp.asarray(normal)))
    noise = gtao.noise_maps_64(NOISE_INDEX, "cpu")
    port_full = gtao.compute_ao(d_t, n_t, tensors, port_s, noise)
    for k in range(4):
        rows = slice(k * band, (k + 1) * band)
        ref_band = np.asarray(ref_band_fn(
            jnp.asarray(depth), jnp.asarray(normal),
            jnp.int32(k * band))).astype(int)
        got = gtao.compute_ao_band(d_t, n_t, tensors, port_s, noise,
                                   k * band, band).numpy().astype(int)
        np.testing.assert_array_equal(got, port_full[rows].numpy())
        # tpurt's band leaves its whole frame only in the image's first and
        # last rows, and only with two or more passes (F22)
        off = (ref_band != ref_full[rows]).any(axis=1)
        edge = {0: slice(0, denoise - 1), 3: slice(band - denoise + 1, band)}
        inner = np.ones(band, bool)
        if k in edge:
            inner[edge[k]] = False
        assert not off[inner].any(), (k, off)
        if denoise > 1 and k in edge:
            assert off[edge[k]].all(), (k, off)
        d = np.abs(got[inner] - ref_band[inner])
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (k, d.max())
