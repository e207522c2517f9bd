"""The plain reference on the CPU: the torch rewrite against the frozen
numpy oracles (rtbench/reference/oracle_np.py, oracle_post_np.py) and a
numpy statement of the mip samplers, the port's 32 x 32 frames against the
reference at the oracle's bars, and deliberate faults that the comparison
has to catch."""
import contextlib
import math
import sys

import numpy as np
import pytest
import torch

from tiny import RTBENCH, make_root

from rtbench.harness import correct, registry
from rtbench.harness.cell import Cell
from rtbench.reference import post, shade
from rtbench.reference.frame import Reference
from rtbench.reference.oracle_np import oracle_render
from rtbench.reference.oracle_post_np import oracle_post_process
from rtbench.reference.scene import SceneTables, box_mip, world_vertices
from rtbench.scenes import build_models

from tiny import cut_config

SIZE = 24
KIND = dict(point=0, spot=1, directional=2, area=3)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def _bench(seed=3):
    config = cut_config(registry.config("bench43k"))
    return config, build_models(config, seed)


def _light_arrays(lights: list) -> dict:
    """The reference's lights as the numpy oracle's struct of arrays."""
    n = len(lights)
    out = dict(pos=np.zeros((n, 3)), light_type=np.zeros(n, np.int32),
               dir=np.zeros((n, 3)), casts_shadows=np.zeros(n, np.int32),
               color=np.zeros((n, 3)), falloff_distance=np.zeros(n),
               area_pos2=np.zeros((n, 3)), penumbra_angle=np.zeros(n),
               area_pos3=np.zeros((n, 3)), umbra_angle=np.zeros(n),
               active=np.ones(n))
    for i, li in enumerate(lights):
        out["pos"][i] = li["pos"].numpy()
        out["light_type"][i] = KIND[li["type"]]
        out["dir"][i] = li.get("dir", torch.zeros(3)).numpy()
        out["casts_shadows"][i] = int(li["casts_shadows"])
        out["color"][i] = li["color"].numpy()
        out["falloff_distance"][i] = li["falloff"]
        out["penumbra_angle"][i] = li.get("penumbra", 0.0)
        out["umbra_angle"][i] = li.get("umbra", 0.0)
        if li["type"] == "area":
            out["area_pos2"][i] = li["pos2"].numpy()
            out["area_pos3"][i] = li["pos3"].numpy()
    return out


def _oracle_scene(ref: Reference, transforms=None) -> dict:
    """The numpy oracle's world-space tables of the same scene: the
    vertices moved in float64 numpy, not by the torch code."""
    t = ref.tables
    mats = (t["matrices"] if transforms is None
            else torch.as_tensor(transforms)).double().numpy()
    inst = t["inst"].numpy()
    pos, nrm = t["pos"].double().numpy(), t["nrm"].double().numpy()
    m = mats[inst]
    wpos = np.einsum("vij,vj->vi", m[:, :, :3], pos) + m[:, :, 3]
    inv_t = np.linalg.inv(mats[:, :, :3]).transpose(0, 2, 1)[inst]
    wn = np.einsum("vij,vj->vi", inv_t, nrm)
    wn /= np.linalg.norm(wn, axis=1, keepdims=True)
    tan = np.einsum("vij,j->vi", m[:, :, :3], np.array([1.0, 0.0, 0.0]))
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    return dict(tri_vertex=t["idx"].numpy(), tri_prim=t["prim"].numpy(),
                vtx_pos=wpos, vtx_uv=t["uv"].double().numpy(),
                vtx_normal=wn,
                vtx_tangent=np.concatenate([tan, np.ones((len(tan), 1))], 1),
                tex_stack=t["tex_stack"].numpy(),
                tex_size=t["tex_size"].numpy())


def _ctl_words(c: dict) -> np.ndarray:
    """The LPM control block's words that LpmFilter reads, from the
    reference's own setup."""
    ctl = np.zeros((24, 4), np.uint32)

    def put(i, j, x):
        ctl[i, j] = np.float32(x).view(np.uint32)

    for j in range(3):
        put(0, j, c["saturation"][j])
    put(0, 3, c["contrast"])
    put(1, 0, c["bias"][0])
    put(1, 1, c["bias"][1])
    put(1, 2, c["luma"][0])
    put(1, 3, c["luma"][1])
    put(2, 0, c["luma"][2])
    for j in range(3):
        put(2, j + 1, c["crosstalk"][j])
        put(3, j, c["rcp_luma"][j])
    return ctl


POSES = [((0.3, -2.2, -5.5), (0.0, 0.45, 1.0)),
         ((-1.0, -1.8, -4.5), (0.3, 0.3, 1.0))]


@pytest.mark.parametrize("transformed", [False, True])
@pytest.mark.parametrize("pose", range(len(POSES)))
def test_gbuffer_equals_numpy_oracle(pose, transformed):
    """The three bench lights (sun, spot, area, all casting shadows), the
    textured cubes, with the models' matrices or per-instance transforms
    (every instance rotated about Y and moved)."""
    config, models = _bench()
    ref = Reference(models, config["lights"], mipmaps=False,
                    gtao=config["renderer"]["gtao"], device="cpu")
    tf = None
    if transformed:
        a = 0.3
        rot = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                        [-math.sin(a), 0, math.cos(a)]], np.float32)
        tf = ref.tables["matrices"].numpy().copy()
        tf[:, :, :3] = np.einsum("ij,njk->nik", rot, tf[:, :, :3])
        tf[:, :, 3] += np.array([0.2, -0.1, 0.3], np.float32)
    pos, d = POSES[pose]
    g, hit, cam = ref.gbuffer(pos, d, width=SIZE, height=SIZE,
                              transforms=tf)
    want = oracle_render(_oracle_scene(ref, tf), dict(
        view=cam["view"], view_inv=cam["view_inv"],
        proj_inv=cam["proj_inv"], camera_pos=cam["pos"]),
        _light_arrays(ref.lights), SIZE, SIZE)
    sure = ~hit[4].numpy()
    lit = sure & ~g["shadow_undecided"].numpy()
    color = g["color"].double().numpy()
    wc = want["color"].reshape(-1, 3)
    assert (want["depth"] < 9999).mean() > 0.3 and wc.max() > 0
    # the oracle gate's measure (RMSE over the peak), 10x tighter; float32
    # against float64 differs most where a light grazes the surface (the
    # Burley term's 1 / (N.V N.L)) and where the tangent frame is rounding
    # noise (below)
    peak = wc.max()
    err = (color - wc)[lit]
    assert math.sqrt(float(np.mean(err * err))) <= 1e-3 * peak
    assert np.quantile(np.abs(err), 0.99) <= 1e-4 * peak
    depth = g["depth"].double().numpy()
    wd = want["depth"].reshape(-1)
    assert np.array_equal((depth < 9999)[sure], (wd < 9999)[sure])
    assert np.abs(depth - wd)[sure].max() <= 1e-4 * wd[wd < 9999].max()
    # on faces whose normal is the default tangent (1, 0, 0) the
    # Gram-Schmidt tangent is rounding noise in both, and the flat normal
    # map's +-0.004 tangent-space components follow it
    nenc = g["normal_enc"].double().numpy()
    assert np.abs(nenc - want["normal_enc"].reshape(-1, 3))[sure].max() \
        <= 5e-3


@pytest.mark.parametrize("denoise", [0, 1])
def test_post_equals_numpy_oracle(denoise):
    """GTAO ULTRA (denoise off and sharp), the composite, LPM and the u8
    store on the same G-buffer."""
    config, models = _bench()
    ref = Reference(models, config["lights"], mipmaps=False,
                    gtao=dict(config["renderer"]["gtao"], denoise=denoise),
                    device="cpu")
    g, _, cam = ref.gbuffer(*POSES[0], width=SIZE, height=SIZE)
    ours = ref.finish(g, cam, SIZE, SIZE, 11)["image"].numpy()
    oc = post.gtao_constants(SIZE, SIZE, cam["fovy"], cam["aspect"])
    consts = dict(viewport_pixel_size=oc["pixel"],
                  ndc_to_view_mul=oc["ndc_mul"], ndc_to_view_add=oc["ndc_add"],
                  ndc_to_view_mul_x_pixel_size=oc["ndc_mul_x_pixel"],
                  effect_radius=oc["effect_radius"],
                  radius_multiplier=oc["radius_multiplier"],
                  effect_falloff_range=oc["falloff_range"],
                  sample_distribution_power=oc["sample_distribution_power"],
                  thin_occluder_compensation=oc["thin_occluder_compensation"],
                  depth_mip_sampling_offset=oc["mip_sampling_offset"],
                  final_value_power=oc["final_value_power"])
    theirs = oracle_post_process(
        g["color"].numpy().reshape(SIZE, SIZE, 3),
        g["depth"].numpy().reshape(SIZE, SIZE),
        g["normal_enc"].numpy().reshape(SIZE, SIZE, 3), consts,
        _ctl_words(ref.lpm), 9, 3, denoise, 11)
    diff = np.abs(ours.astype(int) - theirs.astype(int))
    assert diff.max() <= 2 and (diff > 0).mean() <= 0.02


def _np_bilinear(img, uv):
    h, w = img.shape[:2]
    px, py = uv[0] * w - 0.5, uv[1] * h - 0.5
    x0, y0 = math.floor(px), math.floor(py)
    fx, fy = px - x0, py - y0

    def tap(y, x):
        return img[y % h, x % w].astype(np.float64)

    return ((tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy)
            + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy
            ) / 255.0


def _np_trilinear(chain, uv, lod):
    lod = min(max(lod, 0.0), len(chain) - 1.0)
    l0 = math.floor(lod)
    l1 = min(l0 + 1, len(chain) - 1)
    f = lod - l0
    return _np_bilinear(chain[l0], uv) * (1 - f) \
        + _np_bilinear(chain[l1], uv) * f


@pytest.mark.parametrize("taps", [1, 16])
def test_mip_samplers_equal_numpy(taps):
    """The box-filtered chains and the trilinear and anisotropic samplers
    against a per-lane numpy statement, on a textured mip scene."""
    config = cut_config(registry.config("textures292k"))
    models = build_models(config, 4)
    tables = SceneTables(models, mipmaps=True)
    t = tables.to("cpu")
    rng = np.random.default_rng(taps)
    n = 64
    prim = torch.as_tensor(rng.integers(0, len(t["tex_size"]), n))
    uv = torch.as_tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32)
    lod = torch.as_tensor(rng.uniform(-1, 6, n), dtype=torch.float32)
    duv = torch.as_tensor(rng.uniform(-0.2, 0.2, (n, 2)), dtype=torch.float32)
    layer = 0
    got = (shade.sample_trilinear(t, prim, layer, uv, lod) if taps == 1
           else shade.sample_anisotropic(t, prim, layer, uv, lod, duv, taps))
    levels = t["mip_sizes"].shape[1]
    for i in range(n):
        p = int(prim[i])
        img = tables.tex_stack[p * 3 + layer][:tables.tex_size[p, 0],
                                              :tables.tex_size[p, 1]]
        chain = [img]
        for _ in range(levels - 1):
            chain.append(box_mip(chain[-1]))
        u = uv[i].double().numpy()
        if taps == 1:
            want = _np_trilinear(chain, u, float(lod[i]))
        else:
            want = sum(_np_trilinear(
                chain, u + duv[i].double().numpy() * ((k + 0.5) / taps - 0.5),
                float(lod[i])) for k in range(taps)) / taps
        assert np.abs(got[i].double().numpy() - want).max() <= 1e-5


def test_world_vertices_follow_transforms():
    config, models = _bench()
    t = SceneTables(models, mipmaps=False).to("cpu")
    pos, nrm, tan = world_vertices(t)
    tf = t["matrices"].clone()
    tf[:, :, 3] += torch.tensor([1.0, 2.0, 3.0])
    pos2, nrm2, tan2 = world_vertices(t, tf)
    assert torch.allclose(pos2 - pos, torch.tensor([1.0, 2.0, 3.0]).expand_as(
        pos), atol=1e-5)
    assert torch.equal(nrm, nrm2) and torch.equal(tan, tan2)


@pytest.mark.parametrize("workload", ["tiny.orbit", "tiny.rebuild",
                                      "tiny.aniso1", "tiny.aniso16"])
def test_port_frame_meets_oracle_bars(tiny, workload):
    """A 32 x 32 frame of the port on the CPU, from the measured window,
    against the reference: the oracle gate's 1% RMSE of the image and
    0.5% of hit pixels, and every limit of the cell."""
    root, bench = tiny
    cell = Cell(workload, 21, root=root, bench=bench, device="cpu")
    cell.setup()
    cell.window(0.2)
    ref = cell.reference()
    for j, out in cell.release():
        want = cell.reference_frame(ref, j)
        nums = correct.frame_numbers(out, want)
        assert nums["image_rmse"] <= 0.01
        assert nums["hit_mismatch"] <= 5e-3
        assert correct.verdict(nums, cell.limits)[0], nums


def _fault_numbers(tiny, workload, patch, planted=contextlib.nullcontext):
    """The numbers of the reference made by patch(cell), with the fault
    `planted` while it renders, against the sound reference."""
    root, bench = tiny
    cell = Cell(workload, 8, root=root, bench=bench, device="cpu")
    cell.setup()
    cell.window(0.2)
    frames = cell.release()
    ref = cell.reference()
    wants = [cell.reference_frame(ref, j) for j, _ in frames]
    with planted():
        bad = patch(cell)
        return [correct.frame_numbers(cell.reference_frame(bad, j), w)
                for (j, _), w in zip(frames, wants)], cell.limits


def test_dropped_shadow_light_fails(tiny):
    def patch(cell):
        lights = [dict(li) for li in cell.config["lights"]]
        lights[0]["casts_shadows"] = False
        cell.config = dict(cell.config, lights=lights)
        return cell.reference()

    nums, limits = _fault_numbers(tiny, "tiny.orbit", patch)
    assert not correct.verdict(correct.worst(nums), limits)[0]


def _planted_numbers(tiny, workload, name):
    sys.path.insert(0, str(RTBENCH))
    from control import planted

    return _fault_numbers(tiny, workload, lambda cell: cell.reference(),
                          lambda: planted(name))


def test_wrong_mip_level_moves_the_numbers(tiny):
    """A ray-cone LOD one level coarser (control.FAULTS["lod"]) fails the
    textures cell's limits."""
    nums, limits = _planted_numbers(tiny, "tiny.aniso16", "lod")
    assert not correct.verdict(correct.worst(nums), limits)[0]


@pytest.mark.parametrize("workload", ["tiny.orbit", "tiny.aniso16"])
def test_low_precision_gbuffer_moves_the_numbers(tiny, workload):
    """Depth through bfloat16 in place of R16F, color and normals with 3
    mantissa bits in place of 6 / 5 (control.FAULTS["gbuf"]) fail the
    cell's limits."""
    nums, limits = _planted_numbers(tiny, workload, "gbuf")
    assert not correct.verdict(correct.worst(nums), limits)[0]
