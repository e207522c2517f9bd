"""tpurt_torch host state and exact passes against tpurt.

The port's scene flatten, BVH8 collapse, GTAO constants, noise and LPM
control block must equal the reference's arrays exactly (same numpy code,
same C++ SAH builder). The storage quantizers are held bit-exact. Rays are
held to 2e-7 absolute: tpurt's XLA:CPU program folds the NDC division into
a reciprocal multiply and contracts parts of its small matrix products and
norm into FMAs, so its last bits depend on XLA's fusion, not on the math.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (SCENES, camera, resident_models,  # noqa: F401
                          same_host_builder)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Importing tpurt_torch and building a scene loads no JAX (a
    subprocess: the test session itself has JAX loaded)."""
    code = (
        "import sys\n"
        "from tpurt_torch.engine import Renderer, RendererConfig\n"
        "from tpurt_torch.app.bench_scene import build_bench_scene\n"
        "r = Renderer(RendererConfig(width=16, height=16, device='cpu'))\n"
        "build_bench_scene(r, field=dict(nx=1, nz=1, subdiv=1), cubes=1)\n"
        "assert r.stats()['tris'] > 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not [m for m in sys.modules if m.startswith('jax')]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_flatten_scene_equals_reference(name):
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.scene.scene import flatten_scene

    models = resident_models(name)
    ref = ref_flatten(models).as_pytree()
    got = flatten_scene(models).as_pytree()
    np.testing.assert_array_equal(got["bvh"]["nodes8"], ref["bvh"]["nodes8"])
    for k in ("v0", "e1", "e2", "tri_id"):
        np.testing.assert_array_equal(got["geom"][k], ref["geom"][k])
    np.testing.assert_array_equal(got["tri_attr"], ref["tri_attr"])
    np.testing.assert_array_equal(got["tex_quad48"], ref["tex_quad48"])
    np.testing.assert_array_equal(got["tex_size"], ref["tex_size"])


def test_bench_scene_same_for_both_packages():
    """build_bench_scene gives the same tables through either Renderer."""
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    field = dict(nx=2, nz=2, subdiv=1)
    ref = build_bench_scene(RefRenderer(RefConfig(width=32, height=32)),
                            field=field, cubes=3)
    got = build_bench_scene(Renderer(RendererConfig(width=32, height=32,
                                                    device="cpu")),
                            field=field, cubes=3)
    a, b = ref.scene.as_pytree(), got.scene.as_pytree()
    np.testing.assert_array_equal(b["bvh"]["nodes8"], a["bvh"]["nodes8"])
    np.testing.assert_array_equal(b["tri_attr"], a["tri_attr"])
    np.testing.assert_array_equal(b["tex_quad48"], a["tex_quad48"])
    assert got.stats()["rays_per_frame"] == ref.stats()["rays_per_frame"]
    assert got.stats()["tris"] == ref.stats()["tris"]


@pytest.mark.parametrize("shape", [(64, 64), (40, 48), (1080, 1920)])
def test_gtao_constants_and_noise_equal(shape):
    from tpurt.passes import gtao as ref
    from tpurt_torch.passes import gtao

    h, w = shape
    args = (w, h, 0.1, 1000.0, np.pi / 2, w / h)
    assert gtao.gtao_constants(*args) == ref.gtao_constants(*args)
    for idx in (0, 5, 63):
        want = np.stack([np.asarray(a) for a in ref.noise_maps_64(idx)])
        got = gtao.noise_maps_64(idx, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_lpm_setup_equal():
    from tpurt.passes import tonemap as ref
    from tpurt_torch.passes import tonemap

    for params in (ref.LpmParams(), ref.LpmParams(contrast=0.5, exposure=6.0,
                                                  shoulder=True)):
        mine = tonemap.LpmParams(**vars(params))
        ctl_r, der_r = ref.lpm_setup(params)
        ctl_p, der_p = tonemap.lpm_setup(mine)
        np.testing.assert_array_equal(ctl_p, ctl_r)
        assert der_p.keys() == der_r.keys()
        for k in der_r:
            np.testing.assert_array_equal(der_p[k], der_r[k])


def _floats(seed, n=4096):
    """Edge-heavy positive floats: zeros, denormals of f16, ranges over the
    small-float exponents, rounding ties, overflow past the f16 max."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([
        rng.uniform(0, 1, n), 10.0 ** rng.uniform(-9, 5, n),
        rng.uniform(-1, 0, 64), [0.0, 6.1e-5, 65504.0, 65520.0, 1e6,
                                 np.inf, 2.0 ** -14, 1.0 + 2.0 ** -7]])
    return vals.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_encodings_bit_exact(seed):
    from tpurt.passes import encodings as ref
    from tpurt_torch.passes import encodings

    x = _floats(seed)
    rgb = np.stack([x, x[::-1], np.roll(x, 7)], -1)
    got = encodings.quantize_r11g11b10f(torch.tensor(rgb)).numpy()
    want = np.asarray(ref.quantize_r11g11b10f(jnp.asarray(rgb)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    got = encodings.quantize_r16f(torch.tensor(x)).numpy()
    want = np.asarray(ref.quantize_r16f(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    unit = np.clip(x, -0.5, 1.5)
    np.testing.assert_array_equal(
        encodings.pack_unorm8(torch.tensor(unit)).numpy(),
        np.asarray(ref.pack_unorm8(jnp.asarray(unit))))


@pytest.mark.parametrize("shape", [(64, 64), (40, 48), (48, 40)])
def test_camera_rays_match(shape):
    from tpurt.passes.rays import camera_rays as ref_rays
    from tpurt_torch.engine import convert
    from tpurt_torch.passes.rays import camera_rays

    h, w = shape
    uni = camera(w, h).uniform()
    o_r, d_r = ref_rays({k: jnp.asarray(v) for k, v in uni.items()}, w, h)
    o_p, d_p = camera_rays(convert.camera_tensors(uni, "cpu"), w, h)
    np.testing.assert_array_equal(o_p.numpy(), np.asarray(o_r))
    assert d_p.shape == (h * w, 3)
    assert np.abs(d_p.numpy() - np.asarray(d_r)).max() <= 2e-7


def test_cuda_device_without_card_raises():
    """No CPU fallback: asking for CUDA without a card raises, and a
    wrapper given tensors on two devices raises."""
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(RendererConfig(width=8, height=8, device="cuda"))
    scene = dict(nodes8=torch.zeros((1, 128), device="meta"),
                 tris=torch.zeros((1, 12)), depth8=1)
    with pytest.raises(ValueError):
        trace_closest_bvh8(scene, torch.zeros((4, 3)), torch.ones((4, 3)),
                           0.001, 10.0)


def test_unported_gtao_options_raise():
    """tpurt's diagnostic precisions (wrong AO by design) stay unported and
    raise; bent normals, "half" and "fp16" are ported."""
    from tpurt_torch.passes.gtao import GtaoSettings

    with pytest.raises(NotImplementedError):
        GtaoSettings(precision="debug_nofetch")
    with pytest.raises(NotImplementedError):
        GtaoSettings(precision="debug_noconds")
    for kw in (dict(bent_normals=True), dict(precision="half"),
               dict(precision="fp16")):
        GtaoSettings(**kw)


def test_upload_refuses_a_bvh8_that_could_overflow_the_stack():
    """tpurt clamps its stack pointer silently; the port raises at upload
    when 7 * depth + 1 entries exceed the kernels' 192-entry stack."""
    from tpurt_torch.engine import convert

    def chain(depth):
        nodes8 = np.zeros((depth, 128), np.float32)
        nodes8[:, 48:56] = -1.0
        nodes8[:-1, 48] = np.arange(1, depth)
        nodes8[-1, 56], nodes8[-1, 64] = 0.0, 1.0
        geom = dict(v0=np.zeros((1, 3), np.float32),
                    e1=np.zeros((1, 3), np.float32),
                    e2=np.zeros((1, 3), np.float32),
                    tri_id=np.zeros(1, np.int32))
        return dict(bvh=dict(nodes8=nodes8), geom=geom,
                    tri_attr=np.zeros((1, 40), np.float32),
                    tex_quad48=np.zeros((1, 1, 1, 64), np.uint8))

    assert convert.scene_tensors(chain(27), "cpu")["depth8"] == 27
    with pytest.raises(ValueError, match="stack"):
        convert.scene_tensors(chain(28), "cpu")


def _bench_models(pkg):
    """The bench scene's models (3x3 field, ground, 3 cubes) built with one
    package's procedural module."""
    import importlib

    proc = importlib.import_module(f"{pkg}.scene.procedural")
    models = [proc.box_field(nx=3, nz=3, subdiv=2), proc.ground_plane()]
    for i in range(3):
        m = proc.material_field(nx=1, nz=1, subdiv=1, seed=i)
        m.set_model_matrix(np.array([[0.45, 0, 0, (i - 1) * 1.4],
                                     [0, 0.45, 0, -2.2],
                                     [0, 0, 0.45, 0.0]], np.float32))
        models.append(m)
    for m in models:
        m.update_model_status(np.array([0.0, -2.5, -9.5], np.float32))
    return models


def test_procedural_copies_equal_reference():
    """The port's copies of tpurt's host modules give tpurt's meshes,
    textures and matrices."""
    ref, got = _bench_models("tpurt"), _bench_models("tpurt_torch")
    assert [type(m).__module__ for m in got] == ["tpurt_torch.scene.model"] * 5
    for a, b in zip(ref, got):
        assert a.is_device_resident() == b.is_device_resident()
        np.testing.assert_array_equal(b.model_matrix, a.model_matrix)
        for pa, pb in zip(a.primitives(), b.primitives()):
            for k in ("positions", "normals", "tex_coords", "tangents",
                      "indices"):
                np.testing.assert_array_equal(pb[k], pa[k], err_msg=k)
            assert sorted(map(int, pb["textures"])) == sorted(
                map(int, pa["textures"]))
            for t in pa["textures"]:
                np.testing.assert_array_equal(
                    pb["textures"][t].as_array(), pa["textures"][t].as_array())


def test_camera_and_light_copies_equal_reference():
    from tpurt.scene import camera as ref_camera
    from tpurt.scene import lights as ref_lights
    from tpurt_torch.scene import camera, lights

    def populate(mod):
        ls = mod.Lights()
        ls.directional_lights.append(mod.DirectionalLight(
            dir=np.array([0.35, 0.85, 0.4]) / np.linalg.norm([0.35, 0.85,
                                                              0.4]),
            color=[1.4, 1.3, 1.1], casts_shadows=True))
        ls.spot_lights.append(mod.SpotLight(
            pos=[0.0, -4.0, 0.0], dir=[0.0, 1.0, 0.0], color=[13.6, 1.6, 22],
            falloff_distance=12.0, penumbra_umbra_angles=(0.5, 0.8),
            casts_shadows=True))
        ls.point_lights.append(mod.PointLight(
            pos=[0.0, -3.0, 0.0], color=[6.0, 5.0, 4.0],
            falloff_distance=15.0, casts_shadows=False))
        ls.area_lights.append(mod.AreaLight(
            pos=[-2.0, -3.0, 0.2], pos2=[-2.0, -3.0, -0.8],
            pos3=[-2.0, -2.2, -0.8], invert_normal=False,
            color=[5.9, 0.2, 1.2], falloff_distance=12.0,
            penumbra_umbra_angles=(1.57, 1.571), casts_shadows=True))
        return ls.shader_arrays()

    want, got = populate(ref_lights), populate(lights)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for aspect in (1.0, 1920 / 1080):
        cams = [mod.Camera(aspect=aspect) for mod in (ref_camera, camera)]
        for c in cams:
            c.set_pos([0.0, -2.5, -9.5])
            c.set_dir(np.array([0.0, 0.3, 1.0]) / np.linalg.norm([0, 0.3, 1]))
        want, got = cams[0].uniform(), cams[1].uniform()
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sah_tree_copy_equals_reference():
    """The port's C++ SAH builder (csrc/host, its own g++ build) gives
    tpurt's tree arrays on the cut bench scene, and its numpy fallback
    gives tpurt's numpy fallback's. (The two builders partition in other
    orders, std::partition against a stable concatenation, so their trees
    differ from each other in both packages.)"""
    from tpurt.bvh import build_bvh_sah as ref_build
    from tpurt.bvh.builder import _build_numpy as ref_build_numpy
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.bvh import build_bvh_sah
    from tpurt_torch.bvh.builder import _build_numpy
    from tpurt_torch.bvh.flat import tri_aabbs

    flat = ref_flatten(_bench_models("tpurt"))
    v0 = np.asarray(flat.geom["v0"])[np.argsort(flat.geom["tri_id"])]
    e1 = np.asarray(flat.geom["e1"])[np.argsort(flat.geom["tri_id"])]
    e2 = np.asarray(flat.geom["e2"])[np.argsort(flat.geom["tri_id"])]
    amin, amax = tri_aabbs(v0, v0 + e1, v0 + e2)
    ref = ref_build(amin, amax, max_leaf_size=4).as_pytree()
    got = build_bvh_sah(amin, amax, max_leaf_size=4)
    assert got.builder in ("c++", "numpy")
    for k, v in ref.items():
        np.testing.assert_array_equal(got.as_pytree()[k], np.asarray(v),
                                      err_msg=k)
    fallback = _build_numpy(amin, amax, 4)
    assert fallback.builder == "numpy"
    for k, v in ref_build_numpy(amin, amax, 4).as_pytree().items():
        np.testing.assert_array_equal(fallback.as_pytree()[k], np.asarray(v),
                                      err_msg=k)
