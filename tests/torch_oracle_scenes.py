"""The oracle gate's scenes (tests/test_torch_oracle*.py), built alike for
tpurt and for the port: tpurt's BASELINE configs 1-4 analogues
(tests/test_oracle_rmse.py, tests/test_oracle_full_pipeline.py) with each
BoxTextured cube, which is not shipped (ROADMAP F1), replaced by a
procedural textured cube (``material_field(1, 1, 1, seed)``) mapped onto
the same unit cube [-0.5, 0.5]^3 under the same model matrix, and the
same cameras and lights. Config 2 is tpurt's own procedural scene.

``build(pkg, config)`` returns a prepared Renderer of package `pkg`
("tpurt" or "tpurt_torch"; the port's on the CPU) at SIZE x SIZE. tpurt's
``FlatScene.as_full_pytree()`` feeds the oracle; the port renders.
"""
from __future__ import annotations

import importlib
import math

import numpy as np

SIZE = 128
EYE = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], np.float32)
# vk_xe_gtao.rs quality tiers (slices, steps)
TIERS = {"low": (1, 2), "ultra": (9, 3)}


def _mods(pkg):
    return {name: importlib.import_module(f"{pkg}.{name}") for name in
            ("engine", "scene.procedural", "scene.lights", "passes.gtao")}


def unit_cube(pkg, m3x4, seed):
    """A textured cube on [-0.5, 0.5]^3 under the 3x4 model matrix m3x4,
    as BoxTextured stands under it: material_field's cube of seed `seed`
    (centered at (0, -0.45 h, 0), half extents 0.45 (1, h, 1), h drawn as
    material_field draws it) rescaled and moved onto the unit cube."""
    proc = _mods(pkg)["scene.procedural"]
    h = 0.5 + np.random.default_rng(seed).uniform(0.0, 1.5)
    lin = np.diag([1 / 0.9, 1 / (0.9 * h), 1 / 0.9])
    shift = np.array([0.0, 0.5, 0.0])
    m = np.asarray(m3x4, np.float64)
    out = np.concatenate([m[:, :3] @ lin, (m[:, :3] @ shift
                                            + m[:, 3])[:, None]], axis=1)
    model = proc.material_field(nx=1, nz=1, subdiv=1, seed=seed)
    model.set_model_matrix(out.astype(np.float32))
    return model


def _renderer(pkg, config: int):
    m = _mods(pkg)
    kw = dict(device="cpu") if pkg == "tpurt_torch" else {}
    if config == 4:
        cfg = m["engine"].RendererConfig(width=SIZE, height=SIZE, **kw)
    else:
        cfg = m["engine"].RendererConfig(
            width=SIZE, height=SIZE,
            gtao=m["passes.gtao"].GtaoSettings(1, 2, denoise=0),
            enable_gtao=False, enable_tonemap=False, **kw)
    return m["engine"].Renderer(cfg)


def _look(r, pos, d):
    d = np.asarray(d, np.float64)
    r.camera_mut().set_pos(pos)
    r.camera_mut().set_dir(d / np.linalg.norm(d))


def build(pkg: str, config: int):
    m = _mods(pkg)
    L = m["scene.lights"]
    proc = m["scene.procedural"]
    r = _renderer(pkg, config)
    lights = r.lights_mut()
    if config == 1:
        # one cube and a small occluder between it and a point light
        r.models.append(unit_cube(pkg, EYE, 0))
        r.models.append(unit_cube(pkg, np.array(
            [[0.2, 0, 0, 0.3], [0, 0.2, 0, -0.4], [0, 0, 0.2, -1.2]]), 1))
        _look(r, [0.0, -0.5, -1.6], [0.0, 0.2, 0.98])
        lights.point_lights.append(L.PointLight(
            pos=[0.5, -1.5, -2.5], color=[4.0, 4.0, 4.0],
            falloff_distance=12.0, casts_shadows=True))
    elif config == 2:
        r.models.append(proc.box_field(nx=3, nz=3, subdiv=2))
        r.models.append(proc.ground_plane())
        _look(r, [0.0, -2.0, -5.0], [0.0, 0.35, 1.0])
        sun = np.array([0.3, 0.9, 0.3])
        lights.directional_lights.append(L.DirectionalLight(
            dir=sun / np.linalg.norm(sun), color=[1.2, 1.1, 1.0],
            casts_shadows=True))
        lights.point_lights.append(L.PointLight(
            pos=[0.0, -3.0, 0.0], color=[6.0, 5.0, 4.0],
            falloff_distance=15.0, casts_shadows=True))
        lights.spot_lights.append(L.SpotLight(
            pos=[2.0, -4.0, -2.0], dir=[-0.3, 0.9, 0.3],
            color=[10.0, 2.0, 12.0], falloff_distance=14.0,
            penumbra_umbra_angles=(math.radians(25), math.radians(40)),
            casts_shadows=True))
    elif config == 3:
        # an area light tilted off-axis (an axis-aligned one makes N.L 0
        # on cube faces, where the reference's Burley term is singular)
        r.models.append(unit_cube(pkg, EYE, 2))
        r.models.append(unit_cube(pkg, np.array(
            [[0.5, 0, 0, 1.6], [0, 0.5, 0, 0.0], [0, 0, 0.5, 0.0]]), 3))
        _look(r, [0.7, -0.75, -1.2], [0.1, 0.75, 1.2])
        lights.area_lights.append(L.AreaLight(
            pos=[1.4, -2.0, -1.6], pos2=[0.2, -2.1, -1.7],
            pos3=[0.1, -1.3, -1.9], invert_normal=False,
            color=[8.0, 6.5, 5.0], falloff_distance=10.0,
            penumbra_umbra_angles=(math.radians(80), math.radians(89)),
            casts_shadows=True))
        lights.spot_lights.append(L.SpotLight(
            pos=[0.0, -3.0, -2.0], dir=np.array([0.0, 0.8, 0.6]),
            color=[6.0, 6.0, 6.0], falloff_distance=10.0,
            penumbra_umbra_angles=(math.radians(30), math.radians(50)),
            casts_shadows=True))
    elif config == 4:
        # two cubes over a wide flat floor cube: contact-AO creases, lit
        # and shadowed regions
        r.models.append(unit_cube(pkg, EYE, 4))
        r.models.append(unit_cube(pkg, np.array(
            [[0.35, 0, 0, 0.75], [0, 0.35, 0, 0.3], [0, 0, 0.35, -0.3]]), 5))
        r.models.append(unit_cube(pkg, np.array(
            [[4.0, 0, 0, 0], [0, 0.1, 0, 0.62], [0, 0, 4.0, 0]]), 6))
        _look(r, [0.4, -0.9, -2.1], [-0.1, 0.4, 1.0])
        lights.point_lights.append(L.PointLight(
            pos=[0.8, -2.0, -2.0], color=[5.0, 4.8, 4.5],
            falloff_distance=14.0, casts_shadows=True))
        sun = np.array([0.3, 0.85, 0.42])
        lights.directional_lights.append(L.DirectionalLight(
            dir=sun / np.linalg.norm(sun), color=[0.8, 0.8, 0.75],
            casts_shadows=True))
    r.prepare_first_frame()
    return r


def oracle_gbuffer(ref_r):
    """The oracle's unquantized G-buffer of tpurt's renderer `ref_r`, from
    its tables (tests/oracle.py; no tpurt rendering code)."""
    from oracle import oracle_render

    full = ref_r.scene.as_full_pytree()
    return oracle_render(
        {k: np.asarray(v) for k, v in full.items()
         if k not in ("bvh", "geom")},
        {k: np.asarray(v) for k, v in ref_r.camera.uniform().items()},
        ref_r.lights.shader_arrays(), SIZE, SIZE)
