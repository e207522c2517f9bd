"""The system under test, driven through its public API only: the
``Renderer`` with its ``RendererConfig`` and ``GtaoSettings``, models from
``Model.from_arrays``, the light classes, and ``kernels.build.
launch_counts`` to report which kernels a frame launched. Nothing here
reads the program's internals, and no result of the program reaches the
reference."""
from __future__ import annotations

import numpy as np


def _image(arr: np.ndarray):
    from tpurt_torch.scene.gltf import ImageData

    h, w = arr.shape[:2]
    return ImageData(pixels=np.ascontiguousarray(arr).reshape(-1).copy(),
                     width=w, height=h, format="R8G8B8A8_UNORM")


def _model(prims, matrix):
    from tpurt_torch.scene.mesh import TextureType
    from tpurt_torch.scene.model import Model

    layer = dict(albedo=TextureType.ALBEDO, orm=TextureType.ORM,
                 normal=TextureType.NORMAL)
    port = [dict(positions=p["positions"], normals=p["normals"],
                 tex_coords=p["tex_coords"], tangents=None,
                 indices=p["indices"],
                 textures={layer[k]: _image(v)
                           for k, v in p["textures"].items()})
            for p in prims]
    return Model.from_arrays(port, matrix)


def _light(spec: dict):
    from tpurt_torch.scene import lights as L

    kind = spec["type"]
    shadows = bool(spec["casts_shadows"])
    if kind == "directional":
        d = np.asarray(spec["dir"], np.float64)
        return "directional_lights", L.DirectionalLight(
            dir=d / np.linalg.norm(d), color=spec["color"],
            casts_shadows=shadows)
    angles = (np.radians(spec["penumbra_deg"]), np.radians(spec["umbra_deg"]))
    if kind == "spot":
        return "spot_lights", L.SpotLight(
            pos=spec["pos"], dir=spec["dir"], color=spec["color"],
            falloff_distance=spec["falloff"], penumbra_umbra_angles=angles,
            casts_shadows=shadows)
    if kind == "area":
        return "area_lights", L.AreaLight(
            pos=spec["pos"], pos2=spec["pos2"], pos3=spec["pos3"],
            invert_normal=bool(spec.get("invert_normal", False)),
            color=spec["color"], falloff_distance=spec["falloff"],
            penumbra_umbra_angles=angles, casts_shadows=shadows)
    raise ValueError(f"unknown light type {kind!r}")


def build_renderer(config: dict, traffic: dict, models, pose, device: str):
    """A prepared Renderer of the cell's scene with the camera at `pose`."""
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.passes.gtao import GtaoSettings

    rc = config["renderer"]
    r = Renderer(RendererConfig(
        width=int(traffic["width"]), height=int(traffic["height"]),
        gtao=GtaoSettings(**rc["gtao"]), mipmaps=bool(rc["mipmaps"]),
        aniso_taps=int(traffic["aniso_taps"]), device=device))
    for prims, matrix in models:
        r.models.append(_model(prims, matrix))
    for spec in config["lights"]:
        group, light = _light(spec)
        getattr(r.lights_mut(), group).append(light)
    set_pose(r, pose)
    r.prepare_first_frame()
    return r


def set_pose(r, pose):
    pos, direction = pose
    r.camera_mut().set_pos(pos)
    r.camera_mut().set_dir(direction)


def out_of_reach(r, poses) -> list:
    """(pose index, model index, distance) of every model farther than the
    residency distance from a camera position in `poses`."""
    from tpurt_torch.scene.model import DEVICE_DISTANCE

    far = []
    for i, (pos, _) in enumerate(poses):
        for m, model in enumerate(r.models):
            dist = model.transformed_sphere().distance_from_point(pos)
            if dist > DEVICE_DISTANCE:
                far.append((i, m, dist))
    return far


def rest_transforms(r) -> np.ndarray:
    """The resident models' 3x4 matrices, one per instance."""
    return np.stack([m.model_matrix for m in r.models
                     if m.is_device_resident()]).astype(np.float32)


def launch_counts() -> dict:
    from tpurt_torch.kernels.build import launch_counts as counts

    return dict(counts)
