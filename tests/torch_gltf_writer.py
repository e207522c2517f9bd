"""A glTF writer for the app's tests and ``chip_smoke.py``: the bench
scene's geometry (``tpurt_torch.app.bench_scene``: the box field, the
ground plane and the textured cubes) as one ``.gltf`` file with data-URI
buffers and PNG textures, which ``--model`` of both packages' CLIs loads.

The bench scene is Y-down (its camera's up is -y); the app's
``default_scene`` (the reference's main.rs lights, set for a Y-up glTF)
puts its spot light above the origin pointing down -y. The writer mirrors
y (and so flips each triangle's winding) to make the file Y-up, and halves
it, so that ``default_scene``'s 2x scale restores the bench's size: the
spot light then shines down onto the field's ground between the boxes.
"""
from __future__ import annotations

import base64
import io
import json

import numpy as np

# glTF material slots of the reader's texture types
_SLOTS = {"ALBEDO": ("pbr", "baseColorTexture"),
          "ORM": ("pbr", "metallicRoughnessTexture"),
          "NORMAL": ("mat", "normalTexture"),
          "EMISSIVE": ("mat", "emissiveTexture")}


class _SceneSink:
    """Just enough of a renderer for ``build_bench_scene``."""

    def __init__(self):
        from tpurt_torch.scene.camera import Camera
        from tpurt_torch.scene.lights import Lights

        self.models = []
        self.camera = Camera()
        self.lights = Lights()

    def camera_mut(self):
        return self.camera

    def lights_mut(self):
        return self.lights

    def prepare_first_frame(self):
        pass


def bench_primitives(field=None, cubes: int = 8):
    """The bench scene's primitives in world space (model matrices applied),
    mirrored to Y-up and halved: dicts of positions, normals, tex_coords,
    indices (u32, winding flipped) and textures {type name: (H, W, 4) u8}."""
    from tpurt_torch.app.bench_scene import build_bench_scene

    models = build_bench_scene(_SceneSink(), field=field, cubes=cubes).models
    flip = np.diag([0.5, -0.5, 0.5]).astype(np.float32)
    out = []
    for m in models:
        lin, off = m.model_matrix[:, :3], m.model_matrix[:, 3]
        for p in m._primitives:
            pos = (p["positions"] @ lin.T + off) @ flip.T
            nrm = p["normals"] @ lin.T * np.float32([1, -1, 1])
            idx = np.asarray(p["indices"], np.uint32).reshape(-1, 3)[:, ::-1]
            tex = {t.name: np.asarray(img.pixels, np.uint8).reshape(
                img.height, img.width, 4) for t, img in p["textures"].items()}
            out.append(dict(positions=pos.astype(np.float32),
                            normals=nrm.astype(np.float32),
                            tex_coords=np.asarray(p["tex_coords"], np.float32),
                            indices=np.ascontiguousarray(idx), textures=tex))
    return out


def _png(rgba: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def write_gltf(path, primitives) -> int:
    """One mesh in one data-URI buffer (the reference reader's strict
    layout), a material per textured primitive; returns the triangles."""
    blob = bytearray()
    views, accessors, images, textures, materials, prims = ([] for _ in
                                                            range(6))

    def add(arr, kind, comp, with_bounds=False):
        while len(blob) % 4:
            blob.append(0)
        views.append(dict(buffer=0, byteOffset=len(blob),
                          byteLength=arr.nbytes))
        blob.extend(arr.tobytes())
        acc = dict(bufferView=len(views) - 1, componentType=comp,
                   count=int(arr.shape[0]) if kind != "SCALAR"
                   else int(arr.size), type=kind)
        if with_bounds:
            acc.update(min=arr.min(0).tolist(), max=arr.max(0).tolist())
        accessors.append(acc)
        return len(accessors) - 1

    tris = 0
    for p in primitives:
        attrs = dict(POSITION=add(p["positions"], "VEC3", 5126, True),
                     NORMAL=add(p["normals"], "VEC3", 5126),
                     TEXCOORD_0=add(p["tex_coords"], "VEC2", 5126))
        prim = dict(attributes=attrs,
                    indices=add(p["indices"].reshape(-1), "SCALAR", 5125))
        tris += p["indices"].shape[0]
        if p["textures"]:
            mat = dict(pbrMetallicRoughness={})
            for name, rgba in p["textures"].items():
                images.append(dict(uri="data:image/png;base64,"
                                   + base64.b64encode(_png(rgba)).decode()))
                textures.append(dict(source=len(images) - 1))
                where, slot = _SLOTS[name]
                (mat["pbrMetallicRoughness"] if where == "pbr" else mat)[
                    slot] = dict(index=len(textures) - 1)
            materials.append(mat)
            prim["material"] = len(materials) - 1
        prims.append(prim)
    doc = dict(asset=dict(version="2.0"),
               buffers=[dict(uri="data:application/octet-stream;base64,"
                             + base64.b64encode(bytes(blob)).decode(),
                             byteLength=len(blob))],
               bufferViews=views, accessors=accessors,
               meshes=[dict(primitives=prims)], images=images,
               textures=textures, materials=materials,
               nodes=[dict(mesh=0)], scenes=[dict(nodes=[0])], scene=0)
    with open(path, "w") as f:
        json.dump(doc, f)
    return tris


def write_bench_gltf(path, field=None, cubes: int = 8) -> int:
    """The bench scene (cut by `field` and `cubes`, as build_bench_scene
    takes them) written to `path`; returns its triangle count."""
    return write_gltf(path, bench_primitives(field=field, cubes=cubes))


# a camera of the written scene that sees the spot light's pool and the
# area light's boxes (tpurt's CLI flags --cam-pos / --cam-dir)
CAM_POS = (0.5, 1.4, -2.4)
CAM_DIR = (0.0, -0.3, 1.0)
