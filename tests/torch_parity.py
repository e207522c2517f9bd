"""Shared inputs for the tpurt_torch parity tests (tests/test_torch_*.py).

Small procedural scenes, one camera, and the hit-difference classifier: a
ray whose BVH8 result differs between tpurt's packet kernel and the port's
per-ray traversal must be a *tie* (both triangles at the same t within
2 ULP) or *grazing* (the ray's own slab test rejects a box on the path to
the triangle that only the packet found: a packet enters a box when any of
its lanes hits it, and tpurt runs Moller-Trumbore there without a per-lane
box mask).
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

from tpurt.scene.camera import Camera
from tpurt.scene.procedural import box_field, ground_plane, material_field

CAM_POS = np.array([0.3, -1.6, -3.0], np.float32)
CAM_DIR = np.array([-0.05, 0.4, 1.0])

# scene name -> model factory. "tiny" has 12 triangles (one BVH8 leaf
# slot, fewer than LEAF8_MAX); "ground" adds the 40x40 ground plane.
SCENES = {
    "box_field": lambda: [box_field(nx=3, nz=3, subdiv=2)],
    "material_field": lambda: [material_field(nx=2, nz=2, subdiv=2)],
    "tiny": lambda: [box_field(nx=1, nz=1, subdiv=1)],
    "ground": lambda: [box_field(nx=2, nz=2, subdiv=2), ground_plane()],
}


@pytest.fixture(scope="module", autouse=True)
def same_host_builder():
    """Hold both packages to the same host SAH builder in this process.

    tpurt builds its C++ library in place (tpurt/native/build.py), so test
    workers that build it at the same moment can load a half-written file,
    and tpurt then builds its trees with numpy for the rest of the process.
    The port builds its own copy atomically and would keep C++; the two
    builders give different trees (ROADMAP F10). A module whose tests
    compare trees that each package builds imports this fixture."""
    from tpurt.native import get_lib as ref_lib
    from tpurt_torch.native import build

    if ref_lib() is None:
        with build._LOCK:
            build._LIB, build._TRIED = None, True
    yield


def resident_models(name):
    models = SCENES[name]()
    for m in models:
        m.update_model_status(CAM_POS)
        assert m.is_device_resident()
    return models


def camera(width, height) -> Camera:
    cam = Camera(aspect=width / height)
    cam.set_pos(CAM_POS)
    cam.set_dir(CAM_DIR / np.linalg.norm(CAM_DIR))
    return cam


def slab_np(box, o, d, t_min, t_max):
    """tpurt's _Rays.slab on one box for rays (N, 3), numpy f32."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / d
        t0 = (box[None, 0:3] - o) * inv
        t1 = (box[None, 3:6] - o) * inv
    tnear = np.maximum(np.maximum(np.minimum(t0[:, 0], t1[:, 0]),
                                  np.minimum(t0[:, 1], t1[:, 1])),
                       np.maximum(np.minimum(t0[:, 2], t1[:, 2]),
                                  np.float32(t_min)))
    tfar = np.minimum(np.minimum(np.maximum(t0[:, 0], t1[:, 0]),
                                 np.maximum(t0[:, 1], t1[:, 1])),
                      np.minimum(np.maximum(t0[:, 2], t1[:, 2]), t_max))
    return tnear <= tfar


def moller_trumbore_np(tris, o, d, t_min, t_max):
    """(T,) hit mask and t of one ray against triangle rows (T, 9)."""
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    p = np.stack([d[1] * e2[:, 2] - d[2] * e2[:, 1],
                  d[2] * e2[:, 0] - d[0] * e2[:, 2],
                  d[0] * e2[:, 1] - d[1] * e2[:, 0]], 1)
    det = e1[:, 0] * p[:, 0] + e1[:, 1] * p[:, 1] + e1[:, 2] * p[:, 2]
    valid = np.abs(det) > np.float32(1e-12)
    inv_det = np.float32(1.0) / np.where(valid, det, np.float32(1.0))
    tv = o[None] - v0
    u = (tv[:, 0] * p[:, 0] + tv[:, 1] * p[:, 1] + tv[:, 2] * p[:, 2]) \
        * inv_det
    q = np.stack([tv[:, 1] * e1[:, 2] - tv[:, 2] * e1[:, 1],
                  tv[:, 2] * e1[:, 0] - tv[:, 0] * e1[:, 2],
                  tv[:, 0] * e1[:, 1] - tv[:, 1] * e1[:, 0]], 1)
    v = (d[0] * q[:, 0] + d[1] * q[:, 1] + d[2] * q[:, 2]) * inv_det
    t = (e2[:, 0] * q[:, 0] + e2[:, 1] * q[:, 1] + e2[:, 2] * q[:, 2]) \
        * inv_det
    hit = (valid & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
           & (t < t_max))
    return hit, t


class HitClassifier:
    """Locates each triangle's BVH8 leaf slot and the boxes above it."""

    def __init__(self, nodes8: np.ndarray, geom: dict):
        self.nodes8 = np.asarray(nodes8, np.float32)
        self.geom = {k: np.asarray(v) for k, v in geom.items()}
        self.pos_of_id = np.argsort(self.geom["tri_id"])
        self.parent = {}
        for r, row in enumerate(self.nodes8):
            for k in range(8):
                if row[48 + k] >= 0:
                    self.parent[int(row[48 + k])] = (r, k)

    def path_boxes(self, tri_id):
        """Boxes (6,) from the leaf slot holding `tri_id` up to the root."""
        pos = self.pos_of_id[tri_id]
        first, count = self.nodes8[:, 56:64], self.nodes8[:, 64:72]
        rows, slots = np.nonzero((count > 0) & (first <= pos)
                                 & (pos < first + count))
        r, k = int(rows[0]), int(slots[0])
        boxes = []
        while True:
            boxes.append(self.nodes8[r, 6 * k:6 * k + 6])
            if r not in self.parent:
                return boxes
            r, k = self.parent[r]

    def grazing(self, tri_id, o, d, t_min, t_max) -> bool:
        """The ray's own slab test rejects a box above `tri_id`."""
        return any(not slab_np(b, o[None], d[None], t_min,
                               np.float32(t_max))[0]
                   for b in self.path_boxes(tri_id))

    def tris9(self):
        g = self.geom
        return np.concatenate([g["v0"], g["e1"], g["e2"]], 1).astype(
            np.float32)


def ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def classify_closest(cls: HitClassifier, ref: dict, got: dict, o, d,
                     t_min, t_max):
    """Counts of differing closest hits by kind; 'other' must stay 0."""
    kinds = {"tie": 0, "grazing": 0, "other": 0}
    for i in np.nonzero(ref["tri"] != got["tri"])[0]:
        tr, tg = int(ref["tri"][i]), int(got["tri"][i])
        if tr >= 0 and tg >= 0 and ulp_diff(ref["t"][i], got["t"][i]) <= 2:
            kinds["tie"] += 1
        elif tr >= 0 and (tg < 0 or ref["t"][i] < got["t"][i]) \
                and cls.grazing(tr, o[i], d[i], t_min, t_max):
            kinds["grazing"] += 1
        else:
            kinds["other"] += 1
    return kinds


def classify_occlusion(cls: HitClassifier, ref, got, o, d, t_min, t_max):
    """Counts of differing occlusion lanes by kind; 'other' must stay 0.
    A lane only the packet kernel finds occluded is grazing when every
    triangle that occludes it sits below a box the ray's slab test
    rejects."""
    kinds = {"grazing": 0, "other": 0}
    tris = cls.tris9()
    for i in np.nonzero(ref != got)[0]:
        if not ref[i]:
            kinds["other"] += 1
            continue
        hit, _ = moller_trumbore_np(tris, o[i], d[i], np.float32(t_min),
                                    np.float32(t_max[i]))
        ids = cls.geom["tri_id"][np.nonzero(hit)[0]]
        if len(ids) and all(cls.grazing(int(t), o[i], d[i], t_min, t_max[i])
                            for t in ids):
            kinds["grazing"] += 1
        else:
            kinds["other"] += 1
    return kinds


@contextlib.contextmanager
def recording_ref_multi():
    """Record the shadow rays and the occlusion of every call of tpurt's
    fused ``trace_any_bvh8_multi`` (its shade pass imports it at call
    time) into the yielded list, one dict (o, d, t_min, tm, occ) each."""
    from tpurt.kernels import traverse_bvh8 as tb

    calls = []
    ref_multi = tb.trace_any_bvh8_multi

    def recorded(bvh, geom, origin, dirs, t_min, t_maxs, **kw):
        occ = ref_multi(bvh, geom, origin, dirs, t_min, t_maxs, **kw)
        calls.append(dict(o=np.asarray(origin), t_min=t_min,
                          d=np.stack([np.asarray(x) for x in dirs]),
                          tm=np.stack([np.asarray(x) for x in t_maxs]),
                          occ=np.asarray(occ)))
        return occ

    tb.trace_any_bvh8_multi = recorded
    try:
        yield calls
    finally:
        tb.trace_any_bvh8_multi = ref_multi


def fused_grazing_lanes(cls: HitClassifier, rays: dict, port_scene):
    """Lanes where tpurt's fused occlusion (`rays`, recorded above) differs
    from the port's on the same rays; asserts that each is grazing.

    tpurt's fused kernel pushes a child when any lane of any set hits it,
    with no per-set box mask, so on a grazing lane it can find an occluder
    that its own per-light trace does not reach; the port's fused trace
    equals its per-light trace."""
    import torch

    from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8_multi

    got = trace_any_bvh8_multi(port_scene, torch.tensor(rays["o"]),
                               torch.tensor(rays["d"]), rays["t_min"],
                               torch.tensor(rays["tm"])).numpy()
    for s in range(len(got)):
        kinds = classify_occlusion(cls, rays["occ"][s], got[s], rays["o"],
                                   rays["d"][s], rays["t_min"],
                                   rays["tm"][s])
        assert kinds["other"] == 0, (s, kinds)
    return (got != rays["occ"]).any(0)
