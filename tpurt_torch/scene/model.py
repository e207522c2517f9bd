"""Model residency state machine (LOD streaming).

Reference: vk_model.rs — a type-state machine Storage/Host/Device
(vk_model.rs:23-229) driven by camera distance to the model's bounding
sphere: <= 10 on device, <= 20 staged on host, else evicted to disk
(update_model_status, vk_model.rs:334-345).

On TPU "device residency" means: the model's triangles participate in the
flattened scene tables uploaded to HBM (scene.py rebuilds them when the
resident set changes — the analogue of re-recording upload commands +
rebuilding the BLAS). "Host" keeps decoded numpy arrays in RAM; "storage"
drops them.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from .gltf import GltfModelReader
from .mesh import Sphere


class Residency(enum.Enum):
    STORAGE = 0
    HOST = 1
    DEVICE = 2


DEVICE_DISTANCE = 10.0
HOST_DISTANCE = 20.0


class Model:
    def __init__(self, file_path, model_matrix_3x4, blas_builder=None,
                 visible: bool = True):
        self.file_path = str(file_path)
        self.model_matrix = np.asarray(model_matrix_3x4, np.float32).reshape(3, 4)
        # Ray-traced primitive exclusion: an invisible model is left out of
        # the world BVH entirely, like an instance omitted from the TLAS
        # (the reference excludes models via residency, renderer.rs:641-650;
        # this flag gives the same control explicitly).
        self.visible = bool(visible)
        self.dirty = True  # scene tables need (re)building
        self.state = Residency.STORAGE
        self._primitives = None
        self._sphere: Optional[Sphere] = None
        self._blas = None
        self._blas_builder = blas_builder
        # First touch loads to host to learn the bounding sphere, exactly like
        # the reference's Storage::to_host on construction (vk_model.rs:36-42).
        self._to_host()

    @classmethod
    def from_arrays(cls, primitives, model_matrix_3x4, visible: bool = True):
        """In-memory model (procedural geometry / tests): `primitives` is a
        list of dicts shaped like GltfModelReader.primitive_arrays() output."""
        from .mesh import ritter_bounding_sphere

        self = cls.__new__(cls)
        self.file_path = "<arrays>"
        self.model_matrix = np.asarray(model_matrix_3x4, np.float32).reshape(3, 4)
        self.visible = bool(visible)
        self.dirty = True
        self.state = Residency.HOST
        self._blas = None
        self._blas_builder = None
        for p in primitives:
            p.setdefault("tex_coords", None)
            p.setdefault("normals", None)
            p.setdefault("tangents", None)
            p.setdefault("textures", {})
        self._primitives = primitives
        self._sphere = ritter_bounding_sphere(
            [p["positions"] for p in primitives])
        self._from_arrays = True
        return self

    # -- state transitions ---------------------------------------------------

    def _to_host(self):
        if self._primitives is None:
            reader = GltfModelReader.open(
                self.file_path, normalize_vectors=True,
                coerce_image_to_format="R8G8B8A8_UNORM")
            self._primitives = reader.primitive_arrays()
            self._sphere = reader.get_primitives_bounding_sphere()
        self.state = Residency.HOST

    def _to_storage(self):
        if not getattr(self, "_from_arrays", False):
            self._primitives = None  # in-memory models cannot be reloaded
        self._blas = None
        self.state = Residency.STORAGE

    def _to_device(self):
        if self._primitives is None:
            self._to_host()
        if self._blas is None and self._blas_builder is not None:
            self._blas = self._blas_builder(self)
        self.state = Residency.DEVICE

    def update_model_status(self, camera_pos) -> bool:
        """Distance-driven residency policy (vk_model.rs:334-345).
        Returns True if the resident set changed (scene tables need rebuild)."""
        dist = self.transformed_sphere().distance_from_point(camera_pos)
        old = self.state
        if dist <= DEVICE_DISTANCE:
            self._to_device()
        elif dist <= HOST_DISTANCE:
            self._to_host()
        else:
            self._to_storage()
        return (old == Residency.DEVICE) != (self.state == Residency.DEVICE)

    # -- accessors ------------------------------------------------------------

    def transformed_sphere(self) -> Sphere:
        return self._sphere.transform(self.model_matrix)

    def is_device_resident(self) -> bool:
        return self.state == Residency.DEVICE and self.visible

    def set_visible(self, visible: bool):
        changed = self.visible != bool(visible)
        self.visible = bool(visible)
        self.dirty = self.dirty or changed
        return changed

    def set_model_matrix(self, model_matrix_3x4):
        self.model_matrix = np.asarray(model_matrix_3x4,
                                       np.float32).reshape(3, 4)
        self.dirty = True

    def primitives(self):
        assert self._primitives is not None, "model not host-resident"
        return self._primitives

    @property
    def blas(self):
        return self._blas

    def get_device_primitives_count(self) -> int:
        """Per-model primitive count used for the running custom index
        (renderer.rs:641-650, vk_model.rs:365-384)."""
        return len(self._primitives) if self.is_device_resident() else 0
