"""Mesh attribute metadata and bounding volumes.

TPU-native re-design of the reference's model-reader abstraction
(reference: src/vk_renderer/model_reader/model_reader.rs:5-146). The byte-level
copy-info structs are kept so that asset layouts (interleaved vertex streams,
index blocks, stacked texture layers) stay verifiable against the reference's
golden tests (gltf_model_reader.rs:784-855), while the renderer itself consumes
structure-of-arrays numpy views.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field

import numpy as np


class MeshAttributeType(enum.IntFlag):
    """Bit order defines the interleaved layout: [pos | uv | normal | tangent].

    Mirrors model_reader.rs:5-12; the enumeration order drives the vertex
    stream layout exactly like the reference's ``bitflag_vec!`` macro.
    """

    VERTICES = 1
    TEX_COORDS = 2
    NORMALS = 4
    TANGENTS = 8
    INDICES = 16


class TextureType(enum.IntFlag):
    """Texture-array layer order: albedo, ORM, normal, emissive.

    Mirrors model_reader.rs:14-19; layer indices are what the shading pass
    uses (raytrace.rgen.glsl:132-137 samples layers 0/1/2).
    """

    ALBEDO = 1
    ORM = 2
    NORMAL = 4
    EMISSIVE = 8


def bitflag_list(flag_cls, flags):
    """Enumerate set bits in ascending order (model_reader.rs:22-35)."""
    out = []
    bit = 1
    max_bits = max(int(f) for f in flag_cls).bit_length()
    for _ in range(max_bits):
        if flags & bit:
            out.append(flag_cls(bit))
        bit <<= 1
    return out


def align_offset(offset: int, alignment: int) -> int:
    """model_reader.rs:144-146 (the reference rounds via f32 ceil; for the
    offsets in play the integer form is identical)."""
    return alignment * ((offset + alignment - 1) // alignment)


# Sizes validated by the reference (gltf_model_reader.rs:643-663).
ATTRIBUTE_ELEMENT_SIZE = {
    MeshAttributeType.VERTICES: 12,
    MeshAttributeType.TEX_COORDS: 8,
    MeshAttributeType.NORMALS: 12,
    MeshAttributeType.TANGENTS: 16,
}


@dataclass
class PrimitiveCopyInfo:
    """Byte-layout metadata for one primitive (model_reader.rs:56-72)."""

    mesh_buffer_offset: int = 0
    mesh_size: int = 0
    single_mesh_element_size: int = 0

    indices_buffer_offset: int = 0
    indices_size: int = 0
    single_index_size: int = 0

    image_buffer_offset: int = 0
    image_size: int = 0
    image_format: str = ""
    image_extent: tuple = (0, 0, 1)
    image_mip_levels: int = 0
    image_layers: int = 0


@dataclass
class ModelCopyInfo:
    """model_reader.rs:52-103."""

    primitives_copy_data: list = field(default_factory=list)

    def get_primitive_data(self):
        return self.primitives_copy_data

    def compute_total_size(self) -> int:
        size = 0
        for p in self.primitives_copy_data:
            size += p.mesh_size + p.indices_size + p.image_size
        return size

    def compute_aligned_mesh_and_indices_size(self) -> int:
        size = 0
        for p in self.primitives_copy_data:
            size = align_offset(size, 12)
            size += p.mesh_size + p.indices_size
        return size


@dataclass
class Sphere:
    """Bounding sphere with max-column-scale transform (model_reader.rs:106-142)."""

    center: np.ndarray
    radius: float

    def distance_from_point(self, point) -> float:
        return float(np.linalg.norm(self.center - np.asarray(point, np.float32))) - self.radius

    def transform(self, m3x4: np.ndarray) -> "Sphere":
        m = np.asarray(m3x4, np.float32).reshape(3, 4)
        center = m @ np.array([*self.center, 1.0], np.float32)
        max_scale = max(float(np.linalg.norm(m[:, i])) for i in range(3))
        return Sphere(center=center, radius=max_scale * self.radius)


def ritter_bounding_sphere(position_arrays) -> Sphere:
    """Two-pass Ritter bounding sphere over all primitives' positions.

    Exact port of the numerical recipe in gltf_model_reader.rs:283-399 —
    including the detail that the axis-extreme points are full vertices (the
    vertex minimizing/maximizing each coordinate), evaluated sequentially in
    f32, so results are bit-comparable with the reference.
    """
    positions = [np.asarray(p, np.float32).reshape(-1, 3) for p in position_arrays]
    allp = np.concatenate(positions, axis=0) if positions else np.zeros((0, 3), np.float32)
    if allp.shape[0] == 0:
        return Sphere(np.zeros(3, np.float32), 0.0)

    # First pass: find the vertex pair with the maximum per-axis span.
    xmin = allp[np.argmin(allp[:, 0])]
    xmax = allp[np.argmax(allp[:, 0])]
    ymin = allp[np.argmin(allp[:, 1])]
    ymax = allp[np.argmax(allp[:, 1])]
    zmin = allp[np.argmin(allp[:, 2])]
    zmax = allp[np.argmax(allp[:, 2])]

    def mag2(v):
        return float(np.dot(v, v))

    xspan = mag2(xmax - xmin)
    yspan = mag2(ymax - ymin)
    zspan = mag2(zmax - zmin)

    dia1, dia2, maxspan = xmin, xmax, xspan
    if yspan > maxspan:
        maxspan, dia1, dia2 = yspan, ymin, ymax
    if zspan > maxspan:
        dia1, dia2 = zmin, zmax

    center = ((dia1 + dia2) * np.float32(0.5)).astype(np.float32)
    radius2 = mag2(dia2 - center)
    radius = math.sqrt(radius2)

    # Second pass: grow the sphere for outliers (sequential, order-dependent).
    for p in allp:
        delta = p - center
        old_to_p_sq = mag2(delta)
        if old_to_p_sq > radius2:
            old_to_p = math.sqrt(old_to_p_sq)
            radius = (radius + old_to_p) * 0.5
            radius2 = radius * radius
            old_to_new = old_to_p - radius
            recip = 1.0 / old_to_p
            center = ((radius * center + old_to_new * p) * recip).astype(np.float32)

    return Sphere(center=center.astype(np.float32), radius=float(radius))
