"""glTF (.glb) model reader.

Ground-up reimplementation of the reference's asset loader semantics
(reference: src/vk_renderer/model_reader/gltf_model_reader.rs) on
numpy (tpurt's C++ pixel-permutation fast path gives the same bytes and
is not carried over):

* exactly one mesh / one buffer per model (gltf_model_reader.rs:62-63),
* optional vertex normalization to unit max magnitude (:414-460),
* optional image format coercion with channel permutation (:463-633),
* validation of attribute sizes / element counts / texture extents (:643-681),
* interleaved [pos|uv|normal|tangent] vertex stream + indices + stacked
  texture layers (copy_model_data :156-281),
* two-pass Ritter bounding sphere (:283-399).

The renderer itself consumes the structure-of-arrays accessors
(`positions()`, `indices()`, `texture_stack()`), not the byte stream; the
byte stream exists for golden-layout verification against the reference.
"""
from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .mesh import (
    ATTRIBUTE_ELEMENT_SIZE,
    MeshAttributeType,
    ModelCopyInfo,
    PrimitiveCopyInfo,
    Sphere,
    TextureType,
    align_offset,
    bitflag_list,
    ritter_bounding_sphere,
)

_COMPONENT_SIZE = {5120: 1, 5121: 1, 5122: 2, 5123: 2, 5125: 4, 5126: 4}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4, "MAT3": 9, "MAT4": 16}

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

# Channel maps, mirroring gltf_model_reader.rs:464-488.
_FORMAT_CHANNELS = {
    "R8_UNORM": {"r": 0},
    "R8G8_UNORM": {"r": 0, "g": 1},
    "R8G8B8_UNORM": {"r": 0, "g": 1, "b": 2},
    "R8G8B8A8_UNORM": {"r": 0, "g": 1, "b": 2, "a": 3},
    "B8G8R8_UNORM": {"b": 0, "g": 1, "r": 2},
    "B8G8R8A8_UNORM": {"b": 0, "g": 1, "r": 2, "a": 3},
}


def generate_src_to_dst_map(src_map: Dict[str, int], dst_map: Dict[str, int]) -> Dict[int, int]:
    """gltf_model_reader.rs:529-540."""
    return {s_i: dst_map[c] for c, s_i in src_map.items() if c in dst_map}


def permute_pixels(src: np.ndarray, src_texel_size: int, src_to_dst: Dict[int, int],
                   dst_texel_size: int) -> np.ndarray:
    """Vectorized channel permutation (gltf_model_reader.rs:542-573).

    The reference implements this three ways (scalar / SSSE3 / AVX2); the
    host side uses one vectorized numpy form. Unmapped destination bytes
    are zero.
    """
    src = np.asarray(src, np.uint8).reshape(-1, src_texel_size)
    out = np.zeros((src.shape[0], dst_texel_size), np.uint8)
    for s_i, d_i in src_to_dst.items():
        if s_i < src_texel_size and d_i < dst_texel_size:
            out[:, d_i] = src[:, s_i]
    return out.reshape(-1)


@dataclass
class ImageData:
    pixels: np.ndarray  # (H*W*C,) u8 flat, matching the reference's byte vec
    width: int
    height: int
    format: str  # e.g. "R8G8B8A8_UNORM"

    @property
    def texel_size(self) -> int:
        return len(_FORMAT_CHANNELS[self.format])

    def as_array(self) -> np.ndarray:
        return self.pixels.reshape(self.height, self.width, self.texel_size)


@dataclass
class _Attribute:
    """Strided view descriptor into the model buffer (gltf_model_reader.rs:10-33)."""

    buffer_data_start: int
    buffer_data_len: int
    element_size: int
    element_stride: int

    @property
    def element_count(self) -> int:
        return self.buffer_data_len // self.element_stride


@dataclass
class _Primitive:
    mesh_attributes: Dict[MeshAttributeType, _Attribute] = field(default_factory=dict)
    textures: Dict[TextureType, int] = field(default_factory=dict)  # -> image index


def _decode_image_bytes(data: bytes) -> ImageData:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode == "P":
        img = img.convert("RGBA" if "transparency" in img.info else "RGB")
    if img.mode == "L":
        fmt = "R8_UNORM"
    elif img.mode == "LA":
        img = img.convert("RGBA")
        fmt = "R8G8B8A8_UNORM"
    elif img.mode == "RGB":
        fmt = "R8G8B8_UNORM"
    elif img.mode == "RGBA":
        fmt = "R8G8B8A8_UNORM"
    else:
        img = img.convert("RGBA")
        fmt = "R8G8B8A8_UNORM"
    arr = np.asarray(img, np.uint8)
    h, w = arr.shape[0], arr.shape[1]
    return ImageData(pixels=arr.reshape(-1).copy(), width=w, height=h, format=fmt)


class GltfModelReader:
    """Opens a .glb and validates it (gltf_model_reader.rs:49-150)."""

    def __init__(self, buffer_data: np.ndarray, images, primitives):
        self.buffer_data = buffer_data  # mutable u8 array
        self.images = images
        self.primitives = primitives

    # -- construction -----------------------------------------------------

    @classmethod
    def open(cls, file_path, normalize_vectors: bool = False,
             coerce_image_to_format: Optional[str] = None,
             strict: bool = True) -> "GltfModelReader":
        """Open a .glb (binary) or .gltf (JSON + external buffer) model.

        strict=True enforces the reference's single-mesh/single-buffer
        validation (gltf_model_reader.rs:62-63); strict=False merges the
        primitives of every mesh (a capability extension).
        """
        if str(file_path).lower().endswith(".gltf"):
            doc, buffer_data, image_blobs, buffer_base = \
                cls._parse_gltf_json(file_path)
        else:
            doc, buffer_data, image_blobs, buffer_base = \
                cls._parse_glb(file_path)

        meshes = doc.get("meshes", [])
        buffers = doc.get("buffers", [])
        if strict:
            assert len(meshes) == 1, "expected exactly 1 mesh"
            assert len(buffers) == 1, "expected exactly 1 buffer"

        accessors = doc.get("accessors", [])
        buffer_views = doc.get("bufferViews", [])
        materials = doc.get("materials", [])
        textures_doc = doc.get("textures", [])

        def attr_from_accessor(acc_idx: int) -> _Attribute:
            acc = accessors[acc_idx]
            view = buffer_views[acc["bufferView"]]
            # every buffer is loaded into one concatenated blob;
            # buffer_base[i] is buffer i's start within it
            buf_idx = view.get("buffer", 0)
            assert buf_idx < len(buffer_base), \
                f"accessor references unloaded buffer {buf_idx}"
            size = _COMPONENT_SIZE[acc["componentType"]] * _TYPE_COUNT[acc["type"]]
            stride = view.get("byteStride", size)
            return _Attribute(
                buffer_data_start=(buffer_base[buf_idx]
                                   + acc.get("byteOffset", 0)
                                   + view.get("byteOffset", 0)),
                buffer_data_len=acc["count"] * stride,
                element_size=size,
                element_stride=stride,
            )

        semantic_map = {
            "POSITION": MeshAttributeType.VERTICES,
            "NORMAL": MeshAttributeType.NORMALS,
            "TANGENT": MeshAttributeType.TANGENTS,
            "TEXCOORD_0": MeshAttributeType.TEX_COORDS,
        }

        images = [
            _decode_image_bytes(blob) if blob is not None else None for blob in image_blobs
        ]

        all_prims = [p for mesh in meshes for p in mesh["primitives"]]
        primitives = []
        for prim in all_prims:
            p = _Primitive()
            if "indices" in prim:
                p.mesh_attributes[MeshAttributeType.INDICES] = attr_from_accessor(prim["indices"])
            for sem, acc_idx in prim["attributes"].items():
                if sem in semantic_map:
                    p.mesh_attributes[semantic_map[sem]] = attr_from_accessor(acc_idx)

            mat = materials[prim["material"]] if "material" in prim else {}
            pbr = mat.get("pbrMetallicRoughness", {})

            def image_idx_of(tex_info):
                if tex_info is None:
                    return None
                return textures_doc[tex_info["index"]]["source"]

            for ttype, tex_info in (
                (TextureType.ALBEDO, pbr.get("baseColorTexture")),
                (TextureType.ORM, pbr.get("metallicRoughnessTexture")),
                (TextureType.NORMAL, mat.get("normalTexture")),
                (TextureType.EMISSIVE, mat.get("emissiveTexture")),
            ):
                idx = image_idx_of(tex_info)
                if idx is not None:
                    p.textures[ttype] = idx
            primitives.append(p)

        model = cls(buffer_data, images, primitives)
        if normalize_vectors:
            model._normalize_vectors()
        if coerce_image_to_format is not None:
            model._coerce_images_to_format(coerce_image_to_format)
        model._validate_model()
        return model

    @staticmethod
    def _parse_gltf_json(file_path):
        """.gltf with external or data-URI buffers/images."""
        import base64
        import os
        import urllib.parse

        base_dir = os.path.dirname(os.path.abspath(file_path))
        with open(file_path, "r") as f:
            doc = json.load(f)

        def load_uri(uri: str) -> bytes:
            if uri.startswith("data:"):
                return base64.b64decode(uri.split(",", 1)[1])
            path = os.path.join(base_dir, urllib.parse.unquote(uri))
            with open(path, "rb") as fh:
                return fh.read()

        # load EVERY buffer; concatenate with per-buffer base offsets so
        # accessors/bufferViews can reference any of them (capability
        # extension over the reference's 1-buffer assert)
        blobs = [load_uri(b["uri"]) for b in doc.get("buffers", [])]
        buffer_base = []
        off = 0
        for b in blobs:
            buffer_base.append(off)
            off += len(b)
        joined = b"".join(blobs)
        buffer_data = np.frombuffer(joined, np.uint8).copy()

        image_blobs = []
        views = doc.get("bufferViews", [])
        for img in doc.get("images", []):
            if "bufferView" in img:
                v = views[img["bufferView"]]
                start = buffer_base[v.get("buffer", 0)] + v.get("byteOffset", 0)
                image_blobs.append(joined[start:start + v["byteLength"]])
            elif "uri" in img:
                image_blobs.append(load_uri(img["uri"]))
            else:
                image_blobs.append(None)
        return doc, buffer_data, image_blobs, buffer_base or [0]

    @staticmethod
    def _parse_glb(file_path):
        with open(file_path, "rb") as f:
            blob = f.read()
        magic, _version, _length = struct.unpack_from("<III", blob, 0)
        assert magic == _GLB_MAGIC, "not a GLB file"
        offset = 12
        doc = None
        bin_chunk = b""
        while offset + 8 <= len(blob):
            clen, ctype = struct.unpack_from("<II", blob, offset)
            offset += 8
            data = blob[offset:offset + clen]
            offset += clen
            if ctype == _CHUNK_JSON:
                doc = json.loads(data.decode("utf-8"))
            elif ctype == _CHUNK_BIN:
                bin_chunk = data
        assert doc is not None, "GLB missing JSON chunk"

        buffer_data = np.frombuffer(bin_chunk, np.uint8).copy()

        # Extract raw encoded image blobs (bufferView-embedded only; GLB).
        image_blobs = []
        views = doc.get("bufferViews", [])
        for img in doc.get("images", []):
            if "bufferView" in img:
                v = views[img["bufferView"]]
                start = v.get("byteOffset", 0)
                image_blobs.append(bytes(bin_chunk[start:start + v["byteLength"]]))
            else:
                image_blobs.append(None)
        return doc, buffer_data, image_blobs, [0]

    # -- strided attribute access -----------------------------------------

    def _attr_view(self, attr: _Attribute) -> np.ndarray:
        """(count, element_size) u8 strided view into the model buffer.

        as_strided performs no bounds check; the last element only needs
        element_size bytes (not a full stride), so validate against the real
        extent before building the view."""
        count = attr.element_count
        if count:
            needed = ((count - 1) * attr.element_stride + attr.element_size)
            avail = len(self.buffer_data) - attr.buffer_data_start
            if needed > avail:
                raise ValueError(
                    f"accessor overruns buffer: needs {needed} bytes at "
                    f"offset {attr.buffer_data_start}, has {avail}")
        return np.lib.stride_tricks.as_strided(
            self.buffer_data[attr.buffer_data_start:],
            shape=(count, attr.element_size),
            strides=(attr.element_stride, 1),
        )

    # -- reference-semantics transforms ------------------------------------

    def _normalize_vectors(self):
        """Scale all positions so the max magnitude is <= 1 (gltf_model_reader.rs:414-460).

        Note the reference seeds max_magnitude at 1.0, so models already inside
        the unit sphere are left untouched.
        """
        max_magnitude = np.float32(1.0)
        pos_attrs = [
            p.mesh_attributes[MeshAttributeType.VERTICES]
            for p in self.primitives
            if MeshAttributeType.VERTICES in p.mesh_attributes
        ]
        for attr in pos_attrs:
            pos = self._attr_view(attr).copy().view(np.float32).reshape(-1, 3)
            mags = np.sqrt((pos * pos).sum(axis=1))
            if mags.size:
                max_magnitude = max(max_magnitude, np.float32(mags.max()))
        for attr in pos_attrs:
            view = self._attr_view(attr)
            pos = view.copy().view(np.float32).reshape(-1, 3)
            pos /= max_magnitude
            view[:] = pos.view(np.uint8).reshape(view.shape)

    def _coerce_images_to_format(self, fmt: str):
        """gltf_model_reader.rs:463-527."""
        assert fmt in ("R8G8B8A8_UNORM", "B8G8R8A8_UNORM", "B8G8R8_UNORM"), \
            "Unsupported destination format during format coercion"
        dst_map = _FORMAT_CHANNELS[fmt]
        d_size = len(dst_map)
        done = set()
        for prim in self.primitives:
            for img_idx in prim.textures.values():
                if img_idx in done:
                    continue
                done.add(img_idx)
                img = self.images[img_idx]
                src_map = _FORMAT_CHANNELS[img.format]
                s_size = len(src_map)
                conv = generate_src_to_dst_map(src_map, dst_map)
                if s_size != d_size or any(s != d for s, d in conv.items()):
                    img.pixels = permute_pixels(img.pixels, s_size, conv, d_size)
                img.format = fmt

    def _validate_model(self):
        """gltf_model_reader.rs:635-681."""
        for prim in self.primitives:
            common_count = None
            for atype, attr in prim.mesh_attributes.items():
                if atype in ATTRIBUTE_ELEMENT_SIZE:
                    assert attr.element_size == ATTRIBUTE_ELEMENT_SIZE[atype], \
                        f"{atype} has element size {attr.element_size}"
                else:
                    continue
                if common_count is None:
                    common_count = attr.element_count
                else:
                    assert common_count == attr.element_count
            common_fmt = None
            common_extent = None
            for img_idx in prim.textures.values():
                img = self.images[img_idx]
                if common_extent is None:
                    common_fmt = img.format
                    common_extent = (img.width, img.height)
                else:
                    assert common_extent == (img.width, img.height)
                    assert common_fmt == img.format

    # -- byte-stream export (golden-layout compatible) ----------------------

    def copy_model_data(self, mesh_attributes: MeshAttributeType,
                        textures: TextureType,
                        dst: Optional[bytearray] = None) -> ModelCopyInfo:
        """Interleave requested attributes per primitive (gltf_model_reader.rs:156-281).

        Layout per primitive: [pos|uv|normal|tangent]*count, then indices,
        then (aligned to texel size) texture layers in TextureType order.
        """
        mesh_flags = bitflag_list(MeshAttributeType, mesh_attributes)
        if MeshAttributeType.INDICES in mesh_flags:
            mesh_flags.pop()  # INDICES is the highest bit -> last element
        texture_flags = bitflag_list(TextureType, textures)

        written = 0
        infos = []
        for prim in self.primitives:
            info = PrimitiveCopyInfo()
            if mesh_flags:
                info.mesh_buffer_offset = written
                first = prim.mesh_attributes[mesh_flags[0]]
                count = first.element_count
                views = []
                for flag in mesh_flags:
                    attr = prim.mesh_attributes.get(flag)
                    assert attr is not None, f"Mesh attribute {flag} not found"
                    views.append(self._attr_view(attr)[:count])
                interleaved = np.concatenate(views, axis=1)
                if dst is not None:
                    dst[written:written + interleaved.size] = interleaved.tobytes()
                written += interleaved.size
                info.mesh_size = written - info.mesh_buffer_offset
                info.single_mesh_element_size = info.mesh_size // count

            if mesh_attributes & MeshAttributeType.INDICES:
                info.indices_buffer_offset = written
                idx_attr = prim.mesh_attributes.get(MeshAttributeType.INDICES)
                assert idx_attr is not None, "INDICES not found in model"
                info.single_index_size = idx_attr.element_size
                data = self._attr_view(idx_attr)
                info.indices_size = data.size
                if dst is not None:
                    dst[written:written + data.size] = np.ascontiguousarray(data).tobytes()
                written += data.size

            if texture_flags:
                first_img = self.images[prim.textures[texture_flags[0]]]
                info.image_extent = (first_img.width, first_img.height, 1)
                component_size = first_img.pixels.size // (first_img.width * first_img.height)
                written = align_offset(written, component_size)
                info.image_buffer_offset = written
                info.image_mip_levels = 1
                info.image_layers = len(texture_flags)
                info.image_format = first_img.format
                for ttype in texture_flags:
                    img_idx = prim.textures.get(ttype)
                    assert img_idx is not None, f"Texture type {ttype} not found in model"
                    pix = self.images[img_idx].pixels
                    if dst is not None:
                        dst[written:written + pix.size] = pix.tobytes()
                    written += pix.size
                info.image_size = written - info.image_buffer_offset
            infos.append(info)
        return ModelCopyInfo(infos)

    def get_primitives_bounding_sphere(self) -> Sphere:
        pos = []
        for prim in self.primitives:
            attr = prim.mesh_attributes[MeshAttributeType.VERTICES]
            pos.append(np.ascontiguousarray(self._attr_view(attr)).view(np.float32).reshape(-1, 3))
        return ritter_bounding_sphere(pos)

    # -- structure-of-arrays accessors for the renderer ---------------------

    def primitive_arrays(self):
        """Per-primitive numpy SoA: what the TPU renderer actually consumes."""
        out = []
        for prim in self.primitives:
            def get(flag, dtype, ncomp):
                attr = prim.mesh_attributes.get(flag)
                if attr is None:
                    return None
                return (np.ascontiguousarray(self._attr_view(attr))
                        .view(dtype).reshape(-1, ncomp).copy())

            positions = get(MeshAttributeType.VERTICES, np.float32, 3)
            tex_coords = get(MeshAttributeType.TEX_COORDS, np.float32, 2)
            normals = get(MeshAttributeType.NORMALS, np.float32, 3)
            tangents = get(MeshAttributeType.TANGENTS, np.float32, 4)

            idx_attr = prim.mesh_attributes.get(MeshAttributeType.INDICES)
            if idx_attr is not None:
                dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[idx_attr.element_size]
                indices = (np.ascontiguousarray(self._attr_view(idx_attr))
                           .view(dtype).reshape(-1).astype(np.uint32))
            else:
                indices = np.arange(len(positions), dtype=np.uint32)

            textures = {}
            for ttype, img_idx in prim.textures.items():
                textures[ttype] = self.images[img_idx]

            out.append(dict(
                positions=positions, tex_coords=tex_coords, normals=normals,
                tangents=tangents, indices=indices.reshape(-1, 3), textures=textures,
            ))
        return out
