"""The streaming-texture arena (``engine/texture_arena.py``) and its buddy
sub-allocator (``utils/pool.py``), mirroring tpurt's tests/test_pool.py
and tests/test_texture_arena.py on the port: the allocator's split, merge,
alignment and double free, and the same offsets and free bytes as tpurt's
Python twin on one random sequence; the arena's offsets and counters
(``last_uploaded_rows``, ``last_freed``) equal to tpurt's arena on one
sequence of working sets, growth included; and the Renderer: arena frames
bit-equal to slab frames (with and without mips), and a residency change
that uploads only the joining images' rows and renders bit-equal to a
fresh renderer.
"""
import numpy as np
import pytest
import torch

SIZE = 32


def test_split_produces_buddies():
    from tpurt_torch.utils.pool import BuddySubAllocator

    a = BuddySubAllocator(2048, 128)
    off = a.allocate(128)
    assert off % 128 == 0
    assert a.free_bytes() == 2048 - 128


def test_merge_restores_root():
    from tpurt_torch.utils.pool import BuddySubAllocator

    a = BuddySubAllocator(2048, 128)
    offs = [a.allocate(128) for _ in range(16)]
    assert sorted(offs) == list(range(0, 2048, 128))
    assert a.free_bytes() == 0
    with pytest.raises(MemoryError):
        a.allocate(128)
    for off in offs:
        a.free(off)
    assert a.free_bytes() == 2048
    assert a.allocate(2048) == 0


def test_alignment_sizes_and_double_free():
    from tpurt_torch.utils.pool import BuddySubAllocator

    a = BuddySubAllocator(1 << 16, 256)
    assert a.allocate(300, alignment=1024) % 1024 == 0
    assert a.allocate(257) % 512 == 0
    with pytest.raises(MemoryError):
        a.allocate(1 << 17)
    b = BuddySubAllocator(1024, 128)
    off = b.allocate(128)
    b.free(off)
    with pytest.raises(ValueError):
        b.free(off)


def test_same_offsets_as_tpurts_twin():
    """Mixed sizes and alignments, allocations and frees in a seeded
    order: every offset, MemoryError and free byte count equals tpurt's
    Python twin's."""
    from tpurt.utils.pool import BuddySubAllocator as Ref
    from tpurt_torch.utils.pool import BuddySubAllocator

    rng = np.random.default_rng(0)
    ref, port = Ref(1 << 14, 128, force_python=True), BuddySubAllocator(
        1 << 14, 128)
    assert (port.total, port.min_block) == (ref.total, ref.min_block)
    live = []
    for step in range(400):
        if live and (rng.random() < 0.4 or step > 350):
            off = live.pop(int(rng.integers(0, len(live))))
            ref.free(off)
            port.free(off)
        else:
            size = int(rng.choice([1, 100, 128, 300, 512, 1500, 4096]))
            align = int(rng.choice([1, 1, 256, 1024]))
            got = want = None
            try:
                want = ref.allocate(size, align)
            except MemoryError:
                pass
            try:
                got = port.allocate(size, align)
            except MemoryError:
                pass
            assert got == want, step
            if got is not None:
                live.append(got)
        assert port.free_bytes() == ref.free_bytes()


def _rows(rng, n, width=8):
    return rng.integers(0, 256, (n, width), dtype=np.uint8)


def test_arena_unit_alloc_free_dedup_growth():
    """tpurt's test_arena_unit_alloc_free_dedup on the port."""
    from tpurt_torch.engine.texture_arena import TextureRowArena

    a = TextureRowArena(row_width=8)
    r1 = np.arange(8 * 300, dtype=np.uint8).reshape(300, 8) % 251
    r2 = (r1 + 1) % 251
    off = a.ensure({"k1": r1, "k2": r2})
    assert set(off) == {"k1", "k2"} and a.last_uploaded_rows == 600
    atlas = a.atlas.numpy()
    np.testing.assert_array_equal(atlas[off["k1"]:off["k1"] + 300], r1)
    np.testing.assert_array_equal(atlas[off["k2"]:off["k2"] + 300], r2)
    capacity = a.capacity

    off2 = a.ensure({"k1": r1})
    assert off2["k1"] == off["k1"]
    assert a.last_uploaded_rows == 0 and a.last_freed == 1
    assert a.capacity == capacity

    big = np.tile(r1, (40, 1))
    off3 = a.ensure({"k1": r1, "big": big})
    assert a.capacity > capacity and a.capacity & (a.capacity - 1) == 0
    atlas = a.atlas.numpy()
    np.testing.assert_array_equal(atlas[off3["k1"]:off3["k1"] + 300], r1)
    np.testing.assert_array_equal(
        atlas[off3["big"]:off3["big"] + big.shape[0]], big)


def test_arena_counters_equal_tpurts():
    """One sequence of working sets (joins, leaves, a fragmenting mix and
    a growth) through both arenas: the same offsets, capacity, uploaded
    rows and freed keys at every step, and the same atlas bytes."""
    from tpurt.engine.texture_arena import TextureRowArena as Ref
    from tpurt_torch.engine.texture_arena import TextureRowArena

    rng = np.random.default_rng(4)
    chunks = {f"k{i}": _rows(rng, n) for i, n in enumerate(
        [300, 17, 1024, 256, 700, 90, 2000, 5, 513])}
    steps = [["k0", "k1", "k2"], ["k0", "k2", "k3"], ["k3"],
             ["k3", "k4", "k5", "k1"], ["k1", "k6", "k3"],
             ["k7", "k8", "k6", "k0", "k2"], ["k8"], [],
             ["k0", "k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8"]]
    ref, port = Ref(row_width=8), TextureRowArena(row_width=8)
    for keys in steps:
        want = ref.ensure({k: (chunks[k], None) for k in keys})
        got = port.ensure({k: chunks[k] for k in keys})
        assert got == want, keys
        assert (port.capacity, port.last_uploaded_rows, port.last_freed) == \
            (ref.capacity, ref.last_uploaded_rows, ref.last_freed), keys
        live = np.asarray(ref.atlas)
        for k, off in got.items():
            n = chunks[k].shape[0]
            np.testing.assert_array_equal(port.atlas[off:off + n].numpy(),
                                          live[off:off + n])


def _textured_cube(center, hue, tex=32):
    """tpurt's test cube: a textured cube with a checker albedo."""
    from tpurt_torch.scene.mesh import TextureType
    from tpurt_torch.scene.model import Model
    from tpurt_torch.scene.procedural import _checker_texture, _cube, _image

    pos, nrm, uv, idx = _cube(np.asarray(center, np.float32), 0.5, 2)
    albedo = _checker_texture(tex, [*hue, 255], [250, 250, 250, 255])
    orm = np.full((tex, tex, 4), 255, np.uint8)
    orm[..., 1] = 90
    orm[..., 2] = 30
    normal = np.full((tex, tex, 4), 255, np.uint8)
    normal[..., :2] = 128
    prims = [dict(positions=pos, normals=nrm, tex_coords=uv, tangents=None,
                  textures={TextureType.ALBEDO: _image(albedo),
                            TextureType.ORM: _image(orm),
                            TextureType.NORMAL: _image(normal)},
                  indices=idx.reshape(-1, 3))]
    return Model.from_arrays(prims, np.eye(3, 4, dtype=np.float32))


def _renderer(arena: bool, mipmaps: bool, far: float = 14.0):
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.passes.gtao import GtaoSettings
    from tpurt_torch.scene.lights import PointLight

    r = Renderer(RendererConfig(width=SIZE, height=SIZE, mipmaps=mipmaps,
                                texture_arena=arena, device="cpu",
                                gtao=GtaoSettings(2, 2, denoise=1)))
    r.models.append(_textured_cube([0.0, 0.0, 0.0], [200, 60, 60]))
    r.models.append(_textured_cube([far, 0.0, 0.0], [60, 200, 60], tex=16))
    r.lights_mut().point_lights.append(
        PointLight([0, 0, -2], [3, 3, 3], 10.0, True))
    r.camera_mut().set_dir([0.0, 0.0, 1.0])
    return r


def _image(r):
    return r.render()["image"].numpy()


@pytest.mark.parametrize("mipmaps", [False, True])
def test_arena_frame_equals_slab_frame(mipmaps):
    """tpurt's test_arena_nonmip_quad_bitexact_and_delta (and its mip
    frame): both models resident, mixed extents; the arena holds each
    image's rows at its own extent."""
    slab, ar = _renderer(False, mipmaps, far=5.0), _renderer(True, mipmaps,
                                                              far=5.0)
    for r in (slab, ar):
        r.camera_mut().set_pos([2.5, 0.0, -4.0])
        r.prepare_first_frame()
    key = "tex_mip_quad" if mipmaps else "tex_quad"
    assert ar.scene_device[key] is ar._tex_arena.atlas
    assert slab._tex_arena is None
    if not mipmaps:
        assert "tex_quad_base" in ar.scene_device
        assert "tex_quad_shape" in slab.scene_device
        live = sum(n for _, n in ar._tex_arena._live.values())
        assert live == 32 * 32 + 16 * 16
    np.testing.assert_array_equal(_image(ar), _image(slab))


def test_streaming_uploads_only_joiners():
    """tpurt's test_arena_streaming_delta_uploads_and_bitexact_frames:
    the second cube streams out (nothing uploads, its slots free) and back
    in (only its rows upload, the first cube's offsets stay); every frame
    equals a fresh renderer's at the same camera."""
    from tpurt_torch.scene.model import Residency

    both, only_a = [7.0, 0.0, -3.0], [0.0, 0.0, -3.0]
    r = _renderer(True, mipmaps=True)
    r.camera_mut().set_pos(both)
    r.prepare_first_frame()
    arena = r._tex_arena
    live0 = dict(arena._live)
    assert len(live0) == 2 and arena.last_uploaded_rows == sum(
        n for _, n in live0.values())
    table = r.scene_device["tex_mip_quad"]

    def fresh(pos):
        f = _renderer(True, mipmaps=True)
        f.camera_mut().set_pos(pos)
        return _image(f)

    r.camera_mut().set_pos(only_a)
    img = _image(r)
    assert r.models[1].state != Residency.DEVICE
    assert arena.last_uploaded_rows == 0 and arena.last_freed == 1
    assert r.scene_device["tex_mip_quad"] is table
    np.testing.assert_array_equal(img, fresh(only_a))
    (kept, (off, n)), = arena._live.items()
    assert live0[kept] == (off, n)

    r.camera_mut().set_pos(both)
    img = _image(r)
    assert r.models[1].state == Residency.DEVICE
    joined = sum(n for k, (_, n) in live0.items() if k != kept)
    assert arena.last_uploaded_rows == joined and arena.last_freed == 0
    assert arena._live[kept] == (off, n)
    np.testing.assert_array_equal(img, fresh(both))


def test_dynamic_frames_keep_the_slab():
    """The arena serves the static frame only: the dynamic frames read
    the object tables' own texel table (tpurt's as_object_pytree ships
    tex_quad48 unchanged), and render the same image as without it."""
    from tpurt_torch.app.bench_scene import rotation_frames

    out = []
    for arena in (True, False):
        r = _renderer(arena, mipmaps=False, far=5.0)
        r.camera_mut().set_pos([2.5, 0.0, -4.0])
        r.prepare_first_frame()
        t = rotation_frames(r.scene.transforms, 3)[2]
        out.append(r.render_dynamic(t)["image"])
        assert "tex_quad_shape" in r._obj_device
    assert torch.equal(out[0], out[1])
