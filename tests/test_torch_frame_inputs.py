"""The static frame's inputs without a blocking copy, port only, on the CPU.

Held: GTAO's noise maps of all 64 indices at once (``noise_tables``,
which the renderer keeps on the device) equal ``noise_maps_64``'s, each
from its own index table, bit for bit; the renderer's packed upload
(``convert.InputBuffer``) gives the tensors ``camera_tensors``,
``light_tensors`` and ``gtao_tensors`` give, bit for bit, with their
dtypes and shapes, updates them in place while the layout stays, copies
nothing when no value changed and allocates anew for another light
count; ``frame_graph.frame_key`` (the CUDA graph's key) stays for
in-place changes and the same values, and changes for another tensor,
shape or value, and for each traversal switch the frame reads.
"""
import numpy as np
import pytest
import torch

SIZE = 32


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _renderer():
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    return build_bench_scene(Renderer(RendererConfig(
        width=SIZE, height=SIZE, device="cpu")),
        field=dict(nx=2, nz=2, subdiv=1), cubes=2)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_noise_tables_equal_each_index_table():
    from tpurt_torch.passes.gtao import noise_maps_64, noise_tables

    tables = noise_tables("cpu")
    assert tables.shape == (64, 2, 64, 64) and tables.is_contiguous()
    for i in range(64):
        assert torch.equal(_bits(tables[i]),
                           _bits(noise_maps_64(i, "cpu"))), i
        assert torch.equal(_bits(tables[i]),
                           _bits(noise_maps_64(i + 64, "cpu"))), i
    r = _renderer()
    assert torch.equal(_bits(r._noise), _bits(tables))


def _groups(r):
    from tpurt_torch.engine import convert
    from tpurt_torch.passes.gtao import gtao_constants

    c = r.config
    consts = gtao_constants(c.width, c.height, r.camera.znear,
                            r.camera.zfar, r.camera.fovy, r.camera.aspect)
    return consts, dict(camera=convert.camera_arrays(r.camera.uniform()),
                        lights=r.lights.shader_arrays(),
                        gtao=convert.gtao_arrays(consts))


def _same_tensors(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].is_contiguous(), k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.parametrize("group", ["camera", "lights", "gtao"])
def test_packed_upload_equals_the_per_array_tensors(group):
    """One InputBuffer upload of the camera, lights and GTAO constants
    against ``camera_tensors``, ``light_tensors`` and ``gtao_tensors``."""
    from tpurt_torch.engine import convert

    r = _renderer()
    consts, groups = _groups(r)
    got = convert.InputBuffer("cpu").update(groups)[group]
    want = dict(
        camera=lambda: convert.camera_tensors(r.camera.uniform(), "cpu"),
        lights=lambda: convert.light_tensors(r.lights.shader_arrays(),
                                             "cpu"),
        gtao=lambda: {k: v for k, v in convert.gtao_tensors(
            consts, "cpu").items() if k != "host"})[group]()
    _same_tensors(got, want)


def test_packed_upload_in_place_once_per_change():
    """A moved camera updates the same tensors in one upload span; the
    same values upload nothing; another light count allocates a new
    buffer; the values follow every change."""
    import contextlib

    from tpurt_torch.engine import convert
    from tpurt_torch.scene.lights import PointLight

    r = _renderer()
    buf = convert.InputBuffer("cpu")
    spans = []

    def step(name):
        spans.append(name)
        return contextlib.nullcontext()

    first = buf.update(_groups(r)[1], step)
    assert spans == ["upload"]
    assert buf.update(_groups(r)[1], step) is first and spans == ["upload"]
    ptr = buf.buffer.data_ptr()
    r.camera_mut().set_pos(r.camera.pos + np.float32([0.1, 0.0, 0.0]))
    moved = buf.update(_groups(r)[1], step)
    assert spans == ["upload"] * 2 and buf.buffer.data_ptr() == ptr
    assert all(moved["camera"][k] is first["camera"][k]
               for k in first["camera"])
    _same_tensors(moved["camera"],
                  convert.camera_tensors(r.camera.uniform(), "cpu"))
    r.lights_mut().point_lights.append(PointLight(
        pos=np.float32([0.0, 3.0, 0.0]), color=np.float32([1.0, 1.0, 1.0]),
        falloff_distance=10.0, casts_shadows=True))
    more = buf.update(_groups(r)[1], step)
    assert spans == ["upload"] * 3
    assert more["lights"]["pos"].shape[0] == \
        first["lights"]["pos"].shape[0] + 1
    _same_tensors(more["lights"],
                  convert.light_tensors(r.lights.shader_arrays(), "cpu"))
    _same_tensors(more["camera"],
                  convert.camera_tensors(r.camera.uniform(), "cpu"))


def test_frame_key_follows_what_the_frame_reads():
    from tpurt_torch.engine.frame_graph import frame_key
    from tpurt_torch.passes.gtao import GtaoSettings

    a = torch.zeros(4, 3)
    b = torch.zeros(4, 3)
    inputs = ({"t": a, "n": 3, "shape": (2, 2)}, dict(width=8,
              gtao_settings=GtaoSettings()), (False, False))
    key = frame_key(inputs)
    a += 1.0  # in place: the same tensor, the same key
    assert frame_key(inputs) == key
    assert frame_key(({"t": a, "n": 3, "shape": (2, 2)}, dict(
        width=8, gtao_settings=GtaoSettings()), (False, False))) == key
    for other in [({"t": b, "n": 3, "shape": (2, 2)},) + inputs[1:],
                  ({"t": a[:2], "n": 3, "shape": (2, 2)},) + inputs[1:],
                  ({"t": a, "n": 4, "shape": (2, 2)},) + inputs[1:],
                  (inputs[0], dict(width=9, gtao_settings=GtaoSettings()),
                   inputs[2]),
                  (inputs[0], dict(width=8, gtao_settings=GtaoSettings(
                      denoise=2)), inputs[2]),
                  inputs[:2] + ((True, False),)]:
        assert frame_key(other) != key


@pytest.mark.parametrize("switch", ["POP2_DEFAULT", "UVP_DEFAULT"])
def test_every_traversal_switch_reaches_the_frame_key(switch, monkeypatch):
    """Each module switch a trace reads at call time is in
    ``call_time_switches``, which the renderer's graph key holds: flipping
    it changes the key."""
    from tpurt_torch.engine.frame_graph import frame_key
    from tpurt_torch.kernels import traverse_bvh8 as tb

    before = frame_key(tb.call_time_switches())
    monkeypatch.setattr(tb, switch, True)
    assert frame_key(tb.call_time_switches()) != before
