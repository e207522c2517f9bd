"""The compact node table ``nodes8c`` (``bvh/wide.compact_bvh8``) that K2
reads: built from the ``nodes8`` rows at upload and again on every refit
frame. Exact: the box lanes bit-equal to the rows' (regrouped by
coordinate), the codes equal to the traversal's child_code, empty slots
EMPTY_CODE; a refit frame's shadow traces read the table of that frame's
refit rows. Port-only (no tpurt): the rows themselves are held to tpurt's
in tests/test_torch_host.py and tests/test_torch_lbvh.py.
"""
import numpy as np
import pytest
import torch

W, H = 24, 16
FIELD = dict(nx=2, nz=2, subdiv=1)


def _random_nodes8(n_tris, leaf, seed):
    from test_bvh import random_tris
    from tpurt_torch.bvh import build_bvh_sah, collapse8
    from tpurt_torch.bvh.flat import tri_aabbs

    v0, v1, v2 = random_tris(n_tris, seed=seed, spread=4.0, size=0.6)
    bvh = build_bvh_sah(*tri_aabbs(v0, v1, v2), max_leaf_size=leaf)
    return torch.tensor(collapse8(bvh.as_pytree())[0])


def _check_table(nodes8, table):
    from tpurt_torch.bvh.wide import EMPTY_CODE
    from tpurt_torch.kernels.traverse_bvh8 import _node_children

    m = nodes8.shape[0]
    assert table.shape == (m, 56) and table.dtype == torch.float32
    assert table.is_contiguous()
    bits = table.view(torch.int32)
    rows = nodes8.view(torch.int32)
    for a in range(6):
        for k in range(8):
            assert torch.equal(bits[:, 8 * a + k], rows[:, 6 * k + a])
    codes = bits[:, 48:56]
    _, valid, child_code = _node_children(nodes8, torch.arange(m))
    assert torch.equal(codes[valid], child_code[valid])
    assert (codes[~valid] == EMPTY_CODE).all()
    # no valid slot takes the empty code: internal >= 1, leaves <= -2
    assert (codes[valid] != EMPTY_CODE).all()
    return valid


@pytest.mark.parametrize("n_tris, leaf", [(9, 1), (400, 1), (3000, 4)])
def test_compact_table_from_rows(n_tris, leaf):
    """Random SAH trees: one node (fewer triangles than a leaf slot holds,
    so every child is a leaf), and deeper trees with internal, leaf and
    empty slots."""
    from tpurt_torch.bvh.wide import compact_bvh8

    nodes8 = _random_nodes8(n_tris, leaf, seed=n_tris)
    valid = _check_table(nodes8, compact_bvh8(nodes8))
    internal = nodes8[:, 48:56] >= 0
    if n_tris > 100:
        assert internal.any() and (valid & ~internal).any() \
            and (~valid).any()


def test_scene_tables_carry_the_compact_table():
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.bvh.wide import compact_bvh8
    from tpurt_torch.engine import Renderer, RendererConfig

    r = build_bench_scene(Renderer(RendererConfig(width=W, height=H,
                                                  device="cpu")),
                          field=FIELD, cubes=1)
    sc = r.scene_device
    _check_table(sc["nodes8"], sc["nodes8c"])
    assert torch.equal(sc["nodes8c"].view(torch.int32),
                       compact_bvh8(sc["nodes8"]).view(torch.int32))


def test_refit_frames_rebuild_the_compact_table(monkeypatch):
    """Each refit frame builds nodes8c from its own refit rows, and every
    shadow trace of the frame reads that table: equal to the table of the
    rows refit independently under the frame's transforms."""
    from tpurt_torch.app.bench_scene import build_bench_scene, rotation_frames
    from tpurt_torch.bvh.wide import LEAF8_MAX, compact_bvh8, refit_bvh8
    from tpurt_torch.engine import Renderer, RendererConfig, dynamic
    from tpurt_torch.passes import shade

    r = build_bench_scene(Renderer(RendererConfig(width=W, height=H,
                                                  device="cpu")),
                          field=FIELD, cubes=1)
    built, traced = [], []
    real_compact, real_any = dynamic.compact_bvh8, shade.trace_any_bvh8

    def compact(nodes8):
        built.append((nodes8, real_compact(nodes8)))
        return built[-1][1]

    def any_hit(scene, *args, **kw):
        traced.append(scene["nodes8c"])
        return real_any(scene, *args, **kw)

    monkeypatch.setattr(dynamic, "compact_bvh8", compact)
    monkeypatch.setattr(shade, "trace_any_bvh8", any_hit)
    poses = rotation_frames(r.scene.transforms, 3)[1:]
    for t in poses:
        out = r.render_dynamic(t)
        assert "refit_sah_ratio" in out
    lights = r.stats()["shadow_casting_lights"]
    assert len(built) == len(poses) and len(traced) == lights * len(poses)
    obj, refit = r._obj_device, r._refit_device
    for i, t in enumerate(poses):
        rows, table = built[i]
        vp = dynamic.world_vertices(obj, torch.as_tensor(t))[0]
        tvo = obj["tri_vertex"][refit["order"]]
        v = [vp[tvo[:, k]] for k in range(3)]
        want = refit_bvh8(refit["nodes8"], refit["levels"],
                          torch.minimum(torch.minimum(v[0], v[1]), v[2]),
                          torch.maximum(torch.maximum(v[0], v[1]), v[2]),
                          LEAF8_MAX)
        assert torch.equal(rows.view(torch.int32), want.view(torch.int32))
        assert torch.equal(table.view(torch.int32),
                           compact_bvh8(want).view(torch.int32))
        _check_table(rows, table)
        for seen in traced[i * lights:(i + 1) * lights]:
            assert seen is table
    # the rows moved between the frames, and so did the table
    assert not torch.equal(built[0][1][:, :48], built[1][1][:, :48])
    assert np.array_equal(built[0][1][:, 48:].view(torch.int32).numpy(),
                          built[1][1][:, 48:].view(torch.int32).numpy())
