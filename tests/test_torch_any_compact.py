"""K2 over the compact node table: the port's plain any hit at its default
push order ("none", reading ``nodes8c``) against the plain any hit over the
``nodes8`` rows ("sort", the order K2 used before, and "none") and against
tpurt's ``trace_any_bvh8`` (Pallas in interpret mode) with ``fat=1,
when_push=False`` pinned (ROADMAP F5); and the any hit's default push
order, tpurt's "none" (ROADMAP D1).

Fixtures: a scene larger than one leaf ("material_field") and one smaller
("tiny", 12 triangles), a 40x48 frame (not a multiple of tpurt's 32x32
tile); shadow rays (t_max = 0 on the lanes whose primary ray missed) and
the primary rays themselves (misses included).

Tolerances: against the port's traversals over the rows, the occlusion bit
for bit and, against "none" over the rows, the same work (node pops, leaf
pops, triangle tests, deepest stack); against tpurt, occlusion equal on
>= 99.9% of rays with every differing lane grazing (tests/torch_parity.py,
as tests/test_torch_occlusion.py). The default's per-ray step counts equal
tpurt's per-packet counts under its own default on images whose 32x32
tiles each repeat one ray (as tests/test_torch_steps.py does for "none").
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_occlusion import _ray_sets
from test_torch_steps import PH, PW, TILE, TILES, _pick, _tile_of_pixel
from torch_parity import HitClassifier, classify_occlusion, resident_models

H, W = 40, 48
SCENES = ["material_field", "tiny"]
KINDS = ["shadow", "primary"]


@pytest.fixture(scope="module")
def results():
    from tpurt.kernels.traverse_bvh8 import trace_any_bvh8 as ref_any
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.engine import convert
    from tpurt_torch.kernels.traverse_bvh8 import (_trace_plain,
                                                   trace_any_bvh8,
                                                   trace_any_plain)

    out = {}
    for name in SCENES:
        pt = ref_flatten(resident_models(name)).as_pytree()
        scene = convert.scene_tensors(pt, "cpu")
        cls = HitClassifier(pt["bvh"]["nodes8"], pt["geom"])
        for kind, (o, d, t_min, t_max) in _ray_sets(scene, H, W).items():
            rays = (torch.tensor(o), torch.tensor(d), t_min,
                    torch.tensor(t_max))
            ref = ref_any(pt["bvh"], pt["geom"], jnp.asarray(o),
                          jnp.asarray(d), t_min, jnp.asarray(t_max),
                          height=H, width=W, max_leaf=32, interpret=True,
                          fat=1, when_push=False)
            stats = {k: {} for k in ("compact", "rows_none", "rows_sort")}
            out[name, kind] = dict(
                scene=scene, rays=rays, cls=cls, stats=stats,
                ref=np.asarray(ref),
                default=trace_any_bvh8(scene, *rays).numpy(),
                compact=trace_any_plain(scene, *rays,
                                        stats=stats["compact"]).numpy(),
                rows_none=_trace_plain(scene, *rays[:3], rays[3],
                                       any_hit=True, order="none",
                                       stats=stats["rows_none"]).numpy(),
                rows_sort=trace_any_plain(scene, *rays, push_order="sort",
                                          stats=stats["rows_sort"]).numpy())
    return out


KEYS = [(n, k) for n in SCENES for k in KINDS]


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "-".join(k))
def test_compact_equals_rows(key, results):
    """The default any hit reads nodes8c and equals the traversals over the
    rows bit for bit; under the same order it does the same work."""
    r = results[key]
    np.testing.assert_array_equal(r["default"], r["compact"])
    np.testing.assert_array_equal(r["compact"], r["rows_sort"])
    np.testing.assert_array_equal(r["compact"], r["rows_none"])
    for k in ("node_pops", "leaf_pops", "tri_tests", "max_stack"):
        assert int(r["stats"]["compact"][k]) == \
            int(r["stats"]["rows_none"][k]), k
    t_max = r["rays"][3].numpy()
    assert not r["compact"][t_max == 0.0].any()
    if key[1] == "shadow":
        assert (t_max == 0.0).any()
        assert r["compact"].any() == (key[0] != "tiny")
    else:
        # primary rays: occluded = hit; the frame has misses
        assert r["compact"].any() and not r["compact"].all()


@pytest.mark.parametrize("key", KEYS, ids=lambda k: "-".join(k))
def test_compact_agrees_with_tpurt(key, results):
    r = results[key]
    same = r["ref"] == r["compact"]
    assert same.mean() >= 0.999, f"occ agrees on {same.mean():.5f}"
    o, d, t_min, t_max = (x.numpy() if isinstance(x, torch.Tensor) else x
                          for x in r["rays"])
    kinds = classify_occlusion(r["cls"], r["ref"], r["compact"], o, d, t_min,
                               t_max)
    assert kinds["other"] == 0, kinds


def test_any_default_order_is_none(results):
    """push_order=None resolves to "none" for a one-pop any hit (tpurt's
    default) and to "sort" for the closest hit and the two-pop any hit."""
    from tpurt_torch.kernels.traverse_bvh8 import _resolve_k7a

    assert _resolve_k7a("t", None, False, None, any_hit=True) == \
        (False, "none")
    assert _resolve_k7a("t", None, True, None, any_hit=True) == \
        (False, "none")
    assert _resolve_k7a("t", True, False, None, any_hit=True) == \
        (True, "sort")
    assert _resolve_k7a("t", None, False, None) == (False, "sort")
    r = results["material_field", "shadow"]
    from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8

    occ, node, leaf = trace_any_bvh8(r["scene"], *r["rays"],
                                     count_steps=True)
    occ_n, node_n, leaf_n = trace_any_bvh8(r["scene"], *r["rays"],
                                           count_steps=True,
                                           push_order="none")
    _, node_s, _ = trace_any_bvh8(r["scene"], *r["rays"], count_steps=True,
                                  push_order="sort")
    assert torch.equal(occ, occ_n) and torch.equal(node, node_n) \
        and torch.equal(leaf, leaf_n)
    assert not torch.equal(node, node_s)   # the orders visit differently


def test_default_counts_equal_tpurt_default_per_packet(results):
    """On an image whose 32x32 tiles each repeat one shadow ray (4 occluded,
    3 clear, 1 with t_max = 0, picked by most pops), the port's default
    counted any hit gives each ray tpurt's per-packet counts under tpurt's
    default order, and the same occlusion."""
    from tpurt.kernels.traverse_bvh8 import trace_any_bvh8 as ref_any
    from tpurt.scene.scene import flatten_scene as ref_flatten
    from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8

    r = results["material_field", "shadow"]
    o, d, t_min, t_max = r["rays"]
    occ, node, leaf = trace_any_bvh8(r["scene"], *r["rays"],
                                     count_steps=True)
    pops, dead = (node + leaf).numpy(), t_max.numpy() == 0.0
    occ = occ.numpy()
    picks = _pick(pops, [(occ, 4), (~occ & ~dead, 3), (dead, 1)])
    assert len(set(picks)) == TILES[0] * TILES[1]
    sel = torch.tensor(picks)
    rays = (o[sel], d[sel], t_min, t_max[sel])
    img = _tile_of_pixel()
    pt = ref_flatten(resident_models("material_field")).as_pytree()
    ref = ref_any(pt["bvh"], pt["geom"], jnp.asarray(rays[0][img].numpy()),
                  jnp.asarray(rays[1][img].numpy()), t_min,
                  jnp.asarray(rays[3][img].numpy()), height=PH, width=PW,
                  max_leaf=32, interpret=True, count_steps=True, fat=1,
                  when_push=False)
    got = trace_any_bvh8(r["scene"], *rays, count_steps=True)
    for g, x in zip(got, ref):
        x = np.asarray(x)
        per_tile = x.reshape(PH, PW)[::TILE, ::TILE].reshape(-1)
        np.testing.assert_array_equal(x, per_tile[img])
        np.testing.assert_array_equal(g.numpy(), per_tile)
    assert int(got[0].sum()) == 4 and (got[1] + got[2] > 0).sum() == 7


def test_frame_shape_is_a_layout_only(results, monkeypatch):
    """trace_any_bvh8's height/width (tpurt's arguments) change no bit and
    must describe the rays; shade passes the frame's shape to every
    per-light trace of a frame."""
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.kernels.traverse_bvh8 import trace_any_bvh8
    from tpurt_torch.passes import shade

    r = results["material_field", "shadow"]
    got = trace_any_bvh8(r["scene"], *r["rays"], height=H, width=W)
    np.testing.assert_array_equal(got.numpy(), r["compact"])
    with pytest.raises(ValueError, match="frame"):
        trace_any_bvh8(r["scene"], *r["rays"], height=H - 1, width=W)

    seen = []
    real = shade.trace_any_bvh8

    def recording(*args, **kw):
        seen.append((kw.get("height"), kw.get("width")))
        return real(*args, **kw)

    rr = build_bench_scene(Renderer(RendererConfig(width=24, height=16,
                                                   device="cpu")),
                           field=dict(nx=2, nz=2, subdiv=1), cubes=1)
    monkeypatch.setattr(shade, "trace_any_bvh8", recording)
    rr.render()
    lights = rr.stats()["shadow_casting_lights"]
    assert seen == [(16, 24)] * lights
