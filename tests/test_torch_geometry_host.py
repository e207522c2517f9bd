"""The sharded-geometry frame's host side (``dist/geometry.py``) against
tpurt's, on the cut bench scene of ``tests/torch_dist_worker.py`` (446
tris), both packages on the same host SAH builder (ROADMAP F10):

* ``shard_geometry`` at n = 1, 3 and 8: per shard, the "xla" tier's K6
  tables equal those of tpurt's unpadded stacks (its padding rows are
  padding), the "bvh8" tier's ``nodes8`` equal tpurt's and its triangle
  rows equal tpurt's shard triangles; global ids cover every triangle
  once;
* ``shard_tables`` chunks and meta equal tpurt's for the quad slab, the
  arena's flat rows, and the mip quad, pair and block4 tiers (the tiers
  forced by zeroing the budgets above them, as tpurt's tests force them);
* ``hbm_accounting``: tpurt's keys; ``tri_attr`` and ``texture_rows`` per
  rank equal tpurt's; the traversal is the bytes of the arrays a rank
  holds, where tpurt's "xla" tier reports 4 bytes (F24).
"""
import numpy as np
import pytest
import torch

from torch_parity import same_host_builder  # noqa: F401
import torch_dist_worker as worker


def _scene(**config):
    return worker.renderer(**config)


@pytest.fixture(scope="module")
def bench():
    r = _scene()
    return r, r.scene.as_pytree()


def _stack_rows(a, s, rows):
    """Shard s of a tpurt stack, its first `rows` rows, and the rest."""
    return np.asarray(a[s][:rows]), np.asarray(a[s][rows:])


@pytest.mark.parametrize("n", [1, 3, 8])
def test_shards_equal_tpurt(bench, n):
    from tpurt.dist.geometry import shard_geometry as ref_shards
    from tpurt_torch.bvh.wide import compact_bvh8
    from tpurt_torch.dist import shard_geometry
    from tpurt_torch.engine.convert import bvh2_tensors, pack_tris

    _, pt = bench
    ref = ref_shards(pt, n)
    ref8 = ref_shards(pt, n, tables="bvh8")
    got = shard_geometry(pt, n)
    got8 = shard_geometry(pt, n, tables="bvh8")
    assert len(got) == len(got8) == n
    ids = []
    for s in range(n):
        m = got[s]["nodes2"].shape[0]
        t = got[s]["tris"].shape[0]
        bvh = {k: _stack_rows(v, s, m) for k, v in ref["bvh"].items()}
        geom = {k: _stack_rows(v, s, t) for k, v in ref["geom"].items()}
        # tpurt's padding: unreachable nodes (entry = skip = -1), empty
        # triangles
        assert (bvh["entry"][1] == -1).all() and (bvh["skip"][1] == -1).all()
        assert not geom["v0"][1].any() and not geom["e1"][1].any()
        want = bvh2_tensors({k: v[0] for k, v in bvh.items()},
                            {k: v[0] for k, v in geom.items()},
                            got[s]["depth2"], "cpu")
        for k in ("nodes2", "nodes2c", "tris"):
            np.testing.assert_array_equal(got[s][k], want[k].numpy(),
                                          err_msg=f"{n} {s} {k}")
        # the BVH8 tier: tpurt's nodes8 rows, padded with zero rows; the
        # same triangles in the same leaf order as the binary tier
        m8 = got8[s]["nodes8"].shape[0]
        rows, pad = _stack_rows(ref8["nodes8"], s, m8)
        np.testing.assert_array_equal(got8[s]["nodes8"], rows)
        assert not pad.any()
        np.testing.assert_array_equal(got8[s]["tris"], pack_tris(
            {k: v[0] for k, v in geom.items()}))
        np.testing.assert_array_equal(got8[s]["nodes8c"], compact_bvh8(
            torch.from_numpy(got8[s]["nodes8"])).numpy())
        ids.append(got8[s]["tris"][:, 9])
    ids = np.concatenate(ids)
    np.testing.assert_array_equal(np.sort(ids), np.arange(len(ids)))


def _arena(r, pt):
    """The pytree with the quad rows in the streaming arena's layout
    (tpurt's renderer ships it so): flat rows and a base row per image."""
    return dict(pt, tex_quad48=r.scene_device["tex_quad"].numpy(),
                tex_quad48_base=r.scene_device["tex_quad_base"].numpy())


def _tier_scene(tier):
    import tpurt_torch.scene.scene as scene_mod

    budgets = (scene_mod.MIP_QUAD_BUDGET_BYTES,
               scene_mod.MIP_PAIR_BUDGET_BYTES)
    if tier in ("pair", "block4"):
        scene_mod.MIP_QUAD_BUDGET_BYTES = 0
    if tier == "block4":
        scene_mod.MIP_PAIR_BUDGET_BYTES = 0
    try:
        pt = _scene(mipmaps=True).scene.as_pytree()
    finally:
        (scene_mod.MIP_QUAD_BUDGET_BYTES,
         scene_mod.MIP_PAIR_BUDGET_BYTES) = budgets
    assert pt.get(f"tex_mip_{tier}") is not None
    return pt


@pytest.mark.parametrize("layout", ["slab", "arena", "quad", "pair",
                                    "block4"])
def test_tables_equal_tpurt(bench, layout):
    from tpurt.dist.geometry import freeze_meta as ref_freeze
    from tpurt.dist.geometry import shard_tables as ref_tables
    from tpurt_torch.dist import freeze_meta, shard_tables

    r, pt = bench
    if layout == "slab":
        scene = pt
    elif layout == "arena":
        scene = _arena(r, pt)
    else:
        scene = _tier_scene(layout)
    for n in (1, 3, 8):
        want, want_meta = ref_tables(scene, n)
        got, meta = shard_tables(scene, n)
        assert meta == want_meta and freeze_meta(meta) == ref_freeze(
            want_meta), (layout, n)
        assert sorted(got) == sorted(want) == ["quad_rows", "tri_attr"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_hbm_accounting(bench):
    from tpurt.dist.geometry import hbm_accounting as ref_acct
    from tpurt.dist.geometry import shard_geometry as ref_shards
    from tpurt.dist.geometry import shard_tables as ref_tables
    from tpurt_torch.dist import (hbm_accounting, shard_geometry,
                                  shard_tables)

    _, pt = bench
    n = 4
    tbl, _ = shard_tables(pt, n)
    for tier in ("bvh8", "xla"):
        shards = shard_geometry(pt, n, tier)
        tables = tbl if tier == "bvh8" else None
        ref = ref_acct(pt, ref_shards(pt, n, tables=tier),
                       ref_tables(pt, n)[0] if tables else None, n)
        acct = hbm_accounting(pt, shards, tables, n)
        assert sorted(acct) == sorted(ref)
        assert sorted(acct["replicated_bytes"]) == sorted(
            ref["replicated_bytes"])
        per, ref_per = acct["sharded_per_chip"], ref["sharded_per_chip"]
        held = [sum(v.nbytes for v in s.values()
                    if isinstance(v, np.ndarray)) for s in shards]
        assert per["traversal"] == max(held)
        for rank in range(n):
            assert hbm_accounting(pt, shards, tables, n, rank=rank)[
                "sharded_per_chip"]["traversal"] == held[rank]
        if tier == "bvh8":
            assert sorted(per) == sorted(ref_per)
            for k in ("tri_attr", "texture_rows", "small_replicated"):
                assert per[k] == ref_per[k], k
        else:
            # tpurt sums nbytes // n over its two dicts of 8 bytes
            assert ref_per["traversal"] == 2 * (8 // n) == 4
            assert per["traversal"] > 1000 * ref_per["traversal"]
            # the "xla" tier's shading tables are replicated on every rank
            assert per["tri_attr"] == np.asarray(pt["tri_attr"]).nbytes
            assert per["texture_rows"] == np.asarray(
                pt["tex_quad48"]).nbytes
        assert acct["sharded_total"] == sum(per.values())
        assert acct["ceiling_ratio"] == acct["replicated_total"] / acct[
            "sharded_total"]
