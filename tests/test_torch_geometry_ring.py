"""The sharded-geometry frame's collectives with 2 and 4 gloo ranks on
the CPU, each rank a spawned process (``tests/torch_geometry_worker.py``):

* ``ring_shift`` (``dist/sharding.py``) hands every rank its
  predecessor's tensors, a tree of f32, bool, int64, u8, int32 and empty
  tensors (checked inside every rank);
* ``ring_gather`` of a 103-row table (f32 rows of 40, u8 rows of 64), each
  rank holding its ``shard_tables`` chunk, equals direct indexing for 257
  in-range indices and tpurt's ``ring_gather`` on ``make_mesh(2|4)`` for
  those and for indices into the padding, past the last chunk and
  negative (0 rows: no rank owns them);
* the frame's refusals: a height the ranks do not divide, shards on
  another device than the mesh's, an unknown tier, the "bvh8" tier
  without its tables, more shards than triangles.
"""
import numpy as np
import pytest

import torch_geometry_worker as worker


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    for world in (2, 4):
        worker.spawn(worker.ring_worker, world, str(out))
    return {world: dict(np.load(out / f"gather{world}.npz"))
            for world in (2, 4)}


def _tpurt_ring_gather(table, idx, d):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    from tpurt.dist import make_mesh
    from tpurt.dist.geometry import ring_gather

    chunk = -(-table.shape[0] // d)
    padded = np.zeros((d * chunk,) + table.shape[1:], table.dtype)
    padded[:table.shape[0]] = table

    def body(tbl, ix):
        return ring_gather(tbl[0], chunk, ix, "x", d)

    return np.asarray(shard_map(
        body, mesh=make_mesh(d), in_specs=(P("x"), P()), out_specs=P(),
        check_vma=False)(jnp.asarray(padded.reshape(d, chunk,
                                                    *table.shape[1:])),
                         jnp.asarray(idx)))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["f32", "u8"])
def test_ring_gather(gathered, world, name):
    tables, idx, padded = worker.gather_inputs()
    table = tables[name]
    got = gathered[world]
    np.testing.assert_array_equal(got[f"{name}_idx"], table[idx])
    want = _tpurt_ring_gather(table, np.concatenate([idx, padded]), world)
    mine = np.concatenate([got[f"{name}_idx"], got[f"{name}_padded"]])
    assert mine.dtype == want.dtype
    np.testing.assert_array_equal(mine, want)
    assert not got[f"{name}_padded"].any()


def test_refusals():
    worker.spawn(worker.refusal_worker, 2)
