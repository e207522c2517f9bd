"""K5 (fused multi-set any hit, one pop): the port's plain version against
tpurt's ``trace_any_bvh8_multi(pop2=False)`` in interpret mode and against
the port's own K2 per set, on every case of tests/torch_multi_cases.py; the
port's K5p against its K2 on the same cases (tpurt's K5p side is in
tests/test_torch_multi_pop2*.py); the split above the per-launch cap; the
work counters. Tolerances in tests/torch_multi_cases.py.
"""
import numpy as np
import pytest
import torch

import torch_multi_cases as mc
from torch_parity import same_host_builder  # noqa: F401


@pytest.fixture(scope="module")
def cases():
    return {name: mc.run(name, pop2=False) for name in mc.CASES}


@pytest.mark.parametrize("name", mc.CASES)
def test_multi_equals_k2_per_set(name, cases):
    mc.check_equals_k2(cases[name])


@pytest.mark.parametrize("name", mc.CASES)
def test_multi_agrees_with_tpurt(name, cases):
    mc.check_agrees_with_tpurt(cases[name])


@pytest.mark.parametrize("name", mc.CASES)
def test_multi_pop2_equals_k2_per_set(name):
    mc.check_equals_k2(mc.run(name, pop2=True, with_ref=False))


@pytest.mark.parametrize("pop2", [False, True])
def test_multi_splits_above_the_cap(pop2, cases):
    """More sets than MULTI_SETS_MAX run as several launches; every set
    still equals its own K2 trace (here 9 sets: 4 + 4 + 1)."""
    from tpurt_torch.kernels.traverse_bvh8 import (MULTI_SETS_MAX,
                                                   trace_any_bvh8_multi)

    c = cases["ragged_s4"]
    sel = [s % 4 for s in range(9)]
    assert len(sel) > 2 * MULTI_SETS_MAX
    port = mc.random_scenes()[1]
    got = trace_any_bvh8_multi(port, torch.tensor(c["o"]),
                               [torch.tensor(c["d"][s]) for s in sel],
                               c["t_min"], [torch.tensor(c["tm"][s])
                                            for s in sel], pop2=pop2)
    np.testing.assert_array_equal(got.numpy(), c["solo"][sel])


@pytest.mark.parametrize("pop2", [False, True])
def test_multi_work_counts(pop2, cases):
    """The plain version's work counters: one slab group per node pop and
    live set, at least one pop per lane with a live set, and the stack
    within its bound."""
    from tpurt_torch.kernels.traverse_bvh8 import (stack_entries,
                                                   trace_any_multi_plain)

    c = cases["random"]
    port = mc.random_scenes()[1]
    stats = {}
    trace_any_multi_plain(port, torch.tensor(c["o"]), torch.tensor(c["d"]),
                          c["t_min"], torch.tensor(c["tm"]), stats=stats,
                          pop2=pop2)
    pops, tests = int(stats["node_pops"]), int(stats["node_tests"])
    assert pops <= tests <= len(c["d"]) * pops
    assert pops >= c["o"].shape[0]
    assert int(stats["tri_tests"]) > 0
    assert stats["max_stack"] <= stack_entries(port["depth8"],
                                               2 if pop2 else 1)
