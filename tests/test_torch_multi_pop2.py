"""K5p against tpurt's ``pop2=True`` and the port's K2 on the random and ragged_s1 cases
(tests/torch_multi_cases.py)."""
from torch_multi_cases import pop2_tests
from torch_parity import same_host_builder  # noqa: F401

cases, test_multi_pop2_equals_k2_per_set, test_multi_pop2_agrees_with_tpurt \
    = pop2_tests(("random", "ragged_s1"))
