"""The benchmark's plain reference renderer, in plain torch: it imports
neither JAX nor anything of the program (``frame.Reference``).
``oracle_np.py`` and ``oracle_post_np.py`` are frozen copies of the numpy
oracles of tests/oracle.py and tests/oracle_post.py, which the torch
reference is held to in ``rtbench/tests``."""
