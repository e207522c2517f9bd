"""k1_roofline: harness/roofline.py's share for kernel k1, in %."""
read = lambda trace: trace["roofline_share"]("k1")  # noqa: E731
