"""k2_roofline: harness/roofline.py's share for kernel k2, in %."""
read = lambda trace: trace["roofline_share"]("k2")  # noqa: E731
