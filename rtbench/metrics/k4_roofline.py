"""k4_roofline: harness/roofline.py's share for kernel k4, in %."""
read = lambda trace: trace["roofline_share"]("k4")  # noqa: E731
