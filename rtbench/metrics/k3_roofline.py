"""k3_roofline: harness/roofline.py's share for kernel k3, in %."""
read = lambda trace: trace["roofline_share"]("k3")  # noqa: E731
