"""k10_ms: the device ms a frame of K10 (shade's surface reconstruction),
the summed traced time of every launch whose name holds
``shade_surface`` (the kernel, and on a mip scene its epilogue
``shade_surface_nmap_kernel``) over the number of
``shade_surface_kernel`` launches (one a frame); None where no such launch
was traced."""

FAMILY = "shade_surface"
KERNEL = "shade_surface_kernel"


def read(trace):
    kernels = trace.get("kernels", [])
    frames = sum(1 for name, _ in kernels if KERNEL in name)
    if not frames:
        return None
    return 1e3 * sum(d for name, d in kernels if FAMILY in name) / frames
