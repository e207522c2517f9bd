"""k9_ms: the mean device time of one K9 launch (the texel fetch,
``mip_texels_kernel``: one launch a frame) over the profiled frames, in
ms; None where no launch was traced."""

KERNEL = "mip_texels_kernel"


def read(trace):
    launches = [d for name, d in trace.get("kernels", []) if KERNEL in name]
    if not launches:
        return None
    return 1e3 * sum(launches) / len(launches)
