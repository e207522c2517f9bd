"""device_idle_share: 100 * (1 - the union of the kernel and copy
intervals / the profiled frames' wall time), in %, from the device
trace."""


def read(trace):
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
