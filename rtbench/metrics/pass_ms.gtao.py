"""pass_ms.gtao: the mean device time (ms) of the frame's gtao pass, from the
CUDA events around it in each frame of the traced window (the frame's
step hook); nothing where the entry has no step hook."""


def read(trace):
    ms = trace.get("pass_ms", {}).get("gtao")
    return sum(ms) / len(ms) if ms else None
