"""enqueue_ms: the host's time (ms) inside each frame call of the traced
window (pose set and the entry's return), the mean over the window."""


def read(trace):
    ms = trace.get("enqueue_ms")
    return sum(ms) / len(ms) if ms else None
