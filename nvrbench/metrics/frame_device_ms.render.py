"""Device busy milliseconds a frame: the union of the kernels' and copies'
intervals in the profiler window over its frames."""
from nvrbench.readers import device_ms


def read(r):
    return device_ms(r) if r.kind == "render" else None
