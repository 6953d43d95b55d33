"""Device busy milliseconds a step: the union of the kernels' and copies'
intervals in the profiler window over its steps."""
from nvrbench.readers import device_ms


def read(r):
    return device_ms(r) if r.kind == "fit" else None
