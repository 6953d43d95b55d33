"""1 - the union of device intervals over the profiler window's wall time,
in %, in the render cell."""
from nvrbench.readers import idle_share


def read(r):
    return idle_share(r) if r.kind == "render" else None
