"""The 95th percentile of the window's step times: each the device-timeline
gap between the CUDA events recorded after consecutive steps, idle included."""
from nvrbench.fitcore import percentile


def read(r):
    return percentile(r.step_ms, 95.0) if r.kind == "fit" and r.step_ms else None
