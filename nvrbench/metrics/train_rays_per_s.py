"""Rays stepped in the window over its wall time (which ends in a device
synchronize)."""


def read(r):
    return r.steps * r.rays_per_step / r.window_s if r.kind == "fit" else None
