"""The window's wall time over the frames completed in it."""


def read(r):
    return 1e3 * r.window_s / r.frames if r.kind == "render" and r.frames else None
