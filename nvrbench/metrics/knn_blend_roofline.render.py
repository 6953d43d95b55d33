"""``knn_blend``'s bound (``counts.knn_blend_bound_s`` at the frame's cull
budget, a call a chunk) over its device time in the traced frames, in %."""
from nvrbench.readers import roofline_share


def read(r):
    return roofline_share(r, "knn_blend_kernel", r.knn_bound_s) if r.kind == "render" else None
