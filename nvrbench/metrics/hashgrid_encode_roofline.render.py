"""The fused hash-grid encoding's bound (``counts.hashgrid_encode_bound_s``
of each launch, counted by the reference at the frame's budgets) over
``hashgrid_encode_kernel``'s device time in the traced frames, in %."""
from nvrbench.readers import roofline_share


def read(r):
    if r.kind != "render":
        return None
    return roofline_share(r, "hashgrid_encode_kernel", r.encode_bound_s)
