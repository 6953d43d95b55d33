"""The whole frame's share of the card's peaks: the forward's model FLOPs
(``counts.model_flops``) at the peak of each one's precision, over the
traced window's wall time a frame, in %."""
from nvrbench.readers import mfu


def read(r):
    return mfu(r) if r.kind == "render" else None
