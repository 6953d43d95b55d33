"""The whole train step's share of the card's peaks: its model FLOPs
(``counts.model_flops``) at the peak of each one's precision, over the
traced window's wall time a step, in %."""
from nvrbench.readers import mfu


def read(r):
    return mfu(r) if r.kind == "fit" else None
