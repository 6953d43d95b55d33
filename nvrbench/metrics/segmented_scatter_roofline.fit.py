"""The segmented scatter's share of its roofline: the bounds of a step's
'segmented' table-gradient calls (``counts.scatter_calls``) over the device
time of the call's two kernels (``red_kernel``, ``exchange_kernel`` of
``csrc/segmented_scatter.cu``) in the traced steps, in %."""
from nvrbench.readers import roofline_share

KERNELS = r"(?<!\w)(red_kernel|exchange_kernel)(?!\w)"


def read(r):
    if r.kind != "fit" or not r.scatter_bound_s:
        return None
    return roofline_share(r, KERNELS, r.scatter_bound_s.get("segmented"))
