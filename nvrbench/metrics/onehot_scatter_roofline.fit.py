"""The one-hot scatter's share of its roofline: the bounds of a step's
'onehot' table-gradient calls (``counts.scatter_calls``) over the device
time of ``onehot_cluster_kernel`` (``csrc/onehot_scatter.cu``) in the
traced steps, in %."""
from nvrbench.readers import roofline_share

KERNELS = r"(?<!\w)onehot_cluster_kernel(?!\w)"


def read(r):
    if r.kind != "fit" or not r.scatter_bound_s:
        return None
    return roofline_share(r, KERNELS, r.scatter_bound_s.get("onehot"))
