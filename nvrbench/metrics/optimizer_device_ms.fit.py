"""Device milliseconds a step in the optimizer's ``torch._foreach_*`` sweeps
(``train/state.py:OptaxAdam``), by kernel name: ``multi_tensor_apply``."""
from nvrbench.readers import per_unit_ms
from nvrbench.trace import kernel_seconds


def read(r):
    if r.kind != "fit" or r.trace is None:
        return None
    t = kernel_seconds(r.trace, "multi_tensor_apply")
    return per_unit_ms(r, t) if t > 0 else None
