"""Milliseconds a Prefetcher worker took to build an item, over the items
the traced window consumed: the program's ``item.build`` span
(``datasets/prefetch.py``: the producer call, timed on the worker
thread and recorded by the consumer when it takes the item).

The spans come from the program's buffer
(``instant_nvr_tpu_torch/utils/telemetry.py``), which records only while
a profiler records on the consumer's thread: they are the ``--trace 1``
window's.  The traffic kinds read no span themselves, so this reader
takes the buffer as it finds it.  None where the program has no such
buffer (a checkout before it) or the buffer holds no ``item.build`` span
(no Prefetcher feeds the window).
"""


def read(r):
    if r.kind != "fit":
        return None
    try:
        from instant_nvr_tpu_torch.utils import telemetry
    except ImportError:
        return None
    ns = [s.end_ns - s.start_ns for s in telemetry.spans() if s.name == "item.build"]
    return 1e-6 * sum(ns) / len(ns) if ns else None
