"""Host milliseconds a step blocked on the Prefetcher's queue, in the
program's ``prefetch.wait`` span (``datasets/prefetch.py:Prefetcher``):
the in-program counterpart of ``data_wait_share.fit``, which the harness
times around the same queue from outside.

The spans come from the program's buffer
(``instant_nvr_tpu_torch/utils/telemetry.py``), which records only while
a profiler records: they are the ``--trace 1`` window's.  The traffic
kinds read no span themselves, so this reader takes the buffer as it
finds it.  None where the program has no such buffer (a checkout before
it) or the buffer holds no ``prefetch.wait`` span (no Prefetcher feeds
the window).
"""


def read(r):
    if r.kind != "fit" or not r.trace_units:
        return None
    try:
        from instant_nvr_tpu_torch.utils import telemetry
    except ImportError:
        return None
    ns = [s.end_ns - s.start_ns for s in telemetry.spans() if s.name == "prefetch.wait"]
    return 1e-6 * sum(ns) / r.trace_units if ns else None
