"""Host milliseconds a step in the program's ``step`` span
(``train/compiled.py:CapturedStep.__call__``; the eager route's
``train/step.py:make_train_step``): binding the state, the draws, the
copies into the graph's static inputs and the replay's enqueue.

The spans come from the program's buffer
(``instant_nvr_tpu_torch/utils/telemetry.py``), which records only while
a profiler records: they are the ``--trace 1`` window's.  The traffic
kinds read no span themselves, so this reader takes the buffer as it
finds it.  None where the program has no such buffer (a checkout before
it) or the buffer holds no ``step`` span.
"""


def read(r):
    if r.kind != "fit" or not r.trace_units:
        return None
    try:
        from instant_nvr_tpu_torch.utils import telemetry
    except ImportError:
        return None
    ns = [s.end_ns - s.start_ns for s in telemetry.spans()
          if s.name == "step" and s.parent != "step"]
    return 1e-6 * sum(ns) / r.trace_units if ns else None
