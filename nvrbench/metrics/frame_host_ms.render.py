"""Host milliseconds a frame before its launch, while the card has
nothing of the frame queued: the program's ``frame.pad`` (the padded
gather of the item's rays, ``eval/runner.py:render_full_image``) and
``frame.copy_in`` (the copies into the captured frame's static inputs,
``train/compiled.py:CapturedProgram.run``) spans.

The spans come from the program's buffer
(``instant_nvr_tpu_torch/utils/telemetry.py``), which records only while
a profiler records: they are the ``--trace 1`` window's.  The traffic
kinds read no span themselves, so this reader takes the buffer as it
finds it.  None where the program has no such buffer (a checkout before
it) or the buffer holds neither span.
"""


def read(r):
    if r.kind != "render" or not r.trace_units:
        return None
    try:
        from instant_nvr_tpu_torch.utils import telemetry
    except ImportError:
        return None
    ns = [s.end_ns - s.start_ns for s in telemetry.spans()
          if s.name in ("frame.pad", "frame.copy_in")]
    return 1e-6 * sum(ns) / r.trace_units if ns else None
