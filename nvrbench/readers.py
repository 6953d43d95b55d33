"""What the metric readers (``nvrbench/metrics/<metric>.py``) share: each
reader's ``read(r)`` takes a run's readings ``r`` and returns its number,
or None when the run holds nothing to read (a per-layer metric is then
left out of the result line; a share of a roofline or of a peak is never
given as 0).

The readings (set by the traffic kinds): ``setup_s``; ``window_s``, the
measured window's wall time, ended by a device synchronize; a fit's
``steps``, ``rays_per_step``, ``step_ms`` (the device-timeline gaps between
the events recorded after consecutive steps) and ``data_wait_s`` (host time
blocked on the feed; None where nothing feeds the window); a render's
``frames``; with ``--trace 1`` ``trace`` (``trace.summarize`` of the
profiler window), ``trace_units`` (its steps or frames), ``flops`` (model
FLOPs by precision a unit, ``counts.model_flops``), ``knn_bound_s``
(``knn_blend``'s bound a unit) and a fit's ``scatter_bound_s`` (the
table-gradient scatters' bounds a step by route, ``counts.scatter_calls``).
"""
from __future__ import annotations

from typing import Optional

from . import counts
from .trace import kernel_seconds


def per_unit_ms(r, seconds: Optional[float]) -> Optional[float]:
    if r.trace is None or seconds is None or not r.trace_units:
        return None
    return 1e3 * seconds / r.trace_units


def device_ms(r) -> Optional[float]:
    """Device busy milliseconds a step or frame in the traced window."""
    return per_unit_ms(r, r.trace["busy_s"] if r.trace else None)


def idle_share(r) -> Optional[float]:
    if r.trace is None or r.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])


def roofline_share(r, kernel: str, bound_s: Optional[float]) -> Optional[float]:
    """A kernel's bound over its device time, a unit, in %: the kernels
    whose name matches ``kernel`` (``trace.kernel_seconds``)."""
    if r.trace is None or bound_s is None:
        return None
    t = kernel_seconds(r.trace, kernel)
    if t <= 0:
        return None
    return 100.0 * bound_s * r.trace_units / t


def mfu(r) -> Optional[float]:
    """The model FLOPs' least time at the peaks over the traced window's
    wall time a unit, in %."""
    if r.trace is None or r.flops is None or not r.trace_units:
        return None
    return 100.0 * counts.peak_seconds(r.flops) * r.trace_units / r.trace["window_s"]
