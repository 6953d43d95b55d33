"""The union of time intervals: the device's busy time in a profiler trace.

``train/loop.py`` reads a live profiler window through :func:`busy_us`, and
``tools/analyze_trace.py`` an exported trace, so both count a copy under a
kernel once.
"""
from __future__ import annotations


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    us, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            us, end = us + hi - lo, hi
        elif hi > end:
            us, end = us + hi - end, hi
    return us
