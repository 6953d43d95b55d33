"""The benchmark's reading of a ``torch.profiler`` window: device busy time
as the union of the kernels' and copies' intervals (a copy under a kernel
counts once; the annotation ranges drawn on the device timeline are left
out), device time by kernel name, and the idle gaps of the device labelled
by the harness's host span that was open when each began.

:func:`busy_us` is the union of intervals (the port's
``utils/intervals.py:busy_us``, copied); :func:`summarize` reads the
profiler's events.  The window is the host span named :data:`WINDOW`,
which the traffic kinds open around the traced steps or frames.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "nvrbench.window"
# an idle stretch of the device shorter than this is launch spacing, not a gap
MIN_GAP_US = 5.0
TOP = 10


def merge_intervals(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merge_intervals(intervals))


def gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no merged interval covers."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_gaps(idle: Sequence[Tuple[float, float]],
               spans: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle microseconds by the innermost host span open at each gap's start
    ('other' where none is)."""
    out: Dict[str, float] = {}
    for s, e in idle:
        if e - s < MIN_GAP_US:
            continue
        open_ = [(a, b, n) for a, b, n in spans if a <= s < b and n != WINDOW]
        name = min(open_, key=lambda x: x[1] - x[0])[2] if open_ else "other"
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def summarize(events, prefix: str = "nvrbench.") -> Optional[Dict]:
    """The window's numbers from a profiler's ``events()``: ``busy_s``,
    ``window_s``, ``kernel_s`` (device seconds by kernel name),
    ``device_ops`` and ``idle_gaps`` (the ten largest, as [name, seconds]);
    None when the trace holds no window span or no device event in it."""
    from torch.autograd import DeviceType
    dev, spans = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end, e.name))
        elif e.name.startswith(prefix):
            spans.append((tr.start, tr.end, e.name))
    win = [(s, t) for s, t, n in spans if n == WINDOW]
    if not win:
        return None
    lo, hi = win[0]
    inside = [(max(s, lo), min(t, hi), n) for s, t, n in dev if t > lo and s < hi]
    if not inside:
        return None
    merged = merge_intervals((s, t) for s, t, _ in inside)
    kernel: Dict[str, float] = {}
    for s, t, n in inside:
        kernel[n] = kernel.get(n, 0.0) + (t - s) / 1e6
    idle = label_gaps(gaps(merged, lo, hi), spans)
    top = sorted(kernel.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(t - s for s, t in merged) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "kernel_s": kernel,
            "device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v / 1e6] for n, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}


def kernel_seconds(summary: Dict, *patterns: str) -> float:
    """Device seconds of the kernels whose name matches any of ``patterns``
    (regular expressions, ``re.search``; a plain name matches where it
    occurs)."""
    import re
    rx = [re.compile(p) for p in patterns]
    return sum(v for n, v in summary["kernel_s"].items()
               if any(x.search(n) for x in rx))


def profile(device):
    """A ``torch.profiler.profile`` of the host and, on the card, the device."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
