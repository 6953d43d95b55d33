"""Spans of the port's host path, on the device trace's clock.

Tracing is on exactly while a ``torch.profiler`` records on the calling
thread (``torch.autograd._profiler_enabled()``: the benchmark's
``--trace 1`` window, ``train_net --profile``, ``tools/profile_eval``);
there is no other switch.  On, :func:`span` opens a
``torch.profiler.record_function`` named ``"nvr." + name`` (a profiler
event, so it lies on the device trace's own clock) and keeps the span in
a bounded buffer, timed by ``time.perf_counter_ns``; off, it returns one
shared no-op object and costs the one check.

The profiler is thread-local: it records nothing of a thread it was not
started on (the Prefetcher's workers and stager).  Such a thread times its
own work, and the consumer that takes the work adds the span with
:func:`record`, under the consumer's gate, so the span falls in the window
that consumes it.  :func:`add_to_chrome_trace` writes those spans into an
exported trace, on the trace's clock.

A span is :class:`Span`: ``parent`` is the name of the span that enclosed
it on its thread, ``unit`` the identifier the spans of one step or frame
share (the state's step, the item's frame and camera, the feed position).
Counters are attributes of the objects that count (``Prefetcher.built``,
``DeviceStager.bytes``, ``CapturedStep.fill_bytes``, ...), not kept here.
"""
from __future__ import annotations

import collections
import json
import statistics
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

from .intervals import busy_us

PREFIX = "nvr."
# spans kept; the oldest go first
CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    unit: object
    thread: str


_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_local = threading.local()


def _stack() -> List[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Open:
    __slots__ = ("name", "unit", "rf", "parent", "start")

    def __init__(self, name: str, unit):
        self.name, self.unit = name, unit

    def __enter__(self):
        self.rf = torch.profiler.record_function(
            PREFIX + self.name, None if self.unit is None else str(self.unit))
        self.rf.__enter__()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        _buffer.append(Span(self.name, self.start, end, self.parent, self.unit,
                            threading.current_thread().name))
        self.rf.__exit__(*exc)
        return False


def span(name: str, unit=None):
    """A context manager: the span ``name`` (recorded only while a profiler
    records on this thread; otherwise the shared no-op :data:`NOOP`)."""
    if not torch.autograd._profiler_enabled():
        return NOOP
    return _Open(name, unit)


def untimed(name: str, unit=None):
    """:func:`span`'s stand-in for code that also runs inside a captured
    region, where no span may go: always :data:`NOOP`."""
    return NOOP


def record(name: str, start_ns: int, end_ns: int, unit=None,
           thread: Optional[str] = None) -> None:
    """Add a span that ``thread`` (default this one) timed with
    ``time.perf_counter_ns``, under this thread's gate."""
    if torch.autograd._profiler_enabled():
        _buffer.append(Span(name, int(start_ns), int(end_ns), None, unit,
                            thread or threading.current_thread().name))


def spans() -> List[Span]:
    """The buffer's spans, oldest first."""
    return list(_buffer)


def clear() -> None:
    _buffer.clear()


def self_ns(name: str, buf: Optional[Iterable[Span]] = None) -> int:
    """Nanoseconds of the spans named ``name`` (in ``buf``, default the
    buffer) less what their children on the same thread cover."""
    buf = spans() if buf is None else list(buf)
    total = 0
    for s in buf:
        if s.name != name:
            continue
        kids = [(c.start_ns, c.end_ns) for c in buf
                if c.parent == name and c.thread == s.thread and c is not s
                and s.start_ns <= c.start_ns and c.end_ns <= s.end_ns]
        total += (s.end_ns - s.start_ns) - int(busy_us(kids))
    return total


def host_spans(events: List[Dict]) -> List[Dict]:
    """A Chrome trace's ``nvr.`` spans on the host (the profiler's
    ``user_annotation`` events; their copies drawn on the device timeline,
    ``gpu_user_annotation``, left out)."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(PREFIX)]


def trace_offset_ns(events: List[Dict], buf: Iterable[Span]) -> Optional[float]:
    """The trace's clock less ``perf_counter_ns``, in ns: the median over
    the spans that both the buffer and the trace's ``nvr.`` events hold
    (the k-th of a name in each, where both hold as many), or None."""
    by_trace: Dict[str, List[float]] = collections.defaultdict(list)
    for e in host_spans(events):
        by_trace[e["name"][len(PREFIX):]].append(float(e["ts"]))
    by_buf: Dict[str, List[int]] = collections.defaultdict(list)
    for s in buf:
        by_buf[s.name].append(s.start_ns)
    diffs = []
    for name, starts in by_buf.items():
        ts = by_trace.get(name, [])
        if len(ts) == len(starts):
            diffs += [1e3 * t - s for t, s in zip(sorted(ts), sorted(starts))]
    return statistics.median(diffs) if diffs else None


def add_to_chrome_trace(path: str, buf: Optional[Iterable[Span]] = None) -> int:
    """Write the spans that the profiler could not record (those whose name
    the trace at ``path`` does not hold: the worker threads' ``item.build``
    and ``item.stage``) into it, on the trace's clock (:func:`trace_offset_ns`),
    one thread row each; returns how many were written (0 when no span
    places the clocks)."""
    buf = spans() if buf is None else list(buf)
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    host = host_spans(events)
    traced = {e["name"] for e in host}
    extra = [s for s in buf if PREFIX + s.name not in traced]
    off = trace_offset_ns(events, [s for s in buf if PREFIX + s.name in traced])
    if not extra or off is None:
        return 0
    pid = host[0]["pid"]
    tids: Dict[str, int] = {}
    for s in extra:
        if s.thread not in tids:
            tids[s.thread] = tid = 1_000_000 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": f"nvr worker {s.thread}"}})
        events.append({"ph": "X", "cat": "user_annotation", "name": PREFIX + s.name,
                       "pid": pid, "tid": tids[s.thread],
                       "ts": (s.start_ns + off) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"unit": str(s.unit), "worker": True}})
    with open(path, "w") as f:
        json.dump(data, f)
    return len(extra)
