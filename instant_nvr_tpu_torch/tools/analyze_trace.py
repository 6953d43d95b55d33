"""Summarise a torch.profiler Chrome trace: device time bucketed by kernel
(port of ``tools/analyze_trace.py``, which reads a jax.profiler trace),
host time by the port's ``nvr.`` spans, and the device's idle gaps by the
span they fall under.

    python -m instant_nvr_tpu_torch.tools.analyze_trace <trace or dir> [top_k]

``<trace or dir>`` is a Chrome trace (``.json`` or ``.json.gz``) that
``torch.profiler`` exported, or a directory searched for the newest one,
such as ``<record_dir>/profile`` where ``train/loop.py``'s profiler window
writes ``trace.json``.  The device's complete events (kernels, memcpy and
memset; the annotations drawn on the device timeline left out) are
bucketed by a normalised name (``void ns::kernel<...>(...)`` ->
``ns::kernel``; copies and sets keep their whole name), and the top
``top_k`` print with their total ms and share.  The busy share is the
union of those events' intervals (a copy under a kernel counts once;
``train/loop.py:_device_seconds`` counts a live window the same way) over
the trace's span (its
first event's start to its last event's end).  A trace without device
events (a CPU run) reports that and no share.

Two tables read the ``nvr.`` spans (``utils/telemetry.py``; the worker
threads' ``item.build`` / ``item.stage`` are in a trace that
``train/loop.py`` wrote): host ms by span, total and self (less its
child spans on the same thread), in all and a unit (the trace's ``step``
or ``frame`` spans); and the device's idle time, each gap of at least
:data:`MIN_GAP_US` labelled by the innermost ``nvr.`` span of the
profiled threads open at its start (``other`` where none is; the rule of
``nvrbench/trace.py:label_gaps``), with the first gap and the shorter
gaps' total beside it.  Host-only: it reads a file.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional

from ..utils.intervals import busy_us
from ..utils.telemetry import PREFIX, host_spans

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# an idle stretch of the device shorter than this is launch spacing
MIN_GAP_US = 5.0
UNIT_SPANS = (PREFIX + "step", PREFIX + "frame")


def find_trace(root: str) -> str:
    if os.path.isfile(root):
        return root
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(root, "**", pat), recursive=True)]
    if not paths:
        raise SystemExit(f"no *.json or *.json.gz trace under {root}")
    return max(paths, key=os.path.getmtime)


def normalize(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters; copies and sets as they are."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"^void\s+", "", name.strip())
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def span_table(events: List[Dict]) -> Dict[str, Dict[str, float]]:
    """{span name: count, total_ms, self_ms} of the trace's ``nvr.`` host
    spans; a span's self time is its duration less its children's on the
    same thread (the spans of one thread nest)."""
    rows: Dict[str, Dict[str, float]] = {}
    by_thread = collections.defaultdict(list)
    for e in host_spans(events):
        by_thread[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for spans in by_thread.values():
        spans.sort(key=lambda x: (x[0], -x[1]))
        stack: List[list] = []          # [end, name, children's us, us]
        done = []

        def close(until: float) -> None:
            while stack and stack[-1][0] <= until:
                done.append(stack.pop())

        for s, e, name in spans:
            close(s)
            if stack:
                stack[-1][2] += e - s
            stack.append([e, name, 0.0, e - s])
        close(float("inf"))
        for _, name, kids, dur in done:
            r = rows.setdefault(name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            r["count"] += 1
            r["total_ms"] += dur / 1e3
            r["self_ms"] += (dur - kids) / 1e3
    return rows


def label_gaps(events: List[Dict], lo: float, hi: float) -> Dict:
    """The device's idle stretches in [lo, hi) (us): ``labels`` {innermost
    ``nvr.`` span of the profiled threads open at the gap's start, or
    'other': ms} over the gaps of at least :data:`MIN_GAP_US`, ``first``
    (label, ms) of the first such gap, ``short_ms`` / ``short_n`` of
    the shorter gaps and ``idle_ms`` of all."""
    merged: List[List[float]] = []
    for s, e in sorted((float(x["ts"]), float(x["ts"]) + float(x["dur"]))
                       for x in events if x.get("ph") == "X" and x.get("cat") in DEVICE_CATS):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    spans = [(float(x["ts"]), float(x["ts"]) + float(x["dur"]), x["name"])
             for x in host_spans(events) if not x.get("args", {}).get("worker")]

    def label(at: float) -> str:
        open_ = [(a, b, n) for a, b, n in spans if a <= at < b]
        return min(open_, key=lambda x: x[1] - x[0])[2] if open_ else "other"

    out = {"labels": {}, "first": None, "short_ms": 0.0, "short_n": 0,
           "idle_ms": sum(e - s for s, e in gaps) / 1e3}
    for s, e in gaps:
        if e - s < MIN_GAP_US:
            out["short_ms"] += (e - s) / 1e3
            out["short_n"] += 1
            continue
        name = label(s)
        out["labels"][name] = out["labels"].get(name, 0.0) + (e - s) / 1e3
        if out["first"] is None:
            out["first"] = (name, (e - s) / 1e3)
    return out


def summarize(path: str, top_k: int = 25) -> Dict[str, Optional[float]]:
    """Print the summary of the trace at ``path``; returns its numbers:
    ``device_ms`` (union), ``span_ms``, ``busy``, ``buckets`` {name: ms},
    ``spans`` (:func:`span_table`, with ``units``) and ``gaps``
    (:func:`label_gaps`; None without device events)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    # the spans train/loop.py placed from worker threads may start before
    # the profiler did: the trace's span is the profiler's events'
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e
                and not e.get("args", {}).get("worker")]
    device = [e for e in complete if e.get("cat") in DEVICE_CATS]
    print(f"trace: {path}")
    host = span_table(events)
    units = max([host[n]["count"] for n in UNIT_SPANS if n in host] or [0])
    print_spans(host, units)
    if not device:
        print("no device events (a CPU trace): device time and busy share not measured")
        return {"device_ms": None, "span_ms": None, "busy": None, "buckets": {},
                "spans": host, "units": units, "gaps": None}
    buckets = collections.Counter()
    for e in device:
        buckets[normalize(e.get("name", "?"))] += float(e["dur"]) / 1e3
    total = sum(buckets.values())
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    lo = min(float(e["ts"]) for e in complete)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in complete)
    dev_ms, span_ms = busy_us(spans) / 1e3, (hi - lo) / 1e3
    print(f"device time: {total:.3f} ms in {len(device)} events "
          f"({dev_ms:.3f} ms busy, overlaps once) over a {span_ms:.3f} ms span: "
          f"busy share {dev_ms / span_ms:.3f}")
    for name, ms in buckets.most_common(top_k):
        print(f"  {ms:9.3f} ms  {100 * ms / total:5.1f}%  {name}")
    gaps = label_gaps(events, lo, hi)
    print_gaps(gaps)
    return {"device_ms": dev_ms, "span_ms": span_ms, "busy": dev_ms / span_ms,
            "buckets": dict(buckets), "spans": host, "units": units, "gaps": gaps}


def print_spans(spans: Dict[str, Dict[str, float]], units: int) -> None:
    if not spans:
        print("no nvr. spans (the profiler window ran none of the port's spans)")
        return
    per = f"a unit ({units} step or frame spans)" if units else "a unit (none)"
    print(f"host ms by nvr. span: count, total, self; total and self {per}")
    for name, r in sorted(spans.items(), key=lambda kv: -kv[1]["total_ms"]):
        unit = (f"{r['total_ms'] / units:9.3f} {r['self_ms'] / units:9.3f}" if units
                else "")
        print(f"  {name:24s} {r['count']:6d} {r['total_ms']:10.3f} "
              f"{r['self_ms']:10.3f}  {unit}")


def print_gaps(gaps: Dict) -> None:
    print(f"device idle {gaps['idle_ms']:.3f} ms; gaps of {MIN_GAP_US:g} us or more "
          f"by the nvr. span open at their start:")
    for name, ms in sorted(gaps["labels"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {name}")
    if gaps["first"] is not None:
        print(f"  first gap: {gaps['first'][1]:.3f} ms under {gaps['first'][0]}")
    print(f"  shorter gaps: {gaps['short_ms']:.3f} ms in {gaps['short_n']}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    summarize(find_trace(argv[0]), int(argv[1]) if len(argv) > 1 else 25)


if __name__ == "__main__":
    main()
