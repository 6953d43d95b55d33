"""Summarise a torch.profiler Chrome trace: device time bucketed by kernel
(port of ``tools/analyze_trace.py``, which reads a jax.profiler trace).

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
events (a CPU run) reports that and no share.  Host-only: it reads a file.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, Optional

from ..utils.intervals import busy_us

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def summarize(path: str, top_k: int = 25) -> Dict[str, Optional[float]]:
    """Print the summary of the trace at ``path``; returns its numbers:
    ``device_ms`` (union), ``span_ms``, ``busy`` and ``buckets`` {name: ms}."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in complete if e.get("cat") in DEVICE_CATS]
    print(f"trace: {path}")
    if not device:
        print("no device events (a CPU trace): device time and busy share not measured")
        return {"device_ms": None, "span_ms": None, "busy": None, "buckets": {}}
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
    return {"device_ms": dev_ms, "span_ms": span_ms, "busy": dev_ms / span_ms,
            "buckets": dict(buckets)}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    summarize(find_trace(argv[0]), int(argv[1]) if len(argv) > 1 else 25)


if __name__ == "__main__":
    main()
