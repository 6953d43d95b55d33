"""Profile one full-image eval render (port of ``tools/profile_eval.py``).

    python -m instant_nvr_tpu_torch.tools.profile_eval --cfg_file configs/inb/inb_fake.yaml \\
        [--item 0] [--trace DIR] [--eager] [key value ...]

Loads the weights of ``trained_model_dir`` (a random model, with a warning,
when there are none), renders one test item through
:class:`AutoBudgetRenderer` once to settle the budgets (and the caches),
then again inside a ``torch.profiler`` window, and prints the warm wall ms,
the device ms (the union of the device intervals of the kernels and copies,
``train/loop.py:_device_seconds``), the busy share (device / wall), the
device's copies and fills by name (``Memcpy HtoD (Pageable -> Device)``:
from pageable host memory) and the ten device kernels with the most time.  The frame takes
``eval/runner.py:frame_route``'s route: captured as a CUDA graph on the
card (the settling render also warms it up; the profiled one captures and
replays it the first time, so a third render is profiled), ``--eager``
the Python loop.  ``--trace DIR`` also writes the
window's Chrome trace.  The device defaults to ``cuda``; on the CPU
(``--device cpu``) the trace holds no device time and the device numbers
read "not measured".
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import torch


def top_kernels(prof, n: int = 10):
    """[(kernel name, device ms, calls)] of the ``n`` device kernels with
    the most time in a profiler window (annotations left out)."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            rows.append((us / 1000.0, e.count, e.key))
    rows.sort(reverse=True)
    return [(name, ms, count) for ms, count, name in rows[:n]]


def copies(prof) -> Dict[str, int]:
    """The device's copies and fills in a profiler window, by name (``Memcpy
    HtoD (Pageable -> Device)`` for a copy from pageable host memory)."""
    from torch.autograd import DeviceType
    out: Dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name.startswith(("Memcpy", "Memset")):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def profile_item(renderer, model, item: Dict, trace: Optional[str] = None) -> Dict:
    """Render ``item`` until the budgets settle and a captured renderer has
    captured its graph, then once more inside a profiler window -> {rays,
    warm_ms, device_ms, busy, copies, top}; ``device_ms`` and
    ``busy`` are None when the trace holds no device time."""
    from ..train.loop import _device_seconds
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    renderer(model, item)
    if renderer.captured:
        renderer(model, item)            # the capture, after the warm-up
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        renderer(model, item)            # host arrays: the device is done
        sync()
        wall = time.perf_counter() - t0
    if trace:
        os.makedirs(trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace, "trace.json"))
    dev = _device_seconds(prof.events())
    return {"rays": int(item["ray_o"].shape[0]), "warm_ms": 1000.0 * wall,
            "device_ms": None if dev is None else 1000.0 * dev,
            "busy": None if dev is None else dev / wall,
            "copies": copies(prof), "top": top_kernels(prof)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.tools.profile_eval")
    p.add_argument("--cfg_file", default="configs/inb/inb_fake.yaml")
    p.add_argument("--item", type=int, default=0)
    p.add_argument("--trace", default="", help="directory for the Chrome trace")
    p.add_argument("--device", default="cuda")
    p.add_argument("--eager", action="store_true",
                   help="render op by op from Python, not as a captured CUDA graph")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    from ..config import make_cfg
    from ..datasets.tpose_dataset import TPoseDataset
    from ..eval.runner import AutoBudgetRenderer, budgets_path, eval_chunk, frame_route
    from ..run import load, resolve_device
    cfg = make_cfg(args.cfg_file, args.opts).replace(eval=True)
    device = resolve_device(args.device)
    mspec, rspec, model = load(cfg, device)
    item = TPoseDataset(cfg, "test").get_item(args.item)
    route = frame_route(device, args.eager)
    renderer = AutoBudgetRenderer(mspec, rspec, eval_chunk(cfg),
                                  persist_path=budgets_path(cfg),
                                  captured=route.name == "captured")
    r = profile_item(renderer, model, item, args.trace or None)
    fmt = lambda v, f: "not measured" if v is None else f.format(v)
    print(f"warm render: {r['warm_ms']:.1f} ms for {r['rays']} rays "
          f"({r['rays'] / (r['warm_ms'] / 1000.0):.0f} rays/s) on {device}")
    print(f"device: {fmt(r['device_ms'], '{:.1f} ms')}, busy "
          f"{fmt(r['busy'], '{:.3f}')}, route {route}")
    print(f"copies and fills: {r['copies']}")
    for name, ms, count in r["top"]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:90]}")


if __name__ == "__main__":
    main()
