"""Benchmark of the port: train-step throughput of the flagship (inb_377),
under the protocol and JSON keys of the repo's ``bench.py``.

    python -m instant_nvr_tpu_torch.bench [--device cuda] \
        [--cfg_file configs/inb/inb_377.yaml] [--tiny] [--eager]

Two modes, ``BENCH_MODE=mse|patch|both`` (default both):
  - ``mse``: the ``N_rand`` (1,024) ray MSE step on the fixed synthetic
    batch of ``train_net.synthetic_batch`` (1,200 vertices, a 32^3 pose
    volume, a 128x128 view), from seed-0 weights;
  - ``patch``: the flagship's real training mode, one ``patch_size``^2
    (64x64 = 4,096) ray patch of that scene with ``ray_mask`` all ones,
    through ``train/loop.py:make_patch_loss_fn`` (LPIPS at inb_377's
    widths), from the same seed-0 weights, rebuilt after the MSE state is
    freed.
The step takes ``train/compiled.py:step_route``'s route: on the card the
captured step (``CapturedStep``: the step replayed as a CUDA graph, as the
root ``bench.py`` times a jitted step), ``--eager`` the eager one.  Each
mode takes ``WARMUP_STEPS`` steps (on the captured route the graph's eager
warm-up, and ``CAPTURE_STEPS`` more: its capture and first replay, as
``bench.py``'s warm-up holds the jit's compile), then, when ``BENCH_TRACE`` (the
MSE mode) or ``BENCH_TRACE_PATCH`` (the patch mode) names a directory, a
``TRACE_STEPS``-step ``torch.profiler`` window exported there as a Chrome
trace (``python -m instant_nvr_tpu_torch.tools.analyze_trace <dir>`` reads
it), then :func:`measure`: ``WINDOWS`` windows of ``STEPS_PER_WINDOW``
steps, each on the host clock and ended by ``torch.cuda.synchronize()``;
the median window's rays/s with the min and max.  Step ``i`` of each run
draws from one generator reseeded with ``i % 8``, as ``bench.py`` cycles 8
keys.

Before the last line, each mode prints its ms per step, peak device
memory, table-gradient routes per step and kernel launches; on the card a
mode raises unless every step launched ``knn_blend`` once and each table
gradient's kernel as ``train/step.py:table_grad_launches`` routes it.  The
last line is one JSON object with ``bench.py``'s keys (under
``BENCH_MODE=patch`` the patch rate is the primary metric,
``train_patch_rays_per_sec``) plus ``device`` (the card's name, or
``"cpu"``), ``power_limit`` (from ``nvidia-smi``; null on the CPU),
``route`` (``captured`` or ``eager``) and ``captures`` (the graphs the
modes captured).

The device defaults to ``cuda`` and a missing card is an error;
``--device cpu --tiny`` runs the plain versions at the CPU tests' widths,
and its rates are the CPU's.  ``bench.py``'s retry and re-exec on a
failure are not ported: a failed run raises.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import run, train_net
from .config import make_cfg
from .models import inb
from .ops import knn, scatter
from .renderer.inb_renderer import RenderSpec, make_render_spec
from .train.compiled import CapturedStep, step_route
from .train.loop import make_patch_loss_fn
from .train.state import TrainState, create_train_state
from .train.step import (LossWeights, make_loss_weights, make_train_step,
                         table_grad_launches)

BASELINE_RAYS_PER_SEC = 10240.0      # bench.py:21 (BASELINE.md)
WARMUP_STEPS = 3
CAPTURE_STEPS = 1                    # the captured route's capture, after the warm-up
TRACE_STEPS = 5
WINDOWS = 5
STEPS_PER_WINDOW = 20
N_SEEDS = 8                          # bench.py's rngs[i % 8]
MODES = ("mse", "patch", "both")


class Flagship(NamedTuple):
    """``__graft_entry__._flagship``'s tuple: the config, its specs, the
    loss weights and the MSE batch as host arrays and as tensors."""
    cfg: object
    mspec: inb.ModelSpec
    rspec: RenderSpec
    lw: LossWeights
    batch_np: Dict[str, np.ndarray]
    batch: Dict[str, torch.Tensor]


def flagship(cfg_file: str = "configs/inb/inb_377.yaml",
             device: torch.device | str = "cuda", tiny: bool = False) -> Flagship:
    """The flagship config (``tiny``: at the CPU tests' widths) and its
    fixed ``N_rand``-ray synthetic batch on ``device``."""
    cfg = make_cfg(cfg_file)
    if tiny:
        cfg = cfg.merged(train_net.TINY)
    batch_np = train_net.synthetic_batch_np(cfg, tiny)
    return Flagship(cfg, inb.build_model_spec(cfg), make_render_spec(cfg),
                    make_loss_weights(cfg), batch_np,
                    train_net.to_tensors(batch_np, torch.device(device)))


def patch_batch_np(cfg) -> Dict[str, np.ndarray]:
    """One ``patch_size``^2 ray patch of the full synthetic scene, every ray
    in the mask (``bench.py:96-100``, at any width)."""
    n = cfg.patch_size ** 2
    batch = train_net.synthetic_batch_np(cfg, n_rays=n)
    batch["ray_mask"] = np.ones(n, np.float32)
    return batch


def new_state(cfg, device: torch.device) -> TrainState:
    """A train state from the seed-0 weights (``run.build``)."""
    return create_train_state(cfg, run.build(cfg, device, seed=0)[2])


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seeded_steps(step, state: TrainState, batch: Dict[str, torch.Tensor],
                 gen: torch.Generator, n: int,
                 losses: Optional[List[torch.Tensor]] = None) -> None:
    """``n`` steps; step ``i`` draws from ``gen`` reseeded with ``i % 8`` (a
    host call: nothing waits for the device).  Appends a copy of each loss
    (a captured step's is its graph's output, which the next replay
    overwrites)."""
    for i in range(n):
        gen.manual_seed(i % N_SEEDS)
        _, stats = step(state, batch, generator=gen)
        if losses is not None:
            losses.append(stats["loss"].clone())


def measure(step, state: TrainState, batch: Dict[str, torch.Tensor],
            gen: torch.Generator,
            losses: Optional[List[torch.Tensor]] = None) -> List[float]:
    """``bench.py:_measure``: the rays/s of ``WINDOWS`` windows of
    ``STEPS_PER_WINDOW`` steps each, sorted.  A window is timed on the host
    clock from its first step to a device synchronize after its last."""
    device = batch["ray_o"].device
    n_rays = int(batch["ray_o"].shape[0])
    rates = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        seeded_steps(step, state, batch, gen, STEPS_PER_WINDOW, losses)
        synchronize(device)
        rates.append(STEPS_PER_WINDOW * n_rays / (time.perf_counter() - t0))
    rates.sort()
    return rates


def trace_window(step, state: TrainState, batch: Dict[str, torch.Tensor],
                 gen: torch.Generator, out_dir: str, name: str,
                 losses: List[torch.Tensor]) -> str:
    """``TRACE_STEPS`` steps under ``torch.profiler``; returns the path of
    the Chrome trace written into ``out_dir``."""
    device = batch["ray_o"].device
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        seeded_steps(step, state, batch, gen, TRACE_STEPS, losses)
        synchronize(device)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"bench_{name}.json")
    prof.export_chrome_trace(path)
    return path


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters (``exact``: ``index_add_`` calls), keyed
    by the routes of ``table_grad_launches``."""
    return {"knn_blend": knn.knn_blend.launches,
            "segmented": scatter.segmented_scatter_add.launches,
            "onehot": scatter.onehot_scatter_add.launches,
            "sorted": scatter.sorted_scatter_add.launches,
            "exact": scatter.exact_scatter_add.calls}


def check_launches(launches: Dict[str, int], routes, steps: int) -> None:
    """Raise unless ``launches`` are one ``knn_blend`` a step and each
    table-gradient route's per-step count times ``steps`` (a captured
    step's replays count the launches its graph holds)."""
    want = {k: steps * routes.get(k, 0) for k in launches}
    want["knn_blend"] = steps
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want} ({steps} steps, "
                           f"routes per step {dict(routes)})")


def run_mode(name: str, fl: Flagship, batch: Dict[str, torch.Tensor],
             patch_loss_fn, trace_dir: str, eager: bool = False
             ) -> Tuple[List[float], int]:
    """Warm-up, the optional trace window and :func:`measure` for one mode,
    on a fresh seed-0 state that is freed on return, on ``step_route``'s
    route; returns the sorted window rates and the graphs captured."""
    device = batch["ray_o"].device
    cuda = device.type == "cuda"
    routes = table_grad_launches(fl.mspec, fl.rspec)
    state = new_state(fl.cfg, device)
    route = step_route(fl.cfg, device, eager)
    warmup = WARMUP_STEPS + (CAPTURE_STEPS if route.name == "captured" else 0)
    n_steps = warmup + TRACE_STEPS + WINDOWS * STEPS_PER_WINDOW
    step = (CapturedStep(fl.mspec, fl.rspec, fl.lw, patch_loss_fn, n_steps=n_steps)
            if route.name == "captured"
            else make_train_step(fl.mspec, fl.rspec, fl.lw, patch_loss_fn))
    gen = torch.Generator(device=device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    losses: List[torch.Tensor] = []
    seeded_steps(step, state, batch, gen, warmup, losses)
    synchronize(device)
    trace = (trace_window(step, state, batch, gen, trace_dir, name, losses)
             if trace_dir else None)
    rates = measure(step, state, batch, gen, losses)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    loss = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(loss).all():
        raise RuntimeError(f"{name}: non-finite loss at steps "
                           f"{np.nonzero(~np.isfinite(loss))[0].tolist()}")
    if cuda:
        check_launches(launches, routes, len(losses))
    n_rays = int(batch["ray_o"].shape[0])
    median = rates[len(rates) // 2]
    print(f"[bench-{name}] rays={n_rays} samples={fl.rspec.n_samples} "
          f"steps={len(losses)} ms_per_step={1000 * n_rays / median:.2f} "
          f"rays_per_sec={median:.1f} min={rates[0]:.1f} max={rates[-1]:.1f} "
          f"peak_mem_GB={'not measured' if peak is None else f'{peak / 1e9:.3f}'} "
          f"routes_per_step={dict(routes)} launches={launches} "
          f"loss_first={loss[0]:.5f} loss_last={loss[-1]:.5f} trace={trace} "
          f"route={route.name!r} captures={getattr(step, 'captures', 0)}",
          flush=True)
    return rates, getattr(step, "captures", 0)


def card_line(device: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or None on the
    CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _rate_keys(metric: str, rates: List[float]) -> dict:
    median = rates[len(rates) // 2]
    return {"metric": metric, "value": round(median, 1), "unit": "rays/s",
            "vs_baseline": round(median / BASELINE_RAYS_PER_SEC, 3),
            "windows": WINDOWS, "steps_per_window": STEPS_PER_WINDOW,
            "min": round(rates[0], 1), "max": round(rates[-1], 1)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.bench")
    p.add_argument("--cfg_file", default="configs/inb/inb_377.yaml")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="the CPU tests' widths (with --device cpu)")
    p.add_argument("--eager", action="store_true",
                   help="time the eager step, not the captured one")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the modes of ``BENCH_MODE``; prints and returns the last line."""
    args = parse_args(argv)
    mode = os.environ.get("BENCH_MODE", "both")
    if mode not in MODES:
        raise ValueError(f"BENCH_MODE={mode!r}: one of {MODES}")
    device = run.resolve_device(args.device)
    fl = flagship(args.cfg_file, device, args.tiny)
    out, captures = {}, 0
    if mode in ("both", "mse"):
        rates, n = run_mode("mse", fl, fl.batch, None,
                            os.environ.get("BENCH_TRACE", ""), args.eager)
        captures += n
        out.update(_rate_keys("train_rays_per_sec", rates))
        gc.collect()                     # the MSE state, before the patch one
    if mode in ("both", "patch"):
        pbatch = train_net.to_tensors(patch_batch_np(fl.cfg), device)
        rates, n = run_mode("patch", fl, pbatch, make_patch_loss_fn(fl.cfg),
                            os.environ.get("BENCH_TRACE_PATCH", ""), args.eager)
        captures += n
        if mode == "patch":              # the patch rate is the primary metric
            out.update(_rate_keys("train_patch_rays_per_sec", rates))
        else:
            keys = _rate_keys("", rates)
            out.update({"train_rays_per_sec_patch": keys["value"],
                        "patch_min": keys["min"], "patch_max": keys["max"],
                        "vs_baseline_patch": keys["vs_baseline"]})
    card = card_line(device)
    if card is not None:
        print(card)
    out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out["power_limit"] = card.split(",")[-1].strip() if card else None
    out["route"] = step_route(fl.cfg, device, args.eager).name
    out["captures"] = captures
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
