"""Rendering a trained subject: the program's ``AutoBudgetRenderer`` on its
captured route (``CapturedFrame``) renders ``n_items`` test items in turn,
as ``eval/runner.py:evaluate_dataset`` renders the test split: a frame is
the item's rays to the card, every chunk, the maps back on the host.  The
items (``n_items`` of the test split's ``FrameSampler`` items, the same for
every seed, in a seeded order) are built in set-up, and set-up renders them until the
budgets cover every item and each frame's shape has its graph; a re-render
in the window counts as window work and is printed on an earlier line.

The check: once the window has closed, ``n_check`` frames of the window,
drawn from the seed, are rendered again by the reference (the port's plain
route, frozen) on items it builds from the subject's files itself, in
chunks of ``ref_chunk`` rays with budgets that keep every sample; the
number compared is the worst frame's root-mean-square gap over the colour
and opacity maps (``map_rms_gap``).

Parameters (``nvrbench/workloads/<cell>.yaml``): ``n_items``, ``n_check``,
``ref_chunk``, ``trace_start``, ``trace_frames`` and the check's ``limits``.
"""
from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .. import common, counts, fitcore
from .. import trace as tr

MAP_KEYS = ("rgb_map", "acc_map")
RAY_KEYS = ("ray_o", "ray_d", "near", "far")
META_KEYS = ("A", "big_A", "pbw", "pbw_sizes", "pbounds", "tbounds", "tuv",
             "tuv_sizes", "part_pts", "part_pbw", "lengths2", "part_bounds",
             "R", "Th", "latent_index", "frame_dim")
# a frame's maps altered where they are produced (the fault test)
FAULTS = ("altered_maps",)


def choose_items(ds, cfg, seed: int, n: int) -> List[int]:
    """``n`` of the test split's FrameSampler items, evenly spaced over it,
    in an order drawn from the seed: every seed renders the same items."""
    from instant_nvr_tpu_torch.datasets.samplers import FrameSampler
    interval = cfg.test.get("frame_sampler_interval", 1)
    pool = list(FrameSampler(len(ds), ds.num_cams, interval))
    n = min(n, len(pool))
    items = [pool[(i * len(pool)) // n] for i in range(n)]
    return [items[i] for i in common.rng(seed, "frames").permutation(n)]


def graphs_ready(renderer) -> bool:
    """Whether every frame shape the captured renderer has seen has its graph."""
    fn = renderer.render_fn
    graphs = getattr(fn, "graphs", None)
    return graphs is None or all(g.graph is not None for g in graphs.values())


def warm(renderer, model, items) -> int:
    """Render the items in passes until a pass neither raises the budgets
    nor captures and every shape has its graph; returns the passes.  A raise
    sizes the budgets to the item that overflowed, so the order of the
    items sets the budgets: the caller gives them in a fixed order."""
    for n in range(1, 8):
        fn, caps = renderer.render_fn, getattr(renderer.render_fn, "captures", 0)
        for item in items:
            renderer(model, item)
        if (renderer.render_fn is fn and getattr(fn, "captures", 0) == caps
                and graphs_ready(renderer)):
            return n
    raise RuntimeError("the renderer kept raising budgets or capturing after 7 passes")


def reference_frame(cfg_path: str, ctx, weights, index: int,
                    control: str = "") -> Dict[str, np.ndarray]:
    """The reference's maps of test item ``index``: the item built from the
    subject's files, rendered in chunks with budgets that keep every sample."""
    from ..reference.datasets.tpose_dataset import TPoseDataset
    from ..reference.models import inb
    from ..reference.renderer.inb_renderer import make_render_spec, render_rays
    device = ctx.device
    cfg = common.reference_config(cfg_path, control).merged(
        {"cull_budget": 1.0, "part_budget": 1.0,
         "part_budget_scales": [1.0] * 5})
    spec = inb.build_model_spec(cfg)
    rspec = make_render_spec(cfg)
    model = inb.InbModel(spec, device)
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    item = TPoseDataset(cfg, "test").get_item(index)
    meta = {k: torch.from_numpy(np.ascontiguousarray(item[k])).to(device)
            for k in META_KEYS if k in item}
    chunk = int(ctx.workload["ref_chunk"])
    n = item["ray_o"].shape[0]
    # whole chunks, the last one filled with the first rays again (a budget
    # rounds up to 128 samples, which a short chunk may not hold)
    idx = np.arange(-(-n // chunk) * chunk) % n
    out = {k: [] for k in MAP_KEYS}
    with torch.no_grad(), common.control_precision(control):
        for s in range(0, len(idx), chunk):
            b = dict(meta)
            b.update({k: torch.from_numpy(np.ascontiguousarray(item[k][idx[s:s + chunk]])).to(device)
                      for k in RAY_KEYS})
            ret = render_rays(spec, rspec, model, b, train=False)
            if float(ret["cull_overflow"]) > 0 or float(ret["part_overflow"]) > 0:
                raise RuntimeError("the reference's full budgets overflowed")
            for k in MAP_KEYS:
                out[k].append(ret[k].float().cpu().numpy())
    return {k: np.concatenate(v)[:n] for k, v in out.items()}


def map_rms_gap(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> float:
    """The larger of the colour and opacity maps' root-mean-square gaps."""
    return max(float(np.sqrt(np.mean((np.asarray(got[k], np.float64)
                                      - np.asarray(ref[k], np.float64)) ** 2)))
               for k in MAP_KEYS)


def run(ctx):
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.eval.runner import (AutoBudgetRenderer, eval_chunk,
                                                   frame_route, padded_chunks)
    from instant_nvr_tpu_torch.run import build, resolve_device

    wl, seed = ctx.workload, ctx.args.seed
    subject_root = common.ensure_subject(ctx)
    cfg_path = common.run_config_path(ctx, subject_root)
    weights = common.harness_weights(common.reference_config(cfg_path), seed, ctx.device)
    w_host = {k: v.cpu() for k, v in weights.items()}
    device = resolve_device(str(ctx.device))
    cfg = common.program_config(cfg_path)
    mspec, rspec, model = build(cfg, device, seed=0)
    model.load_state_dict(weights)
    del weights
    model.eval()
    ds = TPoseDataset(cfg, "test")
    indices = choose_items(ds, cfg, seed, int(wl["n_items"]))
    items = [ds.get_item(i) for i in indices]
    route = frame_route(device)
    chunk = eval_chunk(cfg)
    renderer = AutoBudgetRenderer(mspec, rspec, chunk, persist_path=None,
                                  captured=route.name == "captured")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # in the dataset's order, whatever the seed: the budgets, and so each
    # frame's work, are every seed's alike
    passes = warm(renderer, model, [items[i] for i in np.argsort(indices)])
    print(f"nvrbench: set-up rendered {passes} passes over {len(items)} items; "
          f"budgets cull {renderer.mspec.cull_frac:.4f} part {renderer.mspec.part_frac:.4f}",
          file=sys.stderr, flush=True)
    setup_s = time.time() - ctx.started

    fault = ctx.args.fault
    if fault and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}: one of {FAULTS}")
    outs, order, telemetry = {}, [], []
    frames, prof, traced = 0, None, None
    chunks0, fn0 = renderer.chunks_rendered, renderer.render_fn
    caps0 = getattr(fn0, "captures", 0)
    trace_at = ((int(wl["trace_start"]), int(wl["trace_frames"]))
                if ctx.trace else None)
    common.sync(device)
    t0 = time.perf_counter()
    while True:
        if trace_at is not None and frames == trace_at[0]:
            prof = tr.profile(device)
            prof.start()
            span = torch.profiler.record_function(tr.WINDOW)
            span.__enter__()
        k = frames % len(items)
        with torch.profiler.record_function("nvrbench.frame"):
            out = renderer(model, items[k])
        if fault == "altered_maps":
            out["rgb_map"] = out["rgb_map"] + 0.01
        outs[frames] = {m: out[m] for m in MAP_KEYS}
        order.append(k)
        if prof is not None:
            telemetry.append((float(out["cull_need"]), np.asarray(out["part_need"])))
        frames += 1
        if prof is not None and frames == trace_at[0] + trace_at[1]:
            span.__exit__(None, None, None)
            prof.stop()
            traced, prof = (prof, trace_at[1]), None
        if time.perf_counter() - t0 >= ctx.args.seconds and prof is None:
            break
    common.sync(device)
    wall = time.perf_counter() - t0
    per_frame = [padded_chunks(it["ray_o"].shape[0], chunk) for it in items]
    extra = renderer.chunks_rendered - chunks0 - sum(per_frame[k] for k in order)
    if extra or renderer.render_fn is not fn0 or getattr(fn0, "captures", 0) != caps0:
        print(f"nvrbench: the window re-rendered {extra} chunks and captured "
              f"{getattr(renderer.render_fn, 'captures', 0) - caps0} graphs",
              file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    r = SimpleNamespace(kind="render", setup_s=setup_s, window_s=wall, frames=frames,
                        memory_peak_bytes=peak, power_limit=common.power_limit(device),
                        trace=None, flops=None, knn_bound_s=None, trace_units=0,
                        attempted=frames)
    if traced is not None:
        prof, n = traced
        r.trace = tr.summarize(prof.events())
        r.trace_units = n
        from ..reference.models import inb as ref_inb
        # the budgets the frames ran at: the renderer's, as set-up raised
        # them (``part_need`` is a share of the raised cull budget)
        spec = counts.raised_spec(ref_inb.build_model_spec(cfg), renderer.mspec)
        shapes = counts.model_shapes(spec)
        real = int(ds.part_counts.sum())
        n_chunk = chunk * rspec.n_samples
        frame_chunks = per_frame[0]
        flops = {"bf16": 0.0, "f32": 0.0}
        for cull_need, part_need in telemetry:
            f = counts.model_flops(spec, shapes, n_chunk, cull_need, list(part_need),
                                   real, train=False)
            for key in flops:
                flops[key] += frame_chunks * f[key] / len(telemetry)
        r.flops = flops
        K, _ = ref_inb.budgets(spec, n_chunk)
        r.knn_bound_s = frame_chunks * counts.knn_blend_bound_s(K, real, spec.num_parts)

    # the program's state goes before the reference runs
    del renderer, model
    items_n = len(items)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    n_check = min(int(wl["n_check"]), frames)
    check_frames = sorted(common.rng(seed, "check").choice(frames, size=n_check,
                                                           replace=False).tolist())
    gaps = []
    for f in check_frames:
        ref = reference_frame(cfg_path, ctx, w_host, indices[order[f]])
        got = (reference_frame(cfg_path, ctx, w_host, indices[order[f]],
                               control=ctx.args.control)
               if ctx.args.control else outs[f])
        gaps.append(map_rms_gap(got, ref))
    r.numbers = {"map_rms_gap": max(gaps), "frames_checked": len(gaps),
                 "items": items_n}
    r.checks, r.correct = fitcore.judge(r.numbers, wl["limits"])
    r.failed = 0 if r.correct else 1
    return r
