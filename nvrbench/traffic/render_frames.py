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
numbers compared are the worst frame's root-mean-square gap over the
colour and opacity maps (``map_rms_gap``) and the worst frame's median gap
over the subject's pixels (``map_median_gap``: a pixel's largest gap over
its colour and opacity, where the reference's opacity is 0.5 or more),
which a precision lost everywhere moves and a few rays flipped by rounding
do not.  With ``--trace 1`` the reference then
renders the traced frames again as the program did, at its budgets, to
count the fused encoding's bound (:func:`encode_bound_s`).

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


def render_item(ctx, cfg, spec, weights, index: int, chunk: int, n_chunks: int = 0,
                control: str = "") -> Dict[str, np.ndarray]:
    """The reference's maps of test item ``index``, built from the subject's
    files, under its model spec ``spec`` in chunks of ``chunk`` rays:
    ``n_chunks`` of them, else as many as the rays fill, the last filled
    with the first rays again (a budget rounds up to 128 samples, which a
    short chunk may not hold)."""
    from ..reference.datasets.tpose_dataset import TPoseDataset
    from ..reference.models import inb
    from ..reference.renderer.inb_renderer import make_render_spec, render_rays
    device = ctx.device
    rspec = make_render_spec(cfg)
    model = inb.InbModel(spec, device)
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    item = TPoseDataset(cfg, "test").get_item(index)
    meta = {k: torch.from_numpy(np.ascontiguousarray(item[k])).to(device)
            for k in META_KEYS if k in item}
    n = item["ray_o"].shape[0]
    idx = np.arange((n_chunks or -(-n // chunk)) * chunk) % n
    out = {k: [] for k in MAP_KEYS}
    with torch.no_grad(), common.control_precision(control):
        for s in range(0, len(idx), chunk):
            b = dict(meta)
            b.update({k: torch.from_numpy(np.ascontiguousarray(item[k][idx[s:s + chunk]])).to(device)
                      for k in RAY_KEYS})
            ret = render_rays(spec, rspec, model, b, train=False)
            if float(ret["cull_overflow"]) > 0 or float(ret["part_overflow"]) > 0:
                raise RuntimeError("the reference's budgets overflowed")
            for k in MAP_KEYS:
                out[k].append(ret[k].float().cpu().numpy())
    return {k: np.concatenate(v)[:n] for k, v in out.items()}


def reference_frame(cfg_path: str, ctx, weights, index: int,
                    control: str = "") -> Dict[str, np.ndarray]:
    """The check's maps of test item ``index``: the reference (or
    ``control``) with budgets that keep every sample, in chunks of
    ``ref_chunk`` rays."""
    from ..reference.models import inb
    cfg = common.reference_config(cfg_path, control).merged(
        {"cull_budget": 1.0, "part_budget": 1.0, "part_budget_scales": [1.0] * 5})
    return render_item(ctx, cfg, inb.build_model_spec(cfg), weights, index,
                       int(ctx.workload["ref_chunk"]), control=control)


def map_rms_gap(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> float:
    """The larger of the colour and opacity maps' root-mean-square gaps."""
    return max(float(np.sqrt(np.mean((np.asarray(got[k], np.float64)
                                      - np.asarray(ref[k], np.float64)) ** 2)))
               for k in MAP_KEYS)


def encode_bound_s(cfg_path: str, ctx, weights, items: List[int], budgets,
                   chunk: int, n_chunks: int, summary: Dict) -> float:
    """``hashgrid_encode_kernel``'s bound a traced frame: the reference
    renders each traced frame's test item as the program's frame (its
    budgets, chunks and padding) and counts every encoding
    (``counts.encode_bounds``); printed by encoder beside the kernel's
    device time by name."""
    from ..reference.models import inb
    cfg = common.reference_config(cfg_path)
    spec = counts.raised_spec(inb.build_model_spec(cfg), budgets)
    by = {}
    with counts.encode_bounds() as launches:
        for index in items:
            render_item(ctx, cfg, spec, weights, index, chunk, n_chunks)
    for encoder, s in launches:
        by[encoder] = by.get(encoder, 0.0) + s / len(items)
    kernels = {n: v / len(items) for n, v in (summary or {}).get("kernel_s", {}).items()
               if "hashgrid_encode" in n}
    print(f"nvrbench: hashgrid_encode bound a frame by encoder {by} "
          f"({len(launches)} launches in {len(items)} frames); device s a frame "
          f"by kernel {kernels}", file=sys.stderr, flush=True)
    return sum(by.values())


# a pixel of the subject: the reference's opacity at least this
SUBJECT_ACC = 0.5


def map_median_gap(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> float:
    """The median over the subject's pixels of a pixel's largest gap over
    its colour channels and opacity."""
    gap = np.abs(np.asarray(got["rgb_map"], np.float64) - np.asarray(ref["rgb_map"], np.float64))
    gap = np.maximum(gap.reshape(gap.shape[0], -1).max(1),
                     np.abs(np.asarray(got["acc_map"], np.float64)
                            - np.asarray(ref["acc_map"], np.float64)).reshape(-1))
    subject = np.asarray(ref["acc_map"]).reshape(-1) >= SUBJECT_ACC
    return float(np.median(gap[subject])) if subject.any() else float(np.median(gap))


def run(ctx):
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.eval.runner import (AutoBudgetRenderer, eval_chunk,
                                                   frame_route, padded_chunks)
    from instant_nvr_tpu_torch.run import build, resolve_device

    wl, seed = ctx.workload, ctx.args.seed
    subject_root = common.ensure_subject(ctx)
    cfg_path = common.run_config_path(ctx, subject_root)
    weights = common.harness_weights(ctx, cfg_path)
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
                        encode_bound_s=None, attempted=frames)
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
        raised = renderer.mspec
        traced_items = [indices[order[f]] for f in range(trace_at[0], trace_at[0] + n)]

    # the program's state goes before the reference runs
    del renderer, model
    items_n = len(items)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    n_check = min(int(wl["n_check"]), frames)
    check_frames = sorted(common.rng(seed, "check").choice(frames, size=n_check,
                                                           replace=False).tolist())
    gaps, medians = [], []
    for f in check_frames:
        ref = reference_frame(cfg_path, ctx, w_host, indices[order[f]])
        got = (reference_frame(cfg_path, ctx, w_host, indices[order[f]],
                               control=ctx.args.control)
               if ctx.args.control else outs[f])
        gaps.append(map_rms_gap(got, ref))
        medians.append(map_median_gap(got, ref))
        print(f"nvrbench: checked frame {f} (item {indices[order[f]]}): rms gap {gaps[-1]!r}, "
              f"median gap {medians[-1]!r} over "
              f"{float(np.mean(ref['acc_map'] >= SUBJECT_ACC)):.4f} of the pixels",
              file=sys.stderr, flush=True)
    r.numbers = {"map_rms_gap": max(gaps), "map_median_gap": max(medians),
                 "frames_checked": len(gaps), "items": items_n}
    if traced is not None:
        r.encode_bound_s = encode_bound_s(cfg_path, ctx, w_host, traced_items, raised,
                                          chunk, per_frame[0], r.trace)
    r.checks, r.correct = fitcore.judge(r.numbers, wl["limits"])
    r.failed = 0 if r.correct else 1
    return r
