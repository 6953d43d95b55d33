"""A subject's fit as a user runs it: items built by the program's dataset
on the Prefetcher's worker threads, staged by its DeviceStager over
``device_batch`` and stepped by the captured step; a new Prefetcher and
``IterationBasedSampler`` every ``epoch_len`` steps, as each epoch starts
them, with the stage pinned to ``stage_epoch``'s.  Set-up builds every item
once, which fills the dataset's decoded-image cache as a fit's first epoch
does, so the window measures the epochs after it.  Set-up then steps the first
``fitcore.N_CHECK`` items of an epoch of their own through the same feed
(the warm-up and capture, checked against the reference); the window starts
at an epoch's first step.

Parameters (``nvrbench/workloads/<cell>.yaml``): ``stage_epoch``,
``epoch_len``, ``prefetch_depth``, ``schedule_steps``, ``trace_start``,
``trace_steps`` and the check's ``limits``.
"""
from __future__ import annotations

import time

import torch

from .. import common, fitcore

# the epoch number of the set-up's cache-filling items (the window's epochs
# count from 1, the checked steps' is 0)
WARM_EPOCH = 2 ** 31 - 1


class Feed:
    """One epoch's Prefetcher and DeviceStager, as ``train/loop.py:train``
    starts them; iterating yields the staged (item, batch) and adds the host
    time spent waiting on the queue to ``wait[0]``."""

    def __init__(self, prog, seed: int, epoch: int, n: int, depth: int, wait,
                 dev_cache: dict):
        from instant_nvr_tpu_torch.datasets.prefetch import DeviceStager, Prefetcher
        from instant_nvr_tpu_torch.train.loop import device_batch
        self.indices = fitcore.epoch_indices(seed, len(prog.ds), n, epoch)
        rdw = prog.rdw
        self.stager = DeviceStager(prog.device, lambda item, put: device_batch(
            item, rdw, put, cache=dev_cache))
        self.pf = Prefetcher(fitcore.produce(prog, seed, epoch, self.indices),
                             range(n), depth=depth, device_put=self.stager,
                             workers=max(1, int(prog.cfg.train.num_workers)))
        self.it = iter(self.pf)
        self.wait = wait

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        staged = next(self.it)
        self.wait[0] += time.perf_counter() - t
        return self.stager.ready(staged)

    def close(self):
        self.pf.close()


def warm_items(prog, seed: int) -> None:
    """Build each item of the dataset once on the loader's worker count of
    threads (their draws are of a stream of their own)."""
    from concurrent.futures import ThreadPoolExecutor
    make = fitcore.produce(prog, seed, WARM_EPOCH, list(range(len(prog.ds))))
    with ThreadPoolExecutor(max(1, int(prog.cfg.train.num_workers))) as pool:
        list(pool.map(make, range(len(prog.ds))))


def run(ctx):
    wl, seed = ctx.workload, ctx.args.seed
    subject_root = common.ensure_subject(ctx)
    cfg_path = common.run_config_path(ctx, subject_root)
    weights = common.harness_weights(common.reference_config(cfg_path), seed, ctx.device)
    w0 = [v.float().cpu().clone() for v in weights.values()]
    prog = fitcore.setup_program(ctx, cfg_path, weights)
    del weights
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    step = fitcore.make_fault(ctx.args.fault, prog) if ctx.args.fault else prog.step
    depth, n_epoch = int(wl["prefetch_depth"]), int(wl["epoch_len"])
    dev_cache: dict = {}

    # set-up: every item built once, which fills the dataset's decoded-image
    # cache as the fit's first epoch does (the window measures a later epoch)
    warm_items(prog, seed)
    # the checked steps on an epoch of their own (epoch 0)
    feed0 = Feed(prog, seed, 0, fitcore.N_CHECK, depth, [0.0], dev_cache)
    records = [fitcore.Record(epoch=0, pos=i, index=feed0.indices[i],
                              draw_seed=fitcore.draw_seed(seed, 0, i))
               for i in range(fitcore.N_CHECK)]
    try:
        prog_out = fitcore.check_steps(prog, step, feed0, records)
    finally:
        feed0.close()
    setup_s = time.time() - ctx.started

    trace_at = ((int(wl["trace_start"]), int(wl["trace_steps"]))
                if ctx.trace else None)
    win = fitcore.window(
        prog, step, lambda epoch, wait: Feed(prog, seed, epoch, n_epoch, depth, wait,
                                             dev_cache),
        ctx.args.seconds, seed, trace_at, n_epoch, on_epoch_end=lambda f: f.close())
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    readings = fitcore.fit_readings(prog, win, setup_s, peak)
    fitcore.free_program(prog)

    numbers = fitcore.compare(ctx, cfg_path, prog_out, w0, records)
    readings.checks, readings.correct = fitcore.judge(numbers, wl["limits"])
    readings.failed = 0 if readings.correct else 1
    readings.numbers = numbers
    return readings
