"""The control for the data path: the same model, stage and step as
``fit_stream``, on ``n_items`` items of the subject built and staged on the
device in set-up (the program's ``device_batch``) and cycled ``i % n_items``,
as the program's bench cycles its keys.  No loader, prefetch or stager runs
in the window.  Set-up steps the first ``fitcore.N_CHECK`` of them (the
warm-up and capture, checked against the reference).

Parameters (``nvrbench/workloads/<cell>.yaml``): ``stage_epoch``,
``n_items``, ``epoch_len``, ``schedule_steps``, ``trace_start``,
``trace_steps`` and the check's ``limits``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import common, fitcore


def run(ctx):
    from instant_nvr_tpu_torch.train.loop import device_batch
    wl, seed = ctx.workload, ctx.args.seed
    subject_root = common.ensure_subject(ctx)
    cfg_path = common.run_config_path(ctx, subject_root)
    weights = common.harness_weights(ctx, cfg_path)
    w0 = [v.float().cpu().clone() for v in weights.values()]
    prog = fitcore.setup_program(ctx, cfg_path, weights)
    del weights
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    step = fitcore.make_fault(ctx.args.fault, prog) if ctx.args.fault else prog.step

    n_items = int(wl["n_items"])
    if n_items < fitcore.N_CHECK:
        raise ValueError(f"n_items {n_items} < the {fitcore.N_CHECK} checked steps")
    indices = fitcore.epoch_indices(seed, len(prog.ds), n_items, 0)
    make = fitcore.produce(prog, seed, 0, indices)
    put = lambda v: torch.from_numpy(np.asarray(v, order="C")).to(prog.device)
    resident = []
    for pos in range(n_items):
        item = make(pos)
        resident.append((item, device_batch(item, prog.rdw, put)))
    records = [fitcore.Record(epoch=0, pos=i, index=indices[i],
                              draw_seed=fitcore.draw_seed(seed, 0, i))
               for i in range(fitcore.N_CHECK)]
    prog_out = fitcore.check_steps(prog, step, iter(resident), records)
    setup_s = time.time() - ctx.started

    n_epoch = int(wl["epoch_len"])

    def feed(epoch, wait):
        start = (epoch - 1) * n_epoch + fitcore.N_CHECK
        return (resident[(start + i) % n_items] for i in range(n_epoch))

    trace_at = ((int(wl["trace_start"]), int(wl["trace_steps"]))
                if ctx.trace else None)
    win = fitcore.window(prog, step, feed, ctx.args.seconds, seed, trace_at, n_epoch)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    readings = fitcore.fit_readings(prog, win, setup_s, peak)
    readings.data_wait_s = None          # nothing feeds this cell in the window
    resident.clear()
    fitcore.free_program(prog)

    numbers = fitcore.compare(ctx, cfg_path, prog_out, w0, records)
    readings.checks, readings.correct = fitcore.judge(numbers, wl["limits"])
    readings.failed = 0 if readings.correct else 1
    readings.numbers = numbers
    return readings
