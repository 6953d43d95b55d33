"""The fit cells' path, shared by ``traffic/fit_stream.py`` and
``traffic/fit_resident.py``: the training run's per-step path composed from
the program's own functions in ``train/loop.py:train``'s order, its
set-up, the measured window and the check of its first steps against the
reference.

Set-up builds one train state (the harness's weights loaded into the
program's model, ``create_train_state``, ``make_patch_loss_fn``, the step
on ``step_route``'s route: on the card ``CapturedStep``) and drives it
through its first :data:`N_CHECK` steps, fed by the cell's own feed on
items of their own (all different): on the captured route the graph's
three eager warm-up steps, its capture and first replay, and one replay
more.  It keeps each step's loss, the optimizer's first moment after the
first step (the first gradient as the optimizer got it: mu / (1 - b1))
and the parameters after the last; the window then continues with the
same state.  The reference (``reference/``: the port's plain route,
frozen) repeats those steps from the same weights, items and draws, and
:func:`fit_numbers` compares:

  - ``loss_gap``: the largest relative gap of a step's loss;
  - ``grad_gap``: the worst leaf's gap between the program's and the
    reference's first-gradient norms, over the larger of the reference's
    norm of that leaf and of the median leaf;
  - ``median_change_gap``: the median over the leaves of the same gap for
    the norm of each leaf's change over the steps, leaving out the leaves
    whose reference gradient is under a thousandth of the median leaf's
    (they move under Adam by round-off).  The worst leaf's change gap is
    printed beside it and not compared: with the tables at a fitted
    model's scale, two sound trajectories part over the later steps, and a
    small leaf (the deformer's MLP) reads that (PERF.md, section 2);
  - ``ray_median_gap``: the median over the first step's rays of the
    subject (its mask's pixels) of the gap of each ray's colour error
    (``ray_error``, the L1 of its colour against the image): a precision
    lost in every ray moves it, a few rays flipped by rounding do not.

The window steps the same state: each step's item comes from the cell's
feed, its draws from a generator reseeded per step from the run's seed, and
a CUDA event is recorded after it on the step's stream; a step's time is
the gap between consecutive events.  With ``--trace`` a profiler window of
``trace_steps`` steps opens at step ``trace_start`` of the window.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from . import common, counts
from . import trace as tr

N_CHECK = 6
# the step's batch keys (train/loop.py:DEVICE_KEYS)
DEVICE_KEYS = ("rgb", "ray_o", "ray_d", "near", "far", "ray_mask", "occupancy",
               "A", "big_A", "pbw", "pbw_sizes", "pbounds", "tbounds", "tuv",
               "tuv_sizes", "part_pts", "part_pbw", "lengths2", "part_bounds",
               "R", "Th", "latent_index", "frame_dim", "reg_dist_weight")
# leaves whose reference gradient is under this share of the median leaf's
# are left out of median_change_gap (Adam moves them by round-off alone)
ZERO_GRAD_SHARE = 1e-3
FAULTS = ("stale_state", "half_batch")


class Record(SimpleNamespace):
    """One checked step: its item (epoch, position, dataset index) and the
    seed of its draws."""


def item_rng(seed: int, epoch: int, pos: int) -> np.random.Generator:
    return common.rng(seed, "item", epoch, pos)


def draw_seed(seed: int, epoch: int, pos: int) -> int:
    return common.derive(seed, "draws", epoch, pos)


def epoch_indices(seed: int, n_items: int, n: int, epoch: int) -> List[int]:
    """The dataset indices of an epoch, as the loop's
    ``IterationBasedSampler`` draws them, seeded by the run's seed."""
    from instant_nvr_tpu_torch.datasets.samplers import IterationBasedSampler
    return IterationBasedSampler(n_items, n, seed=common.derive(seed, "order")).epoch(epoch)


class Program(SimpleNamespace):
    """The program's objects of a fit cell."""


def setup_program(ctx, cfg_path: str, weights: Dict[str, torch.Tensor]) -> Program:
    """The program's step and train state, from the harness's weights."""
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.models.budget import apply_auto_budget
    from instant_nvr_tpu_torch.run import build, resolve_device
    from instant_nvr_tpu_torch.train.compiled import CapturedStep, step_route
    from instant_nvr_tpu_torch.train.loop import make_patch_loss_fn
    from instant_nvr_tpu_torch.train.stages import stage_for_epoch
    from instant_nvr_tpu_torch.train.state import create_train_state
    from instant_nvr_tpu_torch.train.step import make_loss_weights, make_train_step
    from instant_nvr_tpu_torch.utils import native

    device = resolve_device(str(ctx.device))
    native.load()
    cfg = apply_auto_budget(common.program_config(cfg_path))
    ecfg = stage_for_epoch(cfg, int(ctx.workload["stage_epoch"]))
    mspec, rspec, model = build(cfg, device, seed=0)
    model.load_state_dict(weights)
    lw = make_loss_weights(cfg)
    state = create_train_state(cfg, model)
    patch_fn = make_patch_loss_fn(cfg) if lw.use_patch else None
    route = step_route(cfg, device)
    step = (CapturedStep(mspec, rspec, lw, patch_fn,
                         n_steps=int(ctx.workload["schedule_steps"]))
            if route.name == "captured" else make_train_step(mspec, rspec, lw, patch_fn))
    return Program(cfg=cfg, ecfg=ecfg, mspec=mspec, rspec=rspec, lw=lw,
                   state=state, step=step, route=route, device=device,
                   ds=TPoseDataset(ecfg, "train"),
                   rdw=float(ecfg.get("reg_dist_weight", 0.1)))


def produce(prog: Program, seed: int, epoch: int, indices: List[int]) -> Callable:
    """The item of each position of an epoch, seeded by (seed, epoch,
    position): the producer threads' schedule does not change the draws."""
    def fn(pos: int):
        return prog.ds.get_item(indices[pos], ratio=prog.ecfg.ratio,
                                sample_focus=prog.ecfg.get("sample_focus", ""),
                                rng=item_rng(seed, epoch, pos))
    return fn


def make_fault(name: str, prog: Program) -> Callable:
    """The step with its timed path broken (the fault tests): ``stale_state``
    returns the state unchanged (the parameters restored after the step),
    ``half_batch`` leaves half of the rays out (their mask zeroed, the mean
    over the rest)."""
    step = prog.step
    if name == "stale_state":
        def broken(state, batch, generator=None):
            keep = [p.detach().clone() for p in state.model.parameters()]
            out = step(state, batch, generator=generator)
            with torch.no_grad():
                for p, k in zip(state.model.parameters(), keep):
                    p.copy_(k)
            return out
        return broken
    if name == "half_batch":
        def broken(state, batch, generator=None):
            mask = batch["ray_mask"].clone()
            mask[mask.shape[0] // 2:] = 0
            return step(state, dict(batch, ray_mask=mask), generator=generator)
        return broken
    raise ValueError(f"unknown fault {name!r}: one of {FAULTS}")


def first_moment(state) -> List[torch.Tensor]:
    return [state.optimizer.state[p]["exp_avg"].detach().float().cpu().clone()
            for p in state.model.parameters()]


def check_steps(prog: Program, step, feed: Iterator, records: List[Record]) -> Dict:
    """The first ``len(records)`` steps from ``feed`` (staged (item, batch)
    pairs); returns their losses, the first moment and the rays' colour
    errors of step 1 and the parameters after the last, on the host."""
    gen = torch.Generator(device=prog.device)
    losses, mu1, rays = [], None, None
    for i, rec in enumerate(records):
        item, batch = next(feed)
        gen.manual_seed(rec.draw_seed)
        _, stats = step(prog.state, batch, generator=gen)
        losses.append(stats["loss"].detach().clone())
        if i == 0:
            mu1 = first_moment(prog.state)
            rays = stats["ray_error"].detach().float().cpu().clone()
    common.sync(prog.device)
    b1 = prog.state.optimizer.param_groups[0]["betas"][0]
    return {"losses": [float(x) for x in losses], "ray_error": rays,
            "grads": [m / (1 - b1) for m in mu1],
            "after": [p.detach().float().cpu().clone() for p in prog.state.model.parameters()],
            "names": [n for n, _ in prog.state.model.named_parameters()]}


def window(prog: Program, step, feed: Callable[[int], Iterator], seconds: float,
           seed: int, trace_at: Optional[tuple], epoch_len: int,
           on_epoch_end: Optional[Callable] = None) -> SimpleNamespace:
    """Steps from ``feed(epoch)`` (an iterator of (item, batch), with the host
    time spent waiting for it) until ``seconds`` have passed, then a device
    synchronize.  ``trace_at`` = (first step, steps) of a profiler window."""
    device = prog.device
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device)
    events, stats_kept = [], []
    steps, epoch, prof, traced = 0, 1, None, None
    wait = [0.0]
    common.sync(device)
    t0 = time.perf_counter()
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    done = False
    while not done:
        it = feed(epoch, wait)
        for pos in range(epoch_len):
            if trace_at is not None and steps == trace_at[0]:
                common.sync(device)
                prof = tr.profile(device)
                prof.start()
                win_span = torch.profiler.record_function(tr.WINDOW)
                win_span.__enter__()
            with torch.profiler.record_function("nvrbench.wait_feed"):
                item, batch = next(it)
            gen.manual_seed(draw_seed(seed, epoch, pos))
            with torch.profiler.record_function("nvrbench.step"):
                _, stats = step(prog.state, batch, generator=gen)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            else:                       # the CPU steps synchronously
                events.append(time.perf_counter())
            steps += 1
            if prof is not None:
                stats_kept.append({k: stats[k].detach().clone()
                                   for k in ("cull_need", "part_need")})
                if steps == trace_at[0] + trace_at[1]:
                    common.sync(device)
                    win_span.__exit__(None, None, None)
                    prof.stop()
                    traced = (prof, trace_at[1])
                    prof = None
            if time.perf_counter() - t0 >= seconds and prof is None:
                done = True
                break
        if on_epoch_end is not None:
            on_epoch_end(it)
        epoch += 1
    common.sync(device)
    wall = time.perf_counter() - t0
    if not cuda:
        events.insert(0, t0)
    step_ms = ([a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])] if cuda
               else [1e3 * (b - a) for a, b in zip(events[:-1], events[1:])])
    return SimpleNamespace(steps=steps, wall_s=wall, step_ms=step_ms,
                           data_wait_s=wait[0], traced=traced,
                           telemetry=[{k: v.float().cpu().numpy() for k, v in s.items()}
                                      for s in stats_kept])


def fit_readings(prog: Program, win, setup_s: float, peak: int) -> SimpleNamespace:
    """The readings the metric readers take from a fit run (its checks are
    set once the reference has run)."""
    rays = int(prog.cfg.patch_size) ** 2 if prog.lw.use_patch else int(prog.cfg.N_rand)
    r = SimpleNamespace(kind="fit", setup_s=setup_s, window_s=win.wall_s,
                        steps=win.steps, rays_per_step=rays, step_ms=win.step_ms,
                        data_wait_s=win.data_wait_s, memory_peak_bytes=peak,
                        attempted=win.steps + N_CHECK, power_limit=common.power_limit(prog.device),
                        trace=None, flops=None, knn_bound_s=None,
                        scatter_bound_s=None, trace_units=0)
    if win.traced is not None:
        prof, n = win.traced
        r.trace = tr.summarize(prof.events())
        r.trace_units = n
        r.flops, r.knn_bound_s, r.scatter_bound_s = step_work(prog, win.telemetry)
    return r


def step_work(prog: Program, telemetry: List[Dict]):
    """(mean model FLOPs by precision of a traced step, knn_blend's bound
    seconds a step, the table-gradient scatters' bound seconds a step by
    route) from the traced steps' cull telemetry and the budgets."""
    from .reference.models import inb as ref_inb
    from .reference.renderer.inb_renderer import make_render_spec, pair_budget
    spec = counts.raised_spec(ref_inb.build_model_spec(prog.cfg), prog.mspec)
    shapes = counts.model_shapes(spec)
    rays = int(prog.cfg.patch_size) ** 2 if prog.lw.use_patch else int(prog.cfg.N_rand)
    n = rays * prog.rspec.n_samples
    real = int(prog.ds.part_counts.sum())
    total = {"bf16": 0.0, "f32": 0.0}
    for t in telemetry:
        f = counts.model_flops(spec, shapes, n, float(t["cull_need"]),
                               list(t["part_need"]), real, train=True,
                               patch_side=int(prog.cfg.patch_size) if prog.lw.use_patch else 0)
        for k in total:
            total[k] += f[k] / len(telemetry)
    K, _ = ref_inb.budgets(spec, n)
    rspec = make_render_spec(prog.cfg)
    scatter: Dict[str, float] = {}
    for route, R, F, rows in counts.scatter_calls(
            spec, n, pair_budget(spec, rspec, n) if rspec.use_pair_reg else 0):
        scatter[route] = scatter.get(route, 0.0) + counts.scatter_bound_s(R, F, rows)
    return total, counts.knn_blend_bound_s(K, real, spec.num_parts), scatter


def free_program(prog: Program) -> None:
    for k in ("step", "state", "ds"):
        setattr(prog, k, None)
    gc.collect()
    if prog.device.type == "cuda":
        torch.cuda.empty_cache()


def to_batch(item: Dict, rdw: float, device) -> Dict[str, torch.Tensor]:
    """The step's tensors of an item on ``device`` (the reference's feed)."""
    item = dict(item, reg_dist_weight=np.float32(rdw))
    return {k: torch.from_numpy(np.ascontiguousarray(item[k])).to(device)
            for k in DEVICE_KEYS if k in item}


def reference_steps(ctx, cfg_path: str, weights: Dict[str, torch.Tensor],
                    records: List[Record], control: str = "") -> Dict:
    """The reference's steps on the checked steps' items and draws, from the
    run's initial weights; its losses, first gradients and parameters after."""
    from .reference.datasets.tpose_dataset import TPoseDataset
    from .reference.models import inb
    from .reference.renderer.inb_renderer import make_render_spec
    from .reference.train.patch_loss import make_patch_loss_fn
    from .reference.train.stages import stage_for_epoch
    from .reference.train.state import create_train_state
    from .reference.train.step import make_loss_weights, make_train_step

    device = ctx.device
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with common.control_precision(control):
        try:
            cfg = common.reference_config(cfg_path, control)
            ecfg = stage_for_epoch(cfg, int(ctx.workload["stage_epoch"]))
            spec = inb.build_model_spec(cfg)
            model = inb.InbModel(spec, device)
            model.load_state_dict({k: v.to(device) for k, v in weights.items()})
            lw = make_loss_weights(cfg)
            state = create_train_state(cfg, model)
            step = make_train_step(spec, make_render_spec(cfg), lw,
                                   make_patch_loss_fn(cfg) if lw.use_patch else None)
            ds = TPoseDataset(ecfg, "train")
            rdw = float(ecfg.get("reg_dist_weight", 0.1))
            gen = torch.Generator(device=device)
            losses, grads, rays = [], None, None
            for i, rec in enumerate(records):
                item = ds.get_item(rec.index, ratio=ecfg.ratio,
                                   sample_focus=ecfg.get("sample_focus", ""),
                                   rng=item_rng(ctx.args.seed, rec.epoch, rec.pos))
                gen.manual_seed(rec.draw_seed)
                _, stats = step(state, to_batch(item, rdw, device), generator=gen)
                losses.append(float(stats["loss"]))
                if i == 0:
                    grads = [p.grad.detach().float().cpu().clone() for p in model.parameters()]
                    rays = stats["ray_error"].detach().float().cpu().clone()
                    subject = torch.from_numpy(np.asarray(item["occupancy"]) >= 0.5)
            after = [p.detach().float().cpu().clone() for p in model.parameters()]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"losses": losses, "grads": grads, "after": after, "ray_error": rays,
            "subject": subject, "names": [n for n, _ in model.named_parameters()]}


def _rel_gap(a: np.ndarray, b: np.ndarray, floor: float) -> np.ndarray:
    return np.abs(a - b) / np.maximum(np.abs(b), floor)


def fit_numbers(prog_out: Dict, ref: Dict, w0: List[torch.Tensor]) -> Dict[str, float]:
    """loss_gap, grad_gap, median_change_gap and ray_median_gap (see the
    module doc) of the program's steps (or the control's) against the
    reference's; the worst leaves go to standard error."""
    if prog_out["names"] != ref["names"]:
        raise RuntimeError("the program's and the reference's parameters differ: "
                           f"{prog_out['names']} vs {ref['names']}")
    lp, lr = np.array(prog_out["losses"]), np.array(ref["losses"])
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    gp = np.array([float(torch.linalg.vector_norm(g)) for g in prog_out["grads"]])
    gr = np.array([float(torch.linalg.vector_norm(g)) for g in ref["grads"]])
    med_g = float(np.median(gr))
    grad_gap = float(np.max(_rel_gap(gp, gr, med_g)))
    keep = gr >= ZERO_GRAD_SHARE * med_g
    dp = np.array([float(torch.linalg.vector_norm(a - w)) for a, w in zip(prog_out["after"], w0)])
    dr = np.array([float(torch.linalg.vector_norm(a - w)) for a, w in zip(ref["after"], w0)])
    med_d = float(np.median(dr[keep]))
    cgaps = _rel_gap(dp[keep], dr[keep], med_d)
    names = prog_out["names"]
    g_worst = int(np.argmax(_rel_gap(gp, gr, med_g)))
    c_worst = int(np.flatnonzero(keep)[np.argmax(cgaps)])
    print(f"nvrbench: loss gaps by step {(np.abs(lp - lr) / np.abs(lr)).tolist()}; "
          f"worst grad leaf {names[g_worst]} (norm {float(gp[g_worst])!r} vs {float(gr[g_worst])!r}, "
          f"median {med_g!r}); worst change leaf {names[c_worst]} (norm "
          f"{float(dp[c_worst])!r} vs {float(dr[c_worst])!r}, median {med_d!r}; its gap "
          f"{float(np.max(cgaps))!r})", file=sys.stderr, flush=True)
    rays = torch.abs(prog_out["ray_error"].double() - ref["ray_error"].double())
    if bool(ref["subject"].any()):
        rays = rays[ref["subject"].reshape(-1)]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "median_change_gap": float(np.median(cgaps)),
            "ray_median_gap": float(torch.median(rays)),
            "leaves_left_out": int((~keep).sum())}


def compare(ctx, cfg_path: str, prog_out: Dict, w0: List[torch.Tensor],
            records: List[Record]) -> Dict[str, float]:
    """The numbers of the program's checked steps against the reference's;
    with ``--control`` the control (the reference in the control's lower
    precision) takes the program's place."""
    weights = dict(zip(prog_out["names"], w0))
    ref = reference_steps(ctx, cfg_path, weights, records)
    if ctx.args.control:
        prog_out = reference_steps(ctx, cfg_path, weights, records,
                                   control=ctx.args.control)
    return fit_numbers(prog_out, ref, w0)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(checks, correct): each compared number beside its limit."""
    checks = [{"name": k, "value": float(numbers[k]), "limit": float(limits[k])}
              for k in limits]
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
    return checks, ok


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: List[float]) -> float:
    """(Q3 - Q1) / median, with the quartiles of ``statistics.quantiles``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
