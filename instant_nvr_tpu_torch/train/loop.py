"""The training loop: epochs, stages, prefetch, checkpoint cadence (port of
``instant_nvr_tpu/train/loop.py``).

  - a config view per epoch (``training_stages``: ratio, sample focus,
    distortion weight), a dataset per ratio;
  - ``ep_iter`` steps an epoch over :class:`Prefetcher` threads that build
    items from the dataset (item rng seeded by (epoch, position)) and a
    :class:`DeviceStager` that copies them to the card ahead of the step,
    keeping the per-frame and static tensors in a device cache;
  - a per-step generator seeded by the global step, so a resumed run
    draws what an unbroken one would;
  - the step on ``train/compiled.py:step_route``'s route, printed first:
    on the card a CUDA graph (``CapturedStep``), else the eager step;
  - a console line every ``log_interval`` steps (``batch``: wall seconds
    a step over the interval's steps, read after its stats' ``float()``
    has synchronized; ``data``: the Prefetcher's queue wait a step over
    them), a line per epoch (the host data wait, items built, their mean
    build ms, MB staged), the error map of MSE-guided sampling;
  - a checkpoint every ``save_latest_ep`` (latest) and ``save_ep``
    (numbered) epochs, and resume at the epoch after the last saved one;
  - a ``torch.profiler`` window over steps [lo, hi) with ``profile_window``,
    written to ``record_dir/profile/trace.json`` with the ``nvr.`` spans
    (``utils/telemetry.py``) of the window, the worker threads' too;
  - after each epoch, with ``prune_using_geo``, the occupancy cube of
    ``eval/mesh.py`` at res 128 from the epoch's last item (captured on
    the card: its graph reads the weights the steps trained in place),
    installed in every dataset and written to ``result_dir/latest.npy``;
  - validation on the val split (4 items) every ``eval_ep`` epochs and a
    one-item visualization every ``vis_ep`` epochs
    (``eval/runner.py:evaluate_dataset``; ``metrics_epoch{n}.npy`` and
    ``comparison_epoch{n}/``), each skipped with a message when the split
    has no data.

Across ranks (``parallel/mesh.py``, ``train_net --distributed``) every
rank walks the same items, builds the same host batch and stages its own
slice of the rays; every rank computes the prune cube; only rank 0 writes
(the config dump, budgets, records, checkpoints, ``latest.npy``, the
error map), and every rank waits for it before a resume reads them.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config, dump_cfg
from ..datasets.prefetch import DeviceStager, Prefetcher
from ..datasets.samplers import IterationBasedSampler
from ..datasets.tpose_dataset import TPoseDataset
from ..eval.mesh import occupancy_grid
from ..eval.runner import evaluate_dataset
from ..models.budget import apply_auto_budget
from ..models.lpips import perceptual_loss
from ..parallel import mesh as pmesh
from ..utils import native, telemetry
from ..utils.intervals import busy_us
from .checkpoint import load_checkpoint, save_checkpoint
from .compiled import CapturedStep, step_route
from .recorder import Recorder
from .stages import stage_for_epoch
from .state import TrainState, create_train_state
from .step import make_loss_weights, make_train_step

# batch keys the step consumes (everything else stays on the host)
DEVICE_KEYS = ("rgb", "ray_o", "ray_d", "near", "far", "ray_mask", "occupancy",
               "A", "big_A", "pbw", "pbw_sizes", "pbounds", "tbounds", "tuv",
               "tuv_sizes", "part_pts", "part_pbw", "lengths2", "part_bounds",
               "R", "Th", "latent_index", "frame_dim", "reg_dist_weight")

# keys that depend on the frame only (SMPL pose and meta) or on nothing
# (canonical volumes): their device copies are kept, not copied every step
FRAME_KEYS = ("A", "big_A", "pbw", "pbw_sizes", "pbounds", "R", "Th",
              "part_pts", "part_pbw", "lengths2", "latent_index", "frame_dim")
STATIC_KEYS = ("tbounds", "tuv", "tuv_sizes", "part_bounds")

# frames whose device tensors device_batch keeps: a frame's tensors take
# ~1.1 MB at inb_377's widths, so 256 frames (~0.3 GB) hold every training
# frame of the configurations; with fewer, an epoch's shuffled items miss
# the cache on most steps, and the one staging thread, which copies a
# missed frame's tensors to the card, falls behind a ~7 ms step
MAX_CACHED_FRAMES = 256


def device_batch(item: Dict[str, np.ndarray], reg_dist_weight: float,
                 put: Callable[[np.ndarray], torch.Tensor],
                 cache: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The step's tensors of ``item``, each made by ``put``.  With a
    ``cache`` the frame keys are kept for the ``MAX_CACHED_FRAMES`` most
    recent frames (an LRU) and the static keys once."""
    item = dict(item)
    item["reg_dist_weight"] = np.float32(reg_dist_weight)
    frame = item.get("frame_index", None)

    if cache is not None and frame is not None:
        lru = cache.setdefault("_frames", [])
        f = int(frame)
        if f in lru:
            lru.remove(f)
        lru.append(f)
        if len(lru) > MAX_CACHED_FRAMES:
            evict = lru.pop(0)
            for k in FRAME_KEYS:
                cache.pop((k, evict), None)

    out = {}
    for k in DEVICE_KEYS:
        if k not in item:
            continue
        ck = None
        if cache is not None:
            if k in STATIC_KEYS:
                ck = (k,)
            elif k in FRAME_KEYS and frame is not None:
                ck = (k, int(frame))
        if ck is None:
            out[k] = put(item[k])
        else:
            if ck not in cache:
                cache[ck] = put(item[k])
            out[k] = cache[ck]
    return out


def make_patch_loss_fn(cfg):
    """The image-space patch loss of patch mode (LPIPS unless ``use_ssim``,
    ``use_fourier`` or ``use_tv_image``): ``fn(ret, batch)`` on the
    ``patch_size`` square, masked by ``ray_mask``."""
    size = cfg.patch_size
    weights_path = cfg.get("lpips_weights", "")
    kind = "lpips"
    for k in ("lpips", "ssim", "fourier", "tv_image"):
        if cfg.get(f"use_{k}", False):
            kind = k
            break

    def fn(ret, batch):
        mask = batch["ray_mask"][:, None]
        img_pred = (ret["rgb_map"] * mask).reshape(size, size, 3)
        img_gt = (batch["rgb"] * mask).reshape(size, size, 3)
        if kind == "lpips":
            return perceptual_loss(img_pred, img_gt, weights_path)
        mse = torch.mean((img_pred - img_gt) ** 2)
        if kind == "ssim":
            from ..ops.ssim import ssim_loss
            return 0.1 * (1.0 - ssim_loss(img_pred, img_gt)) + mse
        if kind == "fourier":
            fp = torch.fft.fft2(torch.mean(img_pred, -1))
            fg = torch.fft.fft2(torch.mean(img_gt, -1))
            floss = torch.mean(torch.abs(torch.abs(fp) - torch.abs(fg))) + \
                torch.mean(torch.abs(torch.angle(fp) - torch.angle(fg)))
            return 0.1 * floss + mse
        tv = torch.mean(torch.abs(img_pred[1:] - img_pred[:-1])) + \
            torch.mean(torch.abs(img_pred[:, 1:] - img_pred[:, :-1]))
        return 0.01 * tv + mse

    return fn


class EpochLog(NamedTuple):
    epoch: int
    steps: int
    data_s: float            # host time waiting on the prefetcher (Prefetcher.wait_s)
    wall_s: float            # the epoch's wall time (its steps)
    cube_s: float = 0.0      # the prune_using_geo cube after the steps
    eval_s: float = 0.0      # validation and visualization after the steps


class TrainResult(NamedTuple):
    """What :func:`train` ran: the final state, the loss of every step of
    this run (host floats), one :class:`EpochLog` per epoch, and the
    profiler window's numbers (steps, wall s, device s, busy share; device
    s and busy None when the trace holds no device time) or None."""
    state: TrainState
    losses: List[float]
    epochs: List[EpochLog]
    profile: Optional[Dict]


def _device_seconds(events) -> Optional[float]:
    """Time in which the device ran anything, from a torch.profiler trace's
    events: the union of the intervals of its kernels and copies, so that a
    copy on the stager's stream that overlaps a kernel counts once (the
    annotation ranges drawn on the device timeline are left out), or None
    when the trace holds no device event."""
    from torch.autograd import DeviceType
    us = busy_us([(e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)])
    return us / 1e6 if us > 0 else None


def train(cfg: Config, device: torch.device, resume: bool = True,
          profile_window: Optional[tuple] = None,
          seed: int = 0, eager: bool = False) -> TrainResult:
    """Train ``cfg`` on ``device`` from a random model (``seed``) or the
    last checkpoint (``resume``).  ``profile_window=(lo, hi)`` traces the
    steps [lo, hi) of this run into ``record_dir/profile``.  The step runs
    on ``train/compiled.py:step_route``'s route, printed first (``eager``
    forces the eager one, and the eager routes of the validation's frame
    and LPIPS and of the epoch's cube)."""
    from ..run import build, resolve_device
    # on the card: TF32 off, so the VGG loss's cuDNN convolutions and the
    # matmuls run in float32 as the JAX package's do
    device = resolve_device(str(device))
    rank0, world = pmesh.is_rank0(), pmesh.world_size()
    if not resume and rank0:
        # a fresh run drops the budgets a previous run persisted
        for name in ("budgets.json", "eval_budgets.json*"):
            for path in glob.glob(os.path.join(cfg.trained_model_dir, name)):
                os.remove(path)
    pmesh.barrier()            # rank 0's files are as it left them
    native.load()              # a first build must not count as data wait
    cfg = apply_auto_budget(cfg)
    mspec, rspec, model = build(cfg, device, seed)
    lw = make_loss_weights(cfg)
    state = create_train_state(cfg, model)
    patch_fn = make_patch_loss_fn(cfg) if lw.use_patch else None
    n_epochs = cfg.train.epoch
    route = step_route(cfg, device, eager)
    print(f"step route: {route}", flush=True)
    step_fn = (CapturedStep(mspec, rspec, lw, patch_fn, n_steps=n_epochs * cfg.ep_iter)
               if route.name == "captured" else make_train_step(mspec, rspec, lw, patch_fn))
    begin_epoch, meta = 0, None
    if resume:
        meta = load_checkpoint(cfg.trained_model_dir, state)
        if meta is not None:
            begin_epoch = int(meta["epoch"]) + 1
    if rank0:
        dump_cfg(cfg, cfg.result_dir)
    recorder = Recorder(cfg.record_dir, resume=resume, enabled=rank0)
    if meta is not None:
        recorder.load_state_dict(meta)
        print(f"resumed from epoch {begin_epoch - 1} (step {state.step})")

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    ep_iter = cfg.ep_iter
    max_iter = n_epochs * ep_iter
    gen = torch.Generator(device=device)
    losses, epochs = [], []
    steps_seen, t_start, prof, window, profile = 0, None, None, None, None
    dev_cache: Dict = {}           # device copies of frame and static tensors
    datasets: Dict[float, TPoseDataset] = {}
    stats = None
    try:
        for epoch in range(begin_epoch, n_epochs):
            ecfg = stage_for_epoch(cfg, epoch)
            if ecfg.ratio not in datasets:
                datasets[ecfg.ratio] = TPoseDataset(ecfg, "train")
            ds = datasets[ecfg.ratio]
            recorder.epoch = epoch
            indices = IterationBasedSampler(len(ds), ep_iter, seed=epoch).epoch(epoch)

            def produce(pos, _ds=ds, _ecfg=ecfg, _indices=indices, _epoch=epoch):
                # seeded by (epoch, position), not a shared stream: the
                # producer threads' schedule must not change the draws
                rng = np.random.default_rng(
                    np.random.SeedSequence(entropy=(7, _epoch, pos)))
                return _ds.get_item(_indices[pos], ratio=_ecfg.ratio,
                                    sample_focus=_ecfg.get("sample_focus", ""),
                                    rng=rng)

            rdw = ecfg.get("reg_dist_weight", 0.1)
            stager = DeviceStager(device, lambda item, put, _rdw=rdw: device_batch(
                pmesh.shard_batch(pmesh.pad_rays_to_multiple(item, world),
                                  pmesh.rank(), world), _rdw, put, cache=dev_cache))
            pf = Prefetcher(produce, range(len(indices)), depth=8,
                            device_put=stager,
                            workers=max(1, int(cfg.train.num_workers)))
            ep_t0 = log_t0 = time.time()
            ep_losses, log_steps, log_wait0 = [], 0, 0.0
            try:
                for it, staged in enumerate(pf):
                    item, batch = stager.ready(staged)

                    if profile_window is not None and steps_seen == profile_window[0]:
                        sync()
                        telemetry.clear()
                        prof = torch.profiler.profile(activities=(
                            [torch.profiler.ProfilerActivity.CPU]
                            + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])))
                        prof.start()
                        prof_t0 = time.time()

                    gen.manual_seed(seed * 1_000_003 + epoch * ep_iter + it)
                    state, stats = step_fn(state, batch, generator=gen)
                    # a captured step's stats are its graph's outputs, which
                    # the next replay overwrites
                    ep_losses.append(stats["loss"].clone())
                    steps_seen += 1

                    if prof is not None and steps_seen == profile_window[1]:
                        window = _stop_profile(prof, prof_t0, sync,
                                               steps_seen - profile_window[0])
                        prof = None

                    if ecfg.get("sample_using_mse", False):
                        if ds.error_map is None:
                            ds.init_error_map(int(item["H"]), int(item["W"]))
                            ds.load_error_map(cfg.result_dir)
                        # every ray's error (reduce_stats), without padding
                        err = stats["ray_error"][:len(item["coord"])]
                        ds.update_error_map(item["coord"], err.cpu().numpy(),
                                            item["frame_index"], item["cam_ind"])

                    if t_start is None:
                        sync()
                        t_start = time.time()

                    recorder.step += 1
                    log_steps += 1
                    if (it + 1) % cfg.log_interval == 0 or it == ep_iter - 1:
                        # float() waits for the step: the interval's wall
                        # time is its steps' own
                        recorder.update({k: float(v) for k, v in stats.items()
                                         if v.ndim == 0})
                        now = time.time()
                        print(recorder.console_line(state.schedule(state.step), max_iter,
                                                    (now - log_t0) / log_steps,
                                                    (pf.wait_s - log_wait0) / log_steps),
                              flush=True)
                        recorder.record("train")
                        log_t0, log_steps, log_wait0 = now, 0, pf.wait_s
            finally:
                pf.close()
            sync()
            ep_wall = time.time() - ep_t0
            losses += torch.stack(ep_losses).cpu().tolist() if ep_losses else []
            epochs.append(EpochLog(epoch, len(ep_losses), pf.wait_s, ep_wall))
            print(f"epoch {epoch}: host data wait {pf.wait_s:.1f}s of "
                  f"{ep_wall:.1f}s wall "
                  f"({100.0 * pf.wait_s / max(ep_wall, 1e-9):.1f}%); {pf.built} items "
                  f"built, {1e3 * pf.build_s / max(pf.built, 1):.1f} ms each on a "
                  f"worker; {stager.bytes / 1e6:.1f} MB staged", flush=True)

            if (ecfg.get("sample_using_mse", False) and ds.error_map is not None
                    and rank0):
                os.makedirs(cfg.result_dir, exist_ok=True)
                ds.save_error_map(cfg.result_dir)

            if (epoch + 1) % cfg.save_latest_ep == 0 or epoch == n_epochs - 1:
                save_checkpoint(cfg.trained_model_dir, epoch, state,
                                recorder.state_dict())
            if (epoch + 1) % cfg.save_ep == 0:
                save_checkpoint(cfg.trained_model_dir, epoch, state,
                                recorder.state_dict(), latest=False)
            epochs[-1] = epochs[-1]._replace(**_after_epoch(
                cfg, mspec, rspec, state.model, epoch, item, datasets, eager))
        if prof is not None:       # the window outlasted the run
            window = _stop_profile(prof, prof_t0, sync, steps_seen - profile_window[0])
            prof = None
    finally:
        if prof is not None:
            prof.stop()
        recorder.close()
    if window is not None:
        profile = _profile_summary(*window, cfg.record_dir)
    if t_start is not None:
        print(f"training wall-clock (after the first step): "
              f"{time.time() - t_start:.1f}s")
    return TrainResult(state, losses, epochs, profile)


def _stop_profile(prof, t0: float, sync, steps: int):
    """End a profiler window -> (profiler, wall s, steps); the trace is
    written after the run, out of every epoch's time."""
    sync()
    wall = time.time() - t0
    prof.stop()
    return prof, wall, steps


def _profile_summary(prof, wall: float, steps: int, record_dir: str) -> Dict:
    """Write a window's trace to ``record_dir/profile``, with the spans the
    profiler could not record (the Prefetcher's workers' ``item.build``
    and ``item.stage``) placed on its clock; the window's numbers."""
    out = os.path.join(record_dir, "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    placed = telemetry.add_to_chrome_trace(path)
    dev = _device_seconds(prof.events())
    print(f"profile trace captured: {steps} steps, {wall:.3f}s wall, device "
          f"{'not measured' if dev is None else f'{dev:.3f}s'}, {placed} worker "
          f"spans placed", flush=True)
    return {"steps": steps, "wall_s": wall, "device_s": dev,
            "busy": None if dev is None else dev / wall}


def _after_epoch(cfg: Config, mspec, rspec, model, epoch: int, item: Dict,
                 datasets: Dict[float, TPoseDataset],
                 eager: bool = False) -> Dict[str, float]:
    """The cadence after an epoch's steps and checkpoint: the geometry
    cube, validation, visualization.  Returns their wall times."""
    t0 = time.time()
    if cfg.get("prune_using_geo", False):
        occ, _ = occupancy_grid(cfg, mspec, model, item, deformed=False, res=128,
                                eager=eager)
        for dset in datasets.values():
            dset.set_prune_geometry(occ)
        if pmesh.is_rank0():
            os.makedirs(cfg.result_dir, exist_ok=True)
            np.save(os.path.join(cfg.result_dir, "latest.npy"), occ)
    t1 = time.time()
    if (epoch + 1) % cfg.eval_ep == 0:
        try:
            validate(cfg, mspec, rspec, model, epoch, eager)
        except FileNotFoundError as e:
            print(f"skipping val (no data): {e}")
    if cfg.get("vis_ep", 0) and (epoch + 1) % cfg.vis_ep == 0:
        try:
            evaluate_dataset(cfg.replace(eval=True), mspec, rspec, model,
                             split="val", epoch=epoch, max_items=1,
                             save_images=True, eager=eager)
        except FileNotFoundError as e:
            print(f"skipping vis (no data): {e}")
    return {"cube_s": t1 - t0, "eval_s": time.time() - t1}


def validate(cfg: Config, mspec, rspec, model, epoch: int, eager: bool = False):
    """The val split's first 4 items, scored into ``metrics_epoch{epoch}.npy``."""
    evaluate_dataset(cfg.replace(eval=True), mspec, rspec, model, split="val",
                     epoch=epoch, max_items=4, eager=eager)
