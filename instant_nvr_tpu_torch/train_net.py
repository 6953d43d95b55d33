"""Train the port: the training run of the repo's ``train_net.py``.

    python -m instant_nvr_tpu_torch.train_net --cfg_file configs/inb/inb_fake.yaml
    python -m instant_nvr_tpu_torch.train_net --cfg_file configs/inb/inb_fake.yaml \
        --device cpu --tiny ep_iter 2 train.epoch 2 use_lpips True patch_size 8

runs ``train/loop.py:train`` on the config's dataset: stages, prefetching,
patch-LPIPS steps where the config asks for them, a checkpoint per
``save_latest_ep`` epochs and resume from the last one (``--no_resume``
starts fresh).  ``--dry_run`` prints the parameter inventory,
``--profile`` traces the steps of ``--profile_window`` into
``record_dir/profile``; ``--test`` evaluates the test split after training
(``eval/runner.py:evaluate_dataset``: ``result_dir/metrics.npy`` and the
comparison PNGs).  ``--detect_anomaly`` turns on autograd's anomaly mode;
the config's ``fix_random`` makes the run deterministic
(:func:`apply_fix_random`).

    python -m instant_nvr_tpu_torch.train_net --synthetic --steps 100
    python -m instant_nvr_tpu_torch.train_net --device cpu --tiny --steps 3

trains instead on one fixed batch of ``N_rand`` rays from the synthetic
scene that ``bench.py`` uses (1,200 vertices, a 32^3 pose volume, a
128x128 view), printing loss, psnr and milliseconds per step (``--steps``
selects this run).  ``--tiny`` narrows the model (and the synthetic scene)
to the widths of the CPU tests (``__graft_entry__._flagship(tiny=True)``).
The device defaults to ``cuda`` and a missing card is an error.

    torchrun --nproc_per_node 4 -m instant_nvr_tpu_torch.train_net --distributed ...

runs one rank per card (``parallel/mesh.py``: NCCL, ``cuda:LOCAL_RANK``;
``--device cpu`` makes Gloo ranks on the CPU): the same training run, its
rays split over the ranks, rank 0 writing.  Without NCCL or a card it
raises.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from .models import inb
from .parallel import mesh as pmesh
from .renderer.inb_renderer import RenderSpec
from .train.state import TrainState, create_train_state
from .train.step import LossWeights, make_loss_weights, make_train_step

_TINY_GRID = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=10,
                  base_resolution=4, b=1.38)
TINY = {
    "partnet": {p: {"embedder": {"kwargs": _TINY_GRID}}
                for p in ("body", "leg", "head", "larm", "rarm")},
    "tpose_deformer": {"embedder": {"kwargs": dict(_TINY_GRID, sum=False)}},
    "N_samples": 8, "N_rand": 64, "use_lpips": False,
}


class Trainer(NamedTuple):
    mspec: inb.ModelSpec
    rspec: RenderSpec
    lw: LossWeights
    state: TrainState
    step: object                 # make_train_step's function
    batch: Dict[str, torch.Tensor]


def synthetic_batch(cfg, device: torch.device, tiny: bool = False,
                    n_rays: int | None = None) -> Dict[str, torch.Tensor]:
    """The fixed training batch of ``bench.py`` (``tiny``: of the CPU tests)."""
    from .datasets import synthetic
    scene = synthetic.make_scene(n_verts=600 if tiny else 1200,
                                 grid=16 if tiny else 32)
    side = 32 if tiny else 128
    view = synthetic.render_gt(scene, H=side, W=side)
    batch = synthetic.make_batch(scene, view, n_rays=n_rays or cfg.N_rand)
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def build_trainer(cfg, device: torch.device, seed: int = 0,
                  tiny: bool = False) -> Trainer:
    from .run import build
    mspec, rspec, model = build(cfg, device, seed)
    lw = make_loss_weights(cfg)
    return Trainer(mspec, rspec, lw, create_train_state(cfg, model),
                   make_train_step(mspec, rspec, lw),
                   synthetic_batch(cfg, device, tiny))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.train_net")
    p.add_argument("--cfg_file", default="configs/inb/inb_377.yaml")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="narrow widths (and a small synthetic scene): CPU runs")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--dry_run", action="store_true",
                   help="print the parameter inventory and exit")
    p.add_argument("--profile", action="store_true",
                   help="trace the steps of --profile_window with torch.profiler")
    p.add_argument("--profile_window", default="20:36",
                   help="step window 'start:stop' for --profile")
    p.add_argument("--test", action="store_true",
                   help="evaluate the test split after training")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic batch instead of the dataset")
    p.add_argument("--steps", type=int, default=None,
                   help="steps of the synthetic run (implies --synthetic; "
                        "default 100)")
    p.add_argument("--distributed", action="store_true",
                   help="one rank of a torch.distributed job (torchrun's "
                        "environment): NCCL on cuda, Gloo on cpu")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd's anomaly mode: a NaN made in backward "
                        "raises, naming the op (the JAX package's debug_nans)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.distributed:
        inb.check_distributed(load_config(args))    # before any rank starts
        with pmesh.distributed(args.device) as device:
            _main(args, device)
    else:
        _main(args, None)


def load_config(args):
    """The run's config: the YAML, ``--tiny``'s widths, then the opts."""
    from .config import default_config, finalize, load_yaml_config
    cfg = load_yaml_config(args.cfg_file, defaults=default_config())
    if args.tiny:   # the command line's opts still win over the tiny widths
        cfg = cfg.merged(TINY)
    return finalize(cfg.with_overrides(args.opts))


def apply_fix_random(cfg) -> bool:
    """The config's ``fix_random`` (the JAX package's ``train_net.py:41-46``):
    deterministic cuBLAS (its workspace setting, read when its first
    handle is made), deterministic algorithms and cuDNN; every table
    gradient the atomic kernels would take already takes the sorted-segment
    kernel through the specs ``build_model_spec`` builds, and an exact
    table's ``index_add_`` is deterministic under the flag.  Returns whether
    it was set."""
    if not cfg.get("fix_random", False):
        return False
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return True


def _main(args, device) -> None:
    from .run import resolve_device
    cfg = load_config(args)
    apply_fix_random(cfg)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    if args.dry_run:
        model = inb.InbModel(inb.build_model_spec(cfg), device="meta")
        total = 0
        for name, p in model.named_parameters():
            total += p.numel()
            print(f"{name:60s} {str(tuple(p.shape)):>20s} {p.numel():>12,d}")
        print(f"total parameters: {total:,d}")
        return
    device = resolve_device(str(device or args.device))
    if args.synthetic or args.steps is not None:
        run_synthetic(cfg, device, 100 if args.steps is None else args.steps,
                      args.seed, args.tiny)
        return
    from .train.loop import train
    window = (tuple(int(x) for x in args.profile_window.split(":"))
              if args.profile else None)
    res = train(cfg, device, resume=not args.no_resume, profile_window=window,
                seed=args.seed)
    if args.test:
        from .eval.runner import evaluate_dataset
        from .renderer.inb_renderer import make_render_spec
        evaluate_dataset(cfg.replace(eval=True), inb.build_model_spec(cfg),
                         make_render_spec(cfg), res.state.model, split="test")


def run_synthetic(cfg, device: torch.device, steps: int, seed: int,
                  tiny: bool) -> None:
    """``steps`` MSE steps on the fixed synthetic batch, one line a step
    (across ranks, each steps on its slice of the batch)."""
    t = build_trainer(cfg, device, seed, tiny)
    batch = pmesh.shard_batch(t.batch, pmesh.rank(), pmesh.world_size())
    gen = torch.Generator(device=device).manual_seed(seed)
    for i in range(steps):
        t0 = time.perf_counter()
        _, stats = t.step(t.state, batch, generator=gen)
        loss, psnr = float(stats["loss"]), float(stats["psnr"])   # waits
        ms = 1000.0 * (time.perf_counter() - t0)
        print(f"step {i}: loss {loss:.5f} psnr {psnr:.2f} {ms:.1f} ms "
              f"({cfg.N_rand} rays, {device})", flush=True)


if __name__ == "__main__":
    main()
