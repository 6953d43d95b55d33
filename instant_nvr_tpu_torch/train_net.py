"""Train the port on the synthetic batch (the MSE step of ``bench.py``).

    python -m instant_nvr_tpu_torch.train_net --cfg_file configs/inb/inb_377.yaml --steps 100
    python -m instant_nvr_tpu_torch.train_net --device cpu --tiny --steps 3

Builds the config's model from random weights (``--seed``) and trains it on
one fixed batch of ``N_rand`` rays from the synthetic scene that
``bench.py`` uses (1,200 vertices, a 32^3 pose volume, a 128x128 view),
printing loss, psnr and milliseconds per step.  ``--tiny`` narrows the
model and the scene to the widths of the CPU tests
(``__graft_entry__._flagship(tiny=True)``).  The device defaults to
``cuda`` and a missing card is an error.  Stages, the data loader and
checkpoints come with a later slice (ROADMAP.md, queue A item 10).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from .models import inb
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
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="narrow widths and a small scene (CPU runs)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> None:
    from .config import make_cfg
    from .run import resolve_device
    args = parse_args(argv)
    cfg = make_cfg(args.cfg_file, args.opts)
    if args.tiny:
        cfg = cfg.merged(TINY)
    device = resolve_device(args.device)
    t = build_trainer(cfg, device, args.seed, args.tiny)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for i in range(args.steps):
        t0 = time.perf_counter()
        _, stats = t.step(t.state, t.batch, generator=gen)
        loss, psnr = float(stats["loss"]), float(stats["psnr"])   # waits
        ms = 1000.0 * (time.perf_counter() - t0)
        print(f"step {i}: loss {loss:.5f} psnr {psnr:.2f} {ms:.1f} ms "
              f"({cfg.N_rand} rays, {device})", flush=True)


if __name__ == "__main__":
    main()
