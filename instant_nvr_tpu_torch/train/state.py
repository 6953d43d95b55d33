"""Train state: optimizer and learning-rate schedules (port of
``instant_nvr_tpu/train/state.py``).

Adam with the config's eps (1e-15) and a per-step schedule; the JAX
package's ``optax`` chain maps onto one ``torch.optim`` optimizer with two
parameter groups:

  - ``weight_decay`` is the L2 term ``optax.add_decayed_weights`` adds to
    the gradient before the optimizer, which is what ``torch.optim``'s
    ``weight_decay`` does;
  - ``mlp_weight_decay`` scales the update of every parameter outside an
    ``embed`` subtree (the part tables and the deformer's table): here the
    learning rate of that group, which for these update rules is the same
    scale.

The schedule is read at the state's step before every update, as optax
reads its step count.  The JAX package's bf16 table shadow is not carried
over: it only fuses the table cast into the optimizer sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    """Step count, model, optimizer and schedule; a train step updates the
    model and optimizer in place and advances ``step``."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule

    def set_lr(self) -> None:
        """Every group's learning rate for the update at ``self.step``."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]


def make_lr_schedule(base_lr: float, gamma: float, decay_epochs: int,
                     ep_iter: int) -> Schedule:
    """Per-step form of the reference's per-epoch exponential decay
    ``lr * gamma ** (epoch / decay_epochs)``."""
    def schedule(step: int) -> float:
        epoch = step // max(ep_iter, 1)
        return base_lr * gamma ** (epoch / decay_epochs)
    return schedule


def make_warmup_multi_step(base_lr: float, milestones, gamma: float,
                           warmup_factor: float, warmup_iters: int,
                           warmup_method: str, ep_iter: int) -> Schedule:
    """Per-step form of the reference's WarmupMultiStepLR: gamma per passed
    milestone epoch, with a constant or linear warmup over the first
    ``warmup_iters`` epochs."""
    ms = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        epoch = step // max(ep_iter, 1)
        if epoch >= warmup_iters:
            warm = 1.0
        elif warmup_method == "constant":
            warm = warmup_factor
        else:  # linear
            alpha = epoch / max(warmup_iters, 1)
            warm = warmup_factor * (1.0 - alpha) + alpha
        return base_lr * warm * gamma ** sum(m <= epoch for m in ms)
    return schedule


def multi_step(base_lr: float, boundaries: Dict[int, float]) -> Schedule:
    """``optax.piecewise_constant_schedule``: the rate is multiplied by
    ``boundaries[b]`` from step b on."""
    def schedule(step: int) -> float:
        lr = base_lr
        for b, scale in sorted(boundaries.items()):
            if step >= b:
                lr *= scale
        return lr
    return schedule


def _param_groups(model: nn.Module, mlp_scale: float):
    embed, rest = [], []
    for name, p in model.named_parameters():
        (embed if "embed" in name.split(".") else rest).append(p)
    return [{"params": embed, "lr_scale": 1.0},
            {"params": rest, "lr_scale": float(mlp_scale)}]


def make_optimizer(cfg, model: nn.Module
                   ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer over ``model``'s parameters, schedule) from ``cfg.train``."""
    sched_cfg = cfg.train.scheduler
    sched_type = sched_cfg.get("type", "exponential")
    if sched_type == "exponential":
        schedule = make_lr_schedule(cfg.train.lr, sched_cfg.gamma,
                                    sched_cfg.decay_epochs, cfg.ep_iter)
    elif sched_type == "warmup_multi_step":
        schedule = make_warmup_multi_step(
            cfg.train.lr, sched_cfg.milestones, sched_cfg.gamma,
            sched_cfg.get("warmup_factor", 1.0 / 3),
            sched_cfg.get("warmup_iters", 5),
            sched_cfg.get("warmup_method", "linear"), cfg.ep_iter)
    else:  # multi_step
        schedule = multi_step(cfg.train.lr,
                              {int(m) * cfg.ep_iter: float(sched_cfg.gamma)
                               for m in sched_cfg.milestones})

    if cfg.train.get("moment_dtype", "float32") != "float32":
        raise NotImplementedError(
            "train.moment_dtype other than float32 (the JAX package's bf16 "
            "first moment) is not ported yet (ROADMAP.md, queue A)")

    groups = _param_groups(model, cfg.get("mlp_weight_decay", 1.0))
    for g in groups:
        g["lr"] = schedule(0) * g["lr_scale"]
    wd = float(cfg.train.weight_decay or 0.0)
    optim = cfg.train.get("optim", "adam")
    if optim == "adam":
        opt = torch.optim.Adam(groups, eps=cfg.train.eps, weight_decay=wd)
    elif optim == "radam":
        opt = torch.optim.RAdam(groups, eps=cfg.train.eps, weight_decay=wd)
    elif optim == "sgd":
        opt = torch.optim.SGD(groups, lr=schedule(0), momentum=0.9,
                              weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {optim!r}")
    return opt, schedule


def create_train_state(cfg, model: nn.Module) -> TrainState:
    opt, schedule = make_optimizer(cfg, model)
    return TrainState(step=0, model=model, optimizer=opt, schedule=schedule)
