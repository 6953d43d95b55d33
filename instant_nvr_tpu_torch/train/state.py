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

``train.moment_dtype: bfloat16`` (Adam only, as in the JAX package) keeps
the first moment in bfloat16 and the second in float32: :class:`AdamBf16Mu`,
optax's ``scale_by_adam(mu_dtype=bfloat16)`` in its order of operations.
Any other value keeps both moments in float32, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
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


class AdamBf16Mu(torch.optim.Optimizer):
    """Adam with a bfloat16 first moment: ``optax.adam(lr, eps=eps,
    mu_dtype=jnp.bfloat16)`` after ``optax.add_decayed_weights``.

    ``torch.optim.Adam`` keeps its moments in the parameter's dtype, so this
    is its own update, in ``scale_by_adam``'s order: with g the gradient
    (plus ``weight_decay * p``),

        mu = (1 - b1) g + bf16(b1) * mu16      (the product rounded to bf16,
                                                as JAX's weak-typed b1 * mu16)
        nu = (1 - b2) g^2 + b2 nu               (float32)
        p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        mu16 = bf16(mu)                         (cast after the update)

    The update uses the float32 ``mu`` before it is cast.  The state
    (``exp_avg`` bf16, ``exp_avg_sq`` f32, ``step``) round-trips through
    ``state_dict`` bit for bit."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a gradient, as a handful of
        ``torch._foreach_*`` sweeps over each group (no host sync)."""
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            sts = [self.state[p] for p in ps]
            for p, st in zip(ps, sts):
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
            gs = [p.grad.float() for p in ps]
            if wd:
                gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
            # b1 * mu16 in bfloat16, as JAX's weak-typed product: b1 rounded
            # to bfloat16 is a Python float, so no tensor is copied
            b1_16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            mu = torch._foreach_mul(gs, 1 - b1)
            torch._foreach_add_(mu, torch._foreach_mul([st["exp_avg"] for st in sts], b1_16))
            nus = [st["exp_avg_sq"] for st in sts]
            torch._foreach_mul_(nus, b2)
            g2 = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_add_(nus, g2)
            # optax's bias corrections, 1 - b^t in float32 with a correctly
            # rounded pow (XLA's; torch.pow cubes by products)
            bc1, bc2 = ([float(np.float32(1) - np.float32(b) ** np.float32(st["step"]))
                         for st in sts] for b in (b1, b2))
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(ps, upd)
            torch._foreach_copy_([st["exp_avg"] for st in sts], mu)
        return None

    def load_state_dict(self, state_dict):
        """``Optimizer.load_state_dict`` casts every moment to the
        parameter's dtype; the first moment goes back to bfloat16 (exact:
        it was a bfloat16 value)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)


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

    groups = _param_groups(model, cfg.get("mlp_weight_decay", 1.0))
    for g in groups:
        g["lr"] = schedule(0) * g["lr_scale"]
    wd = float(cfg.train.weight_decay or 0.0)
    optim = cfg.train.get("optim", "adam")
    if optim == "adam" and cfg.train.get("moment_dtype", "float32") == "bfloat16":
        opt = AdamBf16Mu(groups, eps=cfg.train.eps, weight_decay=wd)
    elif optim == "adam":
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
