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

Adam is optax's ``scale_by_adam`` in its order of operations
(:class:`OptaxAdam`).  ``train.moment_dtype: bfloat16`` keeps the first
moment in bfloat16 and the second in float32 (:class:`AdamBf16Mu`).  Any
other value keeps both moments in float32, as the JAX package does.  The
program's RAdam, SGD, step-decay schedules and captured-step updates are
not in this copy: the benchmark's cells train with Adam on an exponential
schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

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


def bias_correction(beta: float, step: int) -> float:
    """optax's bias correction ``1 - beta^t`` in float32 with a correctly
    rounded pow (XLA's; ``torch.pow`` cubes by products), as a host float."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(step))



class OptaxAdam(torch.optim.Optimizer):
    """``optax.adam(lr, eps=eps, mu_dtype=mu_dtype)`` after
    ``optax.add_decayed_weights``, in ``scale_by_adam``'s order of
    operations: with g the gradient (plus ``weight_decay * p``),

        mu = (1 - b1) g + b1 * mu               (float32 moment)
        mu = (1 - b1) g + bf16(b1) * mu16       (bfloat16 moment: the product
                                                 rounded to bf16, as JAX's
                                                 weak-typed b1 * mu16)
        nu = (1 - b2) g^2 + b2 nu               (float32)
        p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        mu16 = bf16(mu)                         (cast after the update)

    The update uses the float32 ``mu`` before it is cast.  Its per-step
    scalars (-lr, both bias corrections) are host floats in :meth:`step`,
    run through the program's ``torch._foreach_*`` sweeps.  (The port's
    Adam; ``torch.optim.Adam`` fuses its last product into ``addcdiv``,
    which gives other bits.)  The state is ``exp_avg`` in ``mu_dtype``,
    ``exp_avg_sq`` f32 and ``step``."""

    mu_dtype = torch.float32

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})

    def _states(self, group, advance: bool = True):
        """(params with a gradient, their states), each state made and,
        with ``advance``, its ``step`` advanced."""
        ps = [p for p in group["params"] if p.grad is not None]
        sts = [self.state[p] for p in ps]
        for p, st in zip(ps, sts):
            if not st:
                st["step"] = 0
                st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            if advance:
                st["step"] = int(st["step"]) + 1
        return ps, sts

    def _update(self, group, ps, sts, bc1, bc2, neg_lr) -> None:
        """One update of ``ps``; ``bc1``, ``bc2`` and ``neg_lr`` are scalars
        (host floats, a list of one a parameter, or 0-d tensors)."""
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        gs = [p.grad.float() for p in ps]
        if wd:
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
        mu = torch._foreach_mul(gs, 1 - b1)
        mus = [st["exp_avg"] for st in sts]
        if self.mu_dtype == torch.bfloat16:
            # b1 * mu16 in bfloat16, as JAX's weak-typed product: b1 rounded
            # to bfloat16 is a Python float, so no tensor is copied
            torch._foreach_add_(mu, torch._foreach_mul(
                mus, float(torch.tensor(b1, dtype=torch.bfloat16))))
        else:
            torch._foreach_add_(mu, torch._foreach_mul(mus, b1))
        nus = [st["exp_avg_sq"] for st in sts]
        torch._foreach_mul_(nus, b2)
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_add_(nus, g2)
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(ps, upd)
        torch._foreach_copy_(mus, mu)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a gradient at each group's
        ``lr``, as a handful of ``torch._foreach_*`` sweeps over each group
        (no host sync)."""
        for group in self.param_groups:
            ps, sts = self._states(group)
            if not ps:
                continue
            b1, b2 = group["betas"]
            bc1 = [bias_correction(b1, st["step"]) for st in sts]
            bc2 = [bias_correction(b2, st["step"]) for st in sts]
            self._update(group, ps, sts, bc1, bc2, -group["lr"])
        return None


class AdamBf16Mu(OptaxAdam):
    """:class:`OptaxAdam` with a bfloat16 first moment: ``optax.adam(lr,
    eps=eps, mu_dtype=jnp.bfloat16)`` (``train.moment_dtype: bfloat16``)."""

    mu_dtype = torch.bfloat16


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
    if sched_type != "exponential":
        raise ValueError(f"scheduler {sched_type!r}: this reference keeps the "
                         "exponential schedule only")
    schedule = make_lr_schedule(cfg.train.lr, sched_cfg.gamma,
                                sched_cfg.decay_epochs, cfg.ep_iter)

    groups = _param_groups(model, cfg.get("mlp_weight_decay", 1.0))
    for g in groups:
        g["lr"] = schedule(0) * g["lr_scale"]
    wd = float(cfg.train.weight_decay or 0.0)
    optim = cfg.train.get("optim", "adam")
    if optim == "adam" and cfg.train.get("moment_dtype", "float32") == "bfloat16":
        opt = AdamBf16Mu(groups, eps=cfg.train.eps, weight_decay=wd)
    elif optim == "adam":
        opt = OptaxAdam(groups, eps=cfg.train.eps, weight_decay=wd)
    else:
        raise ValueError(f"optimizer {optim!r}: this reference keeps Adam only")
    return opt, schedule


def create_train_state(cfg, model: nn.Module) -> TrainState:
    opt, schedule = make_optimizer(cfg, model)
    return TrainState(step=0, model=model, optimizer=opt, schedule=schedule)
