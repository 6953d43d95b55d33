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

Each optimizer is optax's in its order of operations: Adam is
:class:`OptaxAdam` (``scale_by_adam``), RAdam :class:`OptaxRAdam`
(``scale_by_radam``), SGD :class:`OptaxSGD` (``trace`` with momentum 0.9).
``train.moment_dtype: bfloat16`` (Adam only, as in the JAX package) keeps
the first moment in bfloat16 and the second in float32
(:class:`AdamBf16Mu`).  Any other value keeps both moments in float32, as
the JAX package does.  Each update also runs from a
:class:`DeviceSchedule` (the captured step, ``train/compiled.py``).
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


def bias_correction(beta: float, step: int) -> float:
    """optax's bias correction ``1 - beta^t`` in float32 with a correctly
    rounded pow (XLA's; ``torch.pow`` cubes by products), as a host float."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(step))


RADAM_THRESHOLD = 5.0


def radam_rectification(b2: float, step: int) -> Tuple[float, bool]:
    """``optax.scale_by_radam``'s rectification at step count ``step``:
    (r_t, whether ρ_t reaches the threshold 5 so that the rectified update
    is taken), each operation in float32 as JAX computes it.  ρ_t crosses
    5 between counts 5 and 6 for b2 = 0.999."""
    f = np.float32
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = f(b2) ** f(step)
    ro = f(ro_inf) - f(2 * step) * b2t / (f(1) - b2t)
    with np.errstate(invalid="ignore"):     # NaN below the threshold, unused
        r = np.sqrt((ro - f(4)) * (ro - f(2)) * f(ro_inf)
                    / (f((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
    return float(r), bool(ro >= RADAM_THRESHOLD)


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
    or 0-d device tensors read from a :class:`DeviceSchedule` in
    :meth:`step_device`, the form a CUDA graph can replay; both run the same
    ``torch._foreach_*`` sweeps, so they give the same bits.  (The port's
    Adam; ``torch.optim.Adam`` fuses its last product into ``addcdiv``,
    which no sweep with a device scalar reproduces.)  The state
    (``exp_avg`` in ``mu_dtype``, ``exp_avg_sq`` f32, ``step``) round-trips
    through ``state_dict`` bit for bit; a ``step`` read from a
    ``torch.optim.Adam`` checkpoint (a tensor) is taken as its integer."""

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

    @torch.no_grad()
    def step_device(self, sched: "DeviceSchedule", dstep: torch.Tensor) -> None:
        """:meth:`step` with its per-step scalars read from ``sched``'s
        tables at the device step counter ``dstep`` (the state's step before
        the update, a 0-d int64 tensor): no host value enters the sweeps, so
        a CUDA graph of it replays each step's own rate.  The host ``step``
        of the states is left as it is: the caller advances it once a step
        (:meth:`advance_steps`), for ``state_dict``."""
        bc1, bc2 = _at(sched.bc1, dstep), _at(sched.bc2, dstep)
        for i, group in enumerate(self.param_groups):
            ps, sts = self._states(group, advance=False)
            if ps:
                self._update(group, ps, sts, bc1, bc2, _at(sched.neg_lr[i], dstep))

    def advance_steps(self) -> None:
        """Advance every state's host ``step`` by one (after a
        :meth:`step_device`)."""
        for st in self.state.values():
            st["step"] = int(st["step"]) + 1

    def step_tables(self, counts) -> Dict[str, np.ndarray]:
        """The per-step scalars shared by every group, for the step counts
        ``counts`` (the count after each update), as :class:`DeviceSchedule`
        keeps them: the bias corrections ``bc1``, ``bc2`` (float32)."""
        b1, b2 = self._betas()
        return {"bc1": np.asarray([bias_correction(b1, t) for t in counts], np.float32),
                "bc2": np.asarray([bias_correction(b2, t) for t in counts], np.float32)}

    def _betas(self) -> Tuple[float, float]:
        betas = {tuple(g["betas"]) for g in self.param_groups}
        if len(betas) != 1:
            raise ValueError(f"param groups with different betas {sorted(betas)}")
        return betas.pop()

    def load_state_dict(self, state_dict):
        """``Optimizer.load_state_dict`` casts every moment to the
        parameter's dtype; the first moment goes back to ``mu_dtype``
        (exact: it was a value of that dtype)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)


class AdamBf16Mu(OptaxAdam):
    """:class:`OptaxAdam` with a bfloat16 first moment: ``optax.adam(lr,
    eps=eps, mu_dtype=jnp.bfloat16)`` (``train.moment_dtype: bfloat16``)."""

    mu_dtype = torch.bfloat16


class OptaxRAdam(OptaxAdam):
    """``optax.radam(lr, eps=eps)`` after ``optax.add_decayed_weights``, in
    ``scale_by_radam``'s order of operations: the moments as
    :class:`OptaxAdam`'s (float32), then with ``mu_hat = mu / (1 - b1^t)``
    and ``nu_hat = nu / (1 - b2^t)``

        p += -lr * (r_t * mu_hat / (sqrt(nu_hat) + eps)   if ρ_t >= 5
                    else mu_hat)

    with r_t and the branch from :func:`radam_rectification`.  In
    :meth:`step` the branch is a host choice per step; in
    :meth:`step_device` both updates are computed and one is taken with
    ``torch.where`` at the device step, so a graph replays each step's own
    branch.  Both run the same sweeps, so they give the same bits.  The
    state's keys are ``torch.optim.RAdam``'s (``exp_avg``, ``exp_avg_sq``,
    ``step``), and a state of it resumes here."""

    def _update(self, group, ps, sts, bc1, bc2, neg_lr, rect=None, rectify=None):
        """One update of ``ps``; the scalars as :meth:`OptaxAdam._update`'s,
        with ``rect`` (r_t) and ``rectify`` (the branch: host bools, one a
        parameter, or a 0-d bool tensor)."""
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        gs = [p.grad.float() for p in ps]
        if wd:
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
        mus = [st["exp_avg"] for st in sts]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - b1))
        nus = [st["exp_avg_sq"] for st in sts]
        torch._foreach_mul_(nus, b2)
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_add_(nus, g2)
        mu_hat = torch._foreach_div(mus, bc1)
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_mul(mu_hat, rect)
        torch._foreach_div_(upd, den)
        if torch.is_tensor(rectify):
            upd = [torch.where(rectify, u, m) for u, m in zip(upd, mu_hat)]
        else:
            upd = [u if r else m for u, m, r in zip(upd, mu_hat, rectify)]
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(ps, upd)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a gradient at each group's
        ``lr`` (no host sync)."""
        for group in self.param_groups:
            ps, sts = self._states(group)
            if not ps:
                continue
            b1, b2 = group["betas"]
            rects = [radam_rectification(b2, st["step"]) for st in sts]
            self._update(group, ps, sts,
                         [bias_correction(b1, st["step"]) for st in sts],
                         [bias_correction(b2, st["step"]) for st in sts],
                         -group["lr"], [r for r, _ in rects], [b for _, b in rects])
        return None

    @torch.no_grad()
    def step_device(self, sched: "DeviceSchedule", dstep: torch.Tensor) -> None:
        """:meth:`step` with its scalars and branch read from ``sched`` at
        the device step counter ``dstep`` (see :meth:`OptaxAdam.step_device`)."""
        at = lambda table: _at(table, dstep)
        bc1, bc2, rect, rectify = (at(sched.bc1), at(sched.bc2), at(sched.rect),
                                   at(sched.rectify))
        for i, group in enumerate(self.param_groups):
            ps, sts = self._states(group, advance=False)
            if ps:
                self._update(group, ps, sts, bc1, bc2, at(sched.neg_lr[i]), rect,
                             rectify)

    def step_tables(self, counts) -> Dict[str, np.ndarray]:
        """:meth:`OptaxAdam.step_tables` and the rectification of each
        count: ``rect`` (r_t, float32) and ``rectify`` (bool)."""
        _, b2 = self._betas()
        rects = [radam_rectification(b2, t) for t in counts]
        return dict(super().step_tables(counts),
                    rect=np.asarray([r for r, _ in rects], np.float32),
                    rectify=np.asarray([b for _, b in rects], bool))


class OptaxSGD(torch.optim.Optimizer):
    """``optax.sgd(lr, momentum=0.9)`` after ``optax.add_decayed_weights``:
    with g the gradient (plus ``weight_decay * p``),

        trace = g + momentum * trace            (float32, from zeros)
        p += -lr * trace

    The update reads no step count: :meth:`step` takes the group's rate
    as a host float, :meth:`step_device` reads it from a
    :class:`DeviceSchedule`, through the same sweeps.  The state is
    ``torch.optim.SGD``'s ``momentum_buffer``, and a state of it resumes
    here (its first step's buffer, ``g``, is this one's ``g + 0.9 * 0``)."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "momentum": momentum,
                                  "weight_decay": weight_decay})

    def _update(self, group, neg_lr) -> None:
        ps = [p for p in group["params"] if p.grad is not None]
        if not ps:
            return
        bufs = []
        for p in ps:
            st = self.state[p]
            if "momentum_buffer" not in st:
                st["momentum_buffer"] = torch.zeros_like(p, dtype=torch.float32)
            bufs.append(st["momentum_buffer"])
        gs = [p.grad.float() for p in ps]
        if group["weight_decay"]:
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, group["weight_decay"]))
        torch._foreach_mul_(bufs, group["momentum"])
        torch._foreach_add_(bufs, gs)
        torch._foreach_add_(ps, torch._foreach_mul(bufs, neg_lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            self._update(group, -group["lr"])
        return None

    @torch.no_grad()
    def step_device(self, sched: "DeviceSchedule", dstep: torch.Tensor) -> None:
        for i, group in enumerate(self.param_groups):
            self._update(group, _at(sched.neg_lr[i], dstep))

    def advance_steps(self) -> None:
        """Nothing: the state holds no step count."""

    def step_tables(self, counts) -> Dict[str, np.ndarray]:
        return {}


# the optimizers whose update also runs from a DeviceSchedule
DEVICE_OPTIMIZERS = (OptaxAdam, OptaxSGD)


def _at(table: torch.Tensor, dstep: torch.Tensor) -> torch.Tensor:
    """``table[dstep]`` as a gather on the device: indexing with a 0-d
    tensor would read the index on the host, a wait that a graph cannot
    capture."""
    return table.index_select(0, dstep.reshape(1)).reshape(())


class DeviceSchedule:
    """The per-step scalars of an optimizer of :data:`DEVICE_OPTIMIZERS`
    run on the device, for steps ``0 .. n_steps - 1`` (the state's step
    before each update): each group's ``neg_lr`` (``-schedule(t) *
    lr_scale``, float32) and the optimizer's ``step_tables`` at step count
    t + 1 as attributes (Adam's ``bc1``, ``bc2``; RAdam's also ``rect`` and
    ``rectify``), each of ``n_steps`` entries, made with numpy by the same
    host expressions as the optimizer's :meth:`step` (so the float32
    values are the ones its sweeps round its host scalars to)."""

    def __init__(self, optimizer, schedule: Schedule, n_steps: int, device):
        self.n_steps = int(n_steps)
        put = lambda a: torch.from_numpy(np.asarray(a)).to(device)
        for name, table in optimizer.step_tables(range(1, self.n_steps + 1)).items():
            setattr(self, name, put(table))
        lrs = [schedule(t) for t in range(self.n_steps)]
        self.neg_lr = [put(np.asarray([-(lr * g["lr_scale"]) for lr in lrs], np.float32))
                       for g in optimizer.param_groups]


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
        opt = OptaxAdam(groups, eps=cfg.train.eps, weight_decay=wd)
    elif optim == "radam":
        opt = OptaxRAdam(groups, eps=cfg.train.eps, weight_decay=wd)
    elif optim == "sgd":
        opt = OptaxSGD(groups, lr=schedule(0), momentum=0.9, weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {optim!r}")
    return opt, schedule


def create_train_state(cfg, model: nn.Module) -> TrainState:
    opt, schedule = make_optimizer(cfg, model)
    return TrainState(step=0, model=model, optimizer=opt, schedule=schedule)
