"""Losses and the train step (port of ``instant_nvr_tpu/train/step.py``).

One step: render (``render_rays(train=True)``) -> losses -> ``backward()``
-> optimizer update.  The hash-table gradients of the backward go through
the scatter kernels of ``ops/scatter.py`` (routing in ``ops/hashgrid.py``);
:func:`table_grad_launches` says how many of each one step launches.

In patch mode (``use_lpips`` and the other patch losses) the image-space
``patch_loss_fn`` (``train/loop.py:make_patch_loss_fn``) replaces the
image MSE.  ``remat`` recomputes the render forward in the backward
(``torch.utils.checkpoint``) instead of keeping its activations.

Across ranks (a process group, ``parallel/mesh.py``) each rank holds a
contiguous slice of the batch's rays and the step gives every rank the
one-process step on the whole batch, as the JAX package's sharded step
does: each loss term is this rank's sum over the whole batch's count, so
the ranks' losses and gradients sum to the one-process ones, and one SUM
all-reduce of the gradients precedes the update.  The random draws are
the whole batch's on every rank (:func:`draw_render`).  The cull and part
budgets select per rank, from the rank's own samples: the same points as
one process whenever neither overflows (ROADMAP.md §C).  The pair
selection is the one process's in any case (``renderer/inb_renderer.py``).
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models import inb
from ..ops import hashgrid
from ..ops.math import safe_norm
from ..parallel import mesh as pmesh
from ..renderer.inb_renderer import (TELEMETRY_KEYS, RenderSpec, pair_budget,
                                     pair_reg_loss, render_rays)
from ..utils import telemetry
from .crit import elastic_crit, normal_crit, sdf_mask_crit
from .state import TrainState


class LossWeights(NamedTuple):
    """Loss gates and weights (the stage-scheduled distortion weight rides
    in the batch as ``reg_dist_weight``)."""
    pair: float = 10.0
    resd: float = 0.1
    use_pair: bool = True
    use_distortion: bool = True
    use_patch: bool = False       # LPIPS/SSIM/... patch losses
    patch_kind: str = "lpips"
    use_freespace: bool = False   # BCE(occ, 0) on mask-background rays
    free_weight: float = 1e-4
    use_occ: bool = False         # BCE(max occ, 1) on mask-foreground rays
    occ_weight: float = 1e-4
    rgb_resd: float = 0.01        # rgb residual coefficient (rgb_resd_loss_coe)
    num_trained_mask: int = 2 ** 30   # msk_sdf loss only for latents below this
    remat: bool = False


def make_loss_weights(cfg) -> LossWeights:
    patch_kind = ""
    for k in ("lpips", "ssim", "fourier", "tv_image"):
        if cfg.get(f"use_{k}", False):
            patch_kind = k
            break
    return LossWeights(
        pair=cfg.pair_loss_weight,
        resd=cfg.resd_loss_weight,
        use_pair=cfg.use_pair_reg,
        use_distortion=cfg.use_reg_distortion,
        use_patch=bool(patch_kind),
        patch_kind=patch_kind or "lpips",
        use_freespace=cfg.get("use_freespace_loss", False),
        free_weight=cfg.get("free_loss_weight", 1e-4),
        use_occ=cfg.get("use_occ_loss", False),
        occ_weight=cfg.get("occ_loss_weight", 1e-4),
        rgb_resd=cfg.get("rgb_resd_loss_coe", 0.01),
        num_trained_mask=int(cfg.get("num_trained_mask", 2 ** 30)),
        remat=cfg.get("remat", False),
    )


def variant_losses(ret: Dict, batch: Dict, lw: LossWeights, step: int,
                   world: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss terms of model variants, each gated on its key in ``ret`` (the
    inb part model emits none of them).  Returns (loss, stats).  Each term
    is a mean over this rank's equal share of the rays, so over ``world``
    ranks it counts 1/world: the ranks' terms sum to the whole batch's."""
    stats: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), dtype=torch.float32, device=ret["rgb_map"].device)
    terms = []
    if "rgb_res" in ret:
        terms.append(("rgb_resd_loss", lw.rgb_resd,
                      torch.mean(safe_norm(ret["rgb_res"], dim=-1))))
    if "fw_resd" in ret:
        terms.append(("fwresd_loss", 1.0, torch.mean(
            safe_norm(ret["fw_resd"] + ret["bw_resd"], dim=-1))))
    if "pred_pbw" in ret:
        terms.append(("tbw_loss", 1.0,
                      torch.mean((ret["pred_pbw"] - ret["smpl_tbw"]) ** 2)))
    if "msk_sdf" in ret:
        # mask supervision only for the early latent codes
        gate = float(int(batch.get("latent_index", 0)) < lw.num_trained_mask)
        terms.append(("mask_loss", 1.0, sdf_mask_crit(
            ret["msk_sdf"], ret["msk_label"], step) * gate))
    if "surf_normal" in ret and "normal" in batch:
        terms.append(("normal_loss", 0.01, normal_crit(
            ret["surf_normal"], batch["normal"], batch["ray_d"])))
    for key, name in (("gradients", "grad_loss"),
                      ("observed_gradients", "ograd_loss")):
        if key in ret:  # eikonal
            terms.append((name, 0.1, torch.mean(
                (safe_norm(ret[key], dim=-1) - 1.0) ** 2)))
    if "resd_jacobian" in ret:
        terms.append(("elas_loss", 0.1, elastic_crit(ret["resd_jacobian"])))
    for name, weight, l in terms:
        l = l / world
        stats[name] = l
        loss = loss + weight * l
    return loss, stats


PatchLossFn = Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                      torch.Tensor]


def draw_render(mspec: inb.ModelSpec, rspec: RenderSpec, n_rays: int,
                generator: torch.Generator | None,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The random draws of one ``render_rays(train=True)`` on ``n_rays``
    rays, as its ``draws=``: the depth jitter (R, S) and the pair
    regularizer's neighbour offsets (B, 3), B the pair budget of ``n_rays``
    x S samples.  Across ranks ``n_rays`` is the whole batch's: every rank
    draws the one-process draws from the same seed, takes its own rows of
    the jitter, and keeps every offset row for the renderer to give each
    selected point the row of its slot in the one-process selection."""
    S = rspec.n_samples
    t_rand = torch.rand((n_rays, S), generator=generator, device=device)
    noise = torch.rand((pair_budget(mspec, rspec, n_rays * S), 3),
                       generator=generator, device=device)
    return {"t_rand": t_rand, "pair_noise": (noise - 0.5) * rspec.pair_range}


def compute_losses(mspec: inb.ModelSpec, rspec: RenderSpec, lw: LossWeights,
                   model: inb.InbModel, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   draws: Dict[str, torch.Tensor] | None = None,
                   step: int = 0,
                   patch_loss_fn: Optional[PatchLossFn] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, stats).  ``batch['rgb']`` is the ground truth per ray.

    Image MSE (masked by ``ray_mask`` when present), or in patch mode
    ``patch_loss_fn(ret, batch)`` in its place; pair regularizer x
    ``lw.pair``, distortion x ``batch['reg_dist_weight']``, residual
    magnitude x ``lw.resd``, the gated freespace/occupancy BCE terms and
    the variant terms.  Stats carry each term, ``psnr``, the overflow
    telemetry, ``loss`` and the per-ray L1 ``ray_error``.

    Under ``lw.remat`` the render runs inside ``torch.utils.checkpoint``.
    The checkpoint would replay only the global RNG, not ``generator``, so
    the draws are made before it and passed in: the recomputed forward sees
    the same jitter and pair noise.

    Across ranks ``batch`` holds this rank's rays and ``draws`` (or the
    draws from ``generator``) the whole batch's.  Every term is this rank's
    share: its sum over the whole batch's count (rays, samples, budget
    slots; the ray mask's, valid pairs' and background rays' counts summed
    over the ranks in one all-reduce).  The patch loss sees the whole patch
    (gathered with autograd) and counts 1/world on each rank.  The stats
    are the shares too, until the step sums them (:func:`reduce_stats`).
    """
    world = pmesh.world_size()
    R = batch["ray_o"].shape[0]
    if draws is None:
        draws = draw_render(mspec, rspec, R * world, generator,
                            batch["ray_o"].device)
    lo = pmesh.rank() * R
    draws = dict(draws, t_rand=draws["t_rand"][lo:lo + R])
    if lw.remat:
        # the render draws nothing from the global RNG (its draws are given,
        # and render_rays(train=True) samples no pdf), so the checkpoint has
        # no RNG state to keep; keeping it would read and set the global
        # CUDA RNG state, which a CUDA graph capture refuses
        ret = checkpoint(lambda b, d: render_rays(mspec, rspec, model, b,
                                                  train=True, draws=d),
                         batch, draws, use_reentrant=False,
                         preserve_rng_state=False)
    else:
        ret = render_rays(mspec, rspec, model, batch, train=True, draws=draws)
    stats: Dict[str, torch.Tensor] = {}

    rgb_gt = batch["rgb"]
    ray_mask = batch.get("ray_mask")
    masks = (lw.use_freespace or lw.use_occ) and "occupancy" in batch
    is_bg = batch["occupancy"] < 0.5 if masks else None
    pairs = lw.use_pair and "pair_resd0" in ret
    # the counts a mean divides by, summed over the ranks in one all-reduce
    counts = {}
    if ray_mask is not None:
        counts["rays"] = torch.sum(ray_mask)
    if pairs:
        counts["pairs"] = torch.sum(ret["pair_valid"])
    if masks:
        counts["bg"] = torch.sum(is_bg)
    if counts:
        summed = pmesh.all_reduce_(torch.stack([c.float() for c in counts.values()]))
        counts = dict(zip(counts, summed))

    def mean(x):                 # over equal shares of the rays
        return torch.mean(x) / world

    diff2 = torch.sum((ret["rgb_map"] - rgb_gt) ** 2, dim=-1) / 3.0
    if ray_mask is not None:
        img_loss = torch.sum(diff2 * ray_mask) / torch.clamp(counts["rays"],
                                                             min=1.0)
    else:
        img_loss = mean(diff2)
    stats["img_loss"] = img_loss
    stats["psnr"] = -10.0 * torch.log10(img_loss)
    if lw.use_patch and patch_loss_fn is not None:
        whole = pmesh.gather_rows(torch.cat(
            [ret["rgb_map"], rgb_gt, ray_mask[:, None]], dim=-1))
        loss = patch_loss_fn({"rgb_map": whole[:, :3]},
                             {"rgb": whole[:, 3:6],
                              "ray_mask": whole[:, 6]}) / world
        stats["patch_loss"] = loss
    else:
        loss = img_loss

    if pairs:
        pl = pair_reg_loss(ret["pair_resd0"], ret["pair_resd1"],
                           ret["pair_valid"], count=counts["pairs"])
        stats["pair_loss"] = pl
        loss = loss + lw.pair * pl
    if lw.use_distortion and "reg_distortion" in ret:
        dl = mean(ret["reg_distortion"])
        stats["reg_dist"] = dl
        loss = loss + batch.get("reg_dist_weight", 0.1) * dl
    if "resd" in ret:
        norms = safe_norm(ret["resd"], dim=-1)
        # the mean over the one-process budget's slots, whose invalid ones
        # hold a zero residual of norm safe_norm(0), as the ranks' do: the
        # ranks' slots, and the one process's count less theirs (budgets
        # round per sample count) shared out as such invalid slots
        slots = sum(inb.budgets(mspec, R * world * rspec.n_samples)[1])
        n0 = safe_norm(torch.zeros_like(ret["resd"][:1]), dim=-1)[0]
        ol = (torch.sum(norms)
              + (slots - world * norms.shape[0]) * n0 / world) / slots
        stats["offset_loss"] = ol
        loss = loss + lw.resd * ol

    if masks:
        occ_s = torch.clamp(ret["occ"], 1e-6, 1.0 - 1e-6)       # (R, S)
        zero = torch.zeros_like(occ_s)
        if lw.use_freespace:
            denom = torch.clamp(counts["bg"] * occ_s.shape[-1], min=1)
            fl = torch.sum(torch.where(is_bg[:, None], -torch.log(1.0 - occ_s),
                                       zero)) / denom
            stats["free_loss"] = fl
            loss = loss + lw.free_weight * fl
        if lw.use_occ:
            max_occ = torch.amax(occ_s, dim=-1)                  # (R,)
            # only foreground rays whose max occupancy is below 0.5
            pen = (~is_bg) & (max_occ < 0.5)
            ol2 = torch.sum(torch.where(pen, -torch.log(max_occ),
                                        torch.zeros_like(max_occ))) \
                / (occ_s.shape[0] * world)
            stats["occ_loss"] = ol2
            loss = loss + lw.occ_weight * ol2

    vloss, vstats = variant_losses(ret, batch, lw, step, world)
    loss = loss + vloss
    stats.update(vstats)
    for k in TELEMETRY_KEYS:
        stats[k] = ret[k]
    if world > 1:
        stats["budget_counts"] = ret["budget_counts"]
    stats["loss"] = loss
    stats["ray_error"] = torch.sum(torch.abs(ret["rgb_map"] - rgb_gt), dim=-1).detach()
    return loss, stats


def forward_backward(mspec: inb.ModelSpec, rspec: RenderSpec, lw: LossWeights,
                     state: TrainState, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator | None = None,
                     draws: Dict[str, torch.Tensor] | None = None,
                     patch_loss_fn: Optional[PatchLossFn] = None,
                     span=telemetry.untimed) -> Dict[str, torch.Tensor]:
    """A step up to its update: zero the grads, forward, backward, a zero
    gradient for every parameter the loss does not reach; returns the
    stats.  ``span`` is ``telemetry.span`` on the eager route (the
    captured step runs this inside its graph, where no span may go)."""
    with span("step.forward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss, stats = compute_losses(mspec, rspec, lw, state.model, batch,
                                     generator, draws, step=state.step,
                                     patch_loss_fn=patch_loss_fn)
    with span("step.backward"):
        loss.backward()
        # JAX's gradient of a parameter the loss does not reach is zero, and
        # optax still steps it (weight decay, decaying moments), where
        # torch.optim skips a parameter without a gradient
        for p in state.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    return stats


def make_train_step(mspec: inb.ModelSpec, rspec: RenderSpec, lw: LossWeights,
                    patch_loss_fn: Optional[PatchLossFn] = None):
    """The train step ``(state, batch, generator=None, draws=None) ->
    (state, stats)``: zero the grads, forward, backward, one optimizer
    update at the schedule's rate for ``state.step``; the state is updated
    in place.  Stats are detached tensors (nothing waits for the device).
    ``patch_loss_fn`` is the patch-mode image loss (used when
    ``lw.use_patch``).  This is the eager route; ``train/compiled.py``
    replays :func:`make_step_body` as a CUDA graph.  Its spans
    (``utils/telemetry.py``): ``step`` (unit: ``state.step``) holding
    ``step.forward``, ``step.backward`` and ``step.optimizer`` (with the
    ranks' all-reduce)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   draws: Dict[str, torch.Tensor] | None = None):
        with telemetry.span("step", state.step):
            stats = forward_backward(mspec, rspec, lw, state, batch, generator,
                                     draws, patch_loss_fn, span=telemetry.span)
            with telemetry.span("step.optimizer"):
                if pmesh.world_size() > 1:
                    pmesh.all_reduce_grads(state.model.parameters())
                    stats = reduce_stats(stats)
                state.set_lr()
                state.optimizer.step()
            state.step += 1
        return state, {k: v.detach() for k, v in stats.items()}

    return train_step


def make_step_body(mspec: inb.ModelSpec, rspec: RenderSpec, lw: LossWeights,
                   patch_loss_fn: Optional[PatchLossFn] = None):
    """The step as a CUDA graph can capture it: ``body(state, batch, draws,
    sched, dstep) -> stats`` is :func:`make_train_step`'s step (across
    ranks its collectives too, all on the device), with the draws given
    (``draw_render``'s of the whole batch, made before it) and
    the optimizer's update read from the :class:`~.state.DeviceSchedule`
    ``sched`` at the device step counter ``dstep`` (a 0-d int64 tensor,
    advanced by one on the device).  It reads no host value that changes
    from step to step and never waits for the device; ``state.step`` and
    the optimizer's host step counts are the caller's to advance."""

    def body(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Dict[str, torch.Tensor], sched, dstep: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        stats = forward_backward(mspec, rspec, lw, state, batch, None, draws,
                                 patch_loss_fn)
        if pmesh.world_size() > 1:
            pmesh.all_reduce_grads(state.model.parameters())
            stats = reduce_stats(stats)
        state.optimizer.step_device(sched, dstep)
        dstep.add_(1)
        return {k: v.detach() for k, v in stats.items()}

    return body


# stats that are not a rank's share of a sum (reduce_stats)
_NOT_SUMMED = ("psnr", "cull_overflow", "part_overflow", "cull_need",
               "part_need", "budget_counts", "ray_error")


def reduce_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' step stats as the whole batch's, in one collective: the
    loss terms summed (each rank's is its share), ``psnr`` from the summed
    image loss, the overflows from the summed counts, the demand
    (``*_need``) of the rank that needs the most, ``ray_error`` of every
    ray in rank order."""
    shares = [k for k, v in stats.items() if k not in _NOT_SUMMED]
    parts = [stats[k].detach().float().reshape(-1) for k in shares]
    parts += [stats[k].detach().float().reshape(-1) for k in
              ("budget_counts", "cull_need", "part_need", "ray_error")]
    rows = pmesh.all_gather_rows(torch.cat(parts))          # (world, n)
    out = dict(zip(shares, rows[:, :len(shares)].sum(0)))
    n = len(shares)
    true_c, sel_c, flag, sel_p = rows[:, n:n + 4].sum(0)
    out["cull_overflow"] = (true_c - sel_c) / torch.clamp(true_c, min=1)
    out["part_overflow"] = (flag - sel_p) / torch.clamp(flag, min=1)
    out["cull_need"] = rows[:, n + 4].amax()
    n_parts = stats["part_need"].numel()
    out["part_need"] = rows[:, n + 5:n + 5 + n_parts].amax(0)
    out["ray_error"] = rows[:, n + 5 + n_parts:].reshape(-1)
    out["psnr"] = -10.0 * torch.log10(out["img_loss"])
    return out


def encoder_calls(rspec: RenderSpec) -> int:
    """Hash-grid encoder calls of one train step, each asking for a
    gradient (on the card one launch of each of ``ops/hashgrid.py``'s
    forward and backward kernels): the deformer and the part grids over the
    samples, and the deformer again for the pair regularizer's
    neighbours."""
    return 3 if rspec.use_pair_reg else 2


def table_grad_launches(mspec: inb.ModelSpec, rspec: RenderSpec) -> Counter:
    """Table-gradient scatters of one train step by route ('segmented',
    'onehot', 'exact'): the part grids once, the deformer's table once for
    the samples and once more for the pair regularizer's neighbours."""
    part_dtype = (torch.bfloat16 if mspec.grid_compute_dtype == "bfloat16"
                  else torch.float32)
    routes = Counter()
    for s in mspec.part_embeds:
        routes.update(hashgrid.encode_grad_routes(s, part_dtype))
    deformer = hashgrid.encode_grad_routes(mspec.deformer.embed, torch.float32)
    for _ in range(2 if rspec.use_pair_reg else 1):
        routes.update(deformer)
    return routes
