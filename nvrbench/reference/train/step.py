"""Losses and the train step (port of ``instant_nvr_tpu/train/step.py``).

One step: render (``render_rays(train=True)``) -> losses -> ``backward()``
-> optimizer update.  The hash-table gradients of the backward go through
the scatter kernels of ``ops/scatter.py`` (routing in ``ops/hashgrid.py``);
:func:`table_grad_launches` says how many of each one step launches.

In patch mode (``use_lpips`` and the other patch losses) the image-space
``patch_loss_fn`` (``train/loop.py:make_patch_loss_fn``) replaces the
image MSE.  ``remat`` recomputes the render forward in the backward
(``torch.utils.checkpoint``) instead of keeping its activations.

The benchmark's reference is the one-process step: the program's
multi-rank branches, its captured-step body and the loss terms of other
model variants are left out of this copy.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models import inb
from ..ops import hashgrid
from ..ops.math import safe_norm
from ..renderer.inb_renderer import (TELEMETRY_KEYS, RenderSpec, pair_budget,
                                     pair_reg_loss, render_rays)
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
                   patch_loss_fn: Optional[PatchLossFn] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, stats).  ``batch['rgb']`` is the ground truth per ray.

    Image MSE (masked by ``ray_mask`` when present), or in patch mode
    ``patch_loss_fn(ret, batch)`` in its place; pair regularizer x
    ``lw.pair``, distortion x ``batch['reg_dist_weight']``, residual
    magnitude x ``lw.resd`` and the gated freespace/occupancy BCE terms.
    Stats carry each term, ``psnr``, the overflow
    telemetry, ``loss`` and the per-ray L1 ``ray_error``.

    Under ``lw.remat`` the render runs inside ``torch.utils.checkpoint``.
    The checkpoint would replay only the global RNG, not ``generator``, so
    the draws are made before it and passed in: the recomputed forward sees
    the same jitter and pair noise.
    """
    R = batch["ray_o"].shape[0]
    if draws is None:
        draws = draw_render(mspec, rspec, R, generator, batch["ray_o"].device)
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
    # the counts a mean divides by, as float32
    counts = {}
    if ray_mask is not None:
        counts["rays"] = torch.sum(ray_mask)
    if pairs:
        counts["pairs"] = torch.sum(ret["pair_valid"])
    if masks:
        counts["bg"] = torch.sum(is_bg)
    if counts:
        counts = dict(zip(counts, torch.stack([c.float() for c in counts.values()])))

    diff2 = torch.sum((ret["rgb_map"] - rgb_gt) ** 2, dim=-1) / 3.0
    if ray_mask is not None:
        img_loss = torch.sum(diff2 * ray_mask) / torch.clamp(counts["rays"],
                                                             min=1.0)
    else:
        img_loss = torch.mean(diff2)
    stats["img_loss"] = img_loss
    stats["psnr"] = -10.0 * torch.log10(img_loss)
    if lw.use_patch and patch_loss_fn is not None:
        loss = patch_loss_fn({"rgb_map": ret["rgb_map"]},
                             {"rgb": rgb_gt, "ray_mask": ray_mask})
        stats["patch_loss"] = loss
    else:
        loss = img_loss

    if pairs:
        pl = pair_reg_loss(ret["pair_resd0"], ret["pair_resd1"],
                           ret["pair_valid"], count=counts["pairs"])
        stats["pair_loss"] = pl
        loss = loss + lw.pair * pl
    if lw.use_distortion and "reg_distortion" in ret:
        dl = torch.mean(ret["reg_distortion"])
        stats["reg_dist"] = dl
        loss = loss + batch.get("reg_dist_weight", 0.1) * dl
    if "resd" in ret:
        # the mean over the budgets' slots (an invalid one holds a zero
        # residual)
        norms = safe_norm(ret["resd"], dim=-1)
        ol = torch.sum(norms) / norms.shape[0]
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
                / occ_s.shape[0]
            stats["occ_loss"] = ol2
            loss = loss + lw.occ_weight * ol2

    for k in TELEMETRY_KEYS:
        stats[k] = ret[k]
    stats["loss"] = loss
    stats["ray_error"] = torch.sum(torch.abs(ret["rgb_map"] - rgb_gt), dim=-1).detach()
    return loss, stats


def forward_backward(mspec: inb.ModelSpec, rspec: RenderSpec, lw: LossWeights,
                     state: TrainState, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator | None = None,
                     draws: Dict[str, torch.Tensor] | None = None,
                     patch_loss_fn: Optional[PatchLossFn] = None
                     ) -> Dict[str, torch.Tensor]:
    """A step up to its update: zero the grads, forward, backward, a zero
    gradient for every parameter the loss does not reach; returns the
    stats."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, stats = compute_losses(mspec, rspec, lw, state.model, batch,
                                 generator, draws,
                                 patch_loss_fn=patch_loss_fn)
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
    ``lw.use_patch``)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   draws: Dict[str, torch.Tensor] | None = None):
        stats = forward_backward(mspec, rspec, lw, state, batch, generator,
                                 draws, patch_loss_fn)
        state.set_lr()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in stats.items()}

    return train_step


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
