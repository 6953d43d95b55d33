"""Volume renderer for the inb model (port of
``instant_nvr_tpu/renderer/inb_renderer.py``).

Stratified depth samples (jittered when training) -> network forward ->
compositing, plus the budget telemetry the eval runner sizes its budgets
from, and at train time the regularizer tensors:
  - pair regularization: selected points whose occupancy is near 0.5
    (|tocc - 0.5| < pair_thresh) have their residual compared with the
    residual at a jittered neighbour, within a fixed budget of slots
    (kept nearest first, as the model's other budgets);
  - the distortion regularizer per ray.

``jax.random`` keys become a ``torch.Generator`` (``generator=``), or the
draws themselves: ``draws={"t_rand": (R, S) in [0, 1), "pair_noise": (B, 3)
already scaled to the pair range}``, which the parity tests fill with the
JAX package's own draws.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..models import inb
from ..ops.math import safe_norm
from ..ops.ray import stratified_z_vals, z_to_points
from ..ops.rendering import distortion_loss, volume_rendering

TELEMETRY_KEYS = ("cull_overflow", "part_overflow", "cull_need", "part_need")


class RenderSpec(NamedTuple):
    n_samples: int = 64
    perturb: bool = True
    use_pair_reg: bool = True
    pair_budget: int = 1024
    pair_thresh: float = 0.02
    pair_range: float = 0.01
    use_reg_distortion: bool = True
    bg_brightness: float | None = None


def make_render_spec(cfg) -> RenderSpec:
    return RenderSpec(
        n_samples=cfg.N_samples,
        perturb=bool(cfg.perturb),
        use_pair_reg=cfg.use_pair_reg,
        use_reg_distortion=cfg.use_reg_distortion,
        bg_brightness=1.0 if cfg.white_bkgd else None,
    )


def pair_budget(mspec: inb.ModelSpec, rspec: RenderSpec, n_samples: int) -> int:
    """Slots of the pair regularizer for ``n_samples`` ray samples (the
    rows of ``draws["pair_noise"]``)."""
    return min(rspec.pair_budget, sum(inb.budgets(mspec, n_samples)[1]))


def render_rays(mspec: inb.ModelSpec, rspec: RenderSpec, model: inb.InbModel,
                batch: Dict[str, torch.Tensor], train: bool = False,
                generator: torch.Generator | None = None,
                draws: Dict[str, torch.Tensor] | None = None
                ) -> Dict[str, torch.Tensor]:
    """batch rays: ray_o/ray_d (R, 3), near/far (R,) -> render outputs."""
    ray_o, ray_d = batch["ray_o"], batch["ray_d"]
    R = ray_o.shape[0]
    S = rspec.n_samples
    draws = draws or {}

    z_vals = stratified_z_vals(batch["near"], batch["far"], S,
                               perturb=rspec.perturb and train,
                               generator=generator, t_rand=draws.get("t_rand"))
    wpts = z_to_points(ray_o, ray_d, z_vals)               # (R, S, 3)
    viewdir = ray_d[:, None, :].expand(R, S, 3)

    net = inb.forward(mspec, model, wpts.reshape(R * S, 3),
                      viewdir.reshape(R * S, 3), batch, train)

    raw = net["raw"].reshape(R, S, 4)
    weights, rgb_map, acc_map = volume_rendering(
        raw[..., :3], raw[..., 3], bg_brightness=rspec.bg_brightness)
    ret = {
        "rgb_map": rgb_map,      # (R, 3)
        "acc_map": acc_map,      # (R,)
        "weights": weights,      # (R, S)
        "raw": raw,
        "occ": net["occ"].reshape(R, S),
    }
    ret.update({k: net[k] for k in TELEMETRY_KEYS})
    if not train:
        return ret

    ret["resd"] = net["resd"]
    ret["tflag"] = net["tflag"]
    if rspec.use_pair_reg:
        score = torch.where(net["tflag"], torch.abs(net["tocc"][:, 0] - 0.5),
                            torch.full_like(net["tocc"][:, 0], float("inf")))
        budget = pair_budget(mspec, rspec, R * S)
        order = pair_order(score, net["tpart"], net["tdist"])
        idx = torch.topk(order, budget, largest=False).indices
        valid = score[idx] < rspec.pair_thresh
        tpts = net["tpts"][idx]                             # (B, 3)
        noise = draws.get("pair_noise")
        if noise is None:
            noise = (torch.rand(tpts.shape, generator=generator,
                                dtype=tpts.dtype, device=tpts.device)
                     - 0.5) * rspec.pair_range
        ret["pair_resd0"] = net["resd"][idx]
        ret["pair_resd1"] = inb.resd_fn(mspec, model, tpts + noise, batch)
        ret["pair_valid"] = valid
    if rspec.use_reg_distortion:
        ret["reg_distortion"] = distortion_loss(weights, z_vals)   # (R,)
    return ret


def pair_order(score: torch.Tensor, part: torch.Tensor,
               dist: torch.Tensor) -> torch.Tensor:
    """int64 keys that order the pair candidates by score, ties by part,
    then by part distance: the JAX package's ``lax.top_k`` order over its
    part-major slots (ties to the lower slot; a part's slots ascend in
    distance), made of what a slot is, not where it lies, so ranks that
    hold other slices of the samples order their candidates alike.  The
    score, clamped to 1 (anything at or above the pair threshold only has
    to come after what is below it), takes the top 30 bits, the part the
    next 3, the distance's top 30 bits the rest; non-negative floats order
    as their bits."""
    s = torch.clamp(score, max=1.0).view(torch.int32).to(torch.int64)
    d = dist.float().contiguous().view(torch.int32).to(torch.int64) >> 1
    return (s << 33) | (part.to(torch.int64) << 30) | d


def pair_reg_loss(resd0: torch.Tensor, resd1: torch.Tensor,
                  valid: torch.Tensor, eps: float = 1e-8,
                  count: torch.Tensor | None = None) -> torch.Tensor:
    """Direction consistency of the residuals at neighbouring points: the
    distance of their unit directions, masked mean over the valid slots
    (over ``count`` of them when given: every rank's)."""
    v0 = resd0 / (safe_norm(resd0, dim=-1, keepdim=True) + eps)
    v1 = resd1 / (safe_norm(resd1, dim=-1, keepdim=True) + eps)
    per_pt = safe_norm(v1 - v0, dim=-1)
    denom = torch.clamp(torch.sum(valid) if count is None else count, min=1)
    return torch.sum(torch.where(valid, per_pt, torch.zeros_like(per_pt))) / denom
