"""Volume renderer for the inb model, forward (port of
``instant_nvr_tpu/renderer/inb_renderer.py``).

Evenly spaced depth samples -> network forward -> compositing, plus the
budget telemetry the eval runner sizes its budgets from.  Training
(``train=True``: jittered samples, pair and distortion regularizers) is the
next slice of the port.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..models import inb
from ..ops.ray import stratified_z_vals, z_to_points
from ..ops.rendering import volume_rendering

TELEMETRY_KEYS = ("cull_overflow", "part_overflow", "cull_need", "part_need")


class RenderSpec(NamedTuple):
    """The JAX RenderSpec's forward fields (the training fields come with
    the training slice)."""
    n_samples: int = 64
    bg_brightness: float | None = None


def make_render_spec(cfg) -> RenderSpec:
    return RenderSpec(n_samples=cfg.N_samples,
                      bg_brightness=1.0 if cfg.white_bkgd else None)


def render_rays(mspec: inb.ModelSpec, rspec: RenderSpec, model: inb.InbModel,
                batch: Dict[str, torch.Tensor], train: bool = False
                ) -> Dict[str, torch.Tensor]:
    """batch rays: ray_o/ray_d (R, 3), near/far (R,) -> render outputs."""
    if train:
        raise NotImplementedError(
            "render_rays(train=True) is not ported yet: the training step is "
            "the next slice (ROADMAP.md, queue A, 'Train step')")
    ray_o, ray_d = batch["ray_o"], batch["ray_d"]
    R = ray_o.shape[0]
    S = rspec.n_samples

    z_vals = stratified_z_vals(batch["near"], batch["far"], S)
    wpts = z_to_points(ray_o, ray_d, z_vals)               # (R, S, 3)
    viewdir = ray_d[:, None, :].expand(R, S, 3)

    net = inb.forward(mspec, model, wpts.reshape(R * S, 3),
                      viewdir.reshape(R * S, 3), batch)

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
    return ret
