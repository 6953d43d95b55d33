"""Auxiliary criteria (port of ``instant_nvr_tpu/train/crit.py``), used by
the SDF / normal / residual model variants through ``variant_losses``:

  - :func:`elastic_crit`: log-singular-value elasticity of a deformation
    jacobian;
  - :func:`sdf_mask_crit`: mask BCE on the scaled SDF, alpha doubling at
    fixed steps;
  - :func:`normal_crit`: view-weighted surface-normal agreement.
"""
from __future__ import annotations

import torch

from ..ops.math import safe_norm

_ALPHA_MILESTONES = (10000, 20000, 30000, 40000, 50000)


def elastic_crit(jac: torch.Tensor) -> torch.Tensor:
    """jac (..., 3, 3) -> mean over points of sum(log(singular values)^2)."""
    s = torch.linalg.svdvals(jac)
    log_s = torch.log(torch.clamp(s, min=1e-6))
    return torch.mean(torch.sum(log_s ** 2, dim=-1))


def sdf_mask_crit(msk_sdf: torch.Tensor, msk_label: torch.Tensor,
                  iter_step: int) -> torch.Tensor:
    """BCE-with-logits on -alpha * sdf; alpha = 50, doubled past each
    milestone step."""
    alpha = 50.0 * 2.0 ** sum(int(iter_step) > m for m in _ALPHA_MILESTONES)
    logits = -alpha * msk_sdf
    bce = (torch.clamp(logits, min=0) - logits * msk_label
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.mean(bce) / alpha


def normal_crit(normal_pred: torch.Tensor, normal_gt: torch.Tensor,
                viewdir: torch.Tensor) -> torch.Tensor:
    """View-facing-weighted normal distance (the prediction's y and z are
    flipped, as in the reference)."""
    w = torch.clamp(torch.sum(-normal_pred * viewdir, dim=-1), 0.0, 1.0) ** 2
    gt = normal_gt / torch.clamp(safe_norm(normal_gt, keepdim=True), min=1e-8)
    pred = torch.cat([normal_pred[..., :1], -normal_pred[..., 1:]], dim=-1)
    return torch.mean(w * safe_norm(pred - gt))
