"""Volume-rendering compositing and the distortion regularizer (port of
``instant_nvr_tpu/ops/rendering.py``)."""
from __future__ import annotations

import torch


def render_weights(alpha: torch.Tensor, epsilon: float = 1e-10) -> torch.Tensor:
    """alpha (..., R, S) -> weights a_i * prod_{j<i} (1 - a_j + eps)."""
    trans = torch.cumprod(1.0 - alpha + epsilon, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return alpha * trans


def volume_rendering(rgb: torch.Tensor, alpha: torch.Tensor,
                     epsilon: float = 1e-8, bg_brightness=None):
    """Composite rgb (..., R, S, 3) with alpha (..., R, S).

    Returns (weights, rgb_map, acc_map).
    """
    weights = render_weights(alpha, epsilon)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc_map = torch.sum(weights, dim=-1)
    if bg_brightness is not None:
        rgb_map = rgb_map + (1.0 - acc_map[..., None]) * bg_brightness
    return weights, rgb_map, acc_map


def distortion_loss(weights: torch.Tensor, z_vals: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF-360 distortion regularizer per ray: sum_ij w_i w_j
    |mid_i - mid_j| over the midpoints of (z_i, z_i+1).  (R, S) -> (R,)."""
    next_z = torch.cat([z_vals[..., 1:], z_vals[..., -1:]], dim=-1)
    mid = 0.5 * (z_vals + next_z)
    w_ij = weights[..., :, None] * weights[..., None, :]
    d_ij = torch.abs(mid[..., :, None] - mid[..., None, :])
    return torch.sum(w_ij * d_ij, dim=(-1, -2))
