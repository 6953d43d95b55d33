"""Volume-rendering compositing (port of ``instant_nvr_tpu/ops/rendering.py``)."""
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
