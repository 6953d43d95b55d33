"""Volume-rendering compositing and the distortion regularizer (port of
``instant_nvr_tpu/ops/rendering.py``)."""
from __future__ import annotations

import torch


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` of a tensor with no zero entry along ``dim``.  Its
    backward is torch's for that case, ``reversed_cumsum(out * grad) /
    input``, the same ops in the same order, without torch's test for a zero
    entry: that test reads a flag on the host, a wait that a CUDA graph
    cannot capture."""

    @staticmethod
    def forward(ctx, x, dim):
        out = torch.cumprod(x, dim=dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.numel() <= 1 or x.shape[ctx.dim] == 1:
            return grad, None
        w = out * grad
        return w.flip(ctx.dim).cumsum(ctx.dim).flip(ctx.dim).div(x), None


def render_weights(alpha: torch.Tensor, epsilon: float = 1e-10) -> torch.Tensor:
    """alpha (..., R, S) -> weights a_i * prod_{j<i} (1 - a_j + eps).  With
    alpha in [0, 1] every factor is at least eps > 0."""
    trans = _PositiveCumprod.apply(1.0 - alpha + epsilon, -1)
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
