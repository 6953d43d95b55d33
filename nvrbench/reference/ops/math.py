"""Batched geometry math (port of ``instant_nvr_tpu/ops/math.py``).

Only what the forward render path needs: the cofactor 3x3 inverse used by
inverse LBS and the zero-safe norm.
"""
from __future__ import annotations

import torch


def inverse_3x3(m: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Batched 3x3 inverse via the adjugate.  m: (..., 3, 3).

    Adds ``eps`` to the determinant like the JAX version.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d

    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([C, F, I], dim=-1),
    ], dim=-2)
    return adj / (det[..., None, None] + eps)


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a well-defined gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)
