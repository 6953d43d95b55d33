"""NeRF frequency encoding (port of ``instant_nvr_tpu/models/embedders.py``)."""
from __future__ import annotations

import torch


def freq_out_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims + multires * 2 * input_dims


def freq_encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    """x (..., D) -> (..., D + multires*2*D): [x, sin/cos per frequency]."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[..., None, None, :] * freqs[:, None, None]          # (..., M, 1, D)
    feat = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-2)   # (..., M, 2, D)
    feat = feat.reshape(*x.shape[:-1], multires * 2 * x.shape[-1])
    return torch.cat([x, feat], dim=-1)
