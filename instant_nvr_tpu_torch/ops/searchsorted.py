"""Batched searchsorted and hierarchical importance sampling (port of
``instant_nvr_tpu/ops/searchsorted.py``).

The reference's vendored CUDA extension ``lib/csrc/torchsearchsorted`` and
its only consumer ``sample_pdf`` (``lib/networks/renderer/nerf_net_utils.py:
93-128``).  The inb path never calls ``sample_pdf`` (``N_importance`` is
dead config); it is here for parity with the JAX package, on
``torch.searchsorted``.  The uniform draws are passed in (``u``) or drawn
from an explicit ``torch.Generator``.  The CDF's sums run in XLA's CPU
order (a row sum left to right, the prefix sum in blocks of 16) and the
deterministic draws are ``jnp.linspace``'s, so for rows of up to 32
weights the CDF equals the JAX package's bit for bit and a draw that
falls on a CDF value picks the same bin; XLA sums longer rows in another
order, which moves the CDF in its last bits.
"""
from __future__ import annotations

from typing import Optional

import torch


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "right") -> torch.Tensor:
    """Row-wise searchsorted: a (B, A), v (B, V) -> int64 indices (B, V);
    each row of ``v`` is searched in the same row of ``a``."""
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=side == "right")


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from left to right (XLA's CPU order)."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _cumsum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Prefix sum over the last axis in XLA's CPU order: left to right in
    blocks of 16, each block's sums then offset by the prefix sum (the same
    rule, recursively) of the blocks before it."""
    n = x.shape[-1]
    if n <= block:
        out, acc = [], None
        for k in range(n):
            acc = x[..., k] if acc is None else acc + x[..., k]
            out.append(acc)
        return torch.stack(out, -1)
    parts = [_cumsum(x[..., s:s + block], block) for s in range(0, n, block)]
    carry = _cumsum(torch.stack([p[..., -1] for p in parts], -1), block)
    return torch.cat([parts[0]] + [p + carry[..., i:i + 1]
                                   for i, p in enumerate(parts[1:])], -1)


def _linspace01(n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as XLA computes it on the CPU: i times the
    rounded reciprocal of n - 1 (its division by a constant), the end
    exactly 1."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    recip = torch.ones((), dtype=dtype) / (n - 1)
    step = torch.arange(n - 1, dtype=dtype, device=device) * recip.to(device)
    return torch.cat([step, torch.ones(1, dtype=dtype, device=device)])


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` new depths per ray.

    bins (R, S-1) midpoints, weights (R, S-2): weights + 1e-5, the
    normalised pdf, its CDF with a leading zero, and uniform samples
    (``u`` (R, n_samples), else the deterministic linspace with ``det``,
    else ``torch.rand`` from ``generator``) inverted through the CDF."""
    weights = weights + 1e-5
    pdf = weights / _row_sum(weights)[..., None]
    cdf = _cumsum(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)       # (R, S-1)
    R = cdf.shape[0]
    if u is None:
        if det:
            u = _linspace01(n_samples, cdf.dtype, cdf.device).expand(R, n_samples)
        else:
            u = torch.rand((R, n_samples), generator=generator, dtype=cdf.dtype,
                           device=cdf.device)
    inds = searchsorted(cdf, u, side="right")
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins_g0 = torch.gather(bins, -1, torch.clamp(below, max=nb))
    bins_g1 = torch.gather(bins, -1, torch.clamp(above, max=nb))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
