"""Per-part KNN blend weights (port of ``instant_nvr_tpu/ops/knn.py``).

``knn_blend`` (also exported under the JAX name
``knn_blend_weights_multiassign``) returns, for every query point and body
part, the gaussian-weighted blend of the part's 4 nearest SMPL vertices'
bone weights plus the aggregated distance the model thresholds: (C, P, 25).

In this frozen reference ``knn_blend`` runs its plain version on every
device: each (part, query)'s 4 nearest vertices, then ``aggregate``
blends them.
"""
from __future__ import annotations

from typing import Tuple

import torch

_FAR = 1e9            # masked (padded) vertex slots, as in the JAX version
FAR_INIT = 1.5e9      # the d2 of a slot no real vertex fills


def _topk_chunk(q: torch.Tensor, part_pts: torch.Tensor, lengths: torch.Tensor,
                K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (c, 3) -> (P, c, K) ascending squared distances and int64 indices
    of each part's K nearest real vertices; unfilled slots (FAR_INIT, 0).
    ``lengths`` (P,) int64 already clipped to [0, M]."""
    M = part_pts.shape[1]
    diff = q[None, :, None, :] - part_pts[:, None]            # (P, c, M, 3)
    dx, dy, dz = diff.unbind(-1)
    d2 = (dx * dx + dy * dy) + dz * dz                        # (P, c, M)
    valid = torch.arange(M, device=q.device)[None, :] < lengths[:, None]
    d2 = torch.where(valid[:, None], d2, torch.full_like(d2, _FAR))
    if M < K:
        d2 = torch.cat([d2, d2.new_full(d2.shape[:2] + (K - M,), _FAR)], -1)
    best, idx = torch.topk(d2, K, dim=-1, largest=False)      # (P, c, K)
    real = idx < lengths[:, None, None]
    return (torch.where(real, best, torch.full_like(best, FAR_INIT)),
            torch.where(real, idx, torch.zeros_like(idx)))


def aggregate(d: torch.Tensor, idx: torch.Tensor, part_pbw: torch.Tensor,
              radius: float = 0.075, eps: float = 1e-8) -> torch.Tensor:
    """(P, C, K) neighbour distances and vertex indices + (P, M, D) values
    -> (C, P, D + 1); port of ``instant_nvr_tpu/ops/knn.py:_aggregate``.

    Gaussian weights exp(-d^2 / 2r^2) normalised by (sum + eps) blend the
    K value rows; the last channel is the weighted distance, or 1e6 when the
    nearest neighbour lies beyond 8 r.  Indices are clipped to [0, M - 1]:
    JAX's top-k kernel returns padded columns' indices (up to its padded M)
    for the spare slots of a part with fewer than K vertices, and their
    weight is 0.
    """
    d_safe = torch.clamp(d, max=1e10)
    w = torch.exp(-(d_safe * d_safe) / (2.0 * radius * radius))
    w = w / (torch.sum(w, dim=-1, keepdim=True) + eps)
    agg_dist = torch.sum(d_safe * w, dim=-1)                  # (P, C)
    agg_dist = torch.where(torch.amin(d_safe, dim=-1) <= 8.0 * radius,
                           agg_dist, torch.full_like(agg_dist, 1e6))
    P, M = part_pbw.shape[:2]
    pidx = torch.arange(P, device=part_pbw.device)[:, None, None]
    sampled = part_pbw[pidx, idx.long().clamp(0, M - 1)]      # (P, C, K, D)
    agg_val = torch.sum(sampled * w[..., None], dim=-2)       # (P, C, D)
    out = torch.cat([agg_val, agg_dist[..., None]], dim=-1)
    return out.transpose(0, 1).contiguous()                   # (C, P, D + 1)


def knn_blend_plain(query: torch.Tensor, part_pts: torch.Tensor,
                    part_pbw: torch.Tensor, lengths: torch.Tensor,
                    K: int = 4, radius: float = 0.075, eps: float = 1e-8,
                    chunk: int = 1024) -> torch.Tensor:
    """Brute force in plain PyTorch.  query (C, 3); part_pts (P, M, 3);
    part_pbw (P, M, D); lengths (P,) -> (C, P, D + 1).

    Each query's nearest neighbours, then :func:`aggregate`, over query
    chunks of ``chunk``.
    """
    C = query.shape[0]
    P, M, D = part_pbw.shape
    dev = query.device
    lens = lengths.to(dev).long().clamp(0, M)
    out = torch.empty((C, P, D + 1), dtype=torch.float32, device=dev)
    for s in range(0, C, chunk):
        d2, idx = _topk_chunk(query[s:s + chunk], part_pts, lens, K)
        out[s:s + chunk] = aggregate(torch.sqrt(torch.clamp(d2, min=0.0)), idx,
                                     part_pbw, radius, eps)
    return out


def knn_blend(query, part_pts, part_pbw, lengths, K: int = 4,
              radius: float = 0.075, eps: float = 1e-8, chunk: int = 1024):
    """The plain version on every device (the frozen reference has no kernel)."""
    return knn_blend_plain(query, part_pts, part_pbw, lengths, K=K,
                           radius=radius, eps=eps, chunk=chunk)


