"""UV-indexed residual deformation field (port of
``instant_nvr_tpu/models/deformer.py``).

Sample (u, v) for each canonical point from the bigpose UV volume, append
the frame time t, hash-encode uvt and regress a ``0.05 * tanh`` residual
through a small softplus MLP.  Evaluated densely on the fixed-budget point
set; ``flag`` zeroes the residual of invalid slots.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.grid_sample import pts_sample_volume
from ..ops.hashgrid import (HashGridSpec, HashTables, hashgrid_encode,
                            make_hashgrid_spec)
from ..utils.constants import device_constant
from .nn import make_mlp, mlp_apply


class DeformerSpec(NamedTuple):
    embed: HashGridSpec
    d_hidden: int = 32
    n_layers: int = 2
    scale: float = 0.05


def make_deformer_spec(embed_kwargs: dict, primes, scalar_ok: bool = True,
                       exact_grads: bool = False,
                       sorted_grads: bool = False) -> DeformerSpec:
    return DeformerSpec(embed=make_hashgrid_spec(
        primes=primes, scalar_tables=scalar_ok, exact_grads=exact_grads,
        sorted_grads=sorted_grads, **embed_kwargs))


class Deformer(nn.Module):
    def __init__(self, spec: DeformerSpec, device=None):
        super().__init__()
        self.embed = HashTables(spec.embed, device)
        self.mlp = make_mlp(spec.embed.out_dim, 3, spec.d_hidden,
                            spec.n_layers, device=device)


def deformer_apply(spec: DeformerSpec, params: Deformer, pts: torch.Tensor,
                   tuv: torch.Tensor, tbounds: torch.Tensor,
                   frame_t: torch.Tensor, flag: torch.Tensor | None = None,
                   tuv_sizes: torch.Tensor | None = None,
                   compute_dtype=None) -> torch.Tensor:
    """pts (N, 3) canonical points -> residual (N, 3).

    The deformer's tables stay float32 even when the part grids compute in
    bf16 (as in JAX: they are tiny); ``compute_dtype`` applies to its MLP.
    Their per-column gathers round the gradient to bf16 for the scatter
    kernels unless the spec sets ``exact_grads`` (ops/hashgrid.py).
    """
    uv = pts_sample_volume(pts, tuv, tbounds, sizes=tuv_sizes)      # (N, 2)
    if torch.is_tensor(frame_t):
        t = frame_t.to(device=uv.device, dtype=uv.dtype)
    else:   # a host value: one device constant per value
        t = device_constant(("frame_t", float(frame_t), uv.dtype), uv.device,
                            lambda: np.float64(frame_t), uv.dtype)
    uvt = torch.cat([uv, t.reshape(1, 1).expand(uv.shape[0], 1)], dim=-1)
    unit = device_constant(("unit_box", uv.dtype), uv.device,
                           lambda: np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]),
                           uv.dtype)
    feat = hashgrid_encode(spec.embed, params.embed.tables(), uvt, unit)
    resd = spec.scale * torch.tanh(mlp_apply(params.mlp, feat, compute_dtype))
    resd = resd.to(pts.dtype)
    if flag is not None:
        resd = torch.where(flag[:, None], resd, torch.zeros_like(resd))
    return resd
