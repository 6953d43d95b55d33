"""MLP primitives (port of ``instant_nvr_tpu/models/nn.py``).

Layers are modules holding ``w`` (d_in, d_out) and ``b`` (d_out,) — the JAX
layout, not ``nn.Linear``'s transposed one — so weights bridge 1:1.  A
stacked layer carries a leading expert (part) axis: w (P, d_in, d_out),
b (P, d_out).

bf16 compute follows JAX's ``dot(bf16, bf16, preferred_element_type=f32)``:
both operands are rounded to bf16 and multiplied in float32 (each product
of two bf16 values is exact in f32; the sum accumulates in f32).  A bf16
``torch.matmul`` would round its output to bf16, which JAX does not do.
TF32 must be off for this to hold on the card.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """``y = x @ w + b`` with an optional leading expert axis on w and b."""

    def __init__(self, d_in: int, d_out: int, n_experts: int = 0,
                 device=None):
        super().__init__()
        lead = (n_experts,) if n_experts else ()
        self.w = nn.Parameter(torch.empty(lead + (d_in, d_out), device=device))
        self.b = nn.Parameter(torch.empty(lead + (d_out,), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch ``nn.Linear`` default: U(+-1/sqrt(d_in)) for w and b."""
        bound = 1.0 / math.sqrt(self.w.shape[-2])
        with torch.no_grad():
            for t in (self.w, self.b):
                t.uniform_(-bound, bound, generator=generator)


def make_mlp(d_in: int, d_out: int, d_hidden: int = 64, n_layers: int = 2,
             n_experts: int = 0, device=None) -> nn.ModuleList:
    """[in->h] + (n_layers-1) x [h->h] + [h->out]; n_layers counts hidden."""
    dims = [d_in] + [d_hidden] * n_layers + [d_out]
    return nn.ModuleList(Linear(a, b, n_experts, device)
                         for a, b in zip(dims[:-1], dims[1:]))


def _operand(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    if compute_dtype is None or compute_dtype == torch.float32:
        return x.float()
    if compute_dtype == torch.float8_e4m3fn:
        return _fp8_operand(x.float())
    return x.to(compute_dtype).float()


def _fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """The benchmark's control: ``x`` rounded to float8 e4m3 under one
    per-tensor scale (its largest magnitude at e4m3's 448), as an fp8 GEMM
    takes its operands; the gradient passes straight through the rounding
    (a conversion to float8 carries none)."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def linear_apply(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    y = torch.matmul(_operand(x, compute_dtype), _operand(p.w, compute_dtype))
    return y + p.b.float()


def mlp_apply(layers: Sequence, x: torch.Tensor,
              compute_dtype=None) -> torch.Tensor:
    """Softplus between layers, linear output."""
    for layer in layers[:-1]:
        x = F.softplus(linear_apply(layer, x, compute_dtype))
    return linear_apply(layers[-1], x, compute_dtype)


def linear_apply_stacked(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x (P, N, Din), w (P, Din, Dout), b (P, Dout) -> (P, N, Dout)."""
    y = torch.bmm(_operand(x, compute_dtype), _operand(p.w, compute_dtype))
    return y + p.b.float()[:, None, :]


def mlp_apply_stacked(layers: Sequence, x: torch.Tensor,
                      compute_dtype=None) -> torch.Tensor:
    """Stacked-expert :func:`mlp_apply`."""
    for layer in layers[:-1]:
        x = F.softplus(linear_apply_stacked(layer, x, compute_dtype))
    return linear_apply_stacked(layers[-1], x, compute_dtype)


def kaiming_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """torch ``kaiming_normal_`` (fan_in = prod(shape[1:]), gain sqrt(2))."""
    fan_in = math.prod(t.shape[1:])
    with torch.no_grad():
        t.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
