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

Where a gradient is asked (every training path), the product and the bias
go through the autograd Function :class:`_Linear`: its forward is the same
``torch.matmul`` / ``torch.bmm`` and ``+ b``, bit for bit; its backward
gives the input's gradient by the ``torch.matmul`` / ``torch.bmm`` autograd
calls, and the weight's and the bias's by ``ops/mlp_wgrad.py``
(``csrc/mlp_wgrad.cu`` on the card: x^T g and g's sum over the rows in
float32, one launch a layer).  Calls that ask no gradient (the render, the
evaluator, the occupancy cube) run the plain ops alone.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mlp_wgrad import weight_grads


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
    return x.to(compute_dtype).float()


def _product(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stacked: bool) -> torch.Tensor:
    """``x @ w + b`` (``stacked``: ``torch.bmm(x, w) + b[:, None, :]``)."""
    if stacked:
        return torch.bmm(x, w) + b[:, None, :]
    return torch.matmul(x, w) + b


class _Linear(torch.autograd.Function):
    """:func:`_product` on the operands :func:`_operand` made, with the
    weight's and the bias's gradients from
    :func:`ops.mlp_wgrad.weight_grads`."""

    @staticmethod
    def forward(ctx, x, w, b, stacked):
        ctx.save_for_backward(x, w)
        ctx.stacked = stacked
        return _product(x, w, b, stacked)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.bmm(g, w.transpose(1, 2)) if ctx.stacked else torch.matmul(g, w.t())
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            if ctx.stacked:
                gw, gb = weight_grads(x, g)
            else:   # matmul folds x's leading axes into its rows
                gw, gb = weight_grads(x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1]))
        return (gx, gw if ctx.needs_input_grad[1] else None,
                gb if ctx.needs_input_grad[2] else None, None)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stacked: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        return _Linear.apply(x, w, b, stacked)
    return _product(x, w, b, stacked)


def linear_apply(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    return _linear(_operand(x, compute_dtype), _operand(p.w, compute_dtype), p.b.float(),
                   stacked=False)


def mlp_apply(layers: Sequence, x: torch.Tensor,
              compute_dtype=None) -> torch.Tensor:
    """Softplus between layers, linear output."""
    for layer in layers[:-1]:
        x = F.softplus(linear_apply(layer, x, compute_dtype))
    return linear_apply(layers[-1], x, compute_dtype)


def linear_apply_stacked(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x (P, N, Din), w (P, Din, Dout), b (P, Dout) -> (P, N, Dout)."""
    return _linear(_operand(x, compute_dtype), _operand(p.w, compute_dtype), p.b.float(),
                   stacked=True)


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
