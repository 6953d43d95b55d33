"""Fixed-budget selection (port of ``instant_nvr_tpu/ops/select.py``).

Score every candidate, keep a fixed budget of the best, carry a validity
mask, scatter results back.  The budgets keep every shape fixed per chunk,
so nothing on the render path waits for the device to learn a count.

Two ways to keep a budget, as ``select_mode`` routes them:

* ``topk_select``: the budget's smallest scores (drops the farthest first).
  ``torch.topk`` may order tied scores differently from ``lax.top_k``;
  ties are invalid (``inf``) slots in practice, which callers mask, so
  compare results by the selected valid set, not by index order.
* ``partition_select``: the qualifying entries in a fixed random order (a
  cumsum compaction), so an overflow drops a uniform random thinning; the
  same set as ``topk_select`` whenever the count fits the budget, and the
  same indices as JAX's bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def topk_select(score: torch.Tensor, budget: int, thresh: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the ``budget`` smallest scores + ``score[idx] < thresh``."""
    vals, idx = torch.topk(score, budget, largest=False)
    return idx, vals < thresh


_perms: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _fixed_perm(n: int, device=None) -> torch.Tensor:
    """``np.random.default_rng(0).permutation(n)`` (int64) on ``device``,
    made on the host once per (n, device), so a chunk copies nothing."""
    key = (int(n), torch.device(device or "cpu"))
    perm = _perms.get(key)
    if perm is None:
        perm = torch.as_tensor(np.random.default_rng(0).permutation(int(n)),
                               dtype=torch.int64).to(key[1])
        _perms[key] = perm
    return perm


def compact(valid: torch.Tensor, perm: torch.Tensor, budgets, width: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The entries of each row of ``valid`` (..., N) that hold, in ``perm``
    order, packed into the leading slots of (..., width): the first
    ``budgets`` of them (an int, or a tensor of one budget a row), zeros
    after.
    Returns (idx (..., width) int64, count (...,) of filled slots).

    The cumsum gives each kept entry its slot; an entry past its budget
    writes a slot of its own beyond ``width`` (cut off after), so every
    write of the scatter has its own target and nothing waits on a sort
    or the host."""
    vp = valid[..., perm]
    pos = torch.cumsum(vp.to(torch.int32), dim=-1) - 1
    b = budgets[..., None] if torch.is_tensor(budgets) else budgets
    N = perm.shape[0]
    spare = width + torch.arange(N, device=valid.device)
    slot = torch.where(vp & (pos < b), pos.long(), spare)
    idx = torch.zeros(vp.shape[:-1] + (width + N,), dtype=torch.int64,
                      device=valid.device)
    idx.scatter_(-1, slot, perm.expand_as(slot))
    count = (torch.minimum(pos[..., -1] + 1, budgets) if torch.is_tensor(budgets)
             else torch.clamp(pos[..., -1] + 1, max=budgets))
    return idx[..., :width], count


def partition_select(score: torch.Tensor, budget: int, thresh: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-free :func:`topk_select`: the entries with ``score < thresh`` in
    the fixed order of :func:`_fixed_perm`, the first ``budget`` of them.
    Returns (idx (budget,), valid (budget,)): the leading ``count`` slots
    valid, zeros (invalid) after."""
    perm = _fixed_perm(score.shape[0], score.device)
    idx, count = compact(score < thresh, perm, budget, budget)
    return idx, torch.arange(budget, device=score.device) < count


def scatter_back(full_shape_like: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Scatter budget-sized ``values`` into zeros shaped like ``full_shape_like``.

    Invalid slots write to a spare row past the end, cut off after: a
    compaction's invalid slots all hold index 0, which a valid slot may
    own (the valid slots' indices are distinct)."""
    N = full_shape_like.shape[0]
    out = full_shape_like.new_zeros((N + 1,) + tuple(full_shape_like.shape[1:]))
    out[torch.where(valid, idx, N)] = values
    return out[:N]
