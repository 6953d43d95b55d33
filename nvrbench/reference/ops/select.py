"""Fixed-budget selection (port of ``instant_nvr_tpu/ops/select.py``).

Score every candidate, keep a fixed budget of the best, carry a validity
mask, scatter results back.  The budgets keep every shape fixed per chunk,
so nothing on the render path waits for the device to learn a count.

``topk_select`` keeps the budget's smallest scores (drops the farthest
first).  ``torch.topk`` may order tied scores differently from
``lax.top_k``; ties are invalid (``inf``) slots in practice, which callers
mask, so compare results by the selected valid set, not by index order.
"""
from __future__ import annotations

from typing import Tuple

import torch


def topk_select(score: torch.Tensor, budget: int, thresh: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the ``budget`` smallest scores + ``score[idx] < thresh``."""
    vals, idx = torch.topk(score, budget, largest=False)
    return idx, vals < thresh




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
