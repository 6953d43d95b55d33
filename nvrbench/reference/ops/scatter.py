"""Hash-table gradient scatter-adds of the frozen reference, in plain
PyTorch on every device.

Each computes the dense gradient of a table from R scatter records:

    grad[keys[r], f] += payload[r, f]      keys (R,) int32, payload (R, F) bf16

summed in float32 and rounded to bf16 once, (n_rows, F) bf16; the sorted
form drops keys outside [0, n_rows).  ``exact_scatter_add`` is the
float32 gradient of an f32 table that may not be rounded.  The routing in
``ops/hashgrid.py`` asks :func:`onehot_fits` which form a table takes; in
the reference every form sums the same records.
"""
from __future__ import annotations

from typing import Sequence

import torch

# the program's one-hot route: the widest level window x F float32 fits
# this many bytes of one block's shared memory, over at most this many levels
ONEHOT_SMEM_BYTES = 232448
_MAX_LEVELS = 64


def _scatter_plain(keys: torch.Tensor, payload: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    acc = torch.zeros((n_rows, payload.shape[1]), dtype=torch.float32,
                      device=payload.device)
    acc.index_add_(0, keys.long(), payload.float())
    return acc.to(torch.bfloat16)


def segmented_scatter_add(keys: torch.Tensor, payload: torch.Tensor,
                          n_rows: int,
                          level_offsets: Sequence[int] = ()) -> torch.Tensor:
    return _scatter_plain(keys, payload, n_rows)


def onehot_scatter_add(keys: torch.Tensor, payload: torch.Tensor,
                       n_rows: int,
                       level_offsets: Sequence[int] = ()) -> torch.Tensor:
    return _scatter_plain(keys, payload, n_rows)


def sorted_scatter_add(keys: torch.Tensor, payload: torch.Tensor,
                       n_rows: int,
                       level_offsets: Sequence[int] = ()) -> torch.Tensor:
    """The stable sort, then each row's records added in order in float32,
    keys outside the table dropped; bf16."""
    skeys, order = torch.sort(keys, stable=True)
    keep = (skeys >= 0) & (skeys < n_rows)
    acc = torch.zeros((n_rows, payload.shape[1]), dtype=torch.float32,
                      device=payload.device)
    acc.index_add_(0, skeys[keep].long(), payload[order[keep]].float())
    return acc.to(payload.dtype)


def exact_scatter_add(keys: torch.Tensor, g: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """(n_rows, F) gradient in g's dtype, summed in that dtype (index_add_)."""
    acc = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return acc.index_add_(0, keys.reshape(-1).long(), g)


def onehot_fits(level_offsets: Sequence[int], F: int) -> bool:
    """Whether the widest level window x F float32 fits one block's shared
    memory (and the level count the kernel's window table)."""
    n_levels = len(level_offsets) - 1
    widest = max(b - a for a, b in zip(level_offsets[:-1], level_offsets[1:]))
    return 0 < n_levels <= _MAX_LEVELS and widest * F * 4 <= ONEHOT_SMEM_BYTES
