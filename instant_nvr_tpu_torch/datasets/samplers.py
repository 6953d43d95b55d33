"""Index samplers of the training and eval loops (port of
``instant_nvr_tpu/datasets/samplers.py``):

  - :class:`FrameSampler`: one view set every ``interval`` frames (test/val);
  - :class:`IterationBasedSampler`: exactly ``num_iters`` indices an epoch,
    reshuffled per epoch;
  - :func:`shard_indices`: the contiguous shard of one process.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np


class FrameSampler:
    """Sample one view set every ``interval`` frames."""

    def __init__(self, n_items: int, num_cams: int, interval: int):
        inds = np.arange(n_items).reshape(-1, num_cams)
        self.inds = inds[::interval].ravel().tolist()

    def __iter__(self) -> Iterator[int]:
        return iter(self.inds)

    def __len__(self) -> int:
        return len(self.inds)


class IterationBasedSampler:
    """Yields exactly ``num_iters`` indices per epoch, reshuffled per epoch."""

    def __init__(self, n_items: int, num_iters: int, seed: int = 0,
                 shuffle: bool = True):
        self.n = n_items
        self.num_iters = num_iters
        self.seed = seed
        self.shuffle = shuffle

    def epoch(self, epoch: int) -> List[int]:
        rng = np.random.default_rng(self.seed + epoch)
        out: List[int] = []
        while len(out) < self.num_iters:
            order = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
            out.extend(order.tolist())
        return out[:self.num_iters]


def shard_indices(indices: List[int], process_index: int,
                  process_count: int, pad: bool = True) -> List[int]:
    """Contiguous per-process shard.  ``pad`` wraps the tail so every
    process gets the same count (lockstep training); eval passes False, so
    no item is counted twice in merged metrics."""
    per = (len(indices) + process_count - 1) // process_count
    if pad:
        indices = list(indices) + \
            list(indices[: per * process_count - len(indices)])
    return indices[process_index * per:(process_index + 1) * per]
