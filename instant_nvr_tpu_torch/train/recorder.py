"""Metric recording: smoothed console lines and optional TensorBoard
scalars (port of ``instant_nvr_tpu/train/recorder.py``).

A scalar's windowed median drives the console line (lr, ETA, step and
data times, which the caller measures); the TensorBoard writer is used when
``torch.utils.tensorboard`` imports, and skipped otherwise.
"""
from __future__ import annotations

import collections
import os
import shutil
from typing import Dict, Optional

import numpy as np


class SmoothedValue:
    """Median and mean over a sliding window."""

    def __init__(self, window: int = 20):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        v = float(value)
        self.deque.append(v)
        self.total += v
        self.count += 1

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class Recorder:
    """The run's smoothed stats and TensorBoard writer; ``enabled=False``
    (the loop's ranks other than 0) keeps the stats and writes nothing."""

    def __init__(self, record_dir: str, resume: bool = True, enabled: bool = True):
        self.enabled = enabled
        self.step = 0
        self.epoch = 0
        self.stats: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self._writer = None
        self.record_dir = record_dir
        if not enabled:
            return
        if not resume and os.path.isdir(record_dir):
            shutil.rmtree(record_dir, ignore_errors=True)
        os.makedirs(record_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:            # tensorboard is optional
            return
        self._writer = SummaryWriter(log_dir=record_dir)

    def update(self, scalar_stats: Dict[str, float]):
        for k, v in scalar_stats.items():
            self.stats[k].update(float(v))

    def record(self, prefix: str = "train",
               image_stats: Optional[Dict[str, np.ndarray]] = None):
        if not self.enabled or self._writer is None:
            return
        for k, sv in self.stats.items():
            self._writer.add_scalar(f"{prefix}/{k}", sv.median, self.step)
        for k, img in (image_stats or {}).items():
            self._writer.add_image(f"{prefix}/{k}", np.asarray(img),
                                   self.step, dataformats="HWC")

    def console_line(self, lr: float, max_iter: int, batch_time: float,
                     data_time: float) -> str:
        """The JAX package's line; ``batch_time`` is seconds a step (the ETA
        counts the steps left at it), ``data_time`` the seconds a step
        waited for its batch (``train/loop.py``: both over the last log
        interval's steps)."""
        eta = (max_iter - self.step) * batch_time
        h, rem = divmod(int(eta), 3600)
        m, s = divmod(rem, 60)
        parts = [f"eta: {h}:{m:02d}:{s:02d}", f"epoch: {self.epoch}",
                 f"step: {self.step}"]
        for k in ("loss", "psnr", "img_loss"):
            if k in self.stats:
                parts.append(f"{k}: {self.stats[k].median:.4f}")
        parts += [f"lr: {lr:.6f}", f"batch: {batch_time:.3f}s",
                  f"data: {data_time:.3f}s"]
        return "  ".join(parts)

    def state_dict(self) -> Dict:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, d: Dict):
        self.step = int(d.get("step", 0))
        self.epoch = int(d.get("epoch", 0))

    def close(self):
        if self._writer is not None:
            self._writer.close()
