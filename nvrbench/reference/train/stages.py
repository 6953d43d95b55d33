"""The training-stage schedule as per-epoch config views (port of
``instant_nvr_tpu/train/stages.py``).

Each ``training_stages`` entry applies its keys (``ratio``,
``sample_focus``, ``reg_dist_weight``, ...) from its ``_start`` epoch on;
later entries override earlier ones.
"""
from __future__ import annotations

from ..config import Config


def stage_for_epoch(cfg: Config, epoch: int) -> Config:
    """The config view active at ``epoch``."""
    stages = cfg.get("training_stages", []) or []
    active = {}
    for stage in stages:
        d = stage.to_dict() if isinstance(stage, Config) else dict(stage)
        if epoch >= d.get("_start", 0):
            active.update({k: v for k, v in d.items() if k != "_start"})
    return cfg.replace(**active) if active else cfg
