"""Point budgets sized from dataset statistics (port of
``instant_nvr_tpu/models/budget.py``).

The model keeps fixed budgets: K = cull_frac x N samples survive the
SMPL-distance cull, Kp = part_frac x scale_p x K per part.  Budgets too
small drop threshold-passing points (the farthest first); too large waste
work.  :func:`estimate_budgets` probes a few dataset items on the host
(stratified samples -> the distance channel of the pose volume, as the
cull reads it -> per-part nearest-vertex distances) and sizes every budget
at ``headroom`` x the worst surviving share seen.  ``auto_budget: true``
makes the train entry rewrite ``cull_budget`` / ``part_budget`` /
``part_budget_scales`` before the model spec is built (budgets change
compute shapes only, never parameter shapes).
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np


def _trilinear_last_channel(vol: np.ndarray, sizes, bounds: np.ndarray,
                            pts: np.ndarray) -> np.ndarray:
    """Host twin of ``ops/grid_sample.pts_sample_volume`` for channel -1."""
    X, Y, Z = int(sizes[0]), int(sizes[1]), int(sizes[2])
    v = vol[..., -1]
    ext = bounds[1] - bounds[0]
    c = (pts - bounds[0]) / ext * np.array([X - 1, Y - 1, Z - 1])
    c0 = np.clip(np.floor(c).astype(int), 0, [X - 2, Y - 2, Z - 2])
    f = np.clip(c - c0, 0.0, 1.0)
    out = np.zeros(len(pts), vol.dtype)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                out += w * v[c0[:, 0] + dx, c0[:, 1] + dy, c0[:, 2] + dz]
    return out


def estimate_budgets(cfg, dataset, n_probe: int = 4,
                     headroom: float = 1.25,
                     seed: int = 0) -> Tuple[float, float, Tuple[float, ...]]:
    """(cull_frac, part_frac, part_scales) sized from probe items."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    n_samples = cfg.N_samples
    thresh = cfg.smpl_thresh
    worst_cull = 0.0
    worst_part = np.zeros(5)
    for i in rng.choice(len(dataset), min(n_probe, len(dataset)), replace=False):
        item = dataset.get_item(int(i), rng=rng)
        ro, rd = item["ray_o"], item["ray_d"]
        t = item["near"][:, None] + (item["far"] - item["near"])[:, None] \
            * rng.uniform(size=(len(ro), n_samples))
        wpts = (ro[:, None] + rd[:, None] * t[..., None]).reshape(-1, 3)
        ppts = (wpts - item["Th"].reshape(1, 3)) @ item["R"]
        pnorm = _trilinear_last_channel(
            item["pbw"], item.get("pbw_sizes", item["pbw"].shape[:3]),
            item["pbounds"], ppts)
        surv = pnorm < thresh
        worst_cull = max(worst_cull, float(surv.mean()))
        if surv.any():
            sp = ppts[surv]
            for p in range(5):
                n = int(item["lengths2"][p])
                d = cKDTree(item["part_pts"][p][:n]).query(sp)[0]
                worst_part[p] = max(worst_part[p], float((d < thresh).mean()))

    cull = float(np.clip(headroom * worst_cull, 0.02, 1.0))
    need = np.clip(headroom * worst_part, 0.02, 1.0)
    part_frac = float(need.max())
    scales = tuple(float(x) for x in need / part_frac)
    return cull, part_frac, scales


def apply_auto_budget(cfg):
    """``cfg`` with measured budgets when ``cfg.auto_budget`` is set.

    The total part points stay under ``auto_budget_max_points`` (the
    gathers' intermediates grow with them).  The budgets are saved to
    ``trained_model_dir/budgets.json`` at the first probe and read from it
    afterwards, so a resumed run builds the model with the budgets it
    trained at.  Across ranks, rank 0 loads or probes and broadcasts the
    budgets, and only it writes the file: ranks that probed on their own
    could build models of other shapes (a probe changes once
    ``latest.npy`` exists), and then their collectives would not match."""
    if not cfg.get("auto_budget", False):
        return cfg
    from ..parallel import mesh as pmesh
    if pmesh.world_size() > 1:
        import torch
        vals = torch.zeros(7, dtype=torch.float64, device=pmesh.rank_device())
        if pmesh.is_rank0():
            c = _load_or_probe(cfg)
            vals[:] = torch.tensor([c.cull_budget, c.part_budget,
                                    *c.part_budget_scales], dtype=torch.float64)
        vals = pmesh.broadcast_(vals).tolist()
        return cfg.merged({"cull_budget": vals[0], "part_budget": vals[1],
                           "part_budget_scales": vals[2:]})
    return _load_or_probe(cfg)


def _load_or_probe(cfg):
    path = os.path.join(cfg.trained_model_dir, "budgets.json")
    if os.path.exists(path):
        with open(path) as f:
            saved = json.load(f)
        print(f"auto_budget: loaded persisted budgets from {path}")
        return cfg.merged({"cull_budget": saved["cull_budget"],
                           "part_budget": saved["part_budget"],
                           "part_budget_scales": saved["part_budget_scales"]})
    from ..datasets.tpose_dataset import TPoseDataset
    ds = TPoseDataset(cfg, "train")
    cull, part, scales = estimate_budgets(
        cfg, ds, headroom=cfg.get("budget_headroom", 1.25))

    patch = any(cfg.get(f"use_{k}", False)
                for k in ("lpips", "ssim", "fourier", "tv_image"))
    n_rays = cfg.patch_size ** 2 if patch else cfg.N_rand
    total_pp = part * (cull * n_rays * cfg.N_samples) * sum(scales)
    cap = cfg.get("auto_budget_max_points", 131072)
    if total_pp > cap:
        part *= cap / total_pp
        print(f"auto_budget: part budget clamped to {part:.3f} "
              f"(memory cap {cap} part-points; expect some overflow)")

    print(f"auto_budget: cull {cfg.cull_budget} -> {cull:.3f}, part "
          f"{cfg.part_budget} -> {part:.3f}, scales "
          f"{tuple(round(s, 2) for s in scales)}")
    os.makedirs(cfg.trained_model_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"cull_budget": cull, "part_budget": part,
                   "part_budget_scales": list(scales)}, f)
    return cfg.merged({"cull_budget": cull, "part_budget": part,
                       "part_budget_scales": list(scales)})
