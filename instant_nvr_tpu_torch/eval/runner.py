"""Full-image rendering in ray chunks (port of the rendering half of
``instant_nvr_tpu/eval/runner.py``).

The JAX version maps the chunks inside one jit; here a Python loop renders
them one after another on the device and gathers the telemetry on the
device, so a frame waits for the device once, at the end.  Padding is the
JAX version's as it is (a power-of-two chunk count, padded by wrapping the
real rays), so the worst-chunk telemetry, and with it the budgets, match.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..models import inb
from ..renderer.inb_renderer import TELEMETRY_KEYS, RenderSpec, render_rays

RAY_KEYS = ("ray_o", "ray_d", "near", "far")
MAP_KEYS = ("rgb_map", "acc_map")
META_KEYS = ("A", "big_A", "pbw", "pbw_sizes", "pbounds", "tbounds", "tuv",
             "tuv_sizes", "part_pts", "part_pbw", "lengths2", "part_bounds",
             "R", "Th", "latent_index", "frame_dim")


def eval_chunk(cfg) -> int:
    """``eval_render_chunk`` when set, else ``render_chunk``."""
    c = int(cfg.get("eval_render_chunk", -1))
    return c if c > 0 else int(cfg.render_chunk)


def make_chunked_renderer(mspec: inb.ModelSpec, rspec: RenderSpec,
                          chunk: int) -> Callable:
    """-> render_image(model, rays (Npad, ...), meta) -> rgb/acc maps
    (Npad, ...) plus the worst chunk's budget telemetry, all on the device."""

    @torch.no_grad()
    def render_image(model: inb.InbModel, rays: Dict[str, torch.Tensor],
                     meta: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        n = rays["ray_o"].shape[0]
        outs = []
        for s in range(0, n, chunk):
            b = dict(meta)
            b.update({k: rays[k][s:s + chunk] for k in RAY_KEYS})
            ret = render_rays(mspec, rspec, model, b, train=False)
            outs.append({k: ret[k] for k in MAP_KEYS + TELEMETRY_KEYS})
        res = {k: torch.cat([o[k] for o in outs]) for k in MAP_KEYS}
        for k in ("cull_overflow", "part_overflow", "cull_need"):
            res[k] = torch.stack([o[k] for o in outs]).amax()
        res["part_need"] = torch.stack([o["part_need"] for o in outs]).amax(0)
        return res

    return render_image


def padded_chunks(n: int, chunk: int) -> int:
    """Chunks a render of ``n`` rays takes: the chunk count rounded up to a
    power of two (the JAX runner's bucketing)."""
    return 1 << (max(1, -(-n // chunk)) - 1).bit_length()


def _to_device(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


def render_full_image(render_fn, model: inb.InbModel,
                      item: Dict[str, np.ndarray], meta_keys,
                      chunk: int) -> Dict[str, np.ndarray]:
    """Pad host rays to a power-of-two chunk count (wrapping the real rays),
    render on the model's device, unpad; returns numpy arrays."""
    device = next(model.parameters()).device
    n = item["ray_o"].shape[0]
    idx = np.arange(padded_chunks(n, chunk) * chunk) % n
    rays = {k: _to_device(np.asarray(item[k])[idx], device) for k in RAY_KEYS}
    meta = {k: _to_device(item[k], device) for k in meta_keys if k in item}
    out = render_fn(model, rays, meta)
    return {k: v.cpu().numpy()[:n] if k in MAP_KEYS else v.cpu().numpy()
            for k, v in out.items()}


def raise_budgets(mspec: inb.ModelSpec, cull_need: float, part_need,
                  headroom: float = 1.15) -> inb.ModelSpec:
    """Budgets sized to the worst observed demand, with headroom; never
    lowers an existing budget."""
    new_cull = min(1.0, max(mspec.cull_frac, float(cull_need) * headroom))
    old_t = np.array([min(mspec.part_frac * s, 1.0)
                      for s in mspec.part_budget_scales])
    need_t = np.minimum(np.asarray(part_need, np.float64) * headroom, 1.0)
    t = np.maximum(old_t, need_t)
    pf = float(t.max())
    scales = tuple(float(x) for x in t / max(pf, 1e-9))
    return mspec._replace(cull_frac=new_cull, part_frac=pf,
                          part_budget_scales=scales)


def merge_budgets(mspec: inb.ModelSpec, cull_frac: float, part_frac: float,
                  scales) -> inb.ModelSpec:
    """Elementwise-max merge of stored budget fractions into ``mspec``."""
    old_t = np.array([min(mspec.part_frac * s, 1.0)
                      for s in mspec.part_budget_scales])
    new_t = np.array([min(float(part_frac) * float(s), 1.0) for s in scales])
    t = np.maximum(old_t, new_t)
    pf = float(t.max())
    return mspec._replace(
        cull_frac=min(1.0, max(mspec.cull_frac, float(cull_frac))),
        part_frac=pf,
        part_budget_scales=tuple(float(x) for x in t / max(pf, 1e-9)))


class AutoBudgetRenderer:
    """Full-image renderer that drops no sample.

    Starts at the given budgets, reads the overflow telemetry of every
    image, and on any overflow raises the budgets to the measured demand and
    renders again, so the image does not depend on the training budgets.
    ``chunks_rendered`` counts every chunk rendered, re-renders included.
    (The JAX version can also persist raised budgets to a file; that option
    comes with the evaluator.)
    """

    def __init__(self, mspec: inb.ModelSpec, rspec: RenderSpec, chunk: int,
                 max_raises: int = 4):
        self.mspec = mspec
        self.rspec = rspec
        self.chunk = chunk
        self.max_raises = max_raises
        self.chunks_rendered = 0
        self.render_fn = make_chunked_renderer(mspec, rspec, chunk)

    def _render(self, model, item):
        out = render_full_image(self.render_fn, model, item, META_KEYS,
                                self.chunk)
        self.chunks_rendered += padded_chunks(item["ray_o"].shape[0], self.chunk)
        return out

    def __call__(self, model: inb.InbModel,
                 item: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = self._render(model, item)
        for _ in range(self.max_raises):
            if out["cull_overflow"] <= 0 and out["part_overflow"] <= 0:
                return out
            self.mspec = raise_budgets(self.mspec, out["cull_need"],
                                       out["part_need"])
            print(f"eval: budget overflow (cull {float(out['cull_overflow']):.4f}, "
                  f"part {float(out['part_overflow']):.4f}) -> raised to "
                  f"cull_frac={self.mspec.cull_frac:.3f} "
                  f"part_frac={self.mspec.part_frac:.3f}; re-rendering")
            self.render_fn = make_chunked_renderer(self.mspec, self.rspec,
                                                   self.chunk)
            out = self._render(model, item)
        if out["cull_overflow"] > 0 or out["part_overflow"] > 0:
            print(f"eval WARNING: overflow persists after {self.max_raises} "
                  f"budget raises (cull {float(out['cull_overflow']):.4f}, "
                  f"part {float(out['part_overflow']):.4f})")
        return out
