"""Full-image evaluation: chunked rendering and metric accumulation (port
of ``instant_nvr_tpu/eval/runner.py``).

The JAX version maps the chunks inside one jit; here a Python loop renders
them one after another on the device and gathers the telemetry on the
device, so a frame waits for the device once, at the end.  On a CUDA
device the frame is captured as one CUDA graph (:class:`CapturedFrame`,
the counterpart of that jit) and replayed; ``eager`` keeps the Python
loop.  Padding is the JAX version's as it is (a power-of-two chunk count,
padded by wrapping the real rays), so the worst-chunk telemetry, and with
it the budgets, match.
The frame's spans (``utils/telemetry.py``, while a profiler records):
``frame`` (unit: the item's frame and camera) holds ``frame.pad``, the
renderer's (captured: ``frame.copy_in`` and ``frame.replay``, see
``train/compiled.py``; eager: ``frame.copy_in`` and a ``frame.chunk``
each chunk), ``frame.readback``, and ``frame.raise`` around a raise of the
budgets and its re-render; ``AutoBudgetRenderer.raises`` counts the
raises.
Across ranks (``parallel/mesh.py``) each rank renders a contiguous shard
of the items, raises budgets into its own ``eval_budgets.json.rank<r>``,
and rank 0 writes the metrics of every item (:func:`_allgather_metrics`).
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..datasets.samplers import FrameSampler, shard_indices
from ..datasets.tpose_dataset import TPoseDataset
from ..models import inb
from ..parallel import mesh as pmesh
from ..renderer.inb_renderer import TELEMETRY_KEYS, RenderSpec, render_rays
from ..train import compiled
from ..utils import telemetry
from .evaluator import Evaluator, lpips_route

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
                          chunk: int, span=telemetry.untimed) -> Callable:
    """-> render_image(model, rays (Npad, ...), meta) -> rgb/acc maps
    (Npad, ...) plus the worst chunk's budget telemetry, all on the device.
    ``span`` is ``telemetry.span`` on the eager route (the captured frame
    runs this inside its graph, where no span may go)."""

    @torch.no_grad()
    def render_image(model: inb.InbModel, rays: Dict[str, torch.Tensor],
                     meta: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        with span("frame.copy_in"):
            rays = {k: v.to(device) for k, v in rays.items()}
            meta = {k: v.to(device) for k, v in meta.items()}
        n = rays["ray_o"].shape[0]
        outs = []
        for s in range(0, n, chunk):
            with span("frame.chunk", s // chunk):
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


class CapturedFrame(compiled.CapturedProgram):
    """:func:`make_chunked_renderer`'s ``render_image`` as CUDA graphs,
    one per static key: the padded ray count (the power-of-two buckets of
    :func:`padded_chunks`) and the meta's keys, shapes and dtypes (the
    budgets are this renderer's; a raise makes a new renderer, as the JAX
    package recompiles).  The rays and meta are copied into static buffers
    (host arrays straight from the host), the first frame of a key renders
    eagerly on a side stream (the warm-up: kernels, constants, handles),
    the second captures every chunk and the worst-chunk telemetry into one
    graph, and each later one replays it
    (:class:`~..train.compiled.CapturedProgram`).  The outputs are the
    graph's static tensors: read them before the next frame.  Refuses a
    model off the card."""

    name = "frame"

    def __init__(self, mspec: inb.ModelSpec, rspec: RenderSpec, chunk: int):
        super().__init__()
        self.render_image = make_chunked_renderer(mspec, rspec, chunk)

    def __call__(self, model: inb.InbModel, rays: Dict[str, torch.Tensor],
                 meta: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        if device.type != "cuda":
            raise RuntimeError(f"a captured frame renders on a CUDA device, not "
                               f"{device}; eager=True renders on the CPU")
        # the model is a static input too: its parameters' addresses
        key = (id(model), compiled.signature(rays), compiled.signature(meta))
        return self.run(key, {"rays": rays, "meta": meta}, device,
                        lambda st: self.render_image(model, st["rays"], st["meta"]),
                        holds=model)


def padded_chunks(n: int, chunk: int) -> int:
    """Chunks a render of ``n`` rays takes: the chunk count rounded up to a
    power of two (the JAX runner's bucketing)."""
    return 1 << (max(1, -(-n // chunk)) - 1).bit_length()


def _host(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, order="C"))


def render_full_image(render_fn, model: inb.InbModel,
                      item: Dict[str, np.ndarray], meta_keys,
                      chunk: int) -> Dict[str, np.ndarray]:
    """Pad host rays to a power-of-two chunk count (wrapping the real rays),
    render on the model's device (``render_fn`` copies the host tensors
    there), unpad; returns numpy arrays."""
    n = item["ray_o"].shape[0]
    with telemetry.span("frame.pad"):
        idx = np.arange(padded_chunks(n, chunk) * chunk) % n
        rays = {k: _host(np.asarray(item[k])[idx]) for k in RAY_KEYS}
        meta = {k: _host(np.asarray(item[k])) for k in meta_keys if k in item}
    out = render_fn(model, rays, meta)
    with telemetry.span("frame.readback"):
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

    Raised budgets are written to ``persist_path`` (``eval_budgets.json``
    in the model directory, the JAX package's keys; ``.rank<r>`` appended
    on rank r > 0) and merged back, with any ``persist_path*`` sidecar,
    when a later renderer starts, so an eval pays a raise once.

    ``captured`` renders through a :class:`CapturedFrame` (a new one for
    each raise of the budgets), else through the eager
    :func:`make_chunked_renderer`.  ``raises`` counts the raises.
    """

    def __init__(self, mspec: inb.ModelSpec, rspec: RenderSpec, chunk: int,
                 max_raises: int = 4, persist_path: Optional[str] = None,
                 captured: bool = False):
        self.persist_path = persist_path
        if persist_path:
            for path in sorted(glob.glob(persist_path + "*")):
                with open(path) as f:
                    saved = json.load(f)
                mspec = merge_budgets(mspec, saved["cull_frac"],
                                      saved["part_frac"], saved["scales"])
                print(f"eval: loaded raised budgets from {path} "
                      f"(cull_frac={mspec.cull_frac:.3f} "
                      f"part_frac={mspec.part_frac:.3f})")
        self.mspec = mspec
        self.rspec = rspec
        self.chunk = chunk
        self.max_raises = max_raises
        self.chunks_rendered = 0
        self.raises = 0
        self.captured = captured
        self.render_fn = self._renderer()

    def _renderer(self):
        if self.captured:
            return CapturedFrame(self.mspec, self.rspec, self.chunk)
        return make_chunked_renderer(self.mspec, self.rspec, self.chunk,
                                     span=telemetry.span)

    def _save(self) -> None:
        if not self.persist_path:
            return
        r = pmesh.rank()
        path = self.persist_path if r == 0 else f"{self.persist_path}.rank{r}"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"cull_frac": self.mspec.cull_frac,
                       "part_frac": self.mspec.part_frac,
                       "scales": list(self.mspec.part_budget_scales)}, f)

    def _render(self, model, item):
        out = render_full_image(self.render_fn, model, item, META_KEYS,
                                self.chunk)
        self.chunks_rendered += padded_chunks(item["ray_o"].shape[0], self.chunk)
        return out

    def __call__(self, model: inb.InbModel,
                 item: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        unit = tuple(int(item[k]) for k in ("frame_index", "cam_ind") if k in item)
        with telemetry.span("frame", unit):
            return self._render_settled(model, item)

    def _render_settled(self, model, item):
        out = self._render(model, item)
        for _ in range(self.max_raises):
            if out["cull_overflow"] <= 0 and out["part_overflow"] <= 0:
                return out
            with telemetry.span("frame.raise"):
                self.mspec = raise_budgets(self.mspec, out["cull_need"],
                                           out["part_need"])
                self.raises += 1
                self._save()
                print(f"eval: budget overflow (cull {float(out['cull_overflow']):.4f}, "
                      f"part {float(out['part_overflow']):.4f}) -> raised to "
                      f"cull_frac={self.mspec.cull_frac:.3f} "
                      f"part_frac={self.mspec.part_frac:.3f}; re-rendering")
                self.render_fn = self._renderer()
                out = self._render(model, item)
        if out["cull_overflow"] > 0 or out["part_overflow"] > 0:
            print(f"eval WARNING: overflow persists after {self.max_raises} "
                  f"budget raises (cull {float(out['cull_overflow']):.4f}, "
                  f"part {float(out['part_overflow']):.4f})")
        return out


def budgets_path(cfg) -> str:
    return os.path.join(cfg.trained_model_dir, "eval_budgets.json")


def frame_route(device, eager: bool = False) -> compiled.Route:
    """The eval frame's route: ``captured`` (:class:`CapturedFrame`) on a
    CUDA device unless ``eager``; ``eager`` with its reason otherwise."""
    return compiled.program_route(device, eager)


def evaluate_dataset(cfg, mspec: inb.ModelSpec, rspec: RenderSpec,
                     model: inb.InbModel, split: str = "test", epoch: int = -1,
                     max_items: Optional[int] = None,
                     save_images: bool = True,
                     eager: bool = False) -> Dict[str, float]:
    """Render every item of ``split`` (one view set every
    ``frame_sampler_interval`` frames, at most ``max_items``) on the
    model's device, score it and summarize.  Returns the mean metrics (the
    JAX version's dict) plus ``items``, each item's (index, rays, data s,
    render s, metrics s), and ``chunks_rendered``.  Across ranks each
    renders its shard of the items; the metrics and the summary cover
    every item, and only rank 0 writes them (the PNGs: each rank its own
    items')."""
    ds = TPoseDataset(cfg, split)
    interval = cfg[split].get("frame_sampler_interval", 1) if split in cfg else 1
    indices = list(FrameSampler(len(ds), ds.num_cams, interval))
    if max_items:
        indices = indices[:max_items]
    n_total = len(indices)
    indices = shard_indices(indices, pmesh.rank(), pmesh.world_size(), pad=False)
    device = next(model.parameters()).device
    route = frame_route(device, eager)
    renderer = AutoBudgetRenderer(mspec, rspec, eval_chunk(cfg),
                                  persist_path=budgets_path(cfg),
                                  captured=route.name == "captured")
    lpips = lpips_route(device, eager)
    if device.type == "cuda":
        print(f"eval frame route: {route}; eval LPIPS route: {lpips}", flush=True)
    evaluator = Evaluator(result_dir=cfg.result_dir,
                          lpips_weights=cfg.get("lpips_weights", ""),
                          save_images=save_images,
                          eval_part=cfg.get("eval_part", ""),
                          partnames=list(mspec.partnames),
                          test_full=cfg.get("test_full", True),
                          device=device, captured=lpips.name == "captured")
    timings = []
    for idx in indices:
        t0 = time.time()
        item = ds.get_item(idx)
        t1 = time.time()
        out = renderer(model, item)      # host arrays: the device is done
        t2 = time.time()
        evaluator.evaluate(out["rgb_map"], item["rgb"], item["mask_at_box"],
                           int(item["H"]), int(item["W"]),
                           frame_index=int(item["frame_index"]),
                           view_index=int(item["cam_ind"]),
                           sem_mask=item.get("sem_mask"), epoch=epoch)
        t3 = time.time()
        n = int(item["ray_o"].shape[0])
        timings.append((idx, n, t1 - t0, t2 - t1, t3 - t2))
        print(f"eval item {idx} ({n} rays): data {t1 - t0:.2f}s  "
              f"render {t2 - t1:.2f}s  metrics {t3 - t2:.2f}s", flush=True)
    if pmesh.world_size() > 1:
        _allgather_metrics(evaluator, n_total)
        if not pmesh.is_rank0():
            evaluator.result_dir = ""   # rank 0 writes the merged metrics
    return dict(evaluator.summarize(epoch=epoch), items=timings,
                chunks_rendered=renderer.chunks_rendered)


def _allgather_metrics(evaluator: Evaluator, n_total: int) -> None:
    """Every rank's metric lists, merged in rank order (the shards are
    contiguous, so this is the items' order), on every rank.  Shards can
    be uneven: each rank sends its count in the first slot of a buffer of
    ``cap + 1``, and the padding is dropped by count, not by value, so a
    genuine NaN metric survives as it would in one process.  Float64, so
    the merged values are the ranks' own."""
    cap = -(-n_total // pmesh.world_size())
    for attr in ("mse", "psnr", "ssim", "lpips"):
        xs = getattr(evaluator, attr)
        a = torch.zeros(cap + 1, dtype=torch.float64, device=pmesh.rank_device())
        a[0] = len(xs)
        a[1:1 + len(xs)] = torch.tensor(xs, dtype=torch.float64)
        rows = pmesh.all_gather_rows(a).cpu().numpy()
        setattr(evaluator, attr, [float(v) for row in rows
                                  for v in row[1:1 + int(row[0])]])
