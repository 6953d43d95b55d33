"""Entry point of the PyTorch port (mirrors the repo's ``run.py``).

    python -m instant_nvr_tpu_torch.run --type network --cfg_file configs/inb/inb_377.yaml
    python -m instant_nvr_tpu_torch.run --type render  --cfg_file configs/inb/inb_377.yaml

``network`` times ``render_rays(train=False)`` on a synthetic ``N_rand`` ray
batch (the JAX ``run.py --type network`` path when no dataset is on disk).
``render`` renders full synthetic frames at the config's eval resolution
(1024 * eval_ratio per side) through :class:`AutoBudgetRenderer`.  Weights
are random, drawn from ``--seed``: the checkpoint loader and the real
dataset come with later slices.  The device defaults to ``cuda`` and a
missing card is an error, never a silent CPU run.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

PORTED_TYPES = ("network", "render")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.run")
    p.add_argument("--cfg_file", default="configs/inb/inb_377.yaml")
    p.add_argument("--type", default="render")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=1,
                   help="frames to render (--type render)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but torch.cuda is not "
                               "available (pass --device cpu to run the plain "
                               "PyTorch path on the CPU)")
        # full-f32 matmuls, as the JAX package's Precision.HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def build(cfg, device: torch.device, seed: int = 0):
    """(model spec, render spec, random InbModel) for ``cfg``."""
    from .models import inb
    from .renderer.inb_renderer import make_render_spec
    mspec = inb.build_model_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = inb.init_params(mspec, gen, device)
    return mspec, make_render_spec(cfg), model


def synthetic_frame(cfg, n_verts: int = 6890, grid: int = 32,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """One synthetic test frame at the eval resolution: every ray that hits
    the subject's box, with the frame's SMPL metadata."""
    from .datasets import synthetic
    from .ops.ray import get_near_far_np
    scene = synthetic.make_scene(n_verts=n_verts, grid=grid, seed=seed)
    side = int(round(1024 * cfg.eval_ratio))
    view = synthetic.render_gt(scene, H=side, W=side)
    n_box = int(get_near_far_np(scene["wbounds"], view["ray_o"],
                                view["ray_d"])[2].sum())
    return synthetic.make_batch(scene, view, n_rays=n_box, split="test")


def render_frames(cfg, device: torch.device, frames: int, seed: int = 0,
                  n_verts: int = 6890, grid: int = 32) -> dict:
    """Render ``frames`` full synthetic frames; returns the last output, the
    per-frame wall times (each ends in a device synchronize) and counts."""
    from .eval.runner import AutoBudgetRenderer, eval_chunk
    mspec, rspec, model = build(cfg, device, seed)
    item = synthetic_frame(cfg, n_verts=n_verts, grid=grid, seed=seed)
    chunk = eval_chunk(cfg)
    renderer = AutoBudgetRenderer(mspec, rspec, chunk)
    times, out = [], None
    for _ in range(frames):
        t0 = time.perf_counter()
        out = renderer(model, item)          # host arrays: the device is done
        times.append(time.perf_counter() - t0)
    return {"out": out, "frame_s": times, "rays": int(item["ray_o"].shape[0]),
            "chunk": chunk, "chunks_rendered": renderer.chunks_rendered,
            "mspec": renderer.mspec}


def run_render(cfg, device: torch.device, frames: int, seed: int) -> None:
    r = render_frames(cfg, device, frames, seed)
    rgb = r["out"]["rgb_map"]
    warm = r["frame_s"][1:] or r["frame_s"]
    ms = 1000.0 * float(np.median(warm))
    print(f"render: {r['rays']} rays/frame, {frames} frames, chunk {r['chunk']}, "
          f"{r['chunks_rendered']} chunks rendered; rgb in "
          f"[{rgb.min():.4f}, {rgb.max():.4f}]")
    print(f"render: {ms:.1f} ms/frame ({'warm median' if frames > 1 else 'cold'}), "
          f"{r['rays'] / (ms / 1000.0):.0f} rays/s on {device}")


def run_network(cfg, device: torch.device, seed: int) -> None:
    """Forward timing on a synthetic N_rand batch (20 timed calls)."""
    from .datasets import synthetic
    from .renderer.inb_renderer import render_rays
    mspec, rspec, model = build(cfg, device, seed)
    scene = synthetic.make_scene()
    view = synthetic.render_gt(scene, H=128, W=128)
    batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in
             synthetic.make_batch(scene, view, n_rays=cfg.N_rand).items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        render_rays(mspec, rspec, model, batch)
        sync()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            render_rays(mspec, rspec, model, batch)
        sync()
    dt = (time.perf_counter() - t0) / n
    print(f"forward: {dt * 1000:.2f} ms  ({cfg.N_rand / dt:.0f} rays/s) on {device}")


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.type not in PORTED_TYPES:
        raise SystemExit(
            f"--type {args.type} is not ported yet (ported: {PORTED_TYPES}); "
            f"see ROADMAP.md queue A for the slice that brings it")
    from .config import make_cfg
    cfg = make_cfg(args.cfg_file, args.opts)
    device = resolve_device(args.device)
    if args.type == "network":
        run_network(cfg, device, args.seed)
    else:
        run_render(cfg, device, args.frames, args.seed)


if __name__ == "__main__":
    main()
