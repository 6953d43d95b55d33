"""Entry point of the PyTorch port: the repo's ``run.py`` dispatch.

    python -m instant_nvr_tpu_torch.run --type evaluate --cfg_file configs/inb/inb_fake.yaml
    python -m instant_nvr_tpu_torch.run --type vis|bullet|prune|tmesh|tdmesh ...
    python -m instant_nvr_tpu_torch.run --type network|dataset|exportdecoder|exportpart ...
    python -m instant_nvr_tpu_torch.run --type render --frames 3

The types of the JAX ``run.py``:
  - ``evaluate``: the test split scored (PSNR, SSIM, LPIPS) into
    ``result_dir/metrics.npy`` with comparison PNGs (none with
    ``fast_eval``); ``vis``: the same, always with the PNGs;
  - ``bullet``: novel views on a camera orbit into
    ``result_dir/novel_views/``, merged into an mp4 where ffmpeg exists;
  - ``prune``: the occupancy cube ``result_dir/latest.npy`` that
    ``prune_using_geo`` sampling reads; ``tmesh`` / ``tdmesh``: the cube
    and a marching-tetrahedra ``mesh.obj`` in ``result_dir/tmesh`` or
    ``tdmesh`` (after the deformer residual);
  - ``network``: forward timing on a dataset batch, or on a synthetic
    ``N_rand`` batch when the dataset is not on disk; ``dataset``: 8 train
    items; ``exportdecoder`` / ``exportpart``: the MLP weights and the part
    tables as npz, in the JAX version's keys.
Each loads the weights of ``trained_model_dir`` (epoch ``--epoch`` or
``test.epoch``, else the latest) and keeps a random model, drawn from
``--seed``, with a warning when there is none.  The port's own ``render``
renders full synthetic frames at the config's eval resolution (1024 *
eval_ratio per side) from random weights.  The device defaults to ``cuda``
and a missing card is an error, never a silent CPU run.  ``--distributed``
(``evaluate`` and ``vis``; torchrun's environment, ``parallel/mesh.py``)
splits the items over the ranks: NCCL on ``cuda``, Gloo on ``cpu``; rank
0 writes the metrics of every item.  On the card the frames of evaluate,
vis, bullet, network and render are CUDA graphs (``eval/runner.py:
CapturedFrame``), and so are the LPIPS of evaluate and vis
(``eval/evaluator.py:CapturedLpips``) and the cube of prune, tmesh and
tdmesh (``eval/mesh.py:CapturedCube``); ``--eager`` runs them op by op.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.run")
    p.add_argument("--cfg_file", default="configs/inb/inb_377.yaml")
    p.add_argument("--type", default="evaluate")
    p.add_argument("--epoch", type=int, default=-1,
                   help="checkpoint epoch to load (default: the latest)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=1,
                   help="frames to render (--type render)")
    p.add_argument("--distributed", action="store_true",
                   help="one rank of a torch.distributed evaluation "
                        "(torchrun's environment): NCCL on cuda, Gloo on cpu")
    p.add_argument("--eager", action="store_true",
                   help="run op by op from Python, not as captured CUDA graphs: "
                        "the frames of evaluate, vis, bullet, network and render, "
                        "the LPIPS of evaluate and vis, the cube of prune, "
                        "tmesh and tdmesh")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but torch.cuda is not "
                               "available (pass --device cpu to run the plain "
                               "PyTorch path on the CPU)")
        # full-f32 matmuls and convolutions, as the JAX package's
        # Precision.HIGHEST (the LPIPS metric's VGG runs on cuDNN)
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


def load(cfg, device: torch.device, seed: int = 0):
    """:func:`build`, then the weights of ``trained_model_dir`` at epoch
    ``test.epoch`` (or the latest); a random model, with a warning, when
    there is no checkpoint."""
    from .train.checkpoint import load_weights
    mspec, rspec, model = build(cfg, device, seed)
    try:
        load_weights(cfg.trained_model_dir, model, cfg.test.get("epoch", -1))
        print(f"loaded weights from {cfg.trained_model_dir}")
    except FileNotFoundError:
        print("WARNING: no checkpoint found, using random init")
    return mspec, rspec, model


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
                  n_verts: int = 6890, grid: int = 32, eager: bool = False) -> dict:
    """Render ``frames`` full synthetic frames on ``frame_route``'s route;
    returns the last output, the per-frame wall times (each ends in a
    device synchronize) and counts."""
    from .eval.runner import AutoBudgetRenderer, eval_chunk, frame_route
    mspec, rspec, model = build(cfg, device, seed)
    item = synthetic_frame(cfg, n_verts=n_verts, grid=grid, seed=seed)
    chunk = eval_chunk(cfg)
    route = frame_route(device, eager)
    renderer = AutoBudgetRenderer(mspec, rspec, chunk,
                                  captured=route.name == "captured")
    times, out = [], None
    for _ in range(frames):
        t0 = time.perf_counter()
        out = renderer(model, item)          # host arrays: the device is done
        times.append(time.perf_counter() - t0)
    return {"out": out, "frame_s": times, "rays": int(item["ray_o"].shape[0]),
            "chunk": chunk, "chunks_rendered": renderer.chunks_rendered,
            "mspec": renderer.mspec, "route": route}


def run_render(cfg, device: torch.device, frames: int, seed: int,
               eager: bool = False) -> None:
    r = render_frames(cfg, device, frames, seed, eager=eager)
    rgb = r["out"]["rgb_map"]
    warm = r["frame_s"][1:] or r["frame_s"]
    ms = 1000.0 * float(np.median(warm))
    print(f"render: {r['rays']} rays/frame, {frames} frames, chunk {r['chunk']}, "
          f"{r['chunks_rendered']} chunks rendered; rgb in "
          f"[{rgb.min():.4f}, {rgb.max():.4f}]")
    print(f"render: {ms:.1f} ms/frame ({'warm median' if frames > 1 else 'cold'}), "
          f"{r['rays'] / (ms / 1000.0):.0f} rays/s on {device}, route {r['route']}")


def run_network(cfg, device: torch.device, seed: int, eager: bool = False) -> None:
    """Forward timing (20 timed calls) on the train split's first item, or
    on a synthetic ``N_rand`` batch when the dataset is not on disk; on
    ``frame_route``'s route (captured: the batch as one chunk of a
    :class:`~.eval.runner.CapturedFrame`, after its warm-up and capture)."""
    from .datasets.tpose_dataset import TPoseDataset
    from .eval.runner import META_KEYS, RAY_KEYS, CapturedFrame, frame_route
    from .renderer.inb_renderer import render_rays
    from .train.loop import device_batch
    mspec, rspec, model = load(cfg, device, seed)
    put = lambda v: torch.as_tensor(np.asarray(v), device=device)
    try:
        item = TPoseDataset(cfg, "train").get_item(0, rng=np.random.default_rng(0))
        batch = device_batch(item, cfg.get("reg_dist_weight", 0.1), put)
        n_rays = int(batch["ray_o"].shape[0])
        print(f"timing a real dataset batch ({n_rays} rays)")
    except FileNotFoundError as e:
        from .datasets import synthetic
        print(f"dataset not found ({e}); timing a synthetic batch")
        scene = synthetic.make_scene()
        view = synthetic.render_gt(scene, H=128, W=128)
        batch = {k: put(v) for k, v in
                 synthetic.make_batch(scene, view, n_rays=cfg.N_rand).items()}
        n_rays = cfg.N_rand

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    route = frame_route(device, eager)
    if route.name == "captured":
        frame = CapturedFrame(mspec, rspec, n_rays)
        rays = {k: batch[k] for k in RAY_KEYS}
        meta = {k: batch[k] for k in META_KEYS if k in batch}
        forward = lambda: frame(model, rays, meta)
        warm = 2                                # the warm-up, then the capture
    else:
        forward = lambda: render_rays(mspec, rspec, model, batch)
        warm = 1
    with torch.no_grad():
        for _ in range(warm):
            forward()
        sync()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            forward()
        sync()
    dt = (time.perf_counter() - t0) / n
    print(f"forward: {dt * 1000:.2f} ms  ({n_rays / dt:.0f} rays/s) on {device}, "
          f"route {route}")


def run_evaluate(cfg, device: torch.device, seed: int, save_images=None,
                 eager: bool = False) -> dict:
    from .eval.runner import evaluate_dataset
    cfg = cfg.replace(eval=True)
    mspec, rspec, model = load(cfg, device, seed)
    if save_images is None:
        save_images = not cfg.get("fast_eval", False)
    return evaluate_dataset(cfg, mspec, rspec, model, split="test",
                            save_images=save_images, eager=eager)


def run_vis(cfg, device: torch.device, seed: int, eager: bool = False) -> dict:
    """The test split rendered to comparison PNGs (and scored)."""
    return run_evaluate(cfg, device, seed, save_images=True, eager=eager)


def run_bullet(cfg, device: torch.device, seed: int, eager: bool = False):
    from .eval.visualizer import render_novel_views
    mspec, _, model = load(cfg, device, seed)
    return render_novel_views(cfg, mspec, model, eager=eager)


def run_dataset(cfg, device: torch.device, seed: int) -> None:
    from .datasets.tpose_dataset import TPoseDataset
    ds = TPoseDataset(cfg, "train")
    n = min(len(ds), 8)
    t0 = time.time()
    for i in range(n):
        item = ds.get_item(i, rng=np.random.default_rng(i))
        print(f"item {i}: rays={item['ray_o'].shape} H={item['H']} W={item['W']}")
    print(f"{n} items in {time.time() - t0:.2f}s")


def run_exportdecoder(cfg, device: torch.device, seed: int) -> str:
    """The occupancy and colour MLPs and the latent codes ->
    ``result_dir/decoders/decoders.npz``."""
    from .bridge import tree_from_model
    tree = tree_from_model(load(cfg, device, seed)[2])
    flat = {}
    for j, layer in enumerate(tree["occ"]):
        flat[f"occ_{j}_w"], flat[f"occ_{j}_b"] = layer["w"], layer["b"]
    for key, layers in tree["rgb"].items():
        for j, layer in enumerate(layers):
            flat[f"rgb_{key}_{j}_w"], flat[f"rgb_{key}_{j}_b"] = layer["w"], layer["b"]
    flat["latent"] = tree["latent"]
    out = os.path.join(cfg.result_dir, "decoders")
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "decoders.npz"), **flat)
    print(f"wrote {out}/decoders.npz")
    return out


def run_exportpart(cfg, device: torch.device, seed: int) -> str:
    """Each part's hash tables (logical rows) -> ``result_dir/parts/<part>.npz``."""
    from .bridge import tree_from_model
    tree = tree_from_model(load(cfg, device, seed)[2])
    out = os.path.join(cfg.result_dir, "parts")
    os.makedirs(out, exist_ok=True)
    for name, tbl in tree["embed"].items():
        np.savez(os.path.join(out, f"{name}.npz"), dense=tbl["dense"], hash=tbl["hash"])
    print(f"wrote {out}/<part>.npz x{len(tree['embed'])}")
    return out


def run_prune(cfg, device: torch.device, seed: int, eager: bool = False) -> np.ndarray:
    """The occupancy cube (res 128) of the test split's first item ->
    ``result_dir/latest.npy``; on ``cube_route``'s route."""
    from .datasets.tpose_dataset import TPoseDataset
    from .eval.mesh import occupancy_grid
    mspec, _, model = load(cfg, device, seed)
    item = TPoseDataset(cfg, "test").get_item(0)
    occ, _ = occupancy_grid(cfg, mspec, model, item, deformed=False, res=128,
                            eager=eager)
    os.makedirs(cfg.result_dir, exist_ok=True)
    np.save(os.path.join(cfg.result_dir, "latest.npy"), occ)
    print(f"wrote {cfg.result_dir}/latest.npy")
    return occ


def run_tmesh(cfg, device: torch.device, seed: int, deformed: bool = False,
              eager: bool = False):
    from .eval.mesh import extract_mesh
    mspec, _, model = load(cfg, device, seed)
    out = os.path.join(cfg.result_dir, "tdmesh" if deformed else "tmesh")
    return extract_mesh(cfg, mspec, model, out, deformed=deformed, eager=eager)


DISPATCH = {
    "evaluate": run_evaluate,
    "dataset": run_dataset,
    "network": run_network,
    "vis": run_vis,
    "bullet": run_bullet,
    "prune": run_prune,
    "exportdecoder": run_exportdecoder,
    "exportpart": run_exportpart,
    "tmesh": lambda c, d, s, **kw: run_tmesh(c, d, s, deformed=False, **kw),
    "tdmesh": lambda c, d, s, **kw: run_tmesh(c, d, s, deformed=True, **kw),
}


SHARDED = ("evaluate", "vis")
# the types that run a captured program (frames, LPIPS, the cube), and so
# take --eager
CAPTURED_TYPES = ("evaluate", "vis", "bullet", "network", "prune", "tmesh", "tdmesh")


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.type not in DISPATCH and args.type != "render":
        raise SystemExit(f"unknown --type {args.type}; one of "
                         f"{list(DISPATCH) + ['render']}")
    if not args.distributed:
        _main(args, args.device)
        return
    if args.type not in SHARDED:
        raise SystemExit(f"--distributed runs --type {' or '.join(SHARDED)}, "
                         f"not {args.type}")
    from .config import make_cfg
    from .models import inb
    from .parallel import mesh as pmesh
    inb.check_distributed(make_cfg(args.cfg_file, args.opts))
    with pmesh.distributed(args.device) as device:
        _main(args, device)


def _main(args, device) -> None:
    from .config import make_cfg
    cfg = make_cfg(args.cfg_file, args.opts)
    if args.epoch >= 0:
        cfg = cfg.replace(test=cfg.test.replace(epoch=args.epoch))
    device = resolve_device(str(device))
    if args.type == "render":
        run_render(cfg, device, args.frames, args.seed, eager=args.eager)
        return
    if cfg.get("auto_budget", False):
        # the budget probe of training, so the spec has the budgets the
        # checkpoint was trained at
        from .models.budget import apply_auto_budget
        cfg = apply_auto_budget(cfg)
    kwargs = {"eager": args.eager} if args.type in CAPTURED_TYPES else {}
    DISPATCH[args.type](cfg, device, args.seed, **kwargs)


if __name__ == "__main__":
    main()
