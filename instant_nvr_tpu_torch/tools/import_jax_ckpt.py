"""Convert the JAX package's orbax checkpoints into the port's layout.

    python -m instant_nvr_tpu_torch.tools.import_jax_ckpt \\
        --cfg_file configs/inb/inb_377.yaml --src exps/inb/inb_377/trained_model \\
        --out <port trained_model_dir> [--epoch N | --all] [--device cuda] [opts ...]

Reads one epoch of the JAX package's ``trained_model_dir`` (``--epoch N``,
or by default what ``train/checkpoint.py:_find`` resolves: ``latest``, else
the newest numbered epoch), or every numbered epoch (``--all``), with
``train/orbax_format.py`` (no orbax, tensorstore or jax), maps each onto a
train state built from the config on ``--device`` (``load_checkpoint``:
parameters, the optimizer's moments, the step and the meta) and writes it
with ``save_checkpoint`` as ``<out>/<epoch>/state.pt``; the last one
written also becomes ``<out>/latest``.  ``load_checkpoint`` reads the JAX
directory itself as well; the conversion only saves the decoding on every
later start.  ``--device`` defaults to ``cuda`` and raises without a card;
``--device cpu`` converts on the CPU.
"""
from __future__ import annotations

import argparse
import os
from typing import List


def epochs_to_convert(src: str, epoch: int, all_epochs: bool) -> List[str]:
    """The epoch directories of ``src`` to convert, oldest first."""
    from ..train import checkpoint
    if all_epochs:
        tags = sorted((d for d in os.listdir(src) if d.isdigit()), key=int)
        paths = [os.path.join(os.path.abspath(src), t) for t in tags]
    else:
        path = checkpoint._find(src, epoch)
        paths = [] if path is None else [path]
    if not paths:
        raise FileNotFoundError(f"no checkpoint under {src}")
    for p in paths:
        if checkpoint.layout(p) != "orbax":
            raise ValueError(f"{p}: not an orbax checkpoint of the JAX package")
    return paths


def convert(cfg, src: str, out: str, device, epoch: int = -1,
            all_epochs: bool = False) -> List[int]:
    """Convert the chosen epochs of ``src`` into ``out``; returns their
    numbers."""
    from ..run import build
    from ..train import checkpoint
    from ..train.state import create_train_state
    paths = epochs_to_convert(src, epoch, all_epochs)
    _, _, model = build(cfg, device, seed=0)
    state = create_train_state(cfg, model)
    done = []
    for i, path in enumerate(paths):
        meta = checkpoint.restore(path, state)      # replaces the whole state
        e = int(meta["epoch"])
        checkpoint.save_checkpoint(out, e, state, meta, latest=i == len(paths) - 1)
        done.append(e)
    return done


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.tools.import_jax_ckpt")
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--src", required=True, help="the JAX package's trained_model_dir")
    p.add_argument("--out", required=True, help="the port's trained_model_dir")
    p.add_argument("--epoch", type=int, default=-1,
                   help="the epoch to convert (default: latest, else the newest)")
    p.add_argument("--all", action="store_true", help="convert every numbered epoch")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs="*")
    args = p.parse_args(argv)
    from ..config import make_cfg
    from ..run import resolve_device
    device = resolve_device(args.device)
    cfg = make_cfg(args.cfg_file, args.opts)
    done = convert(cfg, args.src, args.out, device, args.epoch, args.all)
    print(f"imported epochs {done} of {args.src} -> {args.out}")


if __name__ == "__main__":
    main()
