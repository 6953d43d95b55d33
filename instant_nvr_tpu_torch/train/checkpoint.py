"""Checkpoint save and restore (port of ``instant_nvr_tpu/train/checkpoint.py``).

The layout of the JAX package (and of the reference's
``trained_model_dir``): one directory per saved epoch, ``<dir>/<epoch>/``,
plus a ``<dir>/latest/`` copy, at most :data:`MAX_KEPT` numbered epochs.
Each directory holds ``state.pt``, written with ``torch.save``: the
model's and the optimizer's state dicts, the step count and the meta
(epoch and the recorder's counters).  The JAX package's orbax checkpoints
are not read here (ROADMAP.md A10: the converter needs orbax, so it lives
outside the port).  Across ranks only rank 0 writes; every rank reads.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import torch

from ..parallel import mesh as pmesh

MAX_KEPT = 20
STATE_FILE = "state.pt"


def _ckpt_dir(model_dir: str, tag) -> str:
    return os.path.join(os.path.abspath(model_dir), str(tag))


def save_checkpoint(model_dir: str, epoch: int, state, recorder_state: Dict,
                    latest: bool = True) -> None:
    """Write ``state`` (a ``TrainState``) as epoch ``epoch``; ``latest``
    also replaces the ``latest`` copy (staged, then renamed, so a reader
    never sees half of it).  A no-op on ranks other than 0."""
    if not pmesh.is_rank0():
        return
    os.makedirs(model_dir, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "meta": {"epoch": int(epoch), **{k: int(v) for k, v in recorder_state.items()}},
    }
    path = _ckpt_dir(model_dir, epoch)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if latest:
        lpath = _ckpt_dir(model_dir, "latest")
        tmp = lpath + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(path, tmp)
        shutil.rmtree(lpath, ignore_errors=True)
        os.replace(tmp, lpath)
    _gc(model_dir)


def _gc(model_dir: str) -> None:
    epochs = sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())
    for e in epochs[:-MAX_KEPT]:
        shutil.rmtree(_ckpt_dir(model_dir, e), ignore_errors=True)


def latest_epoch(model_dir: str) -> Optional[int]:
    if not os.path.isdir(model_dir):
        return None
    epochs = [int(d) for d in os.listdir(model_dir) if d.isdigit()]
    return max(epochs) if epochs else None


def _find(model_dir: str, epoch=None) -> Optional[str]:
    tag = epoch if epoch is not None and int(epoch) >= 0 else "latest"
    path = _ckpt_dir(model_dir, tag)
    if not os.path.isdir(path):
        e = latest_epoch(model_dir)
        if e is None:
            return None
        path = _ckpt_dir(model_dir, e)
    return os.path.join(path, STATE_FILE)


def load_checkpoint(model_dir: str, state, epoch=None) -> Optional[Dict]:
    """Restore epoch ``epoch`` (or ``latest``) into ``state`` in place: the
    model's parameters, the optimizer's moments and the step.  Returns the
    meta, or None when there is no checkpoint.  A checkpoint of another
    model build raises (``load_state_dict``'s error): start a fresh run
    with ``--no_resume``."""
    path = _find(model_dir, epoch)
    if path is None:
        return None
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return payload["meta"]


def load_weights(model_dir: str, model, epoch=None):
    """Weights-only restore into ``model`` in place (the reference's
    ``load_network``): epoch ``epoch`` when >= 0, else ``latest``, else the
    newest numbered epoch.  Reads only the ``model`` entry of ``state.pt``;
    raises ``FileNotFoundError`` when there is no checkpoint and
    ``load_state_dict``'s error for a checkpoint of another build."""
    path = _find(model_dir, epoch)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(payload["model"])
    return model

