"""Checkpoint save and restore (port of ``instant_nvr_tpu/train/checkpoint.py``).

The layout of the JAX package (and of the reference's
``trained_model_dir``): one directory per saved epoch, ``<dir>/<epoch>/``,
plus a ``<dir>/latest/`` copy, at most :data:`MAX_KEPT` numbered epochs.
The port writes ``state.pt`` into each directory with ``torch.save``: the
model's and the optimizer's state dicts, the step count and the meta
(epoch and the recorder's counters).  Across ranks only rank 0 writes;
every rank reads.

It reads two layouts, chosen by what an epoch directory holds:

  - ``state.pt``: the port's own;
  - ``_CHECKPOINT_METADATA`` with ``manifest.ocdbt``: the JAX package's
    orbax checkpoint, read by :mod:`.orbax_format` (no orbax, tensorstore
    or jax) and mapped onto the port's state: the parameters through
    ``bridge.params_from_jax`` (zero tile-padding rows checked and
    dropped), optax's state onto the optimizer's (:func:`optimizer_state_from_jax`),
    ``step`` onto the state's step and ``meta`` into the returned meta.

Anything else raises; neither layout gives way to the other.  A
checkpoint of another model build raises too (the JAX package warns and
starts fresh instead).
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import bridge
from ..parallel import mesh as pmesh
from . import orbax_format
from .state import AdamBf16Mu, OptaxSGD

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
    """The epoch directory to read: ``epoch`` when >= 0, else ``latest``,
    else the newest numbered epoch; None when there is none."""
    tag = epoch if epoch is not None and int(epoch) >= 0 else "latest"
    path = _ckpt_dir(model_dir, tag)
    if not os.path.isdir(path):
        e = latest_epoch(model_dir)
        if e is None:
            return None
        path = _ckpt_dir(model_dir, e)
    return path


def layout(path: str) -> str:
    """``"torch"`` or ``"orbax"``: the layout of epoch directory ``path``;
    raises ``ValueError`` when it holds neither, or both."""
    torch_ = os.path.isfile(os.path.join(path, STATE_FILE))
    orbax = orbax_format.is_orbax_dir(path)
    if torch_ and orbax:
        raise ValueError(f"{path}: holds both {STATE_FILE} and an orbax checkpoint")
    if torch_:
        return "torch"
    if orbax:
        return "orbax"
    raise ValueError(f"{path}: neither {STATE_FILE} nor an orbax checkpoint "
                     f"(_CHECKPOINT_METADATA with manifest.ocdbt)")


def _to_f32(tree):
    """bfloat16 leaves of a read orbax tree as float32 numpy (exact)."""
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _dtypes(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*map(_dtypes, tree.values())) if tree else set()
    if isinstance(tree, list):
        return set().union(*map(_dtypes, tree)) if tree else set()
    return {str(tree.dtype).replace("torch.", "")}


def _state_dict_from_jax(tree, model, path: str) -> Dict[str, torch.Tensor]:
    """A JAX parameter-shaped tree (parameters or one moment) as a state
    dict of ``model``'s parameter names; raises naming ``path`` when it
    does not map."""
    try:
        sd = bridge.params_from_jax(_to_f32(tree), model.spec)
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"{path}: does not map onto the model ({e})") from None
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if set(sd) != set(shapes):
        raise ValueError(f"{path}: leaves {sorted(set(sd) ^ set(shapes))} "
                         f"differ from the model's parameters")
    for n, v in sd.items():
        if tuple(v.shape) != shapes[n]:
            raise ValueError(f"{path}.{n}: shape {tuple(v.shape)}, the model's "
                             f"is {shapes[n]}")
    return sd


def _optax_states(node, path: str) -> Iterator[Tuple[str, object]]:
    """The states of an optax chain (nested lists) with their key paths."""
    if isinstance(node, list):
        for i, child in enumerate(node):
            yield from _optax_states(child, f"{path}.{i}")
    else:
        yield path, node


def optimizer_state_from_jax(opt_state, model, optimizer) -> Dict:
    """``optimizer.state_dict()`` holding the moments of the optax state
    ``opt_state`` (as :func:`orbax_format.read_checkpoint` gives it), for
    the chain ``instant_nvr_tpu/train/state.py:make_optimizer`` builds:
    ``ScaleByAdamState(count, mu, nu)`` (adam, its bf16-``mu`` form, radam)
    gives each parameter's ``step``, ``exp_avg`` and ``exp_avg_sq``;
    ``TraceState(trace)`` (sgd) its ``momentum_buffer``.  The empty states
    of ``add_decayed_weights`` and of the ``mlp_weight_decay`` mask, and
    the schedule's count (the port's schedule reads the state's step), are
    checked and skipped.  A state that does not map raises, naming its key
    path."""
    moments = []
    for path, node in _optax_states(opt_state, "opt_state"):
        fields = set(node) if isinstance(node, dict) else None
        if node is None or fields == {"count"}:
            continue
        if fields == {"inner_state"} and node["inner_state"] is None:
            continue
        if fields in ({"count", "mu", "nu"}, {"trace"}):
            moments.append((path, node))
            continue
        raise ValueError(f"{path}: optax state "
                         f"{sorted(fields) if fields else type(node).__name__} "
                         f"has no counterpart in the port's optimizer")
    sgd = isinstance(optimizer, (torch.optim.SGD, OptaxSGD))
    want = {"trace"} if sgd else {"count", "mu", "nu"}
    if len(moments) != 1 or set(moments[0][1]) != want:
        raise ValueError(f"opt_state: states {[p for p, _ in moments]} do not give the "
                         f"one {sorted(want)} state {type(optimizer).__name__} needs")
    path, node = moments[0]
    index, i = {}, 0
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            index[names[id(p)]] = i
            i += 1
    if sgd:
        trace = _state_dict_from_jax(node["trace"], model, f"{path}.trace")
        state = {index[n]: {"momentum_buffer": trace[n]} for n in index}
    else:
        bf16 = isinstance(optimizer, AdamBf16Mu)
        mu_types, want_mu = _dtypes(node["mu"]), {"bfloat16" if bf16 else "float32"}
        if mu_types != want_mu:
            raise ValueError(f"{path}.mu: dtype {sorted(mu_types)}, "
                             f"{type(optimizer).__name__} keeps {sorted(want_mu)}")
        if _dtypes(node["nu"]) != {"float32"}:
            raise ValueError(f"{path}.nu: dtype {sorted(_dtypes(node['nu']))}, not float32")
        count = int(node["count"])
        mu = _state_dict_from_jax(node["mu"], model, f"{path}.mu")
        nu = _state_dict_from_jax(node["nu"], model, f"{path}.nu")
        state = {index[n]: {"step": count if bf16 else torch.tensor(float(count)),
                            "exp_avg": mu[n].to(torch.bfloat16) if bf16 else mu[n],
                            "exp_avg_sq": nu[n]} for n in index}
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def _load_orbax(path: str, state) -> Dict:
    tree = orbax_format.read_checkpoint(path, ("params", "opt_state", "step", "meta"))
    state.model.load_state_dict(_state_dict_from_jax(tree["params"], state.model, "params"))
    state.optimizer.load_state_dict(
        optimizer_state_from_jax(tree["opt_state"], state.model, state.optimizer))
    state.step = int(tree["step"])
    return {k: int(np.asarray(v)) for k, v in tree["meta"].items()}


def load_checkpoint(model_dir: str, state, epoch=None) -> Optional[Dict]:
    """Restore epoch ``epoch`` (or ``latest``) into ``state`` in place: the
    model's parameters, the optimizer's moments and the step, from either
    layout.  Returns the meta, or None when there is no checkpoint.  A
    checkpoint of another model build raises (``load_state_dict``'s error,
    or the mapping's naming the key path): start a fresh run with
    ``--no_resume``."""
    path = _find(model_dir, epoch)
    return None if path is None else restore(path, state)


def restore(path: str, state) -> Dict:
    """Restore the epoch directory ``path``, in either layout, into
    ``state`` in place; returns its meta."""
    if layout(path) == "orbax":
        return _load_orbax(path, state)
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return payload["meta"]


def load_weights(model_dir: str, model, epoch=None):
    """Weights-only restore into ``model`` in place (the reference's
    ``load_network``): epoch ``epoch`` when >= 0, else ``latest``, else the
    newest numbered epoch.  Reads only the model's entry of ``state.pt``,
    or only the ``params`` leaves of an orbax checkpoint; raises
    ``FileNotFoundError`` when there is no checkpoint and
    ``load_state_dict``'s error for a checkpoint of another build."""
    path = _find(model_dir, epoch)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    if layout(path) == "orbax":
        params = orbax_format.read_checkpoint(path, ("params",))["params"]
        model.load_state_dict(_state_dict_from_jax(params, model, "params"))
        return model
    device = next(model.parameters()).device
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                         weights_only=True)
    model.load_state_dict(payload["model"])
    return model

