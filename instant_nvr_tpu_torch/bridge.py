"""Carry JAX parameters into the port, and the port's back out.

``params_from_jax(tree_np, mspec)`` takes ``jax.tree.map(np.asarray,
params)`` of an ``instant_nvr_tpu.models.inb.init_params`` tree (or a
restored checkpoint) and returns a state dict for
:class:`~instant_nvr_tpu_torch.models.inb.InbModel` (``load_state_dict``).
``tree_from_model(model, which)`` goes the other way, for parameters or
gradients, so tests compare the two frameworks leaf by leaf.  It needs only
numpy: nothing here imports jax.

The JAX tables may carry rows beyond their logical size (TPU scatter-kernel
tile padding, zero by construction); they are dropped after checking that
they are zero.  Tables the JAX package stores packed as
(rows / (128 / F), 128) have no counterpart here and are refused; the
flagship's part grids are scalar and its deformer table is small, so it
has none.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.inb import ModelSpec
from .ops.hashgrid import HashGridSpec


def _table(arr, spec: HashGridSpec, rows: int, name: str) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if spec.scalar:
        if arr.ndim != 1:
            raise ValueError(f"{name}: scalar grid expects a 1-D table, "
                             f"got {arr.shape}")
    elif arr.ndim != 2 or arr.shape[1] != spec.n_features:
        raise ValueError(
            f"{name}: table of shape {arr.shape} is stored packed (or is not "
            f"(rows, {spec.n_features})); packed tables are not supported")
    if arr.shape[0] < rows:
        raise ValueError(f"{name}: {arr.shape[0]} rows, spec needs {rows}")
    if np.any(arr[rows:] != 0):
        raise ValueError(f"{name}: padding rows beyond {rows} are not zero")
    return arr[:rows]


def _layers(prefix: str, layers) -> Dict[str, np.ndarray]:
    out = {}
    for j, layer in enumerate(layers):
        out[f"{prefix}.{j}.w"] = layer["w"]
        out[f"{prefix}.{j}.b"] = layer["b"]
    return out


def params_from_jax(tree_np, mspec: ModelSpec) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> InbModel state dict (CPU f32)."""
    sd: Dict[str, np.ndarray] = {}
    for name, spec in zip(mspec.partnames, mspec.part_embeds):
        t = tree_np["embed"][name]
        sd[f"embed.{name}.dense"] = _table(t["dense"], spec, spec.dense_rows,
                                           f"embed.{name}.dense")
        sd[f"embed.{name}.hash"] = _table(t["hash"], spec, spec.hash_rows,
                                          f"embed.{name}.hash")
    sd.update(_layers("occ", tree_np["occ"]))
    for gkey, layers in tree_np["rgb"].items():
        sd.update(_layers(f"rgb.{gkey}", layers))
    sd["latent"] = tree_np["latent"]
    dspec = mspec.deformer.embed
    d = tree_np["deformer"]
    sd["deformer.embed.dense"] = _table(d["embed"]["dense"], dspec,
                                        dspec.dense_rows, "deformer.embed.dense")
    sd["deformer.embed.hash"] = _table(d["embed"]["hash"], dspec,
                                       dspec.hash_rows, "deformer.embed.hash")
    sd.update(_layers("deformer.mlp", d["mlp"]))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def tree_from_model(model, which: str = "data") -> dict:
    """The model's parameters (``which="data"``) or their gradients
    (``"grad"``) as the JAX parameter tree: nested dicts and lists of numpy
    arrays, tables at their logical rows (no tile padding).  A parameter
    without a gradient gives zeros."""
    if which not in ("data", "grad"):
        raise ValueError(f"which must be 'data' or 'grad', not {which!r}")

    def leaf(p):
        t = p.detach() if which == "data" else p.grad
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().float().cpu().numpy()

    def tables(t):
        return {"dense": leaf(t.dense), "hash": leaf(t.hash)}

    def layers(ls):
        return [{"w": leaf(layer.w), "b": leaf(layer.b)} for layer in ls]

    return {
        "embed": {name: tables(t) for name, t in model.embed.items()},
        "occ": layers(model.occ),
        "rgb": {gkey: layers(ls) for gkey, ls in model.rgb.items()},
        "latent": leaf(model.latent),
        "deformer": {"embed": tables(model.deformer.embed),
                     "mlp": layers(model.deformer.mlp)},
    }
