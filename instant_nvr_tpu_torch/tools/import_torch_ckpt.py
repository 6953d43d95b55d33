"""Import a reference (zju3dv/instant-nvr) ``latest.pth`` into the port
(port of ``tools/import_torch_ckpt.py``).

    python -m instant_nvr_tpu_torch.tools.import_torch_ckpt \\
        --cfg_file configs/inb/inb_377.yaml --ckpt path/to/latest.pth \\
        --out exps/inb/inb_377/trained_model [--epoch 0] [--device cuda]

Maps the reference state dict (``ckpt["net"]`` or the dict itself, a
leading ``net.`` stripped) onto :class:`~instant_nvr_tpu_torch.models.inb.InbModel`
and writes it with ``train/checkpoint.save_checkpoint`` as
``<out>/<epoch>/state.pt`` (and ``latest``) with a fresh Adam state, so
``run --type evaluate`` loads it through ``load_weights``.  The mapping is
the JAX tool's:

  tpose_human.part_networks.<i>.embedder.{dense,hash} -> embed.<part>.{dense,hash}
        hash (H, T, F) flattened to (H*T, F); a scalar grid stores each
        row's feature mean (exact for the sum-over-features aggregation)
  tpose_human.part_networks.<i>.occ.linears.<j>.{weight,bias} -> occ.<j>.{w,b}[i]
        (a Linear weight (out, in) is transposed)
  tpose_human.part_networks.<i>.rgb.linears.<j>  -> rgb.<group>.<j>.{w,b}[slot]
        (the part's slot in ``mspec.rgb_groups()``)
  tpose_human.part_networks.<i>.rgb_latent       -> latent[i]
  tpose_deformer.embedder.{dense,hash}           -> deformer.embed.{dense,hash}
  tpose_deformer.mlp.{0,2,4}.{weight,bias}       -> deformer.mlp.{0,1,2}.{w,b}

A table the reference state dict lacks keeps the seed-0 initial value, as
in the JAX tool.  The port has no packed or tile-padded tables, so nothing
is packed.  A tensor whose shape does not fit the config's spec raises
``ValueError`` naming its key.  As in the JAX package, hashed levels index
their tables with a 32-bit hash where the reference used 64-bit, so they
reproduce the reference only approximately; dense levels and the MLPs map
exactly.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch


def _strip(state_dict) -> Dict[str, torch.Tensor]:
    return {(k[4:] if k.startswith("net.") else k): v for k, v in state_dict.items()}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _table(arr: np.ndarray, scalar: bool) -> np.ndarray:
    """A reference table (rows, F) -- or a hash table (H, T, F) -- in the
    port's storage: (rows, F), or (rows,) feature means for a scalar grid."""
    arr = np.asarray(arr, np.float32)
    arr = arr.reshape(-1, arr.shape[-1])
    if scalar:
        acc = arr[:, 0].copy()
        for f in range(1, arr.shape[1]):
            acc = acc + arr[:, f]
        return acc / np.float32(arr.shape[1])
    return arr


def convert(state_dict, mspec, base: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Reference state dict -> InbModel state dict.  ``base`` (a state
    dict of the same spec) gives the shapes every mapped tensor must have,
    and the tables the reference lacks."""
    sd = _strip(state_dict)
    out = {k: v.detach().clone().cpu() for k, v in base.items()}

    def put(key: str, value: np.ndarray, src: str):
        want = tuple(out[key].shape)
        if tuple(value.shape) != want:
            raise ValueError(f"{src}: shape {tuple(value.shape)} does not fit "
                             f"{key} {want} of this config's spec")
        out[key] = torch.from_numpy(np.array(value, np.float32))

    def get(src: str) -> np.ndarray:
        if src not in sd:
            raise KeyError(f"{src} missing from the reference state dict")
        return _np(sd[src])

    def stacked(key: str, rows, srcs):
        """Stack the parts' tensors into ``key``; a part whose tensor does
        not fit raises naming its own reference key."""
        want = tuple(out[key].shape[1:])
        for r, src in zip(rows, srcs):
            if tuple(r.shape) != want:
                raise ValueError(f"{src}: shape {tuple(r.shape)} does not fit "
                                 f"{key} {want} (per part) of this config's spec")
        put(key, np.stack(rows), srcs[0])

    slot = {}
    for (dh, nl), ids in mspec.rgb_groups():
        for s, i in enumerate(ids):
            slot[i] = (f"h{dh}_l{nl}", s, len(ids))
    n_occ = sum(1 for k in out if k.startswith("occ.") and k.endswith(".w"))
    occ = {j: ([], []) for j in range(n_occ)}
    latent = []
    rgb: Dict[str, Dict[int, list]] = {}
    for i, name in enumerate(mspec.partnames):
        pre = f"tpose_human.part_networks.{i}."
        scalar = mspec.part_embeds[i].scalar
        for kind in ("dense", "hash"):
            if pre + f"embedder.{kind}" in sd:
                put(f"embed.{name}.{kind}", _table(get(pre + f"embedder.{kind}"), scalar),
                    pre + f"embedder.{kind}")
        for j in range(n_occ):
            occ[j][0].append(get(pre + f"occ.linears.{j}.weight").T)
            occ[j][1].append(get(pre + f"occ.linears.{j}.bias"))
        latent.append(get(pre + "rgb_latent"))
        gkey, s, n = slot[i]
        n_rgb = sum(1 for k in out if k.startswith(f"rgb.{gkey}.") and k.endswith(".w"))
        for j in range(n_rgb):
            layer = rgb.setdefault(gkey, {}).setdefault(j, [[None] * n, [None] * n])
            layer[0][s] = get(pre + f"rgb.linears.{j}.weight").T
            layer[1][s] = get(pre + f"rgb.linears.{j}.bias")
    parts = [f"tpose_human.part_networks.{i}." for i in range(mspec.num_parts)]
    for j, (ws, bs) in occ.items():
        stacked(f"occ.{j}.w", ws, [p + f"occ.linears.{j}.weight" for p in parts])
        stacked(f"occ.{j}.b", bs, [p + f"occ.linears.{j}.bias" for p in parts])
    stacked("latent", latent, [p + "rgb_latent" for p in parts])
    for (dh, nl), ids in mspec.rgb_groups():
        gkey = f"h{dh}_l{nl}"
        for j, (ws, bs) in rgb.get(gkey, {}).items():
            stacked(f"rgb.{gkey}.{j}.w", ws, [parts[i] + f"rgb.linears.{j}.weight" for i in ids])
            stacked(f"rgb.{gkey}.{j}.b", bs, [parts[i] + f"rgb.linears.{j}.bias" for i in ids])
    dscalar = mspec.deformer.embed.scalar
    for kind in ("dense", "hash"):
        src = f"tpose_deformer.embedder.{kind}"
        if src in sd:
            put(f"deformer.embed.{kind}", _table(get(src), dscalar), src)
    for j, li in enumerate((0, 2, 4)):
        put(f"deformer.mlp.{j}.w", get(f"tpose_deformer.mlp.{li}.weight").T,
            f"tpose_deformer.mlp.{li}.weight")
        put(f"deformer.mlp.{j}.b", get(f"tpose_deformer.mlp.{li}.bias"),
            f"tpose_deformer.mlp.{li}.bias")
    return out


def reference_shapes(mspec) -> Dict[str, tuple]:
    """{reference key: shape} of a reference state dict for ``mspec``
    (``net.`` prefix stripped): the layout :func:`convert` reads."""
    from ..models.inb import InbModel
    sd = InbModel(mspec, device="meta").state_dict()
    out = {}

    def tables(pre, spec):
        out[pre + "embedder.dense"] = (spec.dense_total, spec.n_features)
        if spec.n_levels > spec.start_hash:
            out[pre + "embedder.hash"] = (spec.n_levels - spec.start_hash,
                                          spec.table_size, spec.n_features)

    def linear(key, w):                       # (in, out) -> Linear (out, in)
        out[key + ".weight"] = (w[-1], w[-2])
        out[key + ".bias"] = (w[-1],)

    slot = {i: f"h{dh}_l{nl}" for (dh, nl), ids in mspec.rgb_groups() for i in ids}
    for i in range(mspec.num_parts):
        pre = f"tpose_human.part_networks.{i}."
        tables(pre, mspec.part_embeds[i])
        for k, v in sd.items():
            if k.startswith("occ.") and k.endswith(".w"):
                linear(pre + f"occ.linears.{k.split('.')[1]}", v.shape)
            if k.startswith(f"rgb.{slot[i]}.") and k.endswith(".w"):
                linear(pre + f"rgb.linears.{k.split('.')[2]}", v.shape)
        out[pre + "rgb_latent"] = tuple(sd["latent"].shape[1:])
    tables("tpose_deformer.", mspec.deformer.embed)
    for j, li in enumerate((0, 2, 4)):
        linear(f"tpose_deformer.mlp.{li}", sd[f"deformer.mlp.{j}.w"].shape)
    return out


def load_reference(path: str):
    """The state dict of a reference checkpoint file."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["net"] if "net" in ckpt else ckpt


def import_checkpoint(cfg, state_dict, out: str, epoch: int, device: torch.device):
    """Convert ``state_dict`` for ``cfg``'s spec, load it into a model on
    ``device`` and write ``<out>/<epoch>/state.pt`` with a fresh optimizer
    state.  Returns the train state."""
    from ..run import build
    from ..train.checkpoint import save_checkpoint
    from ..train.state import create_train_state
    mspec, _, model = build(cfg, device, seed=0)
    model.load_state_dict(convert(state_dict, mspec, model.state_dict()))
    state = create_train_state(cfg, model)
    save_checkpoint(out, epoch, state, {"step": 0, "epoch": epoch})
    return state


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.tools.import_torch_ckpt")
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs="*")
    args = p.parse_args(argv)
    from ..config import make_cfg
    from ..run import resolve_device
    device = resolve_device(args.device)
    cfg = make_cfg(args.cfg_file, args.opts)
    import_checkpoint(cfg, load_reference(args.ckpt), args.out, args.epoch, device)
    print(f"imported {args.ckpt} -> {args.out}/{args.epoch}/state.pt")


if __name__ == "__main__":
    main()
