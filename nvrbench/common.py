"""What every traffic kind of the benchmark shares: the configuration as run,
the subject, the seeds, the weights the harness draws, the card's power
limit and the clocks.

Seeds: every draw of a run derives from ``--seed`` through
:func:`derive`, a ``numpy`` ``SeedSequence`` over (seed, stream, ...), so
any whole number is a seed and two streams never share draws.  The weights
are drawn on the device by the reference's ``init_params`` from a
``torch.Generator`` seeded by ``derive(seed, "weights")``, then loaded into
the program's model: the program and the reference start from the same
tensors, which neither side made.
"""
from __future__ import annotations

import os
import subprocess
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import yaml

from . import subject

# subject writers on the card's host (its 8 cores): one process a frame
SUBJECT_WORKERS = 8


def derive(seed: int, *stream) -> int:
    """A 63-bit seed for the stream named by ``stream`` (ints and strings)
    of run seed ``seed``."""
    words = [int(seed) & (2 ** 64 - 1), int(seed) >> 64]
    for s in stream:
        words.append(zlib.crc32(s.encode()) if isinstance(s, str) else int(s))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               & np.uint64(2 ** 63 - 1))


def rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *stream))


def ensure_subject(ctx) -> str:
    """The configuration's subject, written into the checkout's cache unless
    it is there."""
    workers = SUBJECT_WORKERS if ctx.device.type == "cuda" else 1
    return subject.ensure_subject(str(ctx.cache), ctx.doc["subject"], workers)


def run_config_path(ctx, subject_root: str) -> str:
    """The program's config as run, written to a fixed file of the cache:
    the configuration's ``config`` with the datasets, the SMPL meta and the
    result directory pointed into the checkout's cache."""
    cfg = dict(ctx.doc["config"])
    cfg.update(subject.subject_overrides(subject_root, ctx.doc["subject"]))
    out_dir = Path(ctx.cache) / "run"
    cfg["result_dir"] = str(out_dir / "exps")
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{ctx.config_name}.yaml"
    text = yaml.safe_dump(cfg, sort_keys=False)
    if not path.exists() or path.read_text() != text:
        tmp = path.with_suffix(".yaml.partial")
        tmp.write_text(text)
        os.replace(tmp, path)
    return str(path)


def program_config(path: str):
    from instant_nvr_tpu_torch.config import make_cfg
    return make_cfg(path)


# the controls: the reference in the program's place, one precision step
# below what the configuration states: ``float8_e4m3fn``, the MLP operands
# (bfloat16 in the configuration); ``bfloat16_encoding``, the hash
# encodings' corner lerp and the deformer's table reads (float32 in it)
CONTROLS = ("float8_e4m3fn", "bfloat16_encoding")


def reference_config(path: str, control: str = ""):
    """The reference's config from the same file, with ``control``'s MLP
    precision (the encoding's is :func:`control_precision`'s)."""
    from .reference.config import make_cfg
    if control and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}: one of {CONTROLS}")
    cfg = make_cfg(path)
    if control == "float8_e4m3fn":
        cfg = cfg.merged({"mlp_dtype": control})
    return cfg


def control_precision(control: str = ""):
    """The context in which the reference runs as ``control``: the encoders'
    lerp in bfloat16 under ``bfloat16_encoding``, else unchanged."""
    from .reference.ops import hashgrid
    return hashgrid.lerp_dtype(torch.bfloat16 if control == "bfloat16_encoding"
                               else hashgrid.LERP_DTYPE)


def harness_weights(cfg, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The initial weights of a run: the reference's ``init_params`` on
    ``device`` from a generator seeded by the run's seed, as a state dict."""
    from .reference.models import inb as ref_inb
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    model = ref_inb.init_params(ref_inb.build_model_spec(cfg), gen, device)
    return {k: v.detach() for k, v in model.state_dict().items()}


def power_limit(device: torch.device) -> Optional[str]:
    """The card's name and power limit from ``nvidia-smi`` (None off the card)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

