"""The hash tables' scale after a fit, which the harness draws the check's
tables at (``nvrbench/scales/<config>.yaml``, read by
``common.harness_weights``):

    python3 -m nvrbench.measure_scales --config inb377 --out scales.yaml

fits the configuration on the benchmark's subject with the program's own
training run on the card (``train/loop.py:train`` from seed 0: every
stage, ``train.epoch`` epochs of ``ep_iter`` steps, the captured step),
then reads the root-mean-square of each hash table's entries level by
level (``rms``).  It prints the numbers as YAML and writes them to
``--out``.  It writes its checkpoints under the checkout's
``.nvrbench_cache/run/``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import yaml

from . import nojax


def level_rms(table, level_offsets):
    """The root-mean-square of each level's entries of ``table``: rows
    ``level_offsets[l]:level_offsets[l + 1]`` are level l."""
    import torch
    return [float(torch.sqrt(torch.mean(table[lo:hi].double() ** 2)))
            for lo, hi in zip(level_offsets[:-1], level_offsets[1:])]


def main(argv=None) -> int:
    nojax.install()
    from .run import PKG, ROOT, load_yaml, set_caches
    p = argparse.ArgumentParser(prog="python3 -m nvrbench.measure_scales")
    p.add_argument("--config", required=True, help="a configuration of BENCHMARK.json")
    p.add_argument("--out", default="", help="also write the YAML here")
    args = p.parse_args(argv)

    from . import common
    from instant_nvr_tpu_torch.run import resolve_device
    from instant_nvr_tpu_torch.train.loop import train

    doc = load_yaml(PKG / "configs" / f"{args.config}.yaml")
    device = resolve_device("cuda")
    ctx = SimpleNamespace(cache=set_caches(ROOT), doc=doc, device=device,
                          config_name=args.config)
    cfg_path = common.run_config_path(ctx, common.ensure_subject(ctx))
    cfg = common.program_config(cfg_path)
    t0 = time.perf_counter()
    res = train(cfg, device, resume=False, seed=0)
    fit_s = time.perf_counter() - t0
    trained = dict(res.state.model.named_parameters())
    from .reference.models import inb as ref_inb
    spec = ref_inb.build_model_spec(common.reference_config(cfg_path))
    tables = {}
    for name, level_offsets in common.hash_tables(spec):
        tables[name] = {"rms": level_rms(trained[name].detach(), level_offsets)}
    out = {"config": args.config,
           "fit": {"steps": int(res.state.step), "epochs": int(cfg.train.epoch),
                   "seconds": round(fit_s, 1), "seed": 0,
                   "card": common.power_limit(device) or str(device)},
           "tables": tables}
    text = yaml.safe_dump(out, sort_keys=False, width=120)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
