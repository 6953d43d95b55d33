"""Times this checkout's kernels against another checkout's, in one process
on one CUDA card, on the same inputs.

    python -m instant_nvr_tpu_torch.tools.kernel_ab OTHER_ROOT

Run from the root of this checkout.  OTHER_ROOT's ``instant_nvr_tpu_torch``
is loaded under another package name, so its kernels build from its own
sources into its own ``build/``.  The KNN cases are chip_smoke.py's: the
inb_377 render chunk (C = 65,536), the train step's shape (C = 16,384) and
the ragged parts, each for ``knn_blend`` and ``knn_topk``.  The scatter
cases are chip_smoke.py's uniform-keys rows at the train path's shapes
(body hash; deformer hash, arm dense), the self-check's [1b] (4 x 1,048,576
rows, F = 16 and 1) and [1c] (one 12,276-row level, F = 2 and 1), and the
train step's own records of the body and deformer hash tables, captured by
this checkout's trainer.  Each case times the two wrappers in the order
other, this, this, other: CUDA events around the call (median of 20,
``chip_smoke.cuda_median_ms``) and the profiler's device time per call by
kernel (``chip_smoke.device_ms_by_kernel``), and prints the largest
difference between their outputs.  Prints one line per case, then the
card's ``nvidia-smi`` name and power limit.

    python -m instant_nvr_tpu_torch.tools.kernel_ab OTHER_ROOT --sorted

times the two checkouts' ``sorted_scatter_add`` (``fix_random``'s kernel)
instead, on chip_smoke.py phase 13's cases and on the 18 sorted calls of
one ``fix_random`` patch step of phase 8's subject (written into
``data/fake_zju_smoke`` when it is not there; summed event and queued
device times, ``chip_smoke.queued_ms``), with the deterministic flag on,
as a ``fix_random`` step runs them, and the cases also with it off.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys

ALIAS = "other_instant_nvr_tpu_torch"


def load_other(root: str, module: str = "scatter"):
    """OTHER_ROOT/instant_nvr_tpu_torch/ops/<module>.py (``scatter`` or
    ``knn``), imported as a module of the package ALIAS; the package is
    loaded once per process, from the first root asked for."""
    pkg_dir = os.path.join(os.path.abspath(root), "instant_nvr_tpu_torch")
    pkg = sys.modules.get(ALIAS)
    if pkg is None:
        spec = importlib.util.spec_from_file_location(
            ALIAS, os.path.join(pkg_dir, "__init__.py"),
            submodule_search_locations=[pkg_dir])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[ALIAS] = pkg
        spec.loader.exec_module(pkg)
    elif list(pkg.__path__) != [pkg_dir]:
        raise RuntimeError(f"{ALIAS} is already loaded from {list(pkg.__path__)}")
    return importlib.import_module(f"{ALIAS}.ops.{module}")


def time_sides(cs, fns, call):
    """(event ms, device ms) lists per side and the first turn's device
    split by kernel, timing ``call(fns[side])`` in the order other, this,
    this, other."""
    ms = {"other": [], "this": []}
    dev_ms = {"other": [], "this": []}
    split = {}
    for side in ("other", "this", "this", "other"):
        fn = lambda: call(fns[side])
        ms[side].append(f"{cs.cuda_median_ms(fn):.4f}")
        by_kernel = cs.device_ms_by_kernel(fn)
        dev_ms[side].append(f"{sum(by_kernel.values()):.4f}" if by_kernel
                            else "not measured")
        split.setdefault(side, {cs.kernel_name(k): f"{v:.4f}"
                                for k, v in by_kernel.items()})
    return ms, dev_ms, split


def knn_ab(cs, this, other, dev):
    """Both KNN kernels of both checkouts on chip_smoke.py's chunk, train
    shape and ragged inputs."""
    import numpy as np
    import torch
    cases = cs.knn_inputs(dev, np.random.default_rng(0))
    for name in ("inb_377-chunk", "train-shape", "ragged"):
        query, part_pts, part_pbw, lengths = cases[name]
        for kernel in ("knn_blend", "knn_topk"):
            fns = {side: getattr(mod, kernel) for side, mod in (("other", other),
                                                               ("this", this))}
            if kernel == "knn_blend":
                call = lambda fn: fn(query, part_pts, part_pbw, lengths)
                outs = {side: call(fn) for side, fn in fns.items()}
                diff = {"max_abs_diff": f"{(outs['other'] - outs['this']).abs().max().item():.3e}"}
            else:
                call = lambda fn: fn(query, part_pts, lengths)
                outs = {side: call(fn) for side, fn in fns.items()}
                (od, oi), (td, ti) = outs["other"], outs["this"]
                diff = {"max_abs_diff_d2": f"{(od - td).abs().max().item():.3e}",
                        "idx_differing": int((oi != ti).sum())}
            torch.cuda.synchronize()
            del outs
            ms, dev_ms, split = time_sides(cs, fns, call)
            cs.phase("ab", kernel=kernel, case=name, C=int(query.shape[0]),
                     lengths=lengths.tolist(), **diff, other_ms=ms["other"],
                     this_ms=ms["this"], other_device_ms=dev_ms["other"],
                     this_device_ms=dev_ms["this"], other_kernels=split["other"],
                     this_kernels=split["this"])


def scatter_ab(cs, this, other, dev, cfg):
    """Both scatter kernels of both checkouts on the train path's shapes,
    the self-check's and the train step's own records."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.models import inb
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    bf = lambda a: t(a.astype(np.float32)).to(torch.bfloat16)
    mspec = inb.build_model_spec(cfg)
    _, body_rows, body_offs = mspec.part_embeds[mspec.partnames.index("body")].tables()[-1]
    _, def_rows, def_offs = mspec.deformer.embed.tables()[-1]
    _, arm_rows, arm_offs = mspec.part_embeds[mspec.partnames.index("larm")].tables()[0]
    b1_offs = tuple(range(0, 4 * 1048576 + 1, 1048576))
    b1_keys = cs.level_keys(rng, b1_offs, 65536)
    c1_keys = rng.integers(0, 12276, 1081344).astype(np.int32)
    cases = [
        ("segmented", "body-hash", cs.level_keys(rng, body_offs, 8 * 8192), 1,
         body_rows, body_offs),
        ("segmented", "selfcheck-1b-F16", b1_keys, 16, b1_offs[-1], b1_offs),
        ("segmented", "selfcheck-1b-F1", b1_keys, 1, b1_offs[-1], b1_offs),
        ("onehot", "deformer-hash", cs.level_keys(rng, def_offs, 8 * 22528), 1,
         def_rows, def_offs),
        ("onehot", "arm-dense", cs.level_keys(rng, arm_offs, 8 * 2048), 1,
         arm_rows, arm_offs),
        ("onehot", "selfcheck-1c-F2", c1_keys, 2, 12276, (0, 12276)),
        ("onehot", "selfcheck-1c-F1", c1_keys, 1, 12276, (0, 12276)),
    ]
    cases = [(r, n, t(k), bf(rng.normal(size=(len(k), F))), rows, offs)
             for r, n, k, F, rows, offs in cases]
    calls = cs.capture_train_records(cfg, dev)
    for route, name, rows, offs in (("segmented", "body-hash-real", body_rows, body_offs),
                                    ("onehot", "deformer-hash-real", def_rows, def_offs)):
        k, p = max(((k, p) for r, k, p, n, o in calls
                    if r == route and n == rows and o == tuple(offs)),
                   key=lambda kp: kp[0].shape[0])
        cases.append((route, name, k, p, rows, offs))
    del calls
    for route, name, keys, payload, rows, offs in cases:
        fns = {side: getattr(mod, f"{route}_scatter_add")
               for side, mod in (("other", other), ("this", this))}
        call = lambda fn: fn(keys, payload, rows, offs)
        outs = {side: call(fn).float() for side, fn in fns.items()}
        diff = float((outs["other"] - outs["this"]).abs().max())
        del outs
        ms, dev_ms, split = time_sides(cs, fns, call)
        cs.assert_workspace_zero(name)
        cs.phase("ab", kernel=f"{route}_scatter_add", case=name, R=int(keys.shape[0]),
                 F=int(payload.shape[1]), n_rows=rows, max_abs_diff=f"{diff:.3e}",
                 other_ms=ms["other"], this_ms=ms["this"],
                 other_device_ms=dev_ms["other"], this_device_ms=dev_ms["this"],
                 other_kernels=split["other"], this_kernels=split["this"])


def sorted_ab(cs, this, other, dev, cfg):
    """Both checkouts' sorted kernels on phase 13's cases (the deterministic
    flag on and off) and on one fix_random patch step's 18 calls (on)."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.datasets.fake_zju import write_fake_dataset
    from instant_nvr_tpu_torch.train.state import create_train_state
    fns = {"other": other.sorted_scatter_add, "this": this.sorted_scatter_add}
    saved = torch.are_deterministic_algorithms_enabled()
    try:
        for name, keys, payload, rows, offs, _ in cs.sorted_cases(
                cfg, dev, np.random.default_rng(0), this):
            call = lambda fn: fn(keys, payload, rows, offs)
            outs = {side: call(fn).float() for side, fn in fns.items()}
            diff = float((outs["other"] - outs["this"]).abs().max())
            del outs
            for flag in (True, False):
                torch.use_deterministic_algorithms(flag)
                ms, dev_ms, split = time_sides(cs, fns, call)
                cs.phase("ab", kernel="sorted_scatter_add", case=name, deterministic=flag,
                         R=int(keys.shape[0]), F=int(payload.shape[1]), n_rows=rows,
                         max_abs_diff=f"{diff:.3e}", other_ms=ms["other"], this_ms=ms["this"],
                         other_device_ms=dev_ms["other"], this_device_ms=dev_ms["this"],
                         other_kernels=split["other"], this_kernels=split["this"])
        root = os.path.join(cs.HERE, "data", "fake_zju_smoke")
        if not os.path.isfile(os.path.join(root, "annots.npy")):
            write_fake_dataset(root, n_frames=cs.FRAMES, n_views=3, n_verts=2000, H=512,
                               W=512, supersample=1)
        pcfg = cs.patch_cfg(root, os.path.join(cs.HERE, "exps", "kernel_ab_sorted"),
                            epochs=1, fix_random=True)
        _, _, model = run.build(pcfg, dev, 0)
        torch.use_deterministic_algorithms(True)
        calls = [a for r, a in cs.capture_patch_inputs(pcfg, create_train_state(pcfg, model),
                                                        dev) if r == "sorted"]
        del model
        total = {side: [0.0, 0.0] for side in fns}
        for side in ("other", "this", "this", "other"):
            for keys, payload, rows, offs in calls:
                fn = lambda: fns[side](keys, payload, rows, offs)
                total[side][0] += cs.cuda_median_ms(fn) / 2
                total[side][1] += cs.queued_ms(fn) / 2
        cs.phase("ab", kernel="sorted_scatter_add", case="fix-random-patch-step",
                 deterministic=True, calls=len(calls),
                 shapes=repr([(int(k.shape[0]), int(p.shape[1]), n) for k, p, n, _ in calls]),
                 other_event_ms_sum=f"{total['other'][0]:.4f}",
                 this_event_ms_sum=f"{total['this'][0]:.4f}",
                 other_queued_ms_sum=f"{total['other'][1]:.4f}",
                 this_queued_ms_sum=f"{total['this'][1]:.4f}")
    finally:
        torch.use_deterministic_algorithms(saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", help="root of the other checkout")
    ap.add_argument("--sorted", action="store_true",
                    help="time fix_random's sorted kernel instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.ops import knn, scatter
    dev = run.resolve_device("cuda")
    if args.sorted:
        sorted_ab(cs, scatter, load_other(args.other_root, "scatter"), dev, make_cfg(cs.CFG))
        print(cs.nvidia_smi())
        return 0
    knn_ab(cs, knn, load_other(args.other_root, "knn"), dev)
    scatter_ab(cs, scatter, load_other(args.other_root, "scatter"), dev,
               make_cfg(cs.CFG))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
