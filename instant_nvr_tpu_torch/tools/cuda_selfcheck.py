"""On-card self-check: the port's kernels and its train step on a CUDA card.

    python -m instant_nvr_tpu_torch.tools.cuda_selfcheck                # the card
    python -m instant_nvr_tpu_torch.tools.cuda_selfcheck --device cpu

Port of ``tools/tpu_selfcheck.py``: the same checks at the same sizes, on
inputs drawn from ``np.random.default_rng(0)`` in the same order, so both
tools see the same numbers.  The CPU tests run each kernel's plain version;
only a run on the card shows that the kernels compile and compute the same
there.  Run it after any kernel or toolchain change.

  [1]  KNN: ``knn_blend_unfused`` (the ``knn_topk`` kernel + ``aggregate``,
       "topk+gather") and ``knn_blend`` ("fused") against ``knn_blend_plain``;
  [1b] segmented scatter-add at F=16 and F=1 against numpy;
  [1c] one-hot scatter-add over one wide level at F=2 and F=1 against numpy;
  [2]  float32 matmul precision (reports TF32; never fails);
  [3]  the full-width flagship train step: 1 step, then 10 timed steps.

Prints one line per check, then exits 1 listing the failures, or prints
"all self-checks passed" and exits 0.  The device defaults to ``cuda`` and a
missing card is an error.  ``--device cpu`` runs the plain versions, which
check no kernel, so it rehearses the checks at the TINY sizes and with the
tiny flagship (``train_net --tiny``'s widths) in seconds.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

FLAGSHIP_CFG = Path(__file__).resolve().parents[2] / "configs" / "inb" / "inb_377.yaml"

# the JAX tool's sizes on the card; TINY on the CPU
FULL = {
    "knn": dict(P=5, M=2688, C=4096, lengths=(2688, 2000, 800, 600, 600)),
    "segmented": dict(n_levels=4, level_rows=1048576, per_level=8192 * 8),
    "onehot": dict(n_rows=12276, n_records=1_081_344),
    "matmul": dict(n=256),
    "train": dict(steps=10),
}
TINY = {
    "knn": dict(P=5, M=300, C=256, lengths=(300, 200, 100, 3, 0)),
    "segmented": dict(n_levels=4, level_rows=4096, per_level=512),
    "onehot": dict(n_rows=1000, n_records=8192),
    "matmul": dict(n=256),
    "train": dict(steps=10),
}


class Check(NamedTuple):
    tag: str                    # "[1]", "[1b]", ...
    line: str                   # the report line
    ok: bool
    failure: str                # what failed ('' when ok)
    numbers: Dict[str, float]


def _check(tag: str, line: str, ok: bool, failure: str, **numbers) -> Check:
    return Check(tag, line, bool(ok), "" if ok else failure, numbers)


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_knn(dev: torch.device, rng: np.random.Generator, P: int, M: int,
              C: int, lengths: Sequence[int]) -> List[Check]:
    """[1]: both KNN routes against the plain version; passes when
    isclose(rtol=1e-3, atol=1e-4) holds for >= 99.5% of the entries (the
    JAX tool's gate)."""
    from ..ops import knn
    pts = _tensor(rng.normal(size=(P, M, 3)).astype(np.float32), dev)
    pbw = _tensor(rng.uniform(size=(P, M, 24)).astype(np.float32), dev)
    q = _tensor(rng.normal(size=(C, 3)).astype(np.float32) * 0.5, dev)
    lens = _tensor(np.asarray(lengths, np.int32), dev)
    ref = knn.knn_blend_plain(q, pts, pbw, lens, chunk=2048)
    out = []
    for tag, fn in (("topk+gather", knn.knn_blend_unfused), ("fused", knn.knn_blend)):
        got = fn(q, pts, pbw, lens)
        agree = torch.isclose(got, ref, rtol=1e-3, atol=1e-4).double().mean().item()
        out.append(_check("[1]", f"[1] kernel-vs-plain KNN agreement ({tag}): "
                          f"{agree:.4f}", agree >= 0.995,
                          f"KNN ({tag}) disagrees with knn_blend_plain on this "
                          f"device", agreement=agree))
    return out


def check_segmented(dev: torch.device, rng: np.random.Generator, n_levels: int,
                    level_rows: int, per_level: int,
                    widths: Sequence[int] = (16, 1)) -> List[Check]:
    """[1b], [1b-scalar]: ``segmented_scatter_add`` of ``per_level`` uniform
    keys per level into ``n_levels`` x ``level_rows`` rows, once per payload
    width, against numpy's float32 ``np.add.at``; passes when the max error
    is <= 0.05 x max(1, |ref|max)."""
    from ..ops import scatter
    n_rows = n_levels * level_rows
    offs = tuple(range(0, n_rows + 1, level_rows))
    keys = np.concatenate([rng.integers(i * level_rows, (i + 1) * level_rows, per_level)
                           for i in range(n_levels)]).astype(np.int32)
    k = _tensor(keys, dev)
    out = []
    for F in widths:
        pay = rng.normal(size=(len(keys), F)).astype(np.float32)
        got = scatter.segmented_scatter_add(
            k, _tensor(pay, dev).to(torch.bfloat16), n_rows, offs)
        got = got.float().cpu().numpy()
        ref = np.zeros((n_rows, F), np.float32)
        np.add.at(ref, keys, pay)
        err = float(np.abs(got - ref).max())
        ok = err <= 0.05 * max(1.0, float(np.abs(ref).max()))
        if F == 1:
            tag, line = "[1b-scalar]", f"F=1 scatter-add max err vs numpy: {err:.4f}"
        else:
            tag, line = "[1b]", f"segmented scatter-add max err vs numpy: {err:.4f}"
        out.append(_check(tag, f"{tag} {line}", ok,
                          f"segmented_scatter_add F={F} wrong on this device",
                          max_err=err))
    return out


def check_onehot(dev: torch.device, rng: np.random.Generator, n_rows: int,
                 n_records: int, widths: Sequence[int] = (2, 1)) -> List[Check]:
    """[1c], [1c-scalar]: ``onehot_scatter_add`` of ``n_records`` uniform
    keys into one level window of ``n_rows`` rows, once per payload width,
    against ``np.add.at`` of the bf16-rounded payload; passes when the max
    error relative to |ref|max is <= 0.05."""
    from ..ops import scatter
    keys = rng.integers(0, n_rows, n_records).astype(np.int32)
    k = _tensor(keys, dev)
    out = []
    for F in widths:
        pay = torch.from_numpy(rng.normal(size=(n_records, F)).astype(np.float32))
        pay = pay.to(torch.bfloat16)
        got = scatter.onehot_scatter_add(k, pay.to(dev), n_rows, (0, n_rows))
        got = got.float().cpu().numpy()
        ref = np.zeros((n_rows, F), np.float32)
        np.add.at(ref, keys, pay.float().numpy())
        err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
        if F == 1:
            tag, line = "[1c-scalar]", "F=1 one-hot scatter-add rel err vs numpy"
        else:
            tag, line = "[1c]", "one-hot scatter-add rel err vs numpy"
        out.append(_check(tag, f"{tag} {line}: {err:.4f}", err <= 0.05,
                          f"onehot_scatter_add F={F} wrong on this device",
                          rel_err=err))
    return out


def check_matmul(dev: torch.device, rng: np.random.Generator, n: int) -> List[Check]:
    """[2]: x @ x in float32 on the device against numpy.  Reports only: an
    error above 1e-3 means the matmul ran in TF32."""
    x = rng.normal(size=(n, n)).astype(np.float32)
    t = _tensor(x, dev)
    err = float(np.abs((t @ t).cpu().numpy() - x @ x).max())
    line = f"[2] f32 matmul max err (default precision): {err:.2e}"
    if err > 1e-3:
        line += (" (TF32 matmuls: set torch.backends.cuda.matmul.allow_tf32 = "
                 "False where it matters)")
    return [_check("[2]", line, True, "", max_err=err)]


def check_train(dev: torch.device, cfg, steps: int, tiny: bool = False) -> List[Check]:
    """[3]: the flagship train step on the synthetic batch, from seed 0: one
    step, then ``steps`` timed ones; passes when the last loss is finite
    and below the first."""
    from .. import train_net
    t = train_net.build_trainer(cfg, dev, seed=0, tiny=tiny)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, stats = t.step(t.state, t.batch, generator=gen)
    first = float(stats["loss"])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        _, stats = t.step(t.state, t.batch, generator=gen)
    _sync(dev)
    ms = 1000.0 * (time.perf_counter() - t0) / steps
    last = float(stats["loss"])
    overflow = float(stats["cull_overflow"])
    return [_check("[3]", f"[3] train step: loss {first:.4f} -> {last:.4f}, "
                   f"{ms:.1f} ms/step, cull_overflow {overflow:.2f}",
                   np.isfinite(last) and last < first,
                   "train loss not decreasing / not finite",
                   loss_first=first, loss_last=last, ms_per_step=ms,
                   cull_overflow=overflow)]


def run_checks(device: torch.device) -> List[Check]:
    """Every check, in the JAX tool's order, on inputs from
    ``np.random.default_rng(0)``: at FULL sizes on the card, at TINY sizes
    with the tiny flagship elsewhere."""
    from ..config import make_cfg
    from ..train_net import TINY as TINY_MODEL
    tiny = device.type != "cuda"
    sizes = TINY if tiny else FULL
    rng = np.random.default_rng(0)
    cfg = make_cfg(str(FLAGSHIP_CFG))
    if tiny:
        cfg = cfg.merged(TINY_MODEL)
    return (check_knn(device, rng, **sizes["knn"])
            + check_segmented(device, rng, **sizes["segmented"])
            + check_onehot(device, rng, **sizes["onehot"])
            + check_matmul(device, rng, **sizes["matmul"])
            + check_train(device, cfg, tiny=tiny, **sizes["train"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.tools.cuda_selfcheck")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..run import resolve_device
    device = resolve_device(args.device)      # cuda: raises without a card
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")
    checks = run_checks(device)
    for c in checks:
        print(c.line)
    failures = [c.failure for c in checks if not c.ok]
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" -", f)
        return 1
    print("\nall self-checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
