"""One cell of the port's benchmark, run once:

    python3 -m nvrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; the harness finds everything else by name:

  - the configuration ``nvrbench/configs/<config>.yaml`` (the program's
    config keys under ``config``, the subject under ``subject``);
  - the traffic's parameters ``nvrbench/workloads/<cell>.yaml``;
  - the traffic kind ``nvrbench/traffic/<traffic>.py``, whose ``run(ctx)``
    sets up the program, measures for ``--seconds`` and checks the outputs
    against the reference, returning its readings;
  - each metric's reader ``nvrbench/metrics/<metric>.py``, whose
    ``read(readings)`` gives the number or None.

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (read from a ``torch.profiler``
window inside the measured window and from the harness's clocks).  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit); the last lines of standard error repeat the checks.

A run exits non-zero and prints no result when the card is missing or
there are fewer cards than the cell asks for, when the program is not in
the checkout, or when a module of JAX or of the JAX package was loaded.
Every cache goes inside the checkout: ``.nvrbench_cache/`` (the subject,
the configurations as run), ``build/torch_kernels/`` (the program's nvcc
and g++ builds) and ``build/nvrbench/`` (Triton's and PyTorch's extension
caches).  ``--device cpu`` with ``--overrides`` runs the same path at small
sizes on the CPU (the tests' rehearsal); its timings are the CPU's and it
reports platform ``cpu``.
"""
from __future__ import annotations

import time

_IMPORTED = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List  # noqa: E402

from . import nojax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent

# exit codes of a run that prints no result
EXIT_NO_CARD, EXIT_NO_PROGRAM, EXIT_JAX, EXIT_BAD_CELL = 3, 4, 5, 6


def process_start() -> float:
    """The process's start on the wall clock (Linux: ``/proc``), else the
    time this module was imported."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        stat = Path("/proc/self/stat").read_text()
        start = int(stat[stat.rindex(")") + 2:].split()[19]) / ticks
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + start
    except (OSError, ValueError, IndexError):
        pass
    return _IMPORTED


def load_yaml(path: Path) -> Dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


def merge(dst: Dict, src: Dict) -> Dict:
    """``src`` merged into a copy of ``dst``, nested mappings key by key."""
    out = dict(dst)
    for k, v in src.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def set_caches(root: Path) -> Path:
    """Fixed cache directories inside the checkout; returns the harness's."""
    build = root / "build" / "nvrbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    cache = root / ".nvrbench_cache"
    cache.mkdir(exist_ok=True)
    return cache


def load_reader(name: str):
    """The reader module ``nvrbench/metrics/<name>.py`` (names may hold dots)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"nvrbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (those that list it, or that list no cells
    and move an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m nvrbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu: the rehearsal at small sizes (with --overrides)")
    p.add_argument("--overrides", default="",
                   help="a YAML file whose config, subject and workload "
                        "mappings merge over the cell's (the tests' small sizes)")
    p.add_argument("--control", default="",
                   help="run the reference in the control's lower precision "
                        "in the program's place (the control's test): "
                        "float8_e4m3fn or bfloat16_encoding")
    p.add_argument("--fault", default="",
                   help="break the timed path underneath (the fault tests)")
    return p.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"nvrbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    nojax.install()
    started = process_start()
    args = parse_args(argv)
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        return fail(EXIT_BAD_CELL, f"no {bench_path}")
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(EXIT_BAD_CELL, f"no cell {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cache = set_caches(ROOT)

    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            return fail(EXIT_NO_CARD, "torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(cell["chips"]):
            return fail(EXIT_NO_CARD, f"{torch.cuda.device_count()} cards, the cell "
                                      f"asks for {cell['chips']}")
    try:
        import instant_nvr_tpu_torch  # the program under test
    except ImportError as e:
        return fail(EXIT_NO_PROGRAM, f"the program is not in this checkout: {e}")
    if ROOT not in Path(instant_nvr_tpu_torch.__file__).resolve().parents:
        return fail(EXIT_NO_PROGRAM, f"the program was imported from "
                                     f"{instant_nvr_tpu_torch.__file__}, outside {ROOT}")

    doc = load_yaml(ROOT / conf["file"])
    workload = load_yaml(PKG / "workloads" / f"{cell['name']}.yaml")
    if args.overrides:
        over = load_yaml(Path(args.overrides))
        doc = merge(doc, {k: over[k] for k in ("config", "subject") if k in over})
        workload = merge(workload, over.get("workload", {}))
    kind = importlib.import_module(f"nvrbench.traffic.{cell['traffic']}")
    ctx = SimpleNamespace(args=args, root=ROOT, cache=cache, cell=cell,
                          config_name=cell["config"], doc=doc, workload=workload,
                          device=torch.device(args.device), started=started,
                          trace=bool(args.trace))
    r = kind.run(ctx)

    bad = nojax.loaded()
    if bad:
        return fail(EXIT_JAX, f"modules of JAX or the JAX package were loaded: {bad}")
    metrics = {}
    for m in cell_metrics(bench, cell["name"], ctx.trace):
        value = load_reader(m["name"]).read(r)
        if value is None:
            if not ctx.trace:
                return fail(EXIT_BAD_CELL, f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(r.memory_peak_bytes)}
    if ctx.trace and r.trace is None and args.device == "cuda":
        return fail(EXIT_BAD_CELL, "the traced window holds no device operation")
    if ctx.trace and r.trace is not None:
        device["busy_s"] = r.trace["busy_s"]
        device["window_s"] = r.trace["window_s"]
    line = {"correct": bool(r.correct), "attempted": int(r.attempted),
            "failed": int(r.failed), "metrics": metrics, "device": device}
    if ctx.trace and r.trace is not None:
        line["breakdown"] = {"device_ops": r.trace["device_ops"],
                             "idle_gaps": r.trace["idle_gaps"]}
    line["power_limit"] = r.power_limit
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in r.checks}
    for c in r.checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['value'] <= c['limit'] else 'OVER'})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
