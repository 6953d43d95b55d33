"""Real multi-process data-parallel check of the port (the twin of the
repo's ``tools/multiprocess_check.py``).

    python -m instant_nvr_tpu_torch.tools.multiprocess_check [N] [--device cuda|cpu]

launches N ranks (default 2) on a localhost rendezvous, on Gloo (CUDA
tensors on one card, the default, where NCCL refuses two ranks on one
device; CPU tensors with ``--device cpu``), which run one train step of the tiny model on the synthetic
batch and the uneven-shard metric merge of 5 items, and the
``auto_budget`` broadcast; the orchestrator holds the step against the
same step in one process (loss rtol 2e-4, parameters rtol 2e-3 / atol
2e-5, as the JAX tool's single-process check) and prints ``OK ...``.

The module is also the launcher of the tests and of ``chip_smoke.py``
phase 10: :func:`launch` runs ``case_<name>`` of this module in N worker
processes, each reading ``<dir>/inputs.pt`` and writing
``<dir>/rank<r>.pt``; a case called in the orchestrator's own process
(no group) is the one-process reference.  Every worker blocks cv2,
imageio, PIL, jax and the JAX package before it imports anything, and
fails if any of them was imported.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import socket
import subprocess
import sys
import time

BLOCKED = ("cv2", "imageio", "PIL", "jax", "jaxlib", "instant_nvr_tpu",
           "__graft_entry__")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_ITEMS = 5      # odd on purpose: uneven eval shards


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(case: str, world: int, workdir: str, device: str = "cpu",
           backend: str | None = "gloo", timeout: float = 120.0) -> list:
    """Run ``case_<case>`` in ``world`` ranks and return each rank's
    result.  ``backend`` None leaves the group to the case (a CLI's
    ``--distributed``).  Each rank logs to ``<workdir>/rank<r>.log``; a rank
    that fails or outlives ``timeout`` raises, after every rank is stopped."""
    import torch
    port = free_port()
    procs = []
    cards = torch.cuda.device_count() if device == "cuda" else 0
    try:
        for r in range(world):
            # one card a rank while there are cards enough, else all on one
            dev_r = f"cuda:{r % cards}" if cards else device
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="2")
            env.pop("PYTHONPATH", None)
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            cmd = [sys.executable, "-m", "instant_nvr_tpu_torch.tools.multiprocess_check",
                   "worker", case, workdir, "--device", dev_r]
            if backend:
                cmd += ["--backend", backend]
            procs.append((subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + timeout
        for r, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"case {case}: rank {r} of {world} ended with "
                                   f"{rc}:\n{tail}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _worker(case: str, workdir: str, device: str, backend: str | None) -> None:
    for name in BLOCKED:
        sys.modules[name] = None           # an import of them raises
    import torch
    from instant_nvr_tpu_torch.parallel import mesh as pmesh
    from instant_nvr_tpu_torch.run import resolve_device
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    dev = resolve_device(device)
    if backend:
        dev = pmesh.init_distributed(device, backend)
        # open every rank's connections now with a small collective, while
        # the ranks' start-up skew is seconds: Gloo's connect has a
        # deadline, and a long first step could outlast it
        pmesh.barrier()
    path = os.path.join(workdir, "inputs.pt")
    args = torch.load(path, weights_only=False) if os.path.exists(path) else {}
    out = globals()[f"case_{case}"](args, dev, workdir)
    bad = sorted(m for m in sys.modules if sys.modules[m] is not None
                 and m.split(".")[0] in BLOCKED)
    if bad:
        raise AssertionError(f"the port imported {bad}")
    torch.save(out, os.path.join(workdir, f"rank{int(os.environ['RANK'])}.pt"))
    pmesh.barrier()
    if pmesh.dist.is_initialized():
        pmesh.dist.destroy_process_group()


# -- cases ---------------------------------------------------------------------

def _counts():
    from instant_nvr_tpu_torch.ops import knn, scatter
    return {"knn_blend": knn.knn_blend.launches,
            "segmented_scatter_add": scatter.segmented_scatter_add.launches,
            "onehot_scatter_add": scatter.onehot_scatter_add.launches}


def body_step(mspec, rspec, lw, patch_loss_fn=None):
    """``train/step.py:make_step_body``'s body as a step, run eagerly: what
    a captured step replays, collectives included, on a group that cannot
    capture (Gloo); its update read from a device schedule."""
    import torch
    from instant_nvr_tpu_torch.parallel import mesh as pmesh
    from instant_nvr_tpu_torch.train.state import DeviceSchedule
    from instant_nvr_tpu_torch.train.step import draw_render, make_step_body
    body = make_step_body(mspec, rspec, lw, patch_loss_fn)
    held = {}

    def step(state, batch, generator=None, draws=None):
        dev = batch["ray_o"].device
        if not held:
            held["sched"] = DeviceSchedule(state.optimizer, state.schedule,
                                           state.step + 64, dev)
            held["dstep"] = torch.full((), state.step, dtype=torch.int64, device=dev)
        if draws is None:
            draws = draw_render(mspec, rspec, batch["ray_o"].shape[0] * pmesh.world_size(),
                                generator, dev)
        stats = body(state, batch, draws, held["sched"], held["dstep"])
        state.optimizer.advance_steps()
        state.step += 1
        return state, stats

    return step


def case_step(args: dict, dev, workdir: str = "") -> dict:
    """``args["steps"]`` train steps of ``args["cfg"]`` from
    ``args["state"]`` (a state dict; else random weights from ``seed``) on
    this rank's slice of ``args["batch"]`` (host arrays of the whole
    batch), by the eager step (by :func:`body_step` with ``args["body"]``):
    the first with ``args["draws"]`` when given (the whole batch's),
    else with the generator's draws from ``seed``, the rest from the
    generator seeded by ``seed`` + step.  Returns the first step's stats, gradients and
    updated parameters (host tensors), every step's loss and ms, whether
    the ranks' parameters are bit-equal after the last, the all-reduce's
    ms and bytes, peak device memory, the kernels' launches, and with
    ``telemetry`` this rank's own budget counts before the step."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.config import Config
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.parallel import mesh as pmesh
    from instant_nvr_tpu_torch.renderer.inb_renderer import (make_render_spec,
                                                              render_rays)
    from instant_nvr_tpu_torch.train.loop import make_patch_loss_fn
    from instant_nvr_tpu_torch.train.state import create_train_state
    from instant_nvr_tpu_torch.train.step import (draw_render, make_loss_weights,
                                                  make_train_step)
    cfg = Config(args["cfg"])
    seed = int(args.get("seed", 0))
    mspec, rspec = inb.build_model_spec(cfg), make_render_spec(cfg)
    lw = make_loss_weights(cfg)
    if args.get("state") is not None:
        model = inb.InbModel(mspec, dev)
        model.load_state_dict(args["state"])
    else:
        model = inb.init_params(mspec, torch.Generator(device=dev).manual_seed(seed), dev)
    state = create_train_state(cfg, model)
    step = (body_step if args.get("body") else make_train_step)(
        mspec, rspec, lw, make_patch_loss_fn(cfg) if lw.use_patch else None)
    batch = pmesh.shard_batch(args["batch"], pmesh.rank(), pmesh.world_size())
    batch = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in batch.items()}
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    gen = torch.Generator(device=dev)
    # the first step's draws: given, or the generator's (the whole batch's)
    draws0 = args.get("draws") or draw_render(
        mspec, rspec, len(args["batch"]["ray_o"]), gen.manual_seed(seed), dev)
    draws0 = {k: v.to(dev) for k, v in draws0.items()}
    out = {}
    if args.get("telemetry"):
        lo = pmesh.rank() * batch["ray_o"].shape[0]
        with torch.no_grad():
            ret = render_rays(mspec, rspec, model, batch, train=True, draws=dict(
                draws0, t_rand=draws0["t_rand"][lo:lo + batch["ray_o"].shape[0]]))
        out["telemetry"] = {k: ret[k].cpu() for k in
                            ("budget_counts", "cull_need", "part_need")}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    counts0 = _counts()
    losses, ms = [], []
    for i in range(int(args.get("steps", 1))):
        draws = draws0 if i == 0 else None
        gen.manual_seed(seed + i)
        sync()
        t0 = time.perf_counter()
        _, stats = step(state, batch, generator=gen, draws=draws)
        sync()
        ms.append(1000 * (time.perf_counter() - t0))
        losses.append(float(stats["loss"]))
        if i == 0:
            out["stats0"] = {k: v.cpu() for k, v in stats.items()}
            out["grads0"] = {k: p.grad.detach().cpu().clone()
                             for k, p in model.named_parameters() if p.grad is not None}
            out["params0"] = {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()}
    counts = {k: v - counts0[k] for k, v in _counts().items()}
    out["equal"] = pmesh.replicas_equal(model)
    # one more all-reduce of the last gradients, timed alone
    sync()
    t0 = time.perf_counter()
    nbytes = pmesh.all_reduce_grads(model.parameters())
    sync()
    out.update(losses=losses, ms=ms, launches=counts,
               allreduce_ms=1000 * (time.perf_counter() - t0),
               allreduce_bytes=nbytes,
               peak_mem=torch.cuda.max_memory_allocated(dev) if cuda else None,
               world=pmesh.world_size(), rank=pmesh.rank())
    return out


def case_metrics(args: dict, dev, workdir: str) -> dict:
    """Each rank scores its shard of ``N_ITEMS`` items (known values),
    then the merge; rank 0 summarizes into ``workdir/metrics.npy``."""
    from instant_nvr_tpu_torch.datasets.samplers import shard_indices
    from instant_nvr_tpu_torch.eval.evaluator import Evaluator
    from instant_nvr_tpu_torch.eval.runner import _allgather_metrics
    from instant_nvr_tpu_torch.parallel import mesh as pmesh
    mine = shard_indices(list(range(N_ITEMS)), pmesh.rank(), pmesh.world_size(),
                         pad=False)
    ev = Evaluator(result_dir=workdir if pmesh.is_rank0() else "", save_images=False)
    for i in mine:
        ev.mse.append(float(i))
        ev.psnr.append(10.0 + i)
        # a genuine NaN (a flat SSIM crop) must survive the merge
        ev.ssim.append(float("nan") if i == 3 else 0.5)
        ev.lpips.append(0.1 * i)
    _allgather_metrics(ev, N_ITEMS)
    merged = {k: list(getattr(ev, k)) for k in ("mse", "psnr", "ssim", "lpips")}
    if pmesh.is_rank0():
        ev.summarize()
    return {"mine": mine, "merged": merged}


@contextlib.contextmanager
def _record_writes(paths: list):
    """Record into ``paths`` every file this process writes through
    ``open`` (a writing mode), ``torch.save``, ``np.save`` and
    ``os.replace`` (its target) inside the block."""
    import builtins
    import numpy as np
    import torch
    saved = builtins.open, torch.save, np.save, os.replace

    def spy_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            paths.append(os.fspath(file))
        return saved[0](file, mode, *a, **k)

    def spy_torch_save(obj, f, *a, **k):
        paths.append(os.fspath(f))
        return saved[1](obj, f, *a, **k)

    def spy_np_save(file, *a, **k):
        paths.append(os.fspath(file))
        return saved[2](file, *a, **k)

    def spy_replace(src, dst, *a, **k):
        paths.append(os.fspath(dst))
        return saved[3](src, dst, *a, **k)

    builtins.open, torch.save, np.save, os.replace = (spy_open, spy_torch_save,
                                                     spy_np_save, spy_replace)
    try:
        yield paths
    finally:
        builtins.open, torch.save, np.save, os.replace = saved


def case_budget(args: dict, dev, workdir: str) -> dict:
    """``apply_auto_budget`` with the probe replaced by known budgets:
    which ranks probed, the budgets each rank got, the files each wrote."""
    from instant_nvr_tpu_torch.config import Config
    from instant_nvr_tpu_torch.datasets import tpose_dataset
    from instant_nvr_tpu_torch.models import budget
    probes = []

    def fake_probe(cfg_, ds_, n_probe=4, headroom=1.25, seed=0):
        probes.append(1)
        return 0.31, 0.41, (1.0, 0.8, 0.6, 0.4, 0.2)

    budget.estimate_budgets = fake_probe
    tpose_dataset.TPoseDataset = lambda *a, **k: None
    cfg = Config({"auto_budget": True, "trained_model_dir": os.path.join(workdir, "model"),
                  "cull_budget": 0.1, "part_budget": 0.1, "N_samples": 8,
                  "N_rand": 64, "patch_size": 8})
    with _record_writes([]) as writes:
        out = budget.apply_auto_budget(cfg)
    return {"probes": len(probes), "writes": writes,
            "budgets": [out.cull_budget, out.part_budget,
                        list(out.part_budget_scales)]}


def case_cli(args: dict, dev, workdir: str) -> dict:
    """``args["module"]``'s ``main(args["argv"])`` (``train_net`` or
    ``run``), recording the files this rank writes.  For ``train_net`` it
    also checks that the ranks' parameters are bit-equal right after a
    checkpoint loads and after training, and returns the run's losses,
    epochs, steps and per-step ms (the loop's epochs)."""
    import importlib
    from instant_nvr_tpu_torch.parallel import mesh as pmesh
    from instant_nvr_tpu_torch.train import loop
    seen = {}
    load, train = loop.load_checkpoint, loop.train

    def spy_load(model_dir, state, epoch=None):
        meta = load(model_dir, state, epoch)
        seen["equal_after_load"] = pmesh.replicas_equal(state.model)
        return meta

    def spy_train(*a, **k):
        res = train(*a, **k)
        seen.update(equal_after_train=pmesh.replicas_equal(res.state.model),
                    losses=res.losses, step=res.state.step,
                    epochs=[e.epoch for e in res.epochs],
                    ms_per_step=[1000 * e.wall_s / max(e.steps, 1)
                                 for e in res.epochs],
                    world=pmesh.world_size(),
                    backend=(str(pmesh.dist.get_backend())
                             if pmesh.dist.is_initialized() else None))
        return res

    loop.load_checkpoint, loop.train = spy_load, spy_train
    counts0 = _counts()
    try:
        with _record_writes([]) as writes:
            importlib.import_module(f"instant_nvr_tpu_torch.{args['module']}").main(
                args["argv"])
    finally:
        loop.load_checkpoint, loop.train = load, train
    return dict(seen, writes=writes,
                launches={k: v - counts0[k] for k, v in _counts().items()})


# -- the standalone check ------------------------------------------------------

def tiny_step_inputs(n_rays: int = 256) -> dict:
    """The tiny model (``train_net.TINY``, float32) on the synthetic
    batch, MSE with distortion and the pair regularizer, draws from seed 1.
    Budgets that cannot overflow (1.0: per-rank selections then hold the
    one process's points) and occupancy bias 0 (occupancies near 0.5, so
    the pair regularizer has valid pairs)."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.datasets import synthetic
    from instant_nvr_tpu_torch.models import inb
    cfg = make_cfg(os.path.join(ROOT, "configs", "inb", "inb_377.yaml")).merged(
        train_net.TINY).merged({"mlp_dtype": "float32", "grid_compute_dtype": "float32",
                                "cull_budget": 1.0, "part_budget": 1.0})
    scene = synthetic.make_scene(n_verts=600, grid=16)
    view = synthetic.render_gt(scene, H=32, W=32)
    batch = synthetic.make_batch(scene, view, n_rays=n_rays)
    model = inb.init_params(inb.build_model_spec(cfg), torch.Generator().manual_seed(0),
                            "cpu")
    with torch.no_grad():
        model.occ[-1].b[:, 0] = 0.0
    return {"cfg": cfg.to_dict(), "batch": {k: np.asarray(v) for k, v in batch.items()},
            "state": model.state_dict(), "seed": 1, "steps": 1}


def check(world: int = 2, device: str = "cpu", workdir: str | None = None) -> str:
    """The standalone check (module doc); returns its ``OK`` line."""
    import tempfile
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.run import resolve_device
    dev = resolve_device(device)            # raises on cuda without a card
    workdir = workdir or tempfile.mkdtemp(prefix="mpcheck_torch_")
    inputs = tiny_step_inputs()
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    single = case_step(inputs, dev)
    ranks = launch("step", world, workdir, device)
    loss1, loss_n = single["losses"][0], ranks[0]["losses"][0]
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"rank losses differ: {[r['losses'] for r in ranks]}")
    if not all(r["equal"] for r in ranks):
        raise AssertionError("the ranks' parameters differ after the step")
    if abs(loss1 - loss_n) > 2e-4 * max(1.0, abs(loss1)):
        raise AssertionError(f"{world}-rank loss {loss_n} != one process {loss1}")
    for k, want in single["params0"].items():
        np.testing.assert_allclose(ranks[0]["params0"][k].numpy(), want.numpy(),
                                   rtol=2e-3, atol=2e-5, err_msg=k)
    metrics = launch("metrics", world, workdir, device)
    saved = np.load(os.path.join(workdir, "metrics.npy"), allow_pickle=True).item()
    if len(saved["psnr"]) != N_ITEMS or saved["psnr"] != [10.0 + i for i in range(N_ITEMS)]:
        raise AssertionError(f"merged metrics {saved}")
    shutil.rmtree(os.path.join(workdir, "model"), ignore_errors=True)
    budgets = launch("budget", world, workdir, device)
    if [b["probes"] for b in budgets] != [1] + [0] * (world - 1) or \
            any(b["budgets"] != budgets[0]["budgets"] for b in budgets) or \
            budgets[0]["budgets"][0] != 0.31:
        raise AssertionError(f"budget broadcast: {budgets}")
    return (f"OK {world}-rank loss={loss_n:.8f} single={loss1:.8f} "
            f"metrics={len(saved['psnr'])}/{N_ITEMS} "
            f"shards={[m['mine'] for m in metrics]} budgets={budgets[0]['budgets'][:2]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.tools.multiprocess_check")
    p.add_argument("world", nargs="?", type=int, default=2)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    print(check(a.world, a.device), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        w = argparse.ArgumentParser()
        w.add_argument("case")
        w.add_argument("workdir")
        w.add_argument("--device", required=True)    # launch() names it
        w.add_argument("--backend", default=None)
        a = w.parse_args(sys.argv[2:])
        _worker(a.case, a.workdir, a.device, a.backend)
    else:
        sys.exit(main())

