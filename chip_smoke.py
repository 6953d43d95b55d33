#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``instant_nvr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises (non-zero exit):
  1. device: the card's name and power limit; TF32 off.
  2. build: compiles the port's CUDA kernels from this checkout's sources.
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, at the render path's shapes, with median times over 20 runs.
  4. slice: renders full 512x512 synthetic frames of the full-width inb_377
     model (random weights from a seed) through the same functions as
     ``python -m instant_nvr_tpu_torch.run --type render``; checks the
     outputs and that every chunk went through the kernel; then holds the
     card's render against the CPU's (plain path) on a small view.
Then one JSON line of kernel numbers, the ``nvidia-smi`` name/power line,
and last ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "configs", "inb", "inb_377.yaml")
N_TIMED = 20


def phase(label, **kv):
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_median_ms(fn, n=N_TIMED):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def knn_case(name, query, part_pts, part_pbw, lengths, knn):
    """Kernel vs plain on one input; returns (max_abs_err, ms, plain_ms)."""
    import torch
    got = knn.knn_blend(query, part_pts, part_pbw, lengths)
    ref = knn.knn_blend_plain(query, part_pts, part_pbw, lengths)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    err = (got - ref).abs().max().item()
    # rtol 1e-4 / atol 1e-5: both sides compute the same float32 distances
    # with the same rounding; the rest differs only in summation order and
    # expf vs torch.exp (a few ulp)
    bad = ~torch.isclose(got, ref, rtol=1e-4, atol=1e-5)
    note = "exact-selection"
    if bad.any():
        # an exact distance tie at the 4th neighbour may pick another vertex
        # (topk and the kernel break ties differently): the distance channel
        # must still agree, and every differing row must hold such a tie
        torch.testing.assert_close(got[..., -1], ref[..., -1], rtol=1e-4, atol=1e-5)
        rows = bad.any(-1).nonzero()
        for c, p in rows.tolist():
            d2 = ((query[c] - part_pts[p, :int(lengths[p])]) ** 2).sum(-1)
            five = torch.sort(d2).values[:5]
            if not (len(five) == 5 and five[3] == five[4]):
                torch.testing.assert_close(got[c, p], ref[c, p], rtol=1e-4,
                                           atol=1e-5)
        note = f"{len(rows)} rows differ only by exact distance ties"
    ms = cuda_median_ms(lambda: knn.knn_blend(query, part_pts, part_pbw, lengths))
    plain_ms = cuda_median_ms(
        lambda: knn.knn_blend_plain(query, part_pts, part_pbw, lengths))
    phase("kernel", case=name, C=query.shape[0], lengths=lengths.tolist(),
          max_abs_err=f"{err:.3e}", tol="rtol=1e-4,atol=1e-5", check=note,
          ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    return err, ms, plain_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import instant_nvr_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            instant_nvr_tpu_torch.__file__))) != HERE:
        raise RuntimeError("instant_nvr_tpu_torch must come from this checkout")
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.datasets import synthetic
    from instant_nvr_tpu_torch.eval.runner import AutoBudgetRenderer, eval_chunk
    from instant_nvr_tpu_torch.ops import knn
    from instant_nvr_tpu_torch import cuda_build, run

    # 1. device
    dev = run.resolve_device("cuda")            # also turns TF32 off
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", name=repr(kind), count=torch.cuda.device_count(),
          nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    knn.load_kernel()
    ptxas = [ln.strip() for ln in cuda_build.build_log("knn_blend").splitlines()
             if "registers" in ln]
    phase("build", kernel="knn_blend", seconds=f"{time.perf_counter() - t0:.2f}",
          ptxas=repr(ptxas))

    # 3. kernel vs plain, at the render path's shapes
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(n_verts=6890, grid=32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    # C = 65,536: the cull budget of one 4,096-ray x 64-sample chunk;
    # queries near the surface, like the culled samples
    C = 65536
    q = scene["verts"][rng.integers(0, len(scene["verts"]), C)] \
        + rng.normal(scale=0.03, size=(C, 3))
    errs, times = [], []
    e, ms, pms = knn_case("inb_377-chunk", t(q.astype(np.float32)),
                          t(scene["part_pts"]), t(scene["part_pbw"]),
                          t(scene["lengths2"]), knn)
    errs.append(e)
    times.append((ms, pms))
    # ragged parts: empty and nearly empty parts, C not a multiple of 128
    lengths = np.array([2297, 4593, 0, 0, 17], np.int32)
    P, M, C2 = 5, 4593, C - 37
    e, _, _ = knn_case(
        "ragged", t(rng.normal(scale=0.3, size=(C2, 3)).astype(np.float32)),
        t((0.3 * rng.normal(size=(P, M, 3))).astype(np.float32)),
        t(rng.uniform(size=(P, M, 24)).astype(np.float32)), t(lengths), knn)
    errs.append(e)

    # 4. the slice: full-width inb_377 through run --type render's functions
    cfg = make_cfg(CFG)
    torch.cuda.reset_peak_memory_stats()
    knn.knn_blend.launches = 0
    r = run.render_frames(cfg, dev, frames=3, seed=0)
    launches = knn.knn_blend.launches
    out = r["out"]
    rgb, acc = out["rgb_map"], out["acc_map"]
    if rgb.shape != (r["rays"], 3) or acc.shape != (r["rays"],):
        raise AssertionError(f"output shapes {rgb.shape} {acc.shape}")
    for k in ("rgb_map", "acc_map"):
        v = out[k]
        if not (np.isfinite(v).all() and v.min() >= 0.0 and v.max() <= 1.0):
            raise AssertionError(f"{k} not finite in [0, 1]: "
                                 f"[{v.min()}, {v.max()}]")
    for k in ("cull_overflow", "part_overflow", "cull_need", "part_need"):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f"telemetry {k} not finite: {out[k]}")
    if launches != r["chunks_rendered"] or launches == 0:
        raise AssertionError(f"knn_blend launched {launches} times for "
                             f"{r['chunks_rendered']} chunks")
    warm_ms = 1000.0 * float(np.median(r["frame_s"][1:]))
    phase("slice", config="inb_377", side=int(round(1024 * cfg.eval_ratio)),
          rays_per_frame=r["rays"], chunk=r["chunk"], frames=len(r["frame_s"]),
          chunks_rendered=r["chunks_rendered"], knn_launches=launches,
          frame_ms=[f"{1000 * s:.1f}" for s in r["frame_s"]],
          warm_ms_per_frame=f"{warm_ms:.1f}",
          rays_per_s=f"{r['rays'] / (warm_ms / 1000.0):.0f}",
          peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
          final_cull_frac=f"{r['mspec'].cull_frac:.4f}",
          rgb_range=f"[{rgb.min():.4f},{rgb.max():.4f}]")
    del r, out

    # 4b. the card against the CPU (plain PyTorch path, held against JAX by
    #     the CPU tests) on a small view, same weights, full widths
    small = cfg.merged({"eval_ratio": 16 / 1024})
    mspec, rspec, model = run.build(small, dev, seed=0)
    item = run.synthetic_frame(small)
    gpu = AutoBudgetRenderer(mspec, rspec, eval_chunk(small))(model, item)
    cpu = AutoBudgetRenderer(mspec, rspec, eval_chunk(small))(model.cpu(), item)
    diff = np.abs(gpu["rgb_map"] - cpu["rgb_map"])
    phase("cuda-vs-cpu", rays=len(diff), max_abs_diff=f"{diff.max():.3e}",
          mean_abs_diff=f"{diff.mean():.3e}")
    # bf16 MLP operands round identically on both sides; what differs is
    # summation order (~1e-6) — a threshold flip would show as one sample
    np.testing.assert_allclose(gpu["rgb_map"], cpu["rgb_map"], rtol=1e-3,
                               atol=1e-3)

    ms, pms = times[0]
    print(json.dumps({"kernels": [{
        "name": "knn_blend", "route": "cuda",
        "source": "instant_nvr_tpu_torch/csrc/knn_blend.cu",
        "replaces": "instant_nvr_tpu/ops/pallas/knn_pallas.py:111",
        "launches": launches, "max_abs_err": max(errs),
        "ms": ms, "plain_ms": pms}]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
