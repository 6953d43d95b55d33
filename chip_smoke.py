#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``instant_nvr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--nccl-ranks N]

Phases, each printing one line or more; any failure raises (non-zero exit):
  1. device: the card's name and power limit; TF32 off.
  2. build: compiles the port's CUDA kernels from this checkout's sources,
     one nvcc each, all at once; prints ptxas registers and spills; then
     the data layer's native host libraries (``csrc/nvrhost.cpp`` and the
     image decoder ``instant_nvr_tpu_torch/csrc/imgdecode.cpp``, g++).
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, at the main paths' shapes, with median times over 20 runs, the
     time of one PyTorch library call for the same function where there is
     one, and the kernel's bound (the larger of its float32 operations over
     67 TFLOP/s and its bytes over 3.35 TB/s: the H100 SXM's published
     peaks); ``knn_blend_unfused`` (``knn_topk`` + ``aggregate``) against
     ``knn_blend``.  The KNN kernels run on the render chunk (C =
     65,536), the train step's shape (C = 16,384), ragged parts and an
     adversarial case for their filter (+2 m offsets, duplicated vertices,
     queries on vertices and midpoints), each with the profiler's device
     time per call beside the event time; ``knn_blend``'s epilogue also
     runs on misaligned and wide blend-weight rows.  The scatters also run
     on the records of one train
     step, a hot coarse level (bit-exact), keys outside the table and the
     self-check's [1c] shape, with the profiler's kernel time per call
     beside the event time, and the scatter workspace must be all zero
     after every case (and after phases 5 and 7).
  4. render slice: full 512x512 synthetic frames of the full-width inb_377
     model (random weights from a seed) through the functions of
     ``python -m instant_nvr_tpu_torch.run --type render``; checks the
     outputs and that every chunk went through the KNN kernel; then holds the
     card's render against the CPU's (plain path) on a small view.
  5. train slice: full-width inb_377 MSE train steps (1,024 rays x 64
     samples) through the functions of ``python -m
     instant_nvr_tpu_torch.train_net`` (its route: captured):
     ``train/compiled.py:WARMUP_STEPS`` warm-up steps and the capture, then
     100 more steps (step i draws from a generator seeded i); checks the
     loss and that every table gradient went through the two scatter
     kernels; one torch.profiler window of 5 steps gives the device busy
     share and the top kernels, and its exported trace must read the same
     device time through ``instant_nvr_tpu_torch/tools/analyze_trace.py``.
  6. train step, card vs CPU: one full-width step on 16 rays from the same
     weights and random draws; loss, per-leaf gradients and post-Adam
     parameters at bf16-sized tolerances.
  7. self-check: ``python -m instant_nvr_tpu_torch.tools.cuda_selfcheck``'s
     checks in this process (both KNN routes, the scatters at F=16/1 and
     2/1 on wide levels, matmul precision, 11 full-width train steps); fails
     on any failure and checks every kernel's launch count, ``knn_topk``'s
     included.
  8. patch slice: the training run of ``python -m
     instant_nvr_tpu_torch.train_net --cfg_file configs/inb/inb_fake.yaml``
     (``train/loop.py:train``) at full width in patch-LPIPS mode (4,096
     rays a step as one 64x64 patch, on the captured route): writes the
     fake subject with the port's own writer (3 views x 5 frames at 512^2, 2,000 vertices;
     supersample cut to 1), trains 2 epochs of 10 steps through both
     ``ratio`` stages of inb_377 (0.3, then 0.5 with the head focus), then
     resumes from the checkpoint for a third epoch; checks finite losses,
     the checkpoint layout, the resumed epoch and step, and every launch
     count against the step's routing; prints ms per step, rays/s, the
     host data-wait share per epoch, the busy share of a 5-step profiler
     window and peak memory; checks the stager's copies against the host
     items; times each kernel on one patch step's own inputs; holds one
     patch step (``patch_size`` 16) card vs CPU.
  9. eval slice, on phase 8's checkpoint, through the functions of ``python
     -m instant_nvr_tpu_torch.run --type evaluate|prune|tmesh|tdmesh|bullet``
     (their frames captured, as on the card by default):
     evaluates the test split (view 2 x 5 frames at 512^2, the budgets
     raised on the first frame and saved), printing each frame's render and
     metrics ms, the warm median, rays, chunks, peak memory, PSNR, SSIM and
     LPIPS (recorded, not gated); loads the weights without ``run.load``'s
     random-init fallback; checks one ``knn_blend`` launch per chunk
     rendered and no other kernel, ``eval_budgets.json``, and a second
     evaluation from it that raises nothing, where each frame's launches,
     read from the counter around its render, equal its chunks; holds one 32^2 test item card
     vs CPU (rgb at phase 4b's tolerance, PSNR within 0.01 dB); profiles one
     warm 512^2 item (``tools/profile_eval.py``: device ms, busy share, top
     kernels) and times ``knn_blend`` on one of its chunks' own inputs;
     times the res-128 occupancy cube on the card and marching tetrahedra
     on the host, writes ``latest.npy`` and the two meshes, holds the res-32
     cube card vs CPU (atol 1e-5); renders 4 bullet-time views at 512^2
     (PNGs and an mp4: ffmpeg's where it exists, else the port's mp4v
     writer's, read back with ``eval/video.py:read_mp4``); then trains a fourth epoch
     with ``eval_ep``, ``vis_ep`` and ``prune_using_geo`` at 1 and checks
     their artifacts, printing the epoch's steps, cube and validation time.
 10. data-parallel slice (``instant_nvr_tpu_torch/parallel``), through
     ``tools/multiprocess_check.py``'s ranks: two Gloo ranks on the one
     card (NCCL refuses two ranks on one device) take 5 full-width steps,
     the MSE step (1,024 rays x 64 samples) and a 64x64 patch-LPIPS step
     of phase 8's subject, from the weights and draws of a one-process
     card step, with budgets raised until neither the whole batch nor a
     rank's slice overflows; the first step's loss, all-reduced gradients
     and updated parameters are held against the one-process step at
     phase 6's tolerances, the ranks' parameters bit-equal after 5 steps
     (rank 0's broadcast), each rank's launches against the routing;
     prints per-rank ms per step, the all-reduce's ms and MB, peak memory
     per rank.  Then one NCCL rank runs ``train_net --distributed`` for 3
     patch steps of the subject, and two Gloo ranks ``run --type evaluate
     --distributed`` on phase 9's weights and budgets (5 items: shards of 3
     and 2), whose ``metrics.npy`` is held to phase 9's (PSNR within 1e-4
     dB, the rest 1e-6; bit-equality printed).
 11. real-subject slice: decodes every committed JPEG fixture
     (``datasets/fixtures/jpeg``) to the sha256 its ``digests.json``
     records (the refused kinds must raise naming the file) and prints the
     host ms of a 1024^2 JPEG and of 1024^2 gray and RGB PNGs with every
     row filter (the C++ unfilter beside the numpy loop it replaced); writes
     the JPEG subject (``fake_zju.write_jpeg_subject``) and trains one
     epoch of 10 full-width patch-LPIPS steps on it through ``loop.train``
     with ``train.moment_dtype: bfloat16`` (finite losses, bf16 first
     moments, launches against the routing; ms per step, data wait, peak
     memory); trains the same epoch with float32 moments
     (``torch.optim.Adam``) beside it and times one optimizer step of each
     kind on the trained parameters (not counted in the launches); builds
     a full-width reference-layout ``.pth`` from seeded
     arrays, imports it with ``tools/import_torch_ckpt.py``'s command line,
     checks the state ``load_weights`` reads against the mapping bit for
     bit and renders one test item of the JPEG subject with it (one
     ``knn_blend`` launch a chunk); runs ``tools/prepare_dataset.py`` on a
     small synthetic SMPL model.
 12. orbax slice (the JAX package's checkpoints, ``train/orbax_format.py``):
     decodes the committed zstd corpus (``train/fixtures/orbax``, chunks
     tensorstore wrote at levels 1-22) to its digests with the host library
     ``instant_nvr_tpu_torch/csrc/zstd.cpp`` and prints the decode MB/s
     (median of 10) on its 5 largest frames; reads the two committed
     JAX-trained tiny checkpoints (float32 and bf16 moments), every leaf to
     its digest, loads each through ``load_weights`` on the card and holds
     its render of the committed 256 rays to JAX's ``expected.npz`` at
     phase 4b's tolerance; writes a full-width JAX-layout checkpoint of
     seeded arrays (params, Adam's mu and nu, 8 zero rows a table, step,
     meta) with ``tools/make_fixtures.py``'s writer and prints its read
     time, MB/s and traced host peak; resumes ``loop.train`` from it for
     10 patch steps of phase 8's subject (parameters, moments, step and
     epoch bit-equal to the written arrays before the first step; launches
     as routed); evaluates one test item at that epoch through ``run.load``
     (one ``knn_blend`` launch a chunk), printing ms and peak memory.
 13. completion slice, at inb_377's widths on phase 8's subject: (a)
     ``select_mode: partition``: 10 patch steps with every budget ample and
     10 with the cull and part budgets cut until both overflow (checked by
     the telemetry of one train-mode render), one partition patch step
     card vs CPU (phase 6's tolerances), and one 256^2 test item of phase
     9's weights rendered under partition and under topk (rgb within 1e-5:
     the same selected set); (b) a full-width JAX-layout checkpoint under
     radam whose big tables are stored packed (``flat.reshape(-1, 128)``),
     written by ``tools/make_fixtures.py``'s writer and resumed for 3 steps
     (parameters, both moments and the step bit-equal before the first);
     (c) ``fix_random``: the sorted kernel (``csrc/sorted_scatter.cu``)
     against its plain version on uniform body-hash keys, the body-hash,
     deformer-hash and arm-dense records of one train step, an F = 16
     case, phase 3's pileup, hot-row, out-of-range and [1c] cases, the
     patch step's one-hot shape, a table whose rows are no multiple of the
     tile, buckets of exactly one chunk and of one record more, and more
     than 2,048 tiles (times, bound and ``index_add_`` beside it; under the
     deterministic flag the kernel's times, its device split holding only
     its own kernels, and ``index_add_`` with the flag on and off; twice
     bit-equal; bit-equal to ``sorted_scatter_add_ordered``, the kernel's
     order on the CPU; rows bit-equal or one bf16 ulp from the plain
     version on the CPU, which adds in record order; bit-equal where the
     sums are exact), the 18 sorted calls of one ``fix_random`` patch step,
     each held to the same checks on its own inputs and then timed on them
     (summed), whether ``index_add_`` (an
     exact table's route under ``fix_random``) is deterministic under
     ``use_deterministic_algorithms``, two 10-step
     ``fix_random`` patch runs from one seed whose parameters must be bit-equal
     (every table gradient through the sorted kernel), and 3 full-width
     steps of ``train_net --detect_anomaly``; (d) phase 9's bullet views
     written as an mp4 by the port's writer (bytes, encode ms a frame) and
     read back with its own reader.
 14. none: the number is kept free so that phases 15-19 keep the numbers
     the repo's notes and tests cite.
 15. captured slice (``train/compiled.py``, ``eval/runner.py:CapturedFrame``):
     (a) the full-width inb_377 MSE step and the patch-LPIPS step, 10 steps
     of each route from the seed-0 state with the same draws and an epoch
     boundary (``ep_iter`` 5: an lr change) inside them: losses within
     rtol 1e-3 and parameters within phase 6's 2.1 lr a step; then the
     patch step under ``fix_random`` (every table gradient through the
     sorted kernel), where the losses, every parameter and both moments
     must be bit-equal; (b) launches as routed on both routes, each graph
     holding one ``knn_blend`` and 8 segmented and 10 one-hot launches a
     replay (18 sorted under ``fix_random``), 1 capture and 7 replays, the
     scatter workspace all zero after; (c) phase 8's checkpoint loaded
     into two states, 4 steps of each route on one item of its subject
     (the captured route's fourth is its first replay; its device step
     counter at the state's step), at (a)'s tolerances; (d) one 512^2 test
     frame of that checkpoint, 3 renders a route, then 2 untraced in
     turns, every map bit-equal to the eager one, and a profiled warm
     frame a route (``tools/profile_eval.py``: device ms, busy share,
     pageable host-to-device copies).
 16. programs (``eval/mesh.py:CapturedCube``, ``eval/evaluator.py:
     CapturedLpips``, ``train/compiled.py``'s other step routes): (a) the
     res-128 cube of phase 8's checkpoint, plain, deformed and with
     ``tbw``, on both routes: the captured cubes (a warm-up, the capture,
     a replay) bit-equal to the eager one, ms a cube, the copies a cube
     (profiler: at most one device-to-host, few pageable host-to-device,
     none a chunk), peak memory; other weights loaded in place after the
     capture reach the replay; (b) LPIPS of phase 9's 512^2 items
     through the evaluator on both routes, bit-equal, ms a call; (c) the
     full-width MSE and patch steps under ``train.optim`` radam, then
     sgd, and (d) under ``remat``, 10 steps of each route from the seed-0
     state (the lr change and RAdam's rectification inside): losses and
     parameters at phase 15's tolerances, each replay holding the
     routing's launches (RAdam and SGD keep non-scalar tables: 8
     segmented and 40 one-hot), 1 capture and 7 replays, then 5 timed and
     3 traced steps (ms a step, busy share, device ms, peak); then each
     under ``fix_random``, losses, parameters and moments bit-equal; (e)
     one NCCL rank through ``train_net --distributed`` under
     ``fix_random``, captured (its route printed) against ``--eager``:
     losses, parameters and moments bit-equal.  ``python3 chip_smoke.py
     --nccl-ranks N`` runs (e) alone on N NCCL ranks, one a card.
 17. the fused hash-grid encoding (``csrc/hashgrid_encode.cu``): the cases
     of ``tests/test_torch_hashgrid_fused.py`` (inb_377's part grids with
     bf16 and float32 tables, the deformer's concat grid, non-scalar part
     grids, one spec of each other mode; tables at std 0.1 and 1.0; 1.1 M
     points in and around the boxes and 20,011 a part on cell boundaries),
     each kernel call against the plain chain at ``tests/
     test_torch_hashgrid.py``'s tolerance, with its max error and share of
     bit-equal values; the bf16-lerp control, which must fail that
     tolerance at std 1.0; then the part grids and the deformer at the
     render chunk's shape (``RENDER_KPS``, the budgets
     ``inb377.render.eval``'s set-up raises to): the kernel's output
     against the plain chain's at the same tolerance (its max error and
     share of bit-equal values), the kernel's and the plain
     chain's event and device ms, the bound (the points, the
     distinct table rows the plain chain gathers and the output, each
     once, over 3.35 TB/s) and the share.
     Phases 4 and 5 also assert the route: 2 forward launches a render
     chunk and no backward; in a train step one forward and one backward
     launch an encoder call (``train.step.encoder_calls``), and phases 15
     and 16 hold each replay to them (the forward twice under ``remat``).
     Likewise ``mlp_wgrad``: no launch in a render, one a linear layer
     that asks a gradient in a train step (``train.step.mlp_wgrad_calls``,
     13 at inb_377), eager and a replay, under Adam, RAdam, SGD, ``remat``
     and ``fix_random``.
 18. the encoding's backward (``hashgrid_backward_kernel``, through the
     autograd Function ``ops/hashgrid.py:fused_autograd_encode``) at a fit
     step's shapes (``tests/test_torch_hashgrid_fused.py``'s
     ``BACKWARD_CASES``: the part grids over the 90,112 budget slots, the
     deformer over the same slots and over the pair term's 1,024; tables at
     std 0.1 and 1.0): the records handed to the scatters bit-equal to the
     plain chain's autograd's, the points' gradient bit-equal to the plain
     PyTorch twin on the card and within ``POINTS_LIMIT`` of the term scale
     of a float64 chain, which the bf16-lerp control must fail; then each
     of a fit step's three encoder calls at its shape: forward and
     backward through the plain chain and through the Function (event and
     device ms), the backward kernel's device ms alone, its bound (the
     points, the cotangent, the records, the points' gradient and the
     distinct rows gathered, each once, over 3.35 TB/s) and share.
 19. the MLPs' weight and bias gradients (``csrc/mlp_wgrad.cu``, through
     ``ops/mlp_wgrad.py:weight_grads``) at each linear layer shape of a
     fit step and at the kernel's edges (``tests/test_torch_mlp_wgrad.py``'s
     ``fit_layers`` and ``EDGE_LAYERS``): within ``LIMIT`` of the element's
     sum of |x g| of a float64 x^T g, as cuBLAS's float32 call is, where a
     control with g rounded to bfloat16 is not; two launches bit-equal;
     then each of a fit step's layers at its shape: the kernel's event and
     device ms, cuBLAS's x^T g call's and the bias's sum's device ms (the
     calls the port no longer makes), the bound (2 (Din + 1) Dout
     operations a row over 67 TFLOP/s, or the operands read and the
     gradients written once over 3.35 TB/s) and the share, and the step's
     sums.
Then one JSON line of kernel numbers (launches: the render, train,
self-check, patch, evaluate, data-parallel, real-subject, orbax,
completion, captured and programs phases together, each row also with ``orbax_launches``; a KNN row's times are the render
chunk's, with the train step's shape beside them as ``train_shape_*``; a
scatter row's times are its first case, uniform keys at the main path's
shape, with its train-step case beside them as ``train_records_*``; every
row also has ``patch_step_launches``, the patch runs' launches over their
steps, and a row on the patch path its times on the patch step's own
inputs as ``patch_shape_*``; ``knn_blend`` also has its launches per eval
frame as read in the second evaluation, ``eval_frame_launches``, and its times on one eval chunk's own
inputs as ``eval_shape_*``; every row has phase 10's launches in each
rank, ``dp_launches_per_rank``, phase 13's, ``completion_launches``,
phase 15's, ``captured_launches``, and its
graphs' launches a replay, ``captured_replay_launches``, phase 16's,
``programs_launches``, and its step graphs' launches a replay,
``programs_replay_launches``; the sorted kernel's row, phase 13's only,
has its uniform-keys case with the train step's records beside it, its
times under the deterministic flag and the summed times of a
``fix_random`` patch step's 18 sorted calls), one JSON line of phase 17's
numbers (``hashgrid_encode``), one of phase 18's (``hashgrid_backward``),
one of phase 19's (``mlp_wgrad``), the ``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "configs", "inb", "inb_377.yaml")
N_TIMED = 20
PROFILE_STEPS = 5
TRAIN_STEPS = 100             # phase 5's steps after the warm-up


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


# the H100 SXM's published peaks at 700 W: float32 outside the tensor
# cores, and device memory
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for
    ``flops`` float32 operations and ``nbytes`` bytes of device memory."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def knn_bound(query, part_pts, lengths, out_bytes, row_bytes=0):
    """Bound of a KNN kernel on these inputs: 8 operations per (query, real
    vertex) pair (3 sub, 3 mul, 2 add); the query, the real vertices (and
    ``row_bytes`` more of each, the blend weights), the lengths read once
    and ``out_bytes`` written once."""
    C, (P, M) = query.shape[0], part_pts.shape[:2]
    real = int(lengths.long().clamp(0, M).sum())
    return bound(8 * C * real,
                 C * 12 + real * (12 + row_bytes) + P * 4 + out_bytes)


def exact_d2(q, verts):
    """(dx^2 + dy^2) + dz^2 in float32, the kernels' and plain versions'
    rounding."""
    d = q - verts
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def has_tie(query, part_pts, lengths, c, p):
    """Whether query c's 4th and 5th nearest real vertices of part p are
    exactly as far: then either may be the 4th neighbour."""
    import torch
    five = torch.sort(exact_d2(query[c], part_pts[p, :int(lengths[p])])).values[:5]
    return len(five) == 5 and bool(five[3] == five[4])


def blend_agree(name, got, ref, query, part_pts, lengths):
    """Holds a (C, P, D + 1) blend against its reference; returns
    (max_abs_err, note)."""
    import torch
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
            if not has_tie(query, part_pts, lengths, c, p):
                torch.testing.assert_close(got[c, p], ref[c, p], rtol=1e-4,
                                           atol=1e-5)
        note = f"{len(rows)} rows differ only by exact distance ties"
    return err, note


def knn_case(name, inputs, knn):
    """Kernel vs plain on one input; returns (max_abs_err, ms, plain_ms,
    (bound_ms, bound_by), device_ms)."""
    import torch
    query, part_pts, part_pbw, lengths = inputs
    got = knn.knn_blend(query, part_pts, part_pbw, lengths)
    ref = knn.knn_blend_plain(query, part_pts, part_pbw, lengths)
    torch.cuda.synchronize()
    err, note = blend_agree(name, got, ref, query, part_pts, lengths)
    call = lambda: knn.knn_blend(query, part_pts, part_pbw, lengths)
    ms = cuda_median_ms(call)
    dev_ms = device_ms(call)
    plain_ms = cuda_median_ms(
        lambda: knn.knn_blend_plain(query, part_pts, part_pbw, lengths))
    D = part_pbw.shape[2]
    bnd = knn_bound(query, part_pts, lengths, got.numel() * 4, row_bytes=D * 4)
    phase("kernel", case=name, C=query.shape[0], lengths=lengths.tolist(),
          max_abs_err=f"{err:.3e}", tol="rtol=1e-4,atol=1e-5", check=note,
          ms=f"{ms:.4f}", device_ms=fmt_ms(dev_ms), plain_ms=f"{plain_ms:.4f}",
          bound_ms=f"{bnd[0]:.4f}", bound_by=bnd[1])
    return err, ms, plain_ms, bnd, dev_ms


def knn_inputs(dev, rng):
    """The KNN cases, {name: (query (C, 3), part_pts (P, M, 3), part_pbw
    (P, M, 24), lengths (P,) int32)} on ``dev``: the inb_377 render chunk
    and the ragged parts from ``rng`` (in that order), the train step's
    shape and the filter's adversarial case from ``default_rng(1)``."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(n_verts=6890, grid=32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    verts = scene["verts"]
    pts, pbw, lens = (t(scene[k]) for k in ("part_pts", "part_pbw", "lengths2"))

    def near_surface(r, C):
        """C queries near the surface, like the culled samples."""
        q = verts[r.integers(0, len(verts), C)] + r.normal(scale=0.03, size=(C, 3))
        return t(q.astype(np.float32))
    # C = 65,536: the cull budget of one 4,096-ray x 64-sample chunk
    cases = {"inb_377-chunk": (near_surface(rng, 65536), pts, pbw, lens)}
    # ragged parts: empty and nearly empty parts, C not a multiple of 128
    lengths = np.array([2297, 4593, 0, 0, 17], np.int32)
    P, M, C2 = 5, 4593, 65536 - 37
    cases["ragged"] = (t(rng.normal(scale=0.3, size=(C2, 3)).astype(np.float32)),
                       t((0.3 * rng.normal(size=(P, M, 3))).astype(np.float32)),
                       t(rng.uniform(size=(P, M, 24)).astype(np.float32)), t(lengths))
    extra = np.random.default_rng(1)
    # C = 16,384: the train step's cull budget (0.25 x 1,024 rays x 64
    # samples)
    cases["train-shape"] = (near_surface(extra, 16384), pts, pbw, lens)
    # the filter's adversarial case: the scene moved by +2 m on each axis
    # (|q|^2 ~ 12: the widest margin), every third vertex a copy of the one
    # before it (exact ties), and queries on vertices or on the midpoint
    # between a vertex and its nearest other position (the nearest 2 to 4
    # tie or nearly tie)
    adv = scene["part_pts"] + np.float32(2.0)
    adv[:, 1::3] = adv[:, 0:-1:3][:, :adv[:, 1::3].shape[1]]
    L = scene["lengths2"].astype(np.int64)
    C3 = 16384 - 5
    part = extra.integers(0, len(L), C3)
    a = adv[part, (extra.random(C3) * L[part]).astype(np.int64)]
    b = np.empty_like(a)
    for p in range(len(L)):
        rows = np.nonzero(part == p)[0]
        d = ((a[rows, None].astype(np.float64) - adv[p, None, :L[p]]) ** 2).sum(-1)
        d[d == 0] = np.inf
        b[rows] = adv[p, d.argmin(-1)]
    on_vertex = extra.random(C3) < 0.5
    q = np.where(on_vertex[:, None], a, (a + b) * np.float32(0.5)).astype(np.float32)
    cases["adversarial"] = (t(q), t(adv), pbw, lens)
    return cases


def epilogue_cases(inputs, knn):
    """``knn_blend``'s other epilogue paths against the plain version on
    the first 4,096 queries of ``inputs``: blend-weight rows of D = 24
    floats 4 bytes off 16-byte alignment (scalar loads, staged stores), and
    D = 40 and 41 (rows too wide to stage: direct stores, with 16-byte and
    scalar loads).  Returns the largest error."""
    import numpy as np
    import torch
    query, part_pts, _, lengths = inputs
    query = query[:4096]
    P, M = part_pts.shape[:2]
    rng = np.random.default_rng(2)
    errs = []
    for D, offset in ((24, 1), (40, 0), (41, 0)):
        buf = torch.empty(P * M * D + offset, device=query.device)
        pbw = buf[offset:].view(P, M, D)
        pbw.copy_(torch.from_numpy(rng.uniform(size=(P, M, D)).astype(np.float32)))
        got = knn.knn_blend(query, part_pts, pbw, lengths)
        ref = knn.knn_blend_plain(query, part_pts, pbw, lengths)
        torch.cuda.synchronize()
        err, note = blend_agree(f"epilogue-D{D}", got, ref, query, part_pts, lengths)
        phase("kernel", case=f"epilogue-D{D}", C=query.shape[0],
              aligned=pbw.data_ptr() % 16 == 0, max_abs_err=f"{err:.3e}",
              tol="rtol=1e-4,atol=1e-5", check=note)
        errs.append(err)
    return max(errs)


def sort_slots(d2, idx):
    """(P, C, K) neighbour slots ordered by (d2, idx)."""
    import torch
    o = torch.argsort(idx, dim=-1, stable=True)
    d2, idx = d2.gather(-1, o), idx.gather(-1, o)
    o = torch.argsort(d2, dim=-1, stable=True)
    return d2.gather(-1, o), idx.gather(-1, o)


TOPK_TOL = ("real slots: d2 bit-equal, idx equal but at exact 4th/5th distance "
            "ties; spare slots: d2>=1e9, 0<=idx<M")


def topk_case(name, inputs, knn):
    """``knn_topk`` vs ``knn_topk_plain``, then ``knn_blend_unfused`` vs
    ``knn_blend``, on one input; returns (max_abs_err, ms, plain_ms,
    (bound_ms, bound_by), device_ms)."""
    import torch
    query, part_pts, part_pbw, lengths = inputs
    C, (P, M) = query.shape[0], part_pts.shape[:2]
    got = knn.knn_topk(query, part_pts, lengths)
    ref = knn.knn_topk_plain(query, part_pts, lengths)
    torch.cuda.synchronize()
    for d2, idx in (got, ref):
        if (d2.shape != (P, C, 4) or idx.shape != (P, C, 4)
                or d2.dtype != torch.float32 or idx.dtype != torch.int32):
            raise AssertionError(f"{name}: {d2.dtype} {tuple(d2.shape)}, "
                                 f"{idx.dtype} {tuple(idx.shape)}")
    (d2, idx), (rd2, ridx) = sort_slots(*got), sort_slots(*ref)
    n_real = lengths.long().clamp(0, M).clamp(max=4)
    real = (torch.arange(4, device=query.device) < n_real[:, None, None]).expand_as(d2)
    for side, a, i in (("kernel", d2, idx), ("plain", rd2, ridx)):
        spare_d2, spare_i = a[~real], i[~real]
        if not ((spare_d2 >= 1e9).all() and (spare_i >= 0).all()
                and (spare_i < M).all()):
            raise AssertionError(f"{name}: {side} spare slots not (d2 >= 1e9, "
                                 f"0 <= idx < {M})")
    if not torch.equal(d2[real], rd2[real]):
        raise AssertionError(f"{name}: real-slot d2 differ by up to "
                             f"{(d2 - rd2)[real].abs().max().item():.3e}")
    err = (d2 - rd2)[real].abs().max().item() if real.any() else 0.0
    rows = ((idx != ridx) & real).any(-1).nonzero()           # (p, c) pairs
    for p, c in rows.tolist():
        if not has_tie(query, part_pts, lengths, c, p):
            raise AssertionError(f"{name}: part {p} query {c}: kernel "
                                 f"{idx[p, c].tolist()} plain {ridx[p, c].tolist()}")
    note = f"{len(rows)} rows differ only by exact distance ties" if len(rows) \
        else "exact-selection"
    dist = torch.sqrt(torch.clamp(got[0], min=0.0))
    call = lambda: knn.knn_topk(query, part_pts, lengths)
    ms = cuda_median_ms(call)
    dev_ms = device_ms(call)
    plain_ms = cuda_median_ms(lambda: knn.knn_topk_plain(query, part_pts, lengths))
    agg_ms = cuda_median_ms(lambda: knn.aggregate(dist, got[1], part_pbw))
    bnd = knn_bound(query, part_pts, lengths, P * C * 4 * 8)
    phase("kernel", case=f"{name}-topk", C=C, lengths=lengths.tolist(),
          max_abs_err=f"{err:.3e}", tol=repr(TOPK_TOL), check=note,
          ms=f"{ms:.4f}", device_ms=fmt_ms(dev_ms), plain_ms=f"{plain_ms:.4f}",
          aggregate_ms=f"{agg_ms:.4f}", bound_ms=f"{bnd[0]:.4f}", bound_by=bnd[1])
    unfused = knn.knn_blend_unfused(query, part_pts, part_pbw, lengths)
    fused = knn.knn_blend(query, part_pts, part_pbw, lengths)
    torch.cuda.synchronize()
    u_err, u_note = blend_agree(f"{name}-unfused", unfused, fused, query,
                                part_pts, lengths)
    u_ms = cuda_median_ms(
        lambda: knn.knn_blend_unfused(query, part_pts, part_pbw, lengths))
    phase("kernel", case=f"{name}-unfused-vs-fused", C=C,
          max_abs_err=f"{u_err:.3e}", tol="rtol=1e-4,atol=1e-5", check=u_note,
          unfused_ms=f"{u_ms:.4f}")
    return err, ms, plain_ms, bnd, dev_ms


SCATTER_TOL = ("|kernel-plain| <= 1 bf16 ulp of the row + n_row*2^-24*sum|payload| "
               "(f32 sums in another order)")


def device_ms_by_kernel(fn, n=N_TIMED):
    """Device time per call of ``fn`` by CUDA kernel name: what
    torch.profiler records over ``n`` calls; empty when the trace holds no
    device time."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            t = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if t is None else t
            if us > 0:
                out[e.key] = out.get(e.key, 0.0) + us / n / 1000
    return out


def queued_ms(fn, n=N_TIMED):
    """Device time per call of ``fn`` from CUDA events around ``n`` calls
    that wait behind a ~10 ms spin on the card, so the host has enqueued
    them all before the first runs: the card's time from the first
    kernel's start to the last one's end, gaps between kernels included,
    host time excluded."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_split(fn, n=5, tries=4):
    """``device_ms_by_kernel`` over ``n`` calls, asked again (up to
    ``tries`` times, each over 4x the calls of the one before) when the
    trace holds no device time: a window of a few calls of a ~0.01 ms
    launch has come back empty three times running."""
    for i in range(tries):
        split = device_ms_by_kernel(fn, n * 4 ** i)
        if split:
            return split
    return {}


def device_ms(fn, n=N_TIMED):
    """Device time per call of ``fn`` (all its CUDA kernels), or None when
    the trace holds no device time."""
    by_kernel = device_ms_by_kernel(fn, n)
    return sum(by_kernel.values()) if by_kernel else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def kernel_name(key):
    """A profiler kernel name without namespace, template and arguments."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return (name.split("::")[-1].split() or [key])[-1]


def assert_workspace_zero(where):
    from instant_nvr_tpu_torch.ops import scatter
    nz = scatter.workspace_nonzero()
    if nz:
        raise AssertionError(f"{where}: the scatter workspace holds {nz} nonzero words")


def scatter_case(name, fn, plain, keys, payload, n_rows, level_offsets,
                 exact=False):
    """Scatter kernel vs its plain version; returns (max_abs_err, ms,
    plain_ms, library_ms, (bound_ms, bound_by), device_ms,
    library_device_ms).
    Both sum in f32 and round to bf16 once: a row may differ by one bf16 ulp
    plus the f32 reordering bound, which covers rows whose sum cancels.
    ``exact``: payloads whose sums are exact in f32 in any order, so the
    two must agree bit for bit.  Keys outside the table are dropped by the
    kernel; the plain version (``index_add_``) gets only the others.  The
    library call is one f32 ``index_add_`` into a prepared zero table, its
    zero fill and casts outside the timed region (``library_full_ms``, for
    information: with them); the bound counts the keys and payload read
    once and the bf16 table written once.  ``ms`` and ``library_ms`` are
    CUDA events around the call (host enqueue included), ``device_ms`` and
    ``library_device_ms`` the profiler's kernel time per call
    (``device_split``: the kernel's by CUDA kernel).  The workspace must be
    all zero after the case."""
    import torch
    got = fn(keys, payload, n_rows, level_offsets)
    keep = (keys >= 0) & (keys < n_rows)
    n_dropped = int((~keep).sum())
    rk, rp = (keys, payload) if not n_dropped else (keys[keep].contiguous(),
                                                    payload[keep].contiguous())
    ref = plain(rk, rp, n_rows, level_offsets)
    torch.cuda.synchronize()
    assert_workspace_zero(name)
    F = payload.shape[1]
    if got.shape != (n_rows, F) or got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    k = rk.long()
    count = torch.zeros(n_rows, device=k.device).index_add_(
        0, k, torch.ones_like(k, dtype=torch.float32))
    mass = torch.zeros((n_rows, F), device=k.device).index_add_(
        0, k, rp.float().abs())
    top = torch.maximum(g.abs(), r.abs())
    _, e = torch.frexp(top)                    # top = m * 2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(g), e - 8) * (top > 0)
    diff = (g - r).abs()
    bad = diff > ulp + count[:, None] * 2.0 ** -24 * mass
    if exact:
        bad |= diff > 0
    if bad.any():
        i = int(bad.any(-1).nonzero()[0, 0])
        raise AssertionError(f"{name}: {int(bad.sum())} entries out of tolerance; "
                             f"row {i}: kernel {g[i].tolist()} plain {r[i].tolist()}")
    err = diff.max().item()
    call = lambda: fn(keys, payload, n_rows, level_offsets)
    ms = cuda_median_ms(call)
    split = device_ms_by_kernel(call)
    dev_ms = sum(split.values()) if split else None
    plain_ms = cuda_median_ms(lambda: plain(rk, rp, n_rows, level_offsets))
    acc, pay32 = torch.zeros((n_rows, F), device=k.device), rp.float()
    library_ms = cuda_median_ms(lambda: acc.index_add_(0, k, pay32))
    library_dev_ms = device_ms(lambda: acc.index_add_(0, k, pay32))
    library_full_ms = cuda_median_ms(lambda: torch.zeros(
        (n_rows, F), device=k.device).index_add_(0, k, pay32).to(torch.bfloat16))
    assert_workspace_zero(name)
    R = keys.shape[0]
    bnd = bound(R * F, R * 4 + R * F * 2 + n_rows * F * 2)
    phase("kernel", case=name, R=R, F=F, n_rows=n_rows,
          levels=len(level_offsets) - 1, distinct_keys=int(torch.unique(k).numel()),
          dropped=n_dropped, max_abs_err=f"{err:.3e}",
          rows_differing=int((diff > 0).any(-1).sum()),
          tol=repr("bit-exact" if exact else SCATTER_TOL),
          ms=f"{ms:.4f}",
          device_ms="not measured" if dev_ms is None else f"{dev_ms:.4f}",
          device_split=repr({kernel_name(k): round(v, 4) for k, v in split.items()}),
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          library_device_ms=("not measured" if library_dev_ms is None
                             else f"{library_dev_ms:.4f}"),
          library_full_ms=f"{library_full_ms:.4f}", bound_ms=f"{bnd[0]:.5f}",
          bound_by=bnd[1], workspace="zero")
    return err, ms, plain_ms, library_ms, bnd, dev_ms, library_dev_ms


def level_keys(rng, level_offsets, per_level):
    """Level-major keys, uniform within each level's row window."""
    import numpy as np
    return np.concatenate([rng.integers(a, b, per_level) for a, b in
                           zip(level_offsets[:-1], level_offsets[1:])]).astype(np.int32)


def capture_train_records(cfg, dev):
    """Every table-gradient scatter call of one train-smoke step (a fresh
    trainer from seed 0, its first step): [(route, keys, payload, n_rows,
    level_offsets)], as the kernels received them."""
    import torch
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.ops import hashgrid as hg
    trainer = train_net.build_trainer(cfg, dev, seed=0)
    calls, kernels = [], dict(hg._SCATTER)

    def spy(route):
        def call(keys, payload, n_rows, level_offsets):
            calls.append((route, keys.clone(), payload.clone(), n_rows,
                          tuple(level_offsets)))
            return kernels[route](keys, payload, n_rows, level_offsets)
        return call
    hg._SCATTER.update({route: spy(route) for route in kernels})
    try:
        trainer.step(trainer.state, trainer.batch,
                     generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        hg._SCATTER.update(kernels)
    return calls


def scatter_cases(cfg, dev, rng):
    """Both scatter kernels against their plain versions at the train path's
    shapes, on the train step's own records, on a hot coarse level, with
    keys outside the table, and at the self-check's [1c] shape:
    {kernel: (max_abs_err over its cases, then ms, plain_ms, library_ms,
    bound, device_ms, library_device_ms of its first case (uniform keys),
    then the whole result of its train-step case)}."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.ops import scatter
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    bf = lambda a: t(a.astype(np.float32)).to(torch.bfloat16)
    seg = (scatter.segmented_scatter_add, scatter.segmented_scatter_add_plain)
    one = (scatter.onehot_scatter_add, scatter.onehot_scatter_add_plain)
    mspec = inb.build_model_spec(cfg)
    body = mspec.part_embeds[mspec.partnames.index("body")]
    arm = mspec.part_embeds[mspec.partnames.index("larm")]
    out, records = {}, {}
    errs = {"segmented_scatter_add": [], "onehot_scatter_add": []}

    def run(kernel, name, fns, keys, payload, n_rows, offs, exact=False,
            train_records=False):
        keys = keys if torch.is_tensor(keys) else t(keys)
        res = scatter_case(name, *fns, keys, payload, n_rows, offs, exact)
        errs[kernel].append(res[0])
        out.setdefault(kernel, res)
        if train_records:
            records.setdefault(kernel, res)

    def out_of_range(keys, n_rows):
        """10% of the keys moved outside [0, n_rows), both sides and the
        int32 extremes."""
        keys = keys.copy()
        bad = rng.random(len(keys)) < 0.1
        keys[bad] = rng.choice(np.array([-(2 ** 31), -7, -1, n_rows, n_rows + 5,
                                         2 ** 31 - 1], np.int64), int(bad.sum()))
        return keys

    # body hash table: 10 levels x 8 corners x 8,192 points
    _, body_rows, body_offs = body.tables()[-1]
    R = (len(body_offs) - 1) * 8 * 8192
    run("segmented_scatter_add", "body-hash", seg, level_keys(rng, body_offs, 8 * 8192),
        bf(rng.normal(size=(R, 1))), body_rows, body_offs)
    # pileup: every record on one key of level 2 (levels 0, 1, 3 empty),
    # R not a multiple of 128; small-integer payloads sum exactly
    R = 100003
    offs4 = tuple(range(0, 4 * 50000 + 1, 50000))
    run("segmented_scatter_add", "pileup", seg, np.full(R, 123457, np.int32),
        bf(rng.integers(-8, 9, size=(R, 1))), offs4[-1], offs4, exact=True)
    # F = 2, 4 levels
    R, offs2 = 262144, tuple(range(0, 4 * 262147 + 1, 262147))
    run("segmented_scatter_add", "F2", seg, level_keys(rng, offs2, R // 4),
        bf(rng.normal(size=(R, 2))), offs2[-1], offs2)
    # deformer hash table: 2 levels x 8 corners x 22,528 points, per column
    _, def_rows, def_offs = mspec.deformer.embed.tables()[-1]
    R = (len(def_offs) - 1) * 8 * 22528
    run("onehot_scatter_add", "deformer-hash", one, level_keys(rng, def_offs, 8 * 22528),
        bf(rng.normal(size=(R, 1))), def_rows, def_offs)
    # arm dense table: 9 levels x 8 corners x 2,048 points
    _, rows, offs = arm.tables()[0]
    R = (len(offs) - 1) * 8 * 2048
    run("onehot_scatter_add", "arm-dense", one, level_keys(rng, offs, 8 * 2048),
        bf(rng.normal(size=(R, 1))), rows, offs)
    # the train step's own records (duplicate keys as the main path has
    # them), each table's largest call; the kernels line gives the first of
    # each kernel beside its uniform-keys row
    calls = capture_train_records(cfg, dev)
    phase("kernel", train_step_calls=repr([(r, int(k.shape[0]), n, len(o) - 1)
                                           for r, k, p, n, o in calls]))
    _, arm_rows, arm_offs = arm.tables()[0]
    for kernel, name, fns, route, rows, offs in (
            ("segmented_scatter_add", "body-hash-real", seg, "segmented", body_rows,
             body_offs),
            ("onehot_scatter_add", "deformer-hash-real", one, "onehot", def_rows,
             def_offs),
            ("onehot_scatter_add", "arm-dense-real", one, "onehot", arm_rows,
             arm_offs)):
        keys, payload = max(((k, p) for r, k, p, n, o in calls
                             if r == route and n == rows and o == tuple(offs)),
                            key=lambda kp: kp[0].shape[0])
        run(kernel, name, fns, keys, payload, rows, offs, train_records=True)
    del calls
    # a hot coarse level: 8 rows take 131,072 records (small integers:
    # exact), beside a full-size level
    for kernel, fns in (("segmented_scatter_add", seg), ("onehot_scatter_add", one)):
        hot = (0, 8, 8 + 16411)
        run(kernel, "hot-row", fns, level_keys(rng, hot, 131072),
            bf(rng.integers(-8, 9, size=(2 * 131072, 1))), hot[-1], hot, exact=True)
    # keys outside the table are dropped
    R = (len(def_offs) - 1) * 8 * 22528
    for kernel, fns in (("segmented_scatter_add", seg), ("onehot_scatter_add", one)):
        run(kernel, "out-of-range", fns,
            out_of_range(level_keys(rng, def_offs, 8 * 22528), def_rows),
            bf(rng.normal(size=(R, 1))), def_rows, def_offs)
    # the self-check's [1c]: one 12,276-row level of 1,081,344 records, at
    # F = 2 and 1 (several clusters per level)
    for F in (2, 1):
        run("onehot_scatter_add", f"selfcheck-1c-F{F}", one,
            level_keys(rng, (0, 12276), 1081344),
            bf(rng.normal(size=(1081344, F))), 12276, (0, 12276))
    return {k: (max(errs[k]),) + v[1:] + (records[k],) for k, v in out.items()}


def reset_counts(knn, scatter):
    knn.knn_blend.launches = 0
    knn.knn_topk.launches = 0
    scatter.segmented_scatter_add.launches = 0
    scatter.onehot_scatter_add.launches = 0
    scatter.sorted_scatter_add.launches = 0
    scatter.exact_scatter_add.calls = 0
    from instant_nvr_tpu_torch.ops import hashgrid
    hashgrid.fused_encode.launches = 0
    hashgrid.fused_encode_backward.launches = 0
    from instant_nvr_tpu_torch.ops import mlp_wgrad
    mlp_wgrad.mlp_wgrad.launches = 0


def launch_counts(knn, scatter):
    return {"knn_blend": knn.knn_blend.launches, "knn_topk": knn.knn_topk.launches,
            "segmented_scatter_add": scatter.segmented_scatter_add.launches,
            "onehot_scatter_add": scatter.onehot_scatter_add.launches}


def profile_steps(trainer, gen):
    """One torch.profiler window of PROFILE_STEPS steps -> (busy share, top
    kernels, top ops by the device time of the kernels they launch, summed
    device us, ``analyze_trace.summarize`` of the window's exported trace);
    the share is None and the lists empty when the window holds no device
    time."""
    import contextlib
    import io
    import tempfile
    import torch
    from torch.autograd import DeviceType
    from instant_nvr_tpu_torch.tools import analyze_trace
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            trainer.step(trainer.state, trainer.batch, generator=gen)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
        summary = analyze_trace.summarize(analyze_trace.find_trace(tmp), top_k=5)
    kern, ops = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        # device kernels and copies; not the annotation ranges drawn on the
        # device timeline (Optimizer.step#...), which overlap them
        if getattr(e, "is_user_annotation", False):
            continue
        (kern if e.device_type == DeviceType.CUDA else ops).append((us, e.count, e.key))
    busy = sum(k[0] for k in kern)
    if busy <= 0:
        return None, [], [], busy, summary

    def top(rows):
        rows.sort(reverse=True)
        return [f"{name[:60]}:{us / 1000 / PROFILE_STEPS:.3f}ms/step:x{n // PROFILE_STEPS}"
                for us, n, name in rows[:10] if us > 0]
    return busy / wall_us, top(kern), top(ops), busy, summary


def seeded_steps(trainer, gen, start, n, losses):
    """Steps ``start`` to ``start + n`` of ``trainer``; step i draws from
    ``gen`` seeded i.  Appends a copy of each loss (a captured step's is its
    graph's output, which the next replay overwrites)."""
    for i in range(start, start + n):
        gen.manual_seed(i)
        _, stats = trainer.step(trainer.state, trainer.batch, generator=gen)
        losses.append(stats["loss"].clone())


def train_slice(cfg, dev, knn, scatter):
    """Full-width MSE steps through train_net's functions: the warm-up and
    TRAIN_STEPS more, then a profiled window; returns the launch counts of
    the run and the scatter routes of one step."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.ops import mlp_wgrad
    from instant_nvr_tpu_torch.train.compiled import WARMUP_STEPS
    from instant_nvr_tpu_torch.train.step import (encoder_calls, mlp_wgrad_calls,
                                                  table_grad_launches)
    trainer = train_net.build_trainer(cfg, dev, seed=0)
    routes = table_grad_launches(trainer.mspec, trainer.rspec)
    calls = encoder_calls(trainer.rspec)
    layers = mlp_wgrad_calls(trainer.mspec, trainer.rspec)
    gen = torch.Generator(device=dev)
    n_rays = int(trainer.batch["ray_o"].shape[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(knn, scatter)
    losses = []
    # the captured route's warm-up holds its capture, one step after its own
    warmup = WARMUP_STEPS + (1 if trainer.route.name == "captured" else 0)
    seeded_steps(trainer, gen, 0, warmup + TRAIN_STEPS, losses)
    torch.cuda.synchronize()
    steps = len(losses)
    counts = {"knn_blend": knn.knn_blend.launches,
              "segmented_scatter_add": scatter.segmented_scatter_add.launches,
              "onehot_scatter_add": scatter.onehot_scatter_add.launches}
    exact_calls = scatter.exact_scatter_add.calls
    peak = torch.cuda.max_memory_allocated()
    loss = torch.stack(losses).cpu().numpy()
    if not np.isfinite(loss).all():
        raise AssertionError(f"non-finite loss at steps "
                             f"{np.nonzero(~np.isfinite(loss))[0]}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"loss did not fall: step 0 {loss[0]}, "
                             f"step {steps - 1} {loss[-1]}")
    want = {"knn_blend": steps,
            "segmented_scatter_add": steps * routes["segmented"],
            "onehot_scatter_add": steps * routes["onehot"]}
    if counts != want or routes["exact"] or exact_calls:
        raise AssertionError(f"launches {counts} != {want} (routes per step "
                             f"{dict(routes)}, exact index_add_ calls {exact_calls})")
    from instant_nvr_tpu_torch.ops import hashgrid
    enc = (hashgrid.fused_encode.launches, hashgrid.fused_encode_backward.launches)
    if enc != (steps * calls, steps * calls):
        raise AssertionError(f"train steps' encoders: (forward, backward) launches {enc} "
                             f"!= {calls} of each a step over {steps} steps")
    wgrad = mlp_wgrad.mlp_wgrad.launches
    if wgrad != steps * layers:
        raise AssertionError(f"train steps' MLP weight gradients: {wgrad} launches != "
                             f"{layers} a step over {steps} steps")
    phase("train", config="inb_377", rays=n_rays, samples=trainer.rspec.n_samples,
          steps=steps, peak_mem_GB=f"{peak / 1e9:.3f}",
          loss_first=f"{loss[0]:.5f}",
          loss_last=f"{loss[-1]:.5f}", routes_per_step=repr(dict(routes)),
          launches=repr(counts), route=repr(str(trainer.route)),
          encode_launches=enc[0], encode_backward_launches=enc[1],
          encoder_calls_per_step=f"{enc[1] / steps:g}", mlp_wgrad_launches=wgrad,
          mlp_wgrad_launches_per_step=f"{wgrad / steps:g}")
    busy, top_kernels, top_ops, device_us, summary = profile_steps(trainer, gen)
    # the trace tool reads the same CUPTI events from the exported file: its
    # summed device time must be the profiler's, its busy share a share
    traced_us = 1000 * sum(summary["buckets"].values())
    if (busy is None or summary["busy"] is None or summary["device_ms"] is None
            or not 0 < summary["busy"] <= 1
            or abs(traced_us - device_us) > 0.02 * device_us):
        raise AssertionError(f"analyze_trace on the train profile: busy "
                             f"{summary['busy']}, device ms {summary['device_ms']}, "
                             f"{traced_us:.1f} summed device us against the "
                             f"profiler's {device_us:.1f}")
    top_traced = sorted(summary["buckets"].items(), key=lambda kv: -kv[1])[:5]
    phase("train-profile", steps=PROFILE_STEPS, device_busy=f"{busy:.3f}",
          top_kernels=repr(top_kernels), top_ops=repr(top_ops),
          traced_busy=f"{summary['busy']:.3f}",
          traced_device_ms_per_step=f"{summary['device_ms'] / PROFILE_STEPS:.3f}",
          traced_top=repr([f"{k[:60]}:{ms / PROFILE_STEPS:.3f}ms/step"
                           for k, ms in top_traced]))
    return counts, routes


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def compare_grads(got_tree, want_tree):
    """bf16-sized gradient agreement, leaf by leaf: relative L2 error <=
    2e-2 and max error <= 5e-2 of the leaf's largest entry (the kernels'
    f32 sums in another order than the plain versions', and bf16 operands
    whose f32 inputs differ in the last bit, each flip a bf16 rounding:
    2^-8).  Returns the worst relative L2 error."""
    import numpy as np
    want = dict(_leaves(want_tree))
    worst = 0.0
    for k, g in _leaves(got_tree):
        w = want[k]
        scale = np.linalg.norm(w)
        if scale == 0:
            if g.any():
                raise AssertionError(f"grad {k}: zero on one side only")
            continue
        err = g.astype(np.float64) - w
        rel = np.linalg.norm(err) / scale
        worst = max(worst, rel)
        if rel > 2e-2 or np.abs(err).max() > 5e-2 * np.abs(w).max():
            raise AssertionError(f"grad {k}: rel_l2 {rel:.3e} max "
                                 f"{np.abs(err).max() / np.abs(w).max():.3e}")
    return worst


def compare_step(loss_g, loss_c, grad_g, grad_c, par_g, par_c, lr):
    """One step's loss (rtol 1e-3), gradients (``compare_grads``) and
    updated parameters, card against CPU; returns (worst gradient relative
    L2, parameter entries that differ by more than 1e-6)."""
    import numpy as np
    if not np.isfinite(loss_g) or abs(loss_g - loss_c) > 1e-3 * abs(loss_c):
        raise AssertionError(f"loss card {loss_g} vs cpu {loss_c}")
    worst = compare_grads(grad_g, grad_c)
    # Adam's first update is lr * g / (|g| + eps): an entry moves by lr with
    # the sign of its gradient, so an entry whose gradient is ~0 may move by
    # up to lr either way on either side
    moved = 0
    want = dict(_leaves(par_c))
    for k, p in _leaves(par_g):
        d = np.abs(p - want[k])
        if d.max() > 2.1 * lr:
            raise AssertionError(f"param {k}: differs by {d.max()} > 2.1 lr")
        moved += int((d > 1e-6).sum())
    return worst, moved


def card_vs_cpu_step(cfg, dev):
    """One full-width MSE step on 16 rays, card vs CPU, same weights and
    draws."""
    import torch
    from instant_nvr_tpu_torch import bridge, run, train_net
    from instant_nvr_tpu_torch.renderer.inb_renderer import pair_budget
    from instant_nvr_tpu_torch.train.state import create_train_state
    from instant_nvr_tpu_torch.train.step import make_loss_weights, make_train_step
    cpu = torch.device("cpu")
    mspec, rspec, model_cpu = run.build(cfg, cpu, seed=0)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    step = make_train_step(mspec, rspec, make_loss_weights(cfg))
    batch = train_net.synthetic_batch(cfg, cpu, n_rays=16)
    gen = torch.Generator().manual_seed(1)
    S = rspec.n_samples
    draws = {"t_rand": torch.rand((16, S), generator=gen),
             "pair_noise": (torch.rand((pair_budget(mspec, rspec, 16 * S), 3),
                                       generator=gen) - 0.5) * rspec.pair_range}
    out = []
    for d, model in ((cpu, model_cpu), (dev, model_gpu)):
        state = create_train_state(cfg, model)
        _, stats = step(state, {k: v.to(d) for k, v in batch.items()},
                        draws={k: v.to(d) for k, v in draws.items()})
        out.append((float(stats["loss"]), bridge.tree_from_model(model, "grad"),
                    bridge.tree_from_model(model, "data")))
    (loss_c, grad_c, par_c), (loss_g, grad_g, par_g) = out
    worst, moved = compare_step(loss_g, loss_c, grad_g, grad_c, par_g, par_c,
                                cfg.train.lr)
    phase("train-cuda-vs-cpu", rays=16, loss_card=f"{loss_g:.6f}",
          loss_cpu=f"{loss_c:.6f}", worst_grad_rel_l2=f"{worst:.3e}",
          params_differing=moved,
          tol=repr("loss rtol 1e-3; grads bf16-sized; params <= 2.1 lr"))


def selfcheck(dev, knn, scatter, routes):
    """Phase 7: ``cuda_selfcheck.run_checks`` at its full sizes; raises on
    any failure or on a launch count other than its checks imply.  Returns
    the launch counts of the run."""
    from instant_nvr_tpu_torch.tools import cuda_selfcheck
    reset_counts(knn, scatter)
    checks = cuda_selfcheck.run_checks(dev)
    got = launch_counts(knn, scatter)
    for c in checks:
        phase("selfcheck", check=c.tag, ok=c.ok, line=repr(c.line))
    failures = [c.failure for c in checks if not c.ok]
    if failures:
        raise AssertionError(f"self-check failures: {failures}")
    # [1]: one fused and one unfused KNN; [1b], [1c]: one scatter per width;
    # [3]: 1 + 10 train steps
    steps = 1 + cuda_selfcheck.FULL["train"]["steps"]
    want = {"knn_blend": 1 + steps, "knn_topk": 1,
            "segmented_scatter_add": 2 + steps * routes["segmented"],
            "onehot_scatter_add": 2 + steps * routes["onehot"]}
    if got != want or scatter.exact_scatter_add.calls:
        raise AssertionError(f"self-check launches {got} != {want} (exact "
                             f"index_add_ calls {scatter.exact_scatter_add.calls})")
    train = [c for c in checks if c.tag == "[3]"][0].numbers
    phase("selfcheck", checks=len(checks), failures=0, launches=repr(got),
          train_ms_per_step=f"{train['ms_per_step']:.2f}")
    return got


PATCH_EPOCH_STEPS = 10
# the fake subject's frames: odd, so phase 10's two ranks evaluate uneven
# shards of the test split (one view)
FRAMES = 5
DP_DIR = os.path.join(HERE, "exps", "chip_smoke_dp")
DP_MODEL = os.path.join(DP_DIR, "model")      # phase 9's weights and budgets
DP_STEPS = 5
PATCH_PROFILE = (5, 10)       # the resumed run's (epoch 2's) last 5 steps


def patch_cfg(root, exp_dir, epochs, **extra):
    """inb_fake at full width on the subject at ``root``: 10 patch steps an
    epoch, inb_377's first two ``ratio`` stages on epochs 0 and 1."""
    from instant_nvr_tpu_torch.config import make_cfg
    cfg = make_cfg(os.path.join(HERE, "configs", "inb", "inb_fake.yaml"))
    data = {"data_root": root, "ann_file": os.path.join(root, "annots.npy")}
    return cfg.merged({
        "train_dataset": data, "val_dataset": data, "test_dataset": data,
        "smpl_meta": os.path.join(root, "smpl-meta"),
        "num_train_frame": FRAMES, "num_latent_code": FRAMES,
        "ep_iter": PATCH_EPOCH_STEPS, "train": {"epoch": epochs},
        "log_interval": 5,
        "training_stages": [{"ratio": 0.3, "_start": 0},
                            {"ratio": 0.5, "sample_focus": "head", "_start": 1}],
        "result_dir": exp_dir,
        "trained_model_dir": os.path.join(exp_dir, "trained_model"),
        "record_dir": os.path.join(exp_dir, "record"), **extra})


def check_patch_run(label, res, first_epoch, routes, knn, scatter):
    """Finite losses, the epochs run, and the launches against the
    routing of the steps taken."""
    import numpy as np
    steps = len(res.losses)
    got = launch_counts(knn, scatter)
    if not (steps and np.isfinite(res.losses).all()):
        raise AssertionError(f"{label}: losses {res.losses}")
    if [e.epoch for e in res.epochs] != list(range(first_epoch, first_epoch
                                                   + len(res.epochs))):
        raise AssertionError(f"{label}: epochs {[e.epoch for e in res.epochs]}")
    want = {"knn_blend": steps, "knn_topk": 0,
            "segmented_scatter_add": steps * routes["segmented"],
            "onehot_scatter_add": steps * routes["onehot"]}
    sorted_got, sorted_want = scatter.sorted_scatter_add.launches, steps * routes["sorted"]
    if got != want or sorted_got != sorted_want or routes["exact"] \
            or scatter.exact_scatter_add.calls:
        raise AssertionError(f"{label}: launches {got} != {want}, sorted {sorted_got} != "
                             f"{sorted_want} (exact index_add_ calls "
                             f"{scatter.exact_scatter_add.calls})")
    if sorted_want:
        got["sorted_scatter_add"] = sorted_got
    return got


def check_stager(cfg, dev, n_items=24):
    """The loop's staging path on the card: ``n_items`` patch items through
    the ``Prefetcher`` (4 producer threads) and the ``DeviceStager``
    (pinned copies on its side stream, the frame cache); after ``ready``
    every device tensor, read on the consumer's stream, must equal its
    host array."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.datasets.prefetch import DeviceStager, Prefetcher
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.train import loop
    from instant_nvr_tpu_torch.train.stages import stage_for_epoch
    ecfg = stage_for_epoch(cfg, 1)
    ds = TPoseDataset(ecfg, "train")
    cache = {}
    stager = DeviceStager(dev, lambda item, put: loop.device_batch(
        item, 0.1, put, cache=cache))
    pf = Prefetcher(lambda i: ds.get_item(i % len(ds), ratio=ecfg.ratio,
                                          rng=np.random.default_rng(i)),
                    range(n_items), depth=8, device_put=stager, workers=4)
    checked = 0
    try:
        for staged in pf:
            item, batch = stager.ready(staged)
            for k, t in batch.items():
                want = np.float32(0.1) if k == "reg_dist_weight" else item[k]
                if not np.array_equal(t.cpu().numpy(), want):
                    raise AssertionError(f"stager: {k} differs from the host item")
                checked += 1
    finally:
        pf.close()
    phase("patch-stager", items=n_items, tensors_checked=checked,
          cached_frames=len(cache["_frames"]), check="device == host after ready")


def capture_patch_inputs(cfg, state, dev):
    """The kernel inputs of one patch step (a ratio-0.5 item of the
    subject): ('knn', (query, part_pts, part_pbw, lengths)) and
    (route, (keys, payload, n_rows, level_offsets)) per call."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.ops import hashgrid as hg
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train import loop
    from instant_nvr_tpu_torch.train.stages import stage_for_epoch
    from instant_nvr_tpu_torch.train.step import make_loss_weights, make_train_step
    ecfg = stage_for_epoch(cfg, 1)
    item = TPoseDataset(ecfg, "train").get_item(0, ratio=ecfg.ratio,
                                                rng=np.random.default_rng(3))
    batch = loop.device_batch(item, 0.1, lambda v: torch.as_tensor(np.asarray(v),
                                                                   device=dev))
    mspec = inb.build_model_spec(cfg)
    step = make_train_step(mspec, make_render_spec(cfg), make_loss_weights(cfg),
                           loop.make_patch_loss_fn(cfg))
    calls, kernels, blend = [], dict(hg._SCATTER), inb.knn_blend

    def spy_knn(query, part_pts, part_pbw, lengths, **kw):
        calls.append(("knn", (query.clone(), part_pts, part_pbw, lengths)))
        return blend(query, part_pts, part_pbw, lengths, **kw)

    def spy(route):
        def call(keys, payload, n_rows, level_offsets):
            calls.append((route, (keys.clone(), payload.clone(), n_rows,
                                  tuple(level_offsets))))
            return kernels[route](keys, payload, n_rows, level_offsets)
        return call
    inb.knn_blend = spy_knn
    hg._SCATTER.update({route: spy(route) for route in kernels})
    try:
        step(state, batch, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        inb.knn_blend = blend
        hg._SCATTER.update(kernels)
    return calls


def patch_kernel_cases(calls, knn, scatter):
    """Each kernel against its plain version on the patch step's own
    inputs (each table's largest call): {kernel: result tuple}."""
    seg = (scatter.segmented_scatter_add, scatter.segmented_scatter_add_plain)
    one = (scatter.onehot_scatter_add, scatter.onehot_scatter_add_plain)
    out = {}
    for route, args in calls:
        if route == "knn":
            out["knn_blend"] = knn_case("patch-step", args, knn)
    for kernel, route, fns in (("segmented_scatter_add", "segmented", seg),
                               ("onehot_scatter_add", "onehot", one)):
        mine = [a for r, a in calls if r == route]
        if not mine:
            continue
        keys, payload, n_rows, offs = max(mine, key=lambda a: a[0].shape[0])
        out[kernel] = scatter_case(f"patch-step-{route}", *fns, keys, payload,
                                   n_rows, offs)
    return out


def card_vs_cpu_patch_step(cfg, dev, label="patch-cuda-vs-cpu"):
    """One full-width patch step at patch_size 16 (256 rays), card vs CPU,
    same weights, batch and draws, at the train-cuda-vs-cpu tolerances."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import bridge, run
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.train import loop
    from instant_nvr_tpu_torch.train.state import create_train_state
    from instant_nvr_tpu_torch.train.stages import stage_for_epoch
    from instant_nvr_tpu_torch.train.step import (draw_render, make_loss_weights,
                                                  make_train_step)
    cfg = cfg.merged({"patch_size": 16})
    cpu = torch.device("cpu")
    ecfg = stage_for_epoch(cfg, 1)
    item = TPoseDataset(ecfg, "train").get_item(1, ratio=ecfg.ratio,
                                                rng=np.random.default_rng(4))
    batch = loop.device_batch(item, 0.1, lambda v: torch.as_tensor(np.asarray(v)))
    mspec, rspec, model_cpu = run.build(cfg, cpu, seed=0)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    step = make_train_step(mspec, rspec, make_loss_weights(cfg),
                           loop.make_patch_loss_fn(cfg))
    draws = draw_render(mspec, rspec, 256, torch.Generator().manual_seed(1), cpu)
    out = []
    for d, model in ((cpu, model_cpu), (dev, model_gpu)):
        state = create_train_state(cfg, model)
        _, stats = step(state, {k: v.to(d) for k, v in batch.items()},
                        draws={k: v.to(d) for k, v in draws.items()})
        out.append((float(stats["loss"]), float(stats["patch_loss"]),
                    bridge.tree_from_model(model, "grad"),
                    bridge.tree_from_model(model, "data")))
    (loss_c, pl_c, grad_c, par_c), (loss_g, pl_g, grad_g, par_g) = out
    worst, moved = compare_step(loss_g, loss_c, grad_g, grad_c, par_g, par_c,
                                cfg.train.lr)
    phase(label, card=repr(nvidia_smi()), rays=256, loss_card=f"{loss_g:.6f}",
          loss_cpu=f"{loss_c:.6f}", lpips_card=f"{pl_g:.6f}", lpips_cpu=f"{pl_c:.6f}",
          worst_grad_rel_l2=f"{worst:.3e}", params_differing=moved,
          tol=repr("loss rtol 1e-3; grads bf16-sized; params <= 2.1 lr"))


def patch_slice(dev, knn, scatter):
    """Phase 8 (see the module doc).  Returns (launch counts of the two
    training runs, the steps they took, the kernels' patch-shape results)."""
    import shutil
    import torch
    from instant_nvr_tpu_torch.datasets.fake_zju import write_fake_dataset
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train import loop
    from instant_nvr_tpu_torch.train.checkpoint import STATE_FILE
    from instant_nvr_tpu_torch.train.step import table_grad_launches
    root = os.path.join(HERE, "data", "fake_zju_smoke")
    exp = os.path.join(HERE, "exps", "chip_smoke_patch")
    shutil.rmtree(exp, ignore_errors=True)
    t0 = time.perf_counter()
    write_fake_dataset(root, n_frames=FRAMES, n_views=3, n_verts=2000, H=512, W=512,
                       supersample=1)
    phase("patch-data", root=os.path.relpath(root, HERE), views=3, frames=FRAMES,
          side=512, verts=2000, supersample=1,
          seconds=f"{time.perf_counter() - t0:.2f}")
    cfg = patch_cfg(root, exp, epochs=2)
    routes = table_grad_launches(inb.build_model_spec(cfg), make_render_spec(cfg))
    n_rays = cfg.patch_size ** 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(knn, scatter)
    res = loop.train(cfg, dev, resume=False)
    counts = check_patch_run("patch train", res, 0, routes, knn, scatter)
    model_dir = cfg.trained_model_dir
    for tag in ("1", "latest"):
        if not os.path.isfile(os.path.join(model_dir, tag, STATE_FILE)):
            raise AssertionError(f"no checkpoint {tag}/{STATE_FILE} under {model_dir}")
    saved_step, state = res.state.step, res.state
    reset_counts(knn, scatter)
    res2 = loop.train(patch_cfg(root, exp, epochs=3), dev, resume=True,
                      profile_window=PATCH_PROFILE)
    resumed = check_patch_run("patch resume", res2, 2, routes, knn, scatter)
    if res2.state.step != saved_step + len(res2.losses):
        raise AssertionError(f"resume: step {res2.state.step} != saved "
                             f"{saved_step} + {len(res2.losses)}")
    peak = torch.cuda.max_memory_allocated()
    counts = {k: counts[k] + resumed[k] for k in counts}
    assert_workspace_zero("patch slice")
    epochs = res.epochs + res2.epochs
    for e in epochs:
        phase("patch-epoch", epoch=e.epoch, steps=e.steps, wall_s=f"{e.wall_s:.3f}",
              ms_per_step=f"{1000 * e.wall_s / e.steps:.2f}",
              data_wait_s=f"{e.data_s:.3f}",
              data_wait_share=f"{e.data_s / e.wall_s:.4f}")
    # ms a step: epoch 1, after the first steps and without the profiler
    ms = 1000 * epochs[1].wall_s / epochs[1].steps
    prof = res2.profile or {}
    losses = res.losses + res2.losses
    phase("patch-train", card=repr(nvidia_smi()), config="inb_fake (inb_377 widths)",
          rays=n_rays,
          samples=cfg.N_samples, steps=len(losses), epochs=len(epochs),
          ms_per_step=f"{ms:.2f}", patch_rays_per_sec=f"{1000 * n_rays / ms:.1f}",
          data_wait_share=[f"{e.data_s / e.wall_s:.4f}" for e in epochs],
          profile_steps=prof.get("steps"), profile_wall_s=prof.get("wall_s"),
          profile_device_s=prof.get("device_s"),
          device_busy=("not measured" if prof.get("busy") is None
                       else f"{prof['busy']:.3f}"),
          peak_mem_GB=f"{peak / 1e9:.3f}", loss_first=f"{losses[0]:.5f}",
          loss_last=f"{losses[-1]:.5f}", resumed_at_epoch=res2.epochs[0].epoch,
          resumed_from_step=saved_step, routes_per_step=repr(dict(routes)),
          launches=repr(counts))
    check_stager(cfg, dev)
    calls = capture_patch_inputs(cfg, state, dev)
    timed = patch_kernel_cases(calls, knn, scatter)
    assert_workspace_zero("patch kernel cases")
    del calls, state, res, res2
    card_vs_cpu_patch_step(cfg, dev)
    return counts, len(losses), timed


def capture_eval_chunk(renderer, model, item):
    """The ``knn_blend`` inputs of the first chunk of one render of
    ``item``: (query, part_pts, part_pbw, lengths)."""
    import torch
    from instant_nvr_tpu_torch.models import inb
    blend, first = inb.knn_blend, []

    def spy(query, part_pts, part_pbw, lengths, **kw):
        if not first:
            first.append((query.clone(), part_pts, part_pbw, lengths))
        return blend(query, part_pts, part_pbw, lengths, **kw)
    inb.knn_blend = spy
    try:
        renderer(model, item)
        torch.cuda.synchronize()
    finally:
        inb.knn_blend = blend
    return first[0]


def spy_frame_launches(knn):
    """Wrap ``AutoBudgetRenderer.__call__`` so that each render appends the
    change of ``knn_blend``'s launch counter across it to the returned
    list; returns (that list, a function that removes the wrapper)."""
    from instant_nvr_tpu_torch.eval import runner
    call, seen = runner.AutoBudgetRenderer.__call__, []

    def spy(self, *args, **kw):
        before = knn.knn_blend.launches
        out = call(self, *args, **kw)
        seen.append(knn.knn_blend.launches - before)
        return out
    runner.AutoBudgetRenderer.__call__ = spy
    return seen, lambda: setattr(runner.AutoBudgetRenderer, "__call__", call)


def check_eval_run(label, r, counts):
    """The launches of an evaluate run: one ``knn_blend`` per chunk
    rendered, no other kernel."""
    want = {"knn_blend": r["chunks_rendered"], "knn_topk": 0,
            "segmented_scatter_add": 0, "onehot_scatter_add": 0}
    if counts != want or not r["chunks_rendered"]:
        raise AssertionError(f"{label}: launches {counts} != {want}")


def eval_slice(dev, knn, scatter):
    """Phase 9 (see the module doc) on phase 8's checkpoint.  Returns (the
    launch counts of the evaluate run, ``knn_blend``'s eval-chunk case and
    its launches per eval frame)."""
    import glob
    import shutil
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.eval import evaluator, mesh, runner, video
    from instant_nvr_tpu_torch.tools import profile_eval
    from instant_nvr_tpu_torch.train import checkpoint, loop
    from instant_nvr_tpu_torch.train.step import table_grad_launches
    root = os.path.join(HERE, "data", "fake_zju_smoke")
    exp = os.path.join(HERE, "exps", "chip_smoke_patch")
    # the test split (view 2) at 512^2, every frame
    cfg = patch_cfg(root, exp, epochs=3, eval_ratio=1.0,
                    test={"frame_sampler_interval": 1}).replace(eval=True)
    budgets = runner.budgets_path(cfg)
    for path in glob.glob(budgets + "*"):
        os.remove(path)
    # phase 8's weights, loaded without run.load's random-init fallback:
    # raises when the checkpoint is missing
    mspec, rspec, model = run.build(cfg, dev, seed=0)
    checkpoint.load_weights(cfg.trained_model_dir, model)

    # evaluate: every test item, the budgets raised on the first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(knn, scatter)
    seen, unspy = spy_frame_launches(knn)
    try:
        r = run.run_evaluate(cfg, dev, seed=0)
    finally:
        unspy()
    counts = launch_counts(knn, scatter)
    check_eval_run("evaluate", r, counts)
    peak = torch.cuda.max_memory_allocated()
    if not os.path.isfile(budgets):
        raise AssertionError(f"no {budgets} after the evaluation")
    # phase 10 evaluates these weights again over two ranks, from the
    # budgets this evaluation raised: keep both (the cadence epoch below
    # trains on, and a later evaluation rewrites metrics.npy)
    shutil.rmtree(DP_MODEL, ignore_errors=True)
    shutil.copytree(os.path.join(cfg.trained_model_dir, "latest"),
                    os.path.join(DP_MODEL, "latest"))
    shutil.copy(budgets, DP_MODEL)
    with open(budgets) as f:
        raised = f.read()
    n_items = len(r["items"])
    rays = [it[1] for it in r["items"]]
    render_ms = [1000 * it[3] for it in r["items"]]
    metrics_ms = [1000 * it[4] for it in r["items"]]
    chunk = runner.eval_chunk(cfg)
    per_frame = [runner.padded_chunks(n, chunk) for n in rays]
    # each frame's launches as read from the counter: at least one a chunk,
    # more on a frame whose budgets were raised and rendered again
    if len(seen) != n_items or sum(seen) != counts["knn_blend"] \
            or any(s < p for s, p in zip(seen, per_frame)):
        raise AssertionError(f"evaluate: knn_blend launches per frame {seen}, "
                             f"chunks per frame {per_frame}")
    warm = float(np.median(render_ms[1:]))
    saved = np.load(os.path.join(cfg.result_dir, "metrics.npy"), allow_pickle=True).item()
    shutil.copy(os.path.join(cfg.result_dir, "metrics.npy"), DP_MODEL)
    pngs = glob.glob(os.path.join(cfg.result_dir, "comparison", "*.png"))
    if n_items != FRAMES or len(pngs) != 3 * n_items or len(saved["psnr"]) != n_items \
            or not np.isfinite([r[k] for k in ("psnr", "ssim", "lpips")]).all():
        raise AssertionError(f"evaluate: {n_items} items, {len(pngs)} PNGs, "
                             f"metrics {r}")
    phase("eval", card=repr(nvidia_smi()), config="inb_fake (inb_377 widths), 3 epochs",
          items=n_items, side=512, rays_per_frame=rays, chunk=chunk,
          chunks_per_frame=per_frame, chunks_rendered=r["chunks_rendered"],
          knn_launches=counts["knn_blend"], knn_launches_per_frame=seen,
          render_ms=[f"{t:.1f}" for t in render_ms],
          metrics_ms=[f"{t:.1f}" for t in metrics_ms],
          warm_median_render_ms=f"{warm:.1f}",
          warm_ms_per_item=f"{float(np.median(np.add(render_ms, metrics_ms)[1:])):.1f}",
          rays_per_s=f"{float(np.median(rays[1:])) / (warm / 1000):.0f}",
          peak_mem_GB=f"{peak / 1e9:.3f}", psnr=f"{r['psnr']:.4f}",
          ssim=f"{r['ssim']:.4f}", lpips=f"{r['lpips']:.4f}",
          budgets=repr(raised))
    # a second evaluation starts from the saved budgets: no raise, so each
    # frame launches knn_blend exactly once a chunk
    reset_counts(knn, scatter)
    frame_launches, unspy = spy_frame_launches(knn)
    try:
        r2 = runner.evaluate_dataset(cfg, mspec, rspec, model, max_items=2,
                                     save_images=False)
    finally:
        unspy()
    check_eval_run("evaluate again", r2, launch_counts(knn, scatter))
    want = [runner.padded_chunks(it[1], chunk) for it in r2["items"]]
    if frame_launches != want:
        raise AssertionError(f"evaluate again: knn_blend launches per frame "
                             f"{frame_launches} != chunks {want}: a budget was "
                             f"raised again")
    phase("eval-again", items=len(r2["items"]), chunks_rendered=r2["chunks_rendered"],
          knn_launches_per_frame=frame_launches,
          render_ms=[f"{1000 * it[3]:.1f}" for it in r2["items"]], check="no raise")

    # eval card vs CPU: one test item at 32^2, same weights, plain versions
    # on the CPU
    small = cfg.merged({"eval_ratio": 1 / 16})
    item = TPoseDataset(small, "test").get_item(0)
    model_cpu = copy.deepcopy(model).cpu()
    out, psnr = [], []
    for d, m in ((dev, model), (torch.device("cpu"), model_cpu)):
        o = runner.AutoBudgetRenderer(mspec, rspec, chunk)(m, item)
        ev = evaluator.Evaluator(device=d)
        ev.evaluate(o["rgb_map"], item["rgb"], item["mask_at_box"], int(item["H"]),
                    int(item["W"]))
        out.append(o["rgb_map"])
        psnr.append(ev.psnr[0])
    diff = np.abs(out[0] - out[1])
    phase("eval-cuda-vs-cpu", rays=len(diff), max_abs_diff=f"{diff.max():.3e}",
          psnr_card=f"{psnr[0]:.5f}", psnr_cpu=f"{psnr[1]:.5f}",
          tol=repr("rgb rtol=atol=1e-3 (phase 4b); psnr 0.01 dB"))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-3, atol=1e-3)
    if abs(psnr[0] - psnr[1]) > 0.01:
        raise AssertionError(f"psnr card {psnr[0]} vs cpu {psnr[1]}")

    # profile one warm 512^2 item; then knn_blend on one of its chunks
    item = TPoseDataset(cfg, "test").get_item(0)
    renderer = runner.AutoBudgetRenderer(mspec, rspec, chunk, persist_path=budgets)
    prof = profile_eval.profile_item(renderer, model, item)
    phase("eval-profile", rays=prof["rays"], warm_ms=f"{prof['warm_ms']:.1f}",
          device_ms=fmt_ms(prof["device_ms"]),
          device_busy=("not measured" if prof["busy"] is None else f"{prof['busy']:.3f}"),
          top_kernels=repr([f"{n[:60]}:{ms:.2f}ms:x{c}" for n, ms, c in prof["top"]]))
    eval_knn = knn_case("eval-chunk", capture_eval_chunk(renderer, model, item), knn)

    # prune / tmesh / tdmesh: the cube on the card, the mesh on the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ, tb = mesh.occupancy_grid(cfg, mspec, model, item, False, res=128)
    cube_ms = 1000 * (time.perf_counter() - t0)      # ends in a copy to the host
    t0 = time.perf_counter()
    verts, faces = mesh.marching_tetrahedra(occ, mesh.ISO)
    mt_ms = 1000 * (time.perf_counter() - t0)
    run.run_prune(cfg, dev, seed=0)
    meshes = {d: run.run_tmesh(cfg, dev, 0, deformed=d) for d in (False, True)}
    for path in (os.path.join(cfg.result_dir, "latest.npy"),
                 os.path.join(cfg.result_dir, "tmesh", "latest.npy"),
                 os.path.join(cfg.result_dir, "tdmesh", "latest.npy")):
        c = np.load(path)
        if c.shape != (128, 128, 128) or not np.isfinite(c).all() \
                or c.min() < 0 or c.max() > 1:
            raise AssertionError(f"{path}: {c.shape}, [{c.min()}, {c.max()}]")
    small_occ = [mesh.occupancy_grid(cfg, mspec, m, item, False, res=32)[0]
                 for m in (model, model_cpu)]
    occ_diff = float(np.abs(small_occ[0] - small_occ[1]).max())
    phase("mesh", res=128, occupancy_ms=f"{cube_ms:.1f}",
          points_per_s=f"{128 ** 3 / (cube_ms / 1000):.0f}",
          occupancy_range=f"[{occ.min():.4f},{occ.max():.4f}]",
          marching_tetrahedra_host_ms=f"{mt_ms:.1f}",
          tmesh_verts_faces=(len(meshes[False][0]), len(meshes[False][1])),
          tdmesh_verts_faces=(len(meshes[True][0]), len(meshes[True][1])),
          occupancy_card_vs_cpu_res32=f"{occ_diff:.3e}", tol="atol 1e-5")
    if occ_diff > 1e-5:
        raise AssertionError(f"occupancy card vs cpu differs by {occ_diff}")
    del model_cpu, small_occ

    # bullet: 4 orbit views at 512^2
    t0 = time.perf_counter()
    frames = run.run_bullet(cfg.merged({"render_views": 4}), dev, seed=0)
    bullet_s = time.perf_counter() - t0
    if len(frames) != 4 or not all(os.path.isfile(f) for f in frames):
        raise AssertionError(f"bullet: frames {frames}")
    # ffmpeg's mp4 where it runs, else the port's mp4v writer's
    mp4 = video.read_mp4(os.path.join(cfg.result_dir, "novel_view.mp4"))
    if len(mp4["sample_sizes"]) != 4 or (mp4["width"], mp4["height"]) != (512, 512):
        raise AssertionError(f"bullet mp4: {mp4['sample_sizes']} {mp4['width']}x{mp4['height']}")
    phase("bullet", views=4, side=512, ms_per_view=f"{1000 * bullet_s / 4:.1f}",
          pngs=len(frames), ffmpeg=shutil.which("ffmpeg") is not None,
          mp4_codec=mp4["codec"], mp4_samples=len(mp4["sample_sizes"]))

    # the loop's cadence: a fourth epoch of 10 steps with validation,
    # visualization and the pruning cube after it
    latest = os.path.join(cfg.result_dir, "latest.npy")
    before = os.path.getmtime(latest)
    lcfg = patch_cfg(root, exp, epochs=4, eval_ep=1, vis_ep=1, prune_using_geo=True)
    routes = table_grad_launches(mspec, rspec)
    reset_counts(knn, scatter)
    res = loop.train(lcfg, dev, resume=True)
    got = launch_counts(knn, scatter)
    steps = len(res.losses)
    if [e.epoch for e in res.epochs] != [3] or not np.isfinite(res.losses).all() \
            or got["segmented_scatter_add"] != steps * routes["segmented"] \
            or got["onehot_scatter_add"] != steps * routes["onehot"] \
            or got["knn_blend"] < steps + 2:
        raise AssertionError(f"cadence epoch: {res.epochs}, launches {got}")
    for path in (os.path.join(exp, "metrics_epoch3.npy"),
                 os.path.join(exp, "comparison_epoch3", "frame0000_view0002.png")):
        if not os.path.isfile(path):
            raise AssertionError(f"no {path} after the cadence epoch")
    if not os.path.getmtime(latest) > before:
        raise AssertionError(f"{latest} was not rewritten")
    e = res.epochs[0]
    phase("cadence", epoch=e.epoch, steps=e.steps, steps_s=f"{e.wall_s:.3f}",
          cube_s=f"{e.cube_s:.3f}", validation_and_vis_s=f"{e.eval_s:.3f}",
          launches=repr(got))
    assert_workspace_zero("eval slice")
    return counts, eval_knn, frame_launches

def _tree_of(mspec, state_dict):
    """The JAX-named tree of a state dict (a gradient's unused tables as
    zeros), on the host."""
    import torch
    from instant_nvr_tpu_torch import bridge
    from instant_nvr_tpu_torch.models import inb
    model = inb.InbModel(mspec, "cpu")
    full = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    model.load_state_dict(dict(full, **state_dict))
    return bridge.tree_from_model(model, "data")


def _no_overflow(cfg, inputs, dev, world=2, raises=4):
    """(``cfg`` with budgets raised by ``eval/runner.py:raise_budgets`` until
    the first step's forward overflows nothing, in one process on the whole
    batch and on each rank's slice, its model spec): only then do the
    ranks select the points one process selects (ROADMAP.md §C)."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.eval.runner import raise_budgets
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.parallel import mesh as pmesh
    from instant_nvr_tpu_torch.renderer.inb_renderer import (make_render_spec,
                                                              pair_budget, render_rays)
    rspec = make_render_spec(cfg)
    t_rand = inputs["draws"]["t_rand"].to(dev)
    for _ in range(raises + 1):
        mspec = inb.build_model_spec(cfg)
        model = inb.InbModel(mspec, dev)
        model.load_state_dict(inputs["state"])
        worst, over = None, 0.0
        for r, w in [(0, 1)] + [(r, world) for r in range(world)]:
            b = pmesh.shard_batch(inputs["batch"], r, w)
            b = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in b.items()}
            n = b["ray_o"].shape[0]
            d = {"t_rand": t_rand[r * n:(r + 1) * n], "pair_noise": torch.zeros(
                pair_budget(mspec, rspec, n * rspec.n_samples), 3, device=dev)}
            with torch.no_grad():
                ret = render_rays(mspec, rspec, model, b, train=True, draws=d)
            over += float(ret["cull_overflow"]) + float(ret["part_overflow"])
            need = (float(ret["cull_need"]), ret["part_need"].cpu().numpy())
            worst = need if worst is None else (max(worst[0], need[0]),
                                                np.maximum(worst[1], need[1]))
        if over == 0:
            return cfg, mspec
        raised = raise_budgets(mspec, *worst)
        cfg = cfg.merged({"cull_budget": raised.cull_frac,
                          "part_budget": raised.part_frac,
                          "part_budget_scales": list(raised.part_budget_scales)})
    raise AssertionError(f"budgets still overflow after {raises} raises")


def dp_step_case(label, cfg, batch, dev, seed):
    """One full-width step in one process on the card against two Gloo
    ranks on the same card (``DP_STEPS`` steps, the first compared), from
    the same weights (random, from ``seed``) and draws.  Returns the ranks'
    results."""
    import torch
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.tools import multiprocess_check as mc
    from instant_nvr_tpu_torch.train.step import draw_render, table_grad_launches
    cpu = torch.device("cpu")
    mspec, rspec, model = run.build(cfg, cpu, seed=seed)
    n_rays = len(batch["ray_o"])
    gen = torch.Generator().manual_seed(seed + 1)
    inputs = {"state": model.state_dict(), "batch": batch, "seed": seed + 2,
              "steps": DP_STEPS, "draws": draw_render(mspec, rspec, n_rays, gen, cpu)}
    cfg, mspec = _no_overflow(cfg, inputs, dev)
    # the pair offsets of the raised budgets' pair budget, after the jitter
    inputs["draws"] = draw_render(mspec, rspec, n_rays, gen.manual_seed(seed + 1), cpu)
    inputs["cfg"] = cfg.to_dict()
    routes = table_grad_launches(mspec, make_render_spec(cfg))
    work = os.path.join(DP_DIR, label)
    os.makedirs(work, exist_ok=True)
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    t0 = time.perf_counter()
    ranks = mc.launch("step", 2, work, device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    one = mc.case_step(dict(inputs, steps=1), dev)
    if one["stats0"]["cull_overflow"] or one["stats0"]["part_overflow"]:
        raise AssertionError(f"{label}: the one-process step overflowed")
    lr = cfg.train.lr
    worst, moved = compare_step(
        ranks[0]["losses"][0], one["losses"][0],
        _tree_of(mspec, ranks[0]["grads0"]), _tree_of(mspec, one["grads0"]),
        _tree_of(mspec, ranks[0]["params0"]), _tree_of(mspec, one["params0"]), lr)
    steps = len(ranks[0]["losses"])
    want = {"knn_blend": steps, "segmented_scatter_add": steps * routes["segmented"],
            "onehot_scatter_add": steps * routes["onehot"]}
    for r in ranks:
        if r["losses"] != ranks[0]["losses"] or not r["equal"]:
            raise AssertionError(f"{label}: rank {r['rank']} losses {r['losses']} vs "
                                 f"{ranks[0]['losses']}, parameters equal {r['equal']}")
        if r["launches"] != want:
            raise AssertionError(f"{label}: rank {r['rank']} launches {r['launches']} "
                                 f"!= {want}")
    phase("dp-step", case=label, card=repr(nvidia_smi()), ranks=2, backend="gloo",
          rays=n_rays, rays_per_rank=n_rays // 2, samples=cfg.N_samples,
          budgets=f"cull {mspec.cull_frac:.4f} part {mspec.part_frac:.4f}",
          loss_2rank=f"{ranks[0]['losses'][0]:.6f}", loss_1proc=f"{one['losses'][0]:.6f}",
          worst_grad_rel_l2=f"{worst:.3e}", params_differing=moved,
          tol=repr("loss rtol 1e-3; grads bf16-sized; params <= 2.1 lr (phase 6)"),
          bit_equal_after=steps, steps=steps,
          ms_per_step=[[f"{t:.1f}" for t in r["ms"]] for r in ranks],
          ms_per_step_1proc=f"{one['ms'][0]:.1f}",
          allreduce_ms=[f"{r['allreduce_ms']:.2f}" for r in ranks],
          allreduce_MB=f"{ranks[0]['allreduce_bytes'] / 1e6:.2f}",
          peak_mem_GB=[f"{r['peak_mem'] / 1e9:.3f}" for r in ranks],
          launches_per_rank=repr([r["launches"] for r in ranks]),
          wall_s=f"{wall:.1f}")
    return ranks


def dp_slice(dev, knn, scatter):
    """Phase 10 (see the module doc).  Returns each rank's launches, per
    kernel, over the phase's runs."""
    import glob
    import shutil
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.datasets.samplers import shard_indices
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.tools import multiprocess_check as mc
    from instant_nvr_tpu_torch.train import loop
    from instant_nvr_tpu_torch.train.step import table_grad_launches
    for d in glob.glob(os.path.join(DP_DIR, "*")):
        if os.path.abspath(d) != DP_MODEL:
            shutil.rmtree(d, ignore_errors=True)
    per_rank = [dict.fromkeys(("knn_blend", "segmented_scatter_add",
                               "onehot_scatter_add"), 0) for _ in range(2)]

    def add(ranks):
        for acc, r in zip(per_rank, ranks):
            for k in acc:
                acc[k] += r["launches"][k]

    cpu = torch.device("cpu")
    # the MSE step: inb_377 on the synthetic batch, 1,024 rays x 64 samples
    # (phase 5's step: the image MSE, not the config's patch loss)
    cfg = make_cfg(CFG).merged({"use_lpips": False})
    batch = {k: v.numpy() for k, v in train_net.synthetic_batch(cfg, cpu).items()}
    add(dp_step_case("mse", cfg, batch, dev, seed=0))
    # the patch step: one 64x64 LPIPS patch (4,096 rays) of phase 8's subject
    root = os.path.join(HERE, "data", "fake_zju_smoke")
    pcfg = patch_cfg(root, os.path.join(DP_DIR, "patch_exp"), epochs=1)
    item = TPoseDataset(pcfg, "train").get_item(0, rng=np.random.default_rng(3))
    pbatch = {k: np.asarray(item[k]) for k in loop.DEVICE_KEYS if k in item}
    pbatch["reg_dist_weight"] = np.float32(0.1)
    add(dp_step_case("patch", pcfg, pbatch, dev, seed=10))
    routes = table_grad_launches(inb.build_model_spec(pcfg), make_render_spec(pcfg))

    # one NCCL rank through train_net --distributed: a few patch steps
    data = {"data_root": root, "ann_file": os.path.join(root, "annots.npy")}
    opts = []
    for split in ("train_dataset", "val_dataset", "test_dataset"):
        opts += [f"{split}.data_root", data["data_root"], f"{split}.ann_file",
                 data["ann_file"]]
    opts += ["smpl_meta", os.path.join(root, "smpl-meta"), "num_train_frame", str(FRAMES)]
    exp = os.path.join(DP_DIR, "nccl")
    work = os.path.join(DP_DIR, "nccl_run")
    os.makedirs(work)
    torch.save({"module": "train_net", "argv": [
        "--cfg_file", os.path.join(HERE, "configs", "inb", "inb_fake.yaml"),
        "--device", "cuda", "--distributed", "--no_resume", *opts,
        "ep_iter", "3", "train.epoch", "1", "eval_ep", "100", "result_dir", exp,
        "trained_model_dir", os.path.join(exp, "model"),
        "record_dir", os.path.join(exp, "record")]}, os.path.join(work, "inputs.pt"))
    t0 = time.perf_counter()
    (nccl,) = mc.launch("cli", 1, work, device="cuda", backend=None, timeout=300)
    want = {"knn_blend": 3, "segmented_scatter_add": 3 * routes["segmented"],
            "onehot_scatter_add": 3 * routes["onehot"]}
    if nccl["backend"] != "nccl" or nccl["launches"] != want or nccl["epochs"] != [0] \
            or not np.isfinite(nccl["losses"]).all():
        raise AssertionError(f"nccl rank: {nccl}")
    phase("dp-nccl", card=repr(nvidia_smi()), ranks=1, backend=nccl["backend"],
          entry="train_net --distributed", config="inb_fake (inb_377 widths), patch LPIPS",
          steps=len(nccl["losses"]), losses=[f"{x:.5f}" for x in nccl["losses"]],
          ms_per_step=[f"{x:.1f}" for x in nccl["ms_per_step"]],
          launches=repr(nccl["launches"]), wall_s=f"{time.perf_counter() - t0:.1f}")
    per_rank[0] = {k: v + nccl["launches"][k] for k, v in per_rank[0].items()}

    # run --type evaluate over two Gloo ranks on phase 9's weights and
    # budgets: its metrics.npy against phase 9's one-process file
    work = os.path.join(DP_DIR, "eval_run")
    os.makedirs(work)
    res = os.path.join(DP_DIR, "eval")
    torch.save({"module": "run", "argv": [
        "--cfg_file", os.path.join(HERE, "configs", "inb", "inb_fake.yaml"),
        "--type", "evaluate", "--device", "cuda:0", "--distributed", *opts,
        "eval_ratio", "1.0", "test.frame_sampler_interval", "1",
        "result_dir", res, "trained_model_dir", DP_MODEL]},
        os.path.join(work, "inputs.pt"))
    t0 = time.perf_counter()
    ev = mc.launch("cli", 2, work, device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    (path,) = glob.glob(os.path.join(res, "**", "metrics.npy"), recursive=True)
    got = np.load(path, allow_pickle=True).item()
    want = np.load(os.path.join(DP_MODEL, "metrics.npy"), allow_pickle=True).item()
    diff = {k: float(np.max(np.abs(np.subtract(got[k], want[k]))))
            for k in want if len(got[k]) == len(want[k])}
    if len(got["psnr"]) != FRAMES or len(diff) != 4 or diff["psnr"] > 1e-4 \
            or max(diff["mse"], diff["ssim"], diff["lpips"]) > 1e-6:
        raise AssertionError(f"2-rank metrics {got} vs phase 9's {want}")
    if any(os.path.basename(p) == "metrics.npy" for p in ev[1]["writes"]):
        raise AssertionError("rank 1 wrote metrics.npy")
    counts = [r["launches"] for r in ev]
    if any(c["knn_blend"] == 0 or c["segmented_scatter_add"] or c["onehot_scatter_add"]
           for c in counts):
        raise AssertionError(f"evaluate ranks' launches {counts}")
    add(ev)
    phase("dp-evaluate", card=repr(nvidia_smi()), ranks=2, backend="gloo",
          items=FRAMES, shards=[len(shard_indices(list(range(FRAMES)), r, 2, pad=False))
                                for r in range(2)], side=512,
          bit_equal=all(np.array_equal(got[k], want[k], equal_nan=True) for k in want),
          max_abs_diff=repr(diff), tol=repr("psnr 1e-4 dB; mse, ssim, lpips 1e-6"),
          psnr=[f"{x:.5f}" for x in got["psnr"]], launches_per_rank=repr(counts),
          wall_s=f"{wall:.1f}")
    return per_rank


REAL_ROOT = os.path.join(HERE, "data", "fake_zju_jpeg_smoke")
REAL_DIR = os.path.join(HERE, "exps", "chip_smoke_real")
REAL_STEPS = 10
BIG_JPEG = "subject_1024_q95_420.jpg"      # a committed 1024^2 JPEG fixture


def host_ms(fn, n=10):
    """Median host wall ms of ``fn`` over ``n`` calls after one warm call."""
    import numpy as np
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1000 * (time.perf_counter() - t0))
    return float(np.median(times))


def write_filtered_png(path, img):
    """``img`` (H, W) or (H, W, C) uint8 as a PNG whose rows cycle through
    the five row filters (the port writes unfiltered PNGs only; capture
    masks are filtered), so reading it runs every unfilter."""
    import struct
    import zlib
    import numpy as np
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    raw = img.reshape(H, W * C).astype(np.int32)
    zc = np.zeros((H, C), np.int32)
    up = np.vstack([np.zeros((1, W * C), np.int32), raw[:-1]])
    left = np.hstack([zc, raw[:, :-C]])
    ul = np.hstack([zc, up[:, :-C]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    kind = np.arange(H) % 5
    pred = np.choose(np.broadcast_to(kind[:, None], raw.shape),
                     [np.zeros_like(raw), left, up, (left + up) >> 1, paeth])
    rows = np.concatenate([kind[:, None], (raw - pred) & 255], 1).astype(np.uint8)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    ctype = {1: 0, 3: 2, 4: 6}[C]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def unfilter_numpy(rows, bpp):
    """The PNG unfilter as the port's reader did it before the host decoder:
    numpy, one anti-diagonal of pixels at a time (its plain version)."""
    import numpy as np
    H = rows.shape[0]
    raw = rows[:, 1:].reshape(H, -1, bpp).astype(np.int32)
    filters = rows[:, 0]
    W = raw.shape[1]
    X = np.zeros((H + 1, W + 1, bpp), np.int32)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H, d + 1))
        x = d - r
        a, b, c = X[r + 1, x], X[r, x + 1], X[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = filters[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        X[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return X[1:, 1:].astype(np.uint8).reshape(H, -1)


def synthetic_smpl(root, n_verts=300, seed=0):
    """A small SMPL-like model pickle, two frames of SMPL params and
    vertices under ``root`` and a UV .obj -> (pickle path, obj path)."""
    import pickle
    import numpy as np
    import scipy.sparse
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_verts, 3)) * [0.2, 0.5, 0.1]
    faces = np.array([rng.choice(n_verts, 3, replace=False) for _ in range(2 * n_verts)])
    w = rng.random((n_verts, 24))
    w /= w.sum(1, keepdims=True)
    jreg = rng.random((24, n_verts)) * (rng.random((24, n_verts)) < 0.1)
    jreg /= np.maximum(jreg.sum(1, keepdims=True), 1e-9)
    parents = np.concatenate([[4294967295], np.maximum(np.arange(23) - 2, 0)])
    smpl = {"v_template": v, "shapedirs": rng.normal(size=(n_verts, 3, 10)) * 0.01,
            "J_regressor": scipy.sparse.csc_matrix(jreg), "weights": w,
            "kintree_table": np.stack([parents, np.arange(24)]).astype(np.int64),
            "f": faces.astype(np.uint32)}
    os.makedirs(root, exist_ok=True)
    pkl = os.path.join(root, "smpl.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(smpl, f)
    for d in ("smpl_params", "smpl_vertices"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(2):
        params = {"poses": rng.normal(size=(1, 72)) * 0.3, "Rh": rng.normal(size=(1, 3)),
                  "Th": rng.normal(size=(1, 3)), "shapes": rng.normal(size=(1, 10))}
        np.save(os.path.join(root, "smpl_params", f"{i}.npy"), params)
        np.save(os.path.join(root, "smpl_vertices", f"{i}.npy"),
                v + rng.normal(size=v.shape) * 0.01)
    obj = os.path.join(root, "uv.obj")
    with open(obj, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in v)
        f.writelines(f"vt {a:.6f} {b:.6f}\n" for a, b in rng.random((n_verts, 2)))
        f.writelines(f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}\n"
                     for a, b, c in faces)
    return pkl, obj


def real_slice(dev, knn, scatter):
    """Phase 11 (see the module doc).  Returns the launch counts of its
    training run and render."""
    import hashlib
    import json
    import shutil
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.datasets import fake_zju, image_ops, jpeg
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.eval import runner
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.tools import import_torch_ckpt, prepare_dataset
    from instant_nvr_tpu_torch.train import checkpoint, loop
    from instant_nvr_tpu_torch.train.state import AdamBf16Mu, OptaxAdam, make_optimizer
    from instant_nvr_tpu_torch.train.step import table_grad_launches
    shutil.rmtree(REAL_DIR, ignore_errors=True)
    os.makedirs(REAL_DIR)

    # the committed JPEG fixtures against their recorded digests
    fx = fake_zju.JPEG_FIXTURES
    with open(os.path.join(fx, "digests.json")) as f:
        digests = json.load(f)
    for name, rec in digests["images"].items():
        img = image_ops.read_image(os.path.join(fx, name))
        got = [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]
        if got != [rec["shape"], rec["sha256"]]:
            raise AssertionError(f"{name}: decoded {got} != recorded {rec}")
    for name, what in digests["refused"].items():
        try:
            image_ops.read_image(os.path.join(fx, name))
        except ValueError as e:
            if name not in str(e) or what not in str(e):
                raise AssertionError(f"{name}: refused with {e!r}, expected {what!r}")
        else:
            raise AssertionError(f"{name}: decoded; it must be refused ({what})")
    # host decode times at 1024^2: the JPEG fixture, filtered PNGs
    with open(os.path.join(fx, BIG_JPEG), "rb") as f:
        data = f.read()
    big = jpeg.decode_jpeg(data, BIG_JPEG)
    jpeg_ms = host_ms(lambda: jpeg.decode_jpeg(data, BIG_JPEG))
    pngs = {}
    for kind, img in (("gray", big[..., 1]), ("rgb", big)):
        path = os.path.join(REAL_DIR, f"filtered_{kind}.png")
        write_filtered_png(path, img)
        if not np.array_equal(image_ops.read_png(path), img):
            raise AssertionError(f"filtered {kind} PNG does not read back")
        # the unfilter alone: the C++ pass and the numpy loop it replaced
        C = 1 if img.ndim == 2 else 3
        rows = np.concatenate([(np.arange(img.shape[0]) % 5)[:, None].astype(np.uint8),
                               img.reshape(img.shape[0], -1)], 1)
        if not np.array_equal(jpeg.png_unfilter(rows, C), unfilter_numpy(rows, C)):
            raise AssertionError(f"{kind}: the C++ unfilter differs from the numpy loop")
        pngs[kind] = (host_ms(lambda: image_ops.read_png(path)),
                      host_ms(lambda: jpeg.png_unfilter(rows, C)),
                      host_ms(lambda: unfilter_numpy(rows, C), n=3))
    phase("real-decode", images=len(digests["images"]), refused=len(digests["refused"]),
          check="sha256 of the pixels == digests.json",
          jpeg_1024_host_ms=f"{jpeg_ms:.2f}", jpeg_bytes=len(data),
          **{f"png_1024_{k}_{what}_host_ms": f"{v[i]:.2f}" for k, v in pngs.items()
             for i, what in enumerate(("read", "unfilter", "numpy_unfilter"))})

    # the JPEG subject: one epoch of full-width patch-LPIPS steps with the
    # bf16 first moment
    t0 = time.perf_counter()
    shutil.rmtree(REAL_ROOT, ignore_errors=True)
    fake_zju.write_jpeg_subject(REAL_ROOT)
    n = fake_zju.JPEG_SUBJECT["n_frames"]
    cfg = patch_cfg(REAL_ROOT, REAL_DIR, epochs=1, num_train_frame=n, num_latent_code=n,
                    training_view=[0], test_view=[1], ep_iter=REAL_STEPS,
                    training_stages=[{"ratio": 0.5, "_start": 0}],
                    train={"epoch": 1, "moment_dtype": "bfloat16"})
    write_s = time.perf_counter() - t0
    mspec, rspec = inb.build_model_spec(cfg), make_render_spec(cfg)
    routes = table_grad_launches(mspec, rspec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(knn, scatter)
    res = loop.train(cfg, dev, resume=False)
    counts = check_patch_run("real-subject train", res, 0, routes, knn, scatter)
    peak = torch.cuda.max_memory_allocated()
    opt = res.state.optimizer
    moments = [(st["exp_avg"].dtype, st["exp_avg_sq"].dtype) for st in opt.state.values()]
    n_params = sum(1 for _ in res.state.model.parameters())
    if not isinstance(opt, AdamBf16Mu) or not moments or \
            set(moments) != {(torch.bfloat16, torch.float32)}:
        raise AssertionError(f"moments {type(opt).__name__} {set(moments)} "
                             f"for {len(moments)} of {n_params} parameters")
    e = res.epochs[0]
    phase("real-train", card=repr(nvidia_smi()), config="inb_fake (inb_377 widths)",
          subject="JPEG fixtures, 2 views x 2 frames at 256^2, ratio 0.5",
          write_s=f"{write_s:.2f}", steps=e.steps, rays=cfg.patch_size ** 2,
          ms_per_step=f"{1000 * e.wall_s / e.steps:.2f}",
          data_wait_share=f"{e.data_s / e.wall_s:.4f}",
          moment_dtypes="exp_avg bfloat16, exp_avg_sq float32",
          params_with_moments=f"{len(moments)}/{n_params}",
          peak_mem_GB=f"{peak / 1e9:.3f}", loss_first=f"{res.losses[0]:.5f}",
          loss_last=f"{res.losses[-1]:.5f}", launches=repr(counts))

    # the same epoch with float32 moments, and one optimizer step of each
    # kind on the trained parameters (seeded gradients), alternated
    cfg32 = patch_cfg(REAL_ROOT, os.path.join(REAL_DIR, "f32"), epochs=1, num_train_frame=n,
                      num_latent_code=n, training_view=[0], test_view=[1], ep_iter=REAL_STEPS,
                      training_stages=[{"ratio": 0.5, "_start": 0}],
                      train={"epoch": 1, "moment_dtype": "float32"})
    reset_counts(knn, scatter)
    res32 = loop.train(cfg32, dev, resume=False)
    check_patch_run("real-subject train, float32 moments", res32, 0, routes, knn, scatter)
    if type(res32.state.optimizer) is not OptaxAdam:
        raise AssertionError(f"float32 moments: {type(res32.state.optimizer).__name__}")
    e32 = res32.epochs[0]
    del res32
    model = res.state.model
    gen = torch.Generator(device=dev).manual_seed(0)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype) * 1e-3
    opts = {"bf16": make_optimizer(cfg, model)[0], "f32": make_optimizer(cfg32, model)[0]}
    opt_ms = {k: [] for k in opts}
    for _ in range(3):
        for k, o in opts.items():
            opt_ms[k].append(cuda_median_ms(o.step))
    phase("real-moments", card=repr(nvidia_smi()), steps=e32.steps,
          ms_per_step_bf16=f"{1000 * e.wall_s / e.steps:.2f}",
          ms_per_step_f32=f"{1000 * e32.wall_s / e32.steps:.2f}",
          data_wait_share_f32=f"{e32.data_s / e32.wall_s:.4f}",
          params=sum(p.numel() for p in model.parameters()), tensors=n_params,
          opt_step_ms_bf16=[f"{t:.3f}" for t in opt_ms["bf16"]],
          opt_step_ms_f32=[f"{t:.3f}" for t in opt_ms["f32"]])
    del res, opt, opts, model

    # a reference-layout .pth at full width from seeded arrays, imported
    # through the tool's command line, loaded through load_weights
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
          for k, shape in import_torch_ckpt.reference_shapes(mspec).items()}
    pth = os.path.join(REAL_DIR, "latest.pth")
    torch.save({"net": {"net." + k: v for k, v in sd.items()}, "epoch": 0}, pth)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model_dir = os.path.join(REAL_DIR, "imported")
    import_torch_ckpt.main(["--cfg_file", os.path.join(HERE, "configs", "inb", "inb_fake.yaml"),
                            "--ckpt", pth, "--out", model_dir, "--epoch", "0",
                            "num_latent_code", str(n)])
    import_s = time.perf_counter() - t0
    model = inb.InbModel(mspec, device=dev)
    checkpoint.load_weights(model_dir, model, 0)
    want = import_torch_ckpt.convert(sd, mspec, model.state_dict())
    got = model.state_dict()
    for k in want:
        if not torch.equal(got[k].cpu(), want[k]):
            raise AssertionError(f"imported {k} differs from the mapping")
    occ = "tpose_human.part_networks.{}.occ.linears.0.weight"
    for i in range(mspec.num_parts):        # the mapping itself, independently
        if not torch.equal(got["occ.0.w"][i].cpu(), sd[occ.format(i)].T):
            raise AssertionError(f"occ.0.w[{i}] is not the part's weight transposed")
    dense = sd["tpose_human.part_networks.0.embedder.dense"].double().mean(-1)
    np.testing.assert_allclose(got["embed.body.dense"].cpu().double().numpy(),
                               dense.numpy(), rtol=1e-6, atol=1e-6)
    floats = sum(v.numel() for v in sd.values())
    del sd, want

    # render one test item of the JPEG subject with the imported weights
    reset_counts(knn, scatter)
    item = TPoseDataset(cfg.replace(eval=True), "test").get_item(0)
    renderer = runner.AutoBudgetRenderer(mspec, rspec, runner.eval_chunk(cfg))
    t0 = time.perf_counter()
    out = renderer(model, item)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    rays = out["rgb_map"].shape[0]
    render = launch_counts(knn, scatter)
    if render["knn_blend"] != renderer.chunks_rendered or render["knn_blend"] == 0 \
            or render["segmented_scatter_add"] or render["onehot_scatter_add"]:
        raise AssertionError(f"render launches {render}, chunks {renderer.chunks_rendered}")
    rgb = out["rgb_map"]
    # a composite of colours in [0, 1] whose weights sum to 1 up to rounding
    if not (np.isfinite(rgb).all() and rgb.min() >= -1e-6 and rgb.max() <= 1 + 1e-6):
        raise AssertionError(f"render rgb not finite in [0, 1]: [{rgb.min()}, {rgb.max()}]")
    phase("real-import", ref_floats=floats, made_s=f"{made_s:.2f}",
          import_s=f"{import_s:.2f}", check="loaded state == mapping, bit for bit",
          render_rays=rays, render_chunks=renderer.chunks_rendered,
          render_ms=f"{1000 * render_s:.1f}", knn_launches=render["knn_blend"],
          rgb_range=f"[{rgb.min():.4f},{rgb.max():.4f}]")
    counts = {k: counts[k] + render[k] for k in counts}
    del model

    # dataset preparation on a small synthetic SMPL model
    prep = os.path.join(REAL_DIR, "prepare")
    pkl, obj = synthetic_smpl(prep)
    t0 = time.perf_counter()
    prepare_dataset.main(["--data_root", prep, "--smpl_pkl", pkl, "--uv_obj", obj,
                          "--frames", "0:2:1", "--voxel", "0.05"])
    prep_s = time.perf_counter() - t0
    vol = np.load(os.path.join(prep, "smpl_lbs", "bweights", "1.npy"))
    uv = np.load(os.path.join(prep, "bigpose_uv.npy"))
    if not (np.isfinite(vol).all() and np.allclose(vol[..., :24].sum(-1), 1, atol=1e-4)
            and np.isfinite(uv).all()):
        raise AssertionError("prepare_dataset: blend weights or UVs not valid")
    phase("real-prepare", vertices=300, frames=2, voxel=0.05, bw_volume=list(vol.shape),
          seconds=f"{prep_s:.2f}")
    return counts


ORBAX_DIR = os.path.join(HERE, "exps", "chip_smoke_orbax")
ORBAX_FIXTURES = os.path.join(HERE, "instant_nvr_tpu_torch", "train", "fixtures", "orbax")
ORBAX_STEP = 20               # the step and Adam count of the full-width checkpoint
ORBAX_PAD = 8                 # zero tile-padding rows added to every table
# the JAX package's packed storage: tables from kernel_min_rows rows up (the
# TPU's 190,000), padded to its scatter kernel's 65,536-row tile
JAX_PACK_ROWS, JAX_TILE_ROWS = 190_000, 65536


def leaf_digests(tree):
    """{dotted key path: sha256, shape, dtype} of a read orbax tree (bf16
    leaves by their bits), as ``digests.json`` records them."""
    import hashlib
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.train import orbax_format
    out = {}
    for path, _, v in orbax_format.leaves(tree):
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            x, dt = v.view(torch.uint16).numpy(), "bfloat16"
        else:
            x, dt = np.asarray(v), np.asarray(v).dtype.name
        out[".".join(path)] = {"sha256": hashlib.sha256(np.ascontiguousarray(x).tobytes())
                               .hexdigest(), "shape": list(x.shape), "dtype": dt}
    return out


def seeded_jax_tree(mspec, dev, packed=False):
    """A full-width JAX-layout train state from seeded arrays: the port's
    seed-0 parameters and seeded Adam moments as JAX parameter trees, every
    table with ORBAX_PAD zero rows, step and count ORBAX_STEP, meta epoch 0.
    ``packed``: a table the JAX package stores packed (F < 128 features,
    128 % F == 0, from JAX_PACK_ROWS rows up) is padded with zero rows to
    its JAX_TILE_ROWS tile and stored as ``flat.reshape(-1, 128)``
    (``instant_nvr_tpu/ops/hashgrid.py:_is_packed``, ``_pad_rows``).
    Returns (tree, params, mu, nu) with the unpadded trees."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import bridge
    from instant_nvr_tpu_torch.models import inb
    params = bridge.tree_from_model(inb.init_params(
        mspec, torch.Generator(device=dev).manual_seed(0), dev))
    rng = np.random.default_rng(0)

    def like(tree, f):
        if isinstance(tree, dict):
            return {k: like(v, f) for k, v in tree.items()}
        if isinstance(tree, list):
            return [like(v, f) for v in tree]
        return f(tree)
    mu = like(params, lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 1e-4)
    nu = like(params, lambda a: np.abs(rng.standard_normal(a.shape, dtype=np.float32)) * 1e-6)

    def pad(tree):
        out = like(tree, lambda a: a)
        tables = [out["embed"][p] for p in out["embed"]] + [out["deformer"]["embed"]]
        for t in tables:
            for k in ("dense", "hash"):
                rows, F = t[k].shape[0], (t[k].shape[1] if t[k].ndim == 2 else 0)
                pack = packed and 0 < F < 128 and 128 % F == 0 and rows >= JAX_PACK_ROWS
                n_pad = -rows % JAX_TILE_ROWS if pack else ORBAX_PAD
                t[k] = np.concatenate([t[k], np.zeros((n_pad,) + t[k].shape[1:],
                                                      t[k].dtype)])
                if pack:
                    t[k] = t[k].reshape(-1, 128)
        return out
    count = np.asarray(ORBAX_STEP, np.int32)
    tree = {"params": pad(params),
            "opt_state": [{"count": count, "mu": pad(mu), "nu": pad(nu)}, {"count": count}],
            "step": count, "meta": {"epoch": np.asarray(0, np.int64),
                                    "step": np.asarray(ORBAX_STEP, np.int64)}}
    return tree, params, mu, nu


def orbax_slice(dev, knn, scatter):
    """Phase 12 (see the module doc).  Returns the launch counts of its
    renders, resumed steps and evaluation."""
    import hashlib
    import json
    import shutil
    import tracemalloc
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import bridge, run, train_net
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.datasets import synthetic
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.eval import runner
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer import inb_renderer as rend
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.tools.make_fixtures import write_orbax_checkpoint
    from instant_nvr_tpu_torch.train import checkpoint, loop, orbax_format
    from instant_nvr_tpu_torch.train.step import table_grad_launches
    shutil.rmtree(ORBAX_DIR, ignore_errors=True)
    os.makedirs(ORBAX_DIR)
    with open(os.path.join(ORBAX_FIXTURES, "digests.json")) as f:
        digests = json.load(f)

    # the zstd corpus that tensorstore wrote, to its digests; the host
    # decode rate on the largest frames
    frames = {}
    for name, rec in digests["corpus"].items():
        with open(os.path.join(ORBAX_FIXTURES, "corpus", name), "rb") as f:
            data = f.read()
        out = np.empty(rec["size"], np.uint8)
        orbax_format.decompress_into(data, out, name)
        if hashlib.sha256(out).hexdigest() != rec["sha256"]:
            raise AssertionError(f"corpus {name}: decoded bytes differ from the digest")
        frames[name] = (data, out)
    largest = sorted(frames, key=lambda n: (frames[n][1].nbytes, n))[-5:]
    rates = {}
    for name in largest:
        data, out = frames[name]
        ms = host_ms(lambda: orbax_format.decompress_into(data, out, name))
        rates[name] = out.nbytes / ms / 1e3
    phase("orbax-corpus", frames=len(frames), check="sha256 of the decoded bytes == digests.json",
          largest_bytes=frames[largest[-1]][1].nbytes,
          decode_MBps={n: f"{r:.1f}" for n, r in rates.items()},
          decode_MBps_median=f"{float(np.median(list(rates.values()))):.1f}")

    # the committed checkpoints the JAX package wrote: every leaf to its
    # digest, load_weights on the card, the committed rays against JAX's
    exp = np.load(os.path.join(ORBAX_FIXTURES, "expected.npz"))
    sc = digests["scene"]
    scene = synthetic.make_scene(n_verts=sc["n_verts"], grid=sc["grid"])
    batch = synthetic.make_batch(scene, synthetic.render_gt(scene, H=sc["H"], W=sc["W"]),
                                 n_rays=sc["n_rays"])
    for k in ("ray_o", "ray_d", "near", "far"):
        if not np.array_equal(batch[k], exp[k]):
            raise AssertionError(f"the scene's {k} differ from the committed rays")
    batch = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in batch.items()}
    tiny = make_cfg(CFG).merged(train_net.TINY)
    reset_counts(knn, scatter)
    errs = {}
    for name, rec in sorted(digests["checkpoints"].items()):
        tree = orbax_format.read_checkpoint(os.path.join(ORBAX_FIXTURES, name, "0"), None)
        if leaf_digests(tree) != rec:
            raise AssertionError(f"{name}: leaves differ from digests.json")
        mspec, rspec, model = run.build(tiny, dev)
        checkpoint.load_weights(os.path.join(ORBAX_FIXTURES, name), model)
        with torch.no_grad():
            out = rend.render_rays(mspec, rspec, model, batch, train=False)
        for k, key in (("rgb_map", "rgb"), ("acc_map", "acc")):
            got, want = out[k].cpu().numpy(), exp[f"{name}_{key}"]
            # phase 4b's tolerance, card against JAX's CPU render
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=f"{name} {k}")
            errs[f"{name}_{key}"] = float(np.abs(got - want).max())
    tiny_counts = launch_counts(knn, scatter)
    if tiny_counts["knn_blend"] < len(digests["checkpoints"]) or \
            tiny_counts["segmented_scatter_add"] or tiny_counts["onehot_scatter_add"]:
        raise AssertionError(f"tiny renders launched {tiny_counts}")
    phase("orbax-tiny", checkpoints=sorted(digests["checkpoints"]), rays=sc["n_rays"],
          leaves=sum(len(r) for r in digests["checkpoints"].values()),
          check="leaves == digests.json; render vs JAX's expected.npz rtol=atol=1e-3",
          max_abs_err={k: f"{v:.2e}" for k, v in errs.items()},
          knn_launches=tiny_counts["knn_blend"])

    # a full-width JAX-layout checkpoint from seeded arrays, written by the
    # port's writer, read back: time and host memory of the read
    root = os.path.join(HERE, "data", "fake_zju_smoke")          # phase 8's subject
    cfg = patch_cfg(root, ORBAX_DIR, epochs=2)
    mspec = inb.build_model_spec(cfg)
    tree, params, mu, nu = seeded_jax_tree(mspec, dev)
    path = os.path.join(cfg.trained_model_dir, "0")
    t0 = time.perf_counter()
    write_orbax_checkpoint(path, tree)
    write_s = time.perf_counter() - t0
    nbytes = sum(np.asarray(v).nbytes for _, _, v in orbax_format.leaves(tree))
    floats = sum(np.asarray(v).size for p, _, v in orbax_format.leaves(tree) if p[0] == "params")
    tracemalloc.start()
    t0 = time.perf_counter()
    back = orbax_format.read_checkpoint(path, None)
    read_s = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    if leaf_digests(back) != leaf_digests(tree):
        raise AssertionError("the full-width checkpoint does not read back leaf for leaf")
    del back
    t0 = time.perf_counter()
    orbax_format.read_checkpoint(path, ("params",))
    params_s = time.perf_counter() - t0
    phase("orbax-full", card=repr(nvidia_smi()), config="inb_fake (inb_377 widths)",
          param_floats=floats, leaves=len(list(orbax_format.leaves(tree))),
          bytes=nbytes, pad_rows=ORBAX_PAD, write_s=f"{write_s:.2f}",
          read_s=f"{read_s:.3f}", read_MBps=f"{nbytes / read_s / 1e6:.1f}",
          read_peak_traced_MB=f"{peak / 1e6:.1f}", params_only_read_s=f"{params_s:.3f}")

    # resume loop.train from it: step, epoch and moments bit for bit before
    # the first step, then 10 full-width patch-LPIPS steps
    want_sd = bridge.params_from_jax(params, mspec)
    want_mu, want_nu = bridge.params_from_jax(mu, mspec), bridge.params_from_jax(nu, mspec)
    load = loop.load_checkpoint
    checked = {}

    def check_resume(model_dir, state, epoch=None):
        meta = load(model_dir, state, epoch)
        if meta != {"epoch": 0, "step": ORBAX_STEP} or state.step != ORBAX_STEP:
            raise AssertionError(f"resumed meta {meta}, step {state.step}")
        names = {id(p): n for n, p in state.model.named_parameters()}
        for n, v in state.model.state_dict().items():
            if not torch.equal(v.cpu(), want_sd[n]):
                raise AssertionError(f"resumed parameter {n} differs from the written one")
        for p, st in state.optimizer.state.items():
            n = names[id(p)]
            if not (torch.equal(st["exp_avg"].cpu(), want_mu[n])
                    and torch.equal(st["exp_avg_sq"].cpu(), want_nu[n])
                    and int(st["step"]) == ORBAX_STEP):
                raise AssertionError(f"resumed moments of {n} differ from the written ones")
        checked["tensors"] = len(state.optimizer.state)
        return meta
    routes = table_grad_launches(mspec, make_render_spec(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(knn, scatter)
    loop.load_checkpoint = check_resume
    try:
        res = loop.train(cfg, dev, resume=True)
    finally:
        loop.load_checkpoint = load
    counts = check_patch_run("orbax resume", res, 1, routes, knn, scatter)
    if checked.get("tensors") != sum(1 for _ in res.state.model.parameters()):
        raise AssertionError(f"resume checked {checked} moment tensors")
    if res.state.step != ORBAX_STEP + len(res.losses) or len(res.losses) != PATCH_EPOCH_STEPS:
        raise AssertionError(f"resumed run: step {res.state.step}, {len(res.losses)} steps")
    e = res.epochs[0]
    phase("orbax-resume", card=repr(nvidia_smi()), resumed_epoch=e.epoch,
          from_step=ORBAX_STEP, steps=e.steps, rays=cfg.patch_size ** 2,
          check="params, exp_avg, exp_avg_sq, step == written, bit for bit",
          ms_per_step=f"{1000 * e.wall_s / e.steps:.2f}",
          data_wait_share=f"{e.data_s / e.wall_s:.4f}",
          peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
          loss_first=f"{res.losses[0]:.5f}", loss_last=f"{res.losses[-1]:.5f}",
          routes_per_step=repr(dict(routes)), launches=repr(counts))
    del res

    # evaluate one test item through run.load on the same directory, at
    # the JAX-layout epoch
    ecfg = cfg.merged({"test": {"epoch": 0}}).replace(eval=True)
    reset_counts(knn, scatter)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emspec, erspec, model = run.load(ecfg, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for n, v in model.state_dict().items():
        if not torch.equal(v.cpu(), want_sd[n]):
            raise AssertionError(f"run.load: {n} is not the JAX-layout epoch's")
    item = TPoseDataset(ecfg, "test").get_item(0)
    renderer = runner.AutoBudgetRenderer(emspec, erspec, runner.eval_chunk(ecfg))
    t0 = time.perf_counter()
    out = renderer(model, item)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    ev = launch_counts(knn, scatter)
    if ev["knn_blend"] != renderer.chunks_rendered or ev["knn_blend"] == 0 \
            or ev["segmented_scatter_add"] or ev["onehot_scatter_add"]:
        raise AssertionError(f"eval launches {ev}, chunks {renderer.chunks_rendered}")
    rgb = out["rgb_map"]
    if not (np.isfinite(rgb).all() and rgb.min() >= -1e-6 and rgb.max() <= 1 + 1e-6):
        raise AssertionError(f"eval rgb not finite in [0, 1]: [{rgb.min()}, {rgb.max()}]")
    phase("orbax-eval", card=repr(nvidia_smi()), epoch=0, layout=checkpoint.layout(path),
          load_s=f"{load_s:.3f}", rays=rgb.shape[0], chunks=renderer.chunks_rendered,
          render_ms=f"{1000 * render_s:.1f}", knn_launches=ev["knn_blend"],
          peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
          rgb_range=f"[{rgb.min():.4f},{rgb.max():.4f}]")
    del model
    return {k: tiny_counts[k] + counts[k] + ev[k] for k in counts}


# table-gradient launches of a flagship patch step under fix_random: the
# 8 segmented and 10 one-hot routes all become the sorted kernel
FIX_ROUTES_PER_STEP = 18
PARTITION_AMPLE = {"cull_budget": 1.0, "part_budget": 1.0,
                   "part_budget_scales": [1.0] * 5}
PARTITION_SCARCE = {"cull_budget": 0.05, "part_budget": 0.02}
PACKED_STEPS = 3
FIX_STEPS = PATCH_EPOCH_STEPS


def step_telemetry(cfg, model, dev):
    """The budget telemetry of one train-mode render of a ratio-0.3 patch
    item of the subject (one ``knn_blend`` launch)."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer import inb_renderer as rend
    from instant_nvr_tpu_torch.train import loop
    from instant_nvr_tpu_torch.train.stages import stage_for_epoch
    ecfg = stage_for_epoch(cfg, 0)
    item = TPoseDataset(ecfg, "train").get_item(0, ratio=ecfg.ratio,
                                                rng=np.random.default_rng(5))
    batch = loop.device_batch(item, 0.1, lambda v: torch.as_tensor(np.asarray(v), device=dev))
    with torch.no_grad():
        out = rend.render_rays(inb.build_model_spec(cfg), rend.make_render_spec(cfg), model,
                               batch, train=True,
                               generator=torch.Generator(device=dev).manual_seed(0))
    return {k: float(out[k]) for k in ("cull_overflow", "part_overflow")}


# the CUDA kernels of one sorted_scatter_add call (csrc/sorted_scatter.cu):
# no sort, no gather, no fill
SORTED_KERNELS = {"count_kernel", "prefix_kernel", "scan_kernel", "scatter_kernel",
                  "boundary_kernel", "work_kernel", "tile_kernel", "combine_kernel"}


def sorted_check(name, keys, payload, n_rows, offs, scatter, exact=False):
    """``sorted_scatter_add`` on the card, held to its contract: two
    launches bit-equal; bit-equal to ``sorted_scatter_add_ordered`` on the
    CPU (the kernel's own summation order); against the plain version on
    the CPU, which adds each row in record order: rows bit-equal, rows one
    bf16 ulp off (rows whose records span chunks), none further beyond the
    f32 reordering bound (with ``exact``, sums exact in any order: every
    row bit-equal).  Raises on any difference; returns (rows one ulp off
    the plain version, rows touched)."""
    import torch
    got = scatter.sorted_scatter_add(keys, payload, n_rows, offs)
    again = scatter.sorted_scatter_add(keys, payload, n_rows, offs)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
        raise AssertionError(f"{name}: two launches differ")
    kc, pc = keys.cpu(), payload.cpu()
    ordered = scatter.sorted_scatter_add_ordered(kc, pc, n_rows, offs)
    g = got.cpu()
    off_order = int((g.view(torch.int16) != ordered.view(torch.int16)).any(-1).sum())
    if off_order:
        raise AssertionError(f"{name}: {off_order} rows differ from the kernel's order "
                             f"(sorted_scatter_add_ordered)")
    ref = scatter.sorted_scatter_add_plain(kc, pc, n_rows, offs)
    g, r = g.float(), ref.float()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    diff = (g - r).abs()
    keep = (kc >= 0) & (kc < n_rows)
    k = kc[keep].long()
    count = torch.zeros(n_rows).index_add_(0, k, torch.ones(k.shape[0]))
    mass = torch.zeros_like(g).index_add_(0, k, pc[keep].float().abs())
    bad = diff > ulp + count[:, None] * 2.0 ** -24 * mass
    if exact:
        bad |= diff > 0
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} entries beyond "
                             f"{'0' if exact else 'one bf16 ulp'}")
    return int((diff > 0).any(-1).sum()), int((count > 0).sum())


def sorted_case(name, keys, payload, n_rows, offs, exact, scatter):
    """``sorted_scatter_add`` against its plain version: ``scatter_case``'s
    check on the card (the plain version's ``index_add_`` adds in any order
    there) and its times, then ``sorted_check``.  Then, under
    ``use_deterministic_algorithms`` as a ``fix_random`` step runs it, the
    kernel's event time, its queued device time (``queued_ms``) and its
    device split over 5 calls, which must hold only the kernel's own CUDA
    kernels (no sort, gather or fill), and ``index_add_``'s times with the
    flag on and off.  Returns scatter_case's result, the rows off the
    plain version and a dict of (event ms, device ms) pairs."""
    import torch
    fns = (scatter.sorted_scatter_add, scatter.sorted_scatter_add_plain)
    res = scatter_case(name, *fns, keys, payload, n_rows, offs, exact)
    rows_off, touched = sorted_check(name, keys, payload, n_rows, offs, scatter, exact)
    # under the deterministic flag, as fix_random sets it
    call = lambda: scatter.sorted_scatter_add(keys, payload, n_rows, offs)
    keep = (keys >= 0) & (keys < n_rows)
    kd, pd = keys[keep].long(), payload[keep].float()
    saved = torch.are_deterministic_algorithms_enabled()
    det = {}
    try:
        for flag in (True, False):
            torch.use_deterministic_algorithms(flag)
            acc = torch.zeros((n_rows, payload.shape[1]), device=keys.device)
            lib = lambda: acc.index_add_(0, kd, pd)
            det[f"index_add_{'det' if flag else 'nondet'}"] = (cuda_median_ms(lib),
                                                               queued_ms(lib))
        torch.use_deterministic_algorithms(True)
        det["kernel_det"] = (cuda_median_ms(call), queued_ms(call))
        split = device_split(call)
    finally:
        torch.use_deterministic_algorithms(saved)
    if not split:
        raise AssertionError(f"{name}: no profile of a sorted launch saw a kernel")
    names = {kernel_name(key) for key in split}
    if not names <= SORTED_KERNELS:
        raise AssertionError(f"{name}: a sorted launch ran {sorted(names - SORTED_KERNELS)}")
    plan = scatter.sorted_plan(keys.shape[0], payload.shape[1], n_rows)
    phase("sorted-vs-cpu", card=repr(nvidia_smi()), case=name, rows=n_rows,
          rows_touched=touched, regime="tiled" if plan.tiled else "small",
          tiles=plan.tiles, bucket_passes=plan.passes, small_splits=plan.small_splits,
          rows_bit_equal=n_rows - rows_off, rows_one_ulp=rows_off,
          check="kernel twice bit-equal; bit-equal to sorted_scatter_add_ordered (CPU); "
                "vs the CPU plain version in record order: "
                + ("bit-equal" if exact else "bit-equal or one bf16 ulp"),
          det_ms=f"{det['kernel_det'][0]:.4f}", det_queued_ms=f"{det['kernel_det'][1]:.4f}",
          det_device_split=repr({kernel_name(k): round(v, 4) for k, v in split.items()}),
          det_device_split_ms=f"{sum(split.values()):.4f}",
          index_add_det_ms=f"{det['index_add_det'][0]:.4f}",
          index_add_det_queued_ms=f"{det['index_add_det'][1]:.4f}",
          index_add_nondet_ms=f"{det['index_add_nondet'][0]:.4f}",
          index_add_nondet_queued_ms=f"{det['index_add_nondet'][1]:.4f}")
    return res + (rows_off, det)


def sorted_cases(cfg, dev, rng, scatter):
    """Phase 13c's sorted cases, on the card (``tools/kernel_ab.py --sorted``
    times the same): [(name, keys, payload, n_rows, level_offsets, exact)],
    uniform keys on the body hash first.  The train step's own records on
    the body hash, the deformer hash and an arm's dense table; F = 16;
    phase 3's edge cases: every record on one key (R not a multiple of 32,
    one run over 3,126 windows), a hot coarse level (small-integer
    payloads: exact), 10% of the keys outside the table, the self-check's
    [1c] shape (more records than one grid covers); the patch step's
    largest one-hot-route shape (the deformer's dense table: 6 levels x 8
    corners x 90,112 points on 12,276 rows); a table whose rows are no
    multiple of the tile (6 tiles, the last of 77 rows); tiles whose
    buckets hold exactly one chunk and one more record; more than 2,048
    tiles (two radix passes)."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.models import inb
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    bf = lambda a: t(np.asarray(a, np.float32)).to(torch.bfloat16)
    mspec = inb.build_model_spec(cfg)
    _, body_rows, body_offs = mspec.part_embeds[mspec.partnames.index("body")].tables()[-1]
    _, def_rows, def_offs = mspec.deformer.embed.tables()[-1]
    _, dd_rows, dd_offs = mspec.deformer.embed.tables()[0]
    _, arm_rows, arm_offs = mspec.part_embeds[mspec.partnames.index("larm")].tables()[0]
    R = (len(body_offs) - 1) * 8 * 8192
    cases = [("body-hash", t(level_keys(rng, body_offs, 8 * 8192)), bf(rng.normal(size=(R, 1))),
              body_rows, body_offs, False)]
    calls = capture_train_records(cfg, dev)
    for name, rows, offs in (("body-hash-real", body_rows, body_offs),
                             ("deformer-hash-real", def_rows, def_offs),
                             ("arm-dense-real", arm_rows, arm_offs)):
        k, p = max(((k, p) for r, k, p, n, o in calls if n == rows and o == tuple(offs)),
                   key=lambda kp: kp[0].shape[0])
        cases.append((name, k, p, rows, offs, False))
    del calls
    R = 4 * 65536
    cases.append(("F16", t(rng.integers(0, 50000, R).astype(np.int32)),
                  bf(rng.normal(size=(R, 16))), 50000, (0, 50000), False))
    R = 100003
    offs4 = tuple(range(0, 4 * 50000 + 1, 50000))
    cases.append(("pileup", t(np.full(R, 123457, np.int32)),
                  bf(rng.integers(-8, 9, size=(R, 1))), offs4[-1], offs4, True))
    hot = (0, 8, 8 + 16411)
    cases.append(("hot-row", t(level_keys(rng, hot, 131072)),
                  bf(rng.integers(-8, 9, size=(2 * 131072, 1))), hot[-1], hot, True))
    keys = level_keys(rng, def_offs, 8 * 22528)
    out = rng.random(len(keys)) < 0.1
    keys[out] = rng.choice(np.array([-(2 ** 31), -7, -1, def_rows, def_rows + 5,
                                     2 ** 31 - 1], np.int64), int(out.sum()))
    cases.append(("out-of-range", t(keys), bf(rng.normal(size=(len(keys), 1))), def_rows,
                  def_offs, False))
    cases.append(("selfcheck-1c-F2", t(level_keys(rng, (0, 12276), 1081344)),
                  bf(rng.normal(size=(1081344, 2))), 12276, (0, 12276), False))
    R = (len(dd_offs) - 1) * 8 * 90112
    cases.append(("onehot-patch-shape", t(level_keys(rng, dd_offs, 8 * 90112)),
                  bf(rng.normal(size=(R, 1))), dd_rows, dd_offs, False))
    tile, chunk = scatter.SORTED_TILE_ELEMS, scatter.SORTED_CHUNK_ELEMS
    rows = 5 * tile + 77
    cases.append(("ragged-tile", t(level_keys(rng, (0, rows), 262144)),
                  bf(rng.normal(size=(262144, 1))), rows, (0, rows), False))
    keys = np.concatenate([rng.integers(t0 * tile, (t0 + 1) * tile, chunk + extra)
                           for t0, extra in ((1, 0), (3, 1), (4, 0))]).astype(np.int32)
    rng.shuffle(keys)
    rows = 6 * tile
    cases.append(("bucket-at-chunk", t(keys), bf(rng.normal(size=(len(keys), 1))), rows,
                  (0, rows), False))
    rows = 2100 * tile + 7
    cases.append(("two-pass", t(level_keys(rng, (0, rows), 655360)),
                  bf(rng.normal(size=(655360, 1))), rows, (0, rows), False))
    return cases


def sorted_step_total(calls, scatter):
    """The sorted launches of one fix_random patch step, each held to its
    contract on its own inputs (``sorted_check``), then timed on them
    under the deterministic flag: (launches, summed event ms, summed queued
    device ms, summed deterministic ``index_add_`` queued device ms)."""
    import torch
    mine = [a for r, a in calls if r == "sorted"]
    rows_off = [sorted_check(f"fix-random step call {i} (R={int(k.shape[0])}, n_rows={n})",
                             k, p, n, o, scatter)[0] for i, (k, p, n, o) in enumerate(mine)]
    ev = lib_ms = 0.0
    each = []
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for keys, payload, n_rows, offs in mine:
            call = lambda: scatter.sorted_scatter_add(keys, payload, n_rows, offs)
            ev += cuda_median_ms(call)
            each.append(queued_ms(call))
            keep = (keys >= 0) & (keys < n_rows)
            acc = torch.zeros((n_rows, payload.shape[1]), device=keys.device)
            kd, pd = keys[keep].long(), payload[keep].float()
            lib_ms += queued_ms(lambda: acc.index_add_(0, kd, pd))
    finally:
        torch.use_deterministic_algorithms(saved)
    dev_ms = sum(each)
    phase("fix-random-step-sorted", card=repr(nvidia_smi()), launches=len(mine),
          shapes=repr([(int(k.shape[0]), int(p.shape[1]), n) for k, p, n, _ in mine]),
          check="each call: twice bit-equal; bit-equal to sorted_scatter_add_ordered (CPU); "
                "bit-equal or one bf16 ulp to the CPU plain version",
          rows_one_ulp=repr(rows_off), queued_ms_each=repr([round(v, 4) for v in each]),
          event_ms_sum=f"{ev:.4f}", queued_ms_sum=f"{dev_ms:.4f}",
          index_add_det_queued_ms_sum=f"{lib_ms:.4f}")
    return len(mine), ev, dev_ms, lib_ms


def completion_slice(dev, knn, scatter):
    """Phase 13 (see the module doc).  Returns (the launch counts of its
    main-path runs, the sorted kernel's results: uniform keys first)."""
    import glob
    import shutil
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import bridge, run, train_net
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.eval import runner, video
    from instant_nvr_tpu_torch.datasets.image_ops import read_png
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.tools.make_fixtures import write_orbax_checkpoint
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.train import loop, orbax_format
    from instant_nvr_tpu_torch.train.state import OptaxRAdam
    from instant_nvr_tpu_torch.train.step import table_grad_launches
    root = os.path.join(HERE, "data", "fake_zju_smoke")          # phase 8's subject
    total = {k: 0 for k in ("knn_blend", "knn_topk", "segmented_scatter_add",
                            "onehot_scatter_add", "sorted_scatter_add")}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # (a) select_mode: partition -- 10 patch steps with every budget ample,
    #     then with the cull and part budgets forced to overflow
    for label, budgets in (("ample", PARTITION_AMPLE), ("scarce", PARTITION_SCARCE)):
        exp = os.path.join(HERE, "exps", f"chip_smoke_partition_{label}")
        shutil.rmtree(exp, ignore_errors=True)
        cfg = patch_cfg(root, exp, epochs=1, select_mode="partition", **budgets)
        routes = table_grad_launches(inb.build_model_spec(cfg), make_render_spec(cfg))
        reset_counts(knn, scatter)
        res = loop.train(cfg, dev, resume=False)
        add(check_patch_run(f"partition {label}", res, 0, routes, knn, scatter))
        reset_counts(knn, scatter)
        tel = step_telemetry(cfg, res.state.model, dev)
        add(launch_counts(knn, scatter))
        overflow = tel["cull_overflow"] > 0 and tel["part_overflow"] > 0
        if overflow != (label == "scarce") or (label == "ample" and any(tel.values())):
            raise AssertionError(f"partition {label}: telemetry {tel}")
        e = res.epochs[0]
        phase("partition-train", card=repr(nvidia_smi()), budgets=label, steps=e.steps,
              ms_per_step=f"{1000 * e.wall_s / e.steps:.2f}",
              loss_first=f"{res.losses[0]:.5f}", loss_last=f"{res.losses[-1]:.5f}",
              cull_overflow=f"{tel['cull_overflow']:.4f}",
              part_overflow=f"{tel['part_overflow']:.4f}",
              knn_launches=res.epochs[0].steps)
        del res
    card_vs_cpu_patch_step(patch_cfg(root, os.path.join(HERE, "exps", "chip_smoke_partition_ample"),
                                     epochs=1, select_mode="partition", **PARTITION_AMPLE),
                           dev, label="partition-cuda-vs-cpu")
    # a 256^2 test item of phase 9's weights under partition and under topk
    exp = os.path.join(HERE, "exps", "chip_smoke_patch")
    rgbs = {}
    for mode in ("partition", "topk"):
        ecfg = patch_cfg(root, exp, epochs=3, select_mode=mode).replace(eval=True)
        emspec, erspec, model = run.load(ecfg, dev)
        item = TPoseDataset(ecfg, "test").get_item(0)
        renderer = runner.AutoBudgetRenderer(emspec, erspec, runner.eval_chunk(ecfg))
        reset_counts(knn, scatter)
        t0 = time.perf_counter()
        out = renderer(model, item)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
        ev = launch_counts(knn, scatter)
        if ev["knn_blend"] != renderer.chunks_rendered or ev["segmented_scatter_add"] \
                or ev["onehot_scatter_add"] or scatter.sorted_scatter_add.launches:
            raise AssertionError(f"{mode} render launches {ev}, "
                                 f"chunks {renderer.chunks_rendered}")
        add(ev)
        rgbs[mode] = out["rgb_map"]
        phase("partition-eval", card=repr(nvidia_smi()), select_mode=mode,
              rays=len(out["rgb_map"]),
              chunks=renderer.chunks_rendered, knn_launches=ev["knn_blend"],
              render_ms=f"{ms:.1f}")
        del model
    diff = float(np.abs(rgbs["partition"] - rgbs["topk"]).max())
    phase("partition-vs-topk", card=repr(nvidia_smi()), rays=len(rgbs["topk"]),
          max_abs_diff=f"{diff:.3e}",
          tol="atol 1e-5 (the same selected set, in another slot order)")
    if not np.isfinite(rgbs["partition"]).all() or diff > 1e-5:
        raise AssertionError(f"partition render differs from topk's by {diff}")

    # (b) a full-width JAX-layout checkpoint under radam with packed tables,
    #     resumed for 3 steps with the moments bit-equal before the first
    exp = os.path.join(HERE, "exps", "chip_smoke_packed")
    shutil.rmtree(exp, ignore_errors=True)
    cfg = patch_cfg(root, exp, epochs=2, ep_iter=PACKED_STEPS,
                    train={"epoch": 2, "optim": "radam"})
    mspec = inb.build_model_spec(cfg)
    tree, params, mu, nu = seeded_jax_tree(mspec, dev, packed=True)
    packed = [".".join(p) for p, _, v in orbax_format.leaves(tree)
              if p[0] == "params" and np.ndim(v) == 2 and np.shape(v)[1] == 128]
    if not packed:
        raise AssertionError("no table stored packed")
    t0 = time.perf_counter()
    write_orbax_checkpoint(os.path.join(cfg.trained_model_dir, "0"), tree)
    write_s = time.perf_counter() - t0
    nbytes = sum(np.asarray(v).nbytes for _, _, v in orbax_format.leaves(tree))
    del tree
    want_sd = bridge.params_from_jax(params, mspec)
    want_mu, want_nu = bridge.params_from_jax(mu, mspec), bridge.params_from_jax(nu, mspec)
    del params, mu, nu
    load, checked = loop.load_checkpoint, {}

    def check_resume(model_dir, state, epoch=None):
        t = time.perf_counter()
        meta = load(model_dir, state, epoch)
        checked["load_s"] = time.perf_counter() - t
        if meta != {"epoch": 0, "step": ORBAX_STEP} or state.step != ORBAX_STEP:
            raise AssertionError(f"packed resume: meta {meta}, step {state.step}")
        if not isinstance(state.optimizer, OptaxRAdam):
            raise AssertionError(f"packed resume: {type(state.optimizer).__name__}")
        names = {id(p): n for n, p in state.model.named_parameters()}
        for n, v in state.model.state_dict().items():
            if not torch.equal(v.cpu(), want_sd[n]):
                raise AssertionError(f"packed resume: parameter {n} differs")
        for p, st in state.optimizer.state.items():
            n = names[id(p)]
            if not (torch.equal(st["exp_avg"].cpu(), want_mu[n])
                    and torch.equal(st["exp_avg_sq"].cpu(), want_nu[n])
                    and int(st["step"]) == ORBAX_STEP):
                raise AssertionError(f"packed resume: moments of {n} differ")
        checked["tensors"] = len(state.optimizer.state)
        return meta
    routes = table_grad_launches(mspec, make_render_spec(cfg))
    reset_counts(knn, scatter)
    loop.load_checkpoint = check_resume
    try:
        res = loop.train(cfg, dev, resume=True)
    finally:
        loop.load_checkpoint = load
    add(check_patch_run("packed resume", res, 1, routes, knn, scatter))
    if checked.get("tensors") != sum(1 for _ in res.state.model.parameters()) \
            or len(res.losses) != PACKED_STEPS:
        raise AssertionError(f"packed resume: checked {checked}, {len(res.losses)} steps")
    e = res.epochs[0]
    phase("packed-resume", card=repr(nvidia_smi()), optim="radam",
          packed_tables=len(packed), param_floats=sum(v.numel() for v in want_sd.values()),
          bytes=nbytes, write_s=f"{write_s:.2f}", load_s=f"{checked['load_s']:.2f}",
          steps=e.steps, ms_per_step=f"{1000 * e.wall_s / e.steps:.2f}",
          check="params, exp_avg, exp_avg_sq, step == written, bit for bit",
          loss_first=f"{res.losses[0]:.5f}", loss_last=f"{res.losses[-1]:.5f}",
          routes_per_step=repr(dict(routes)))
    del res, want_sd, want_mu, want_nu
    shutil.rmtree(exp, ignore_errors=True)

    # (c) fix_random: the sorted kernel on one step's records and on
    #     uniform keys; two runs from one seed bit-equal; --detect_anomaly
    cfg377 = make_cfg(CFG)
    mspec377 = inb.build_model_spec(cfg377)
    rng = np.random.default_rng(13)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    results = [sorted_case(name, k, p, rows, offs, exact, scatter)
               for name, k, p, rows, offs, exact in sorted_cases(cfg377, dev, rng, scatter)]
    # index_add_ under use_deterministic_algorithms: the exact route's call
    # (an exact float32 table keeps it under fix_random)
    R = 4 * 65536
    keys = t(rng.integers(0, 20000, R).astype(np.int32))
    pay = t(rng.normal(size=(R, 1)).astype(np.float32))
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = scatter.exact_scatter_add(keys, pay, 20000)
        b = scatter.exact_scatter_add(keys, pay, 20000)
        index_add_det = bool(torch.equal(a, b))
    except RuntimeError as err:
        index_add_det = f"raises: {str(err).splitlines()[0][:120]}"
    finally:
        torch.use_deterministic_algorithms(saved)
    phase("index-add-deterministic", card=repr(nvidia_smi()), R=R,
          index_add_deterministic_under_the_flag=repr(index_add_det))
    if index_add_det is not True:
        raise AssertionError(f"index_add_ under the deterministic flag: {index_add_det}")

    reset_counts(knn, scatter)
    runs, fix_per_step = [], []
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        for name in ("a", "b"):
            exp = os.path.join(HERE, "exps", f"chip_smoke_fix_random_{name}")
            shutil.rmtree(exp, ignore_errors=True)
            cfg = patch_cfg(root, exp, epochs=1, fix_random=True)
            if not train_net.apply_fix_random(cfg):
                raise AssertionError("fix_random not applied")
            routes = table_grad_launches(inb.build_model_spec(cfg), make_render_spec(cfg))
            if routes != {"sorted": FIX_ROUTES_PER_STEP}:
                raise AssertionError(f"fix_random routes {routes}")
            reset_counts(knn, scatter)
            res = loop.train(cfg, dev, resume=False, seed=0)
            got = check_patch_run(f"fix_random {name}", res, 0, routes, knn, scatter)
            add(got)
            fix_per_step.append(got["sorted_scatter_add"] / len(res.losses))
            runs.append((res.losses, {k: v.detach().clone()
                                      for k, v in res.state.model.state_dict().items()},
                         1000 * res.epochs[0].wall_s / res.epochs[0].steps))
            if name == "a":     # one more step's sorted calls (after the copy above)
                step_total = sorted_step_total(capture_patch_inputs(cfg, res.state, dev),
                                               scatter)
                if step_total[0] != FIX_ROUTES_PER_STEP:
                    raise AssertionError(f"fix_random step: {step_total[0]} sorted calls")
            del res
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]
    (la, pa, ms_a), (lb, pb, ms_b) = runs
    differing = [k for k in pa if not torch.equal(pa[k].view(torch.int32)
                                                  if pa[k].dtype == torch.float32 else pa[k],
                                                  pb[k].view(torch.int32)
                                                  if pb[k].dtype == torch.float32 else pb[k])]
    phase("fix-random", card=repr(nvidia_smi()), runs=2, steps=len(la),
          routes_per_step=repr(dict(routes)), ms_per_step=[f"{ms_a:.2f}", f"{ms_b:.2f}"],
          losses_equal=la == lb, params_differing=differing,
          check="every parameter bit-equal after both runs")
    if la != lb or differing:
        raise AssertionError(f"fix_random runs differ: losses {la} vs {lb}, {differing}")
    del runs, pa, pb

    reset_counts(knn, scatter)
    try:
        train_net.main(["--cfg_file", CFG, "--steps", "3", "--detect_anomaly"])
    finally:
        torch.autograd.set_detect_anomaly(False)
    got = launch_counts(knn, scatter)
    mroutes = table_grad_launches(mspec377, make_render_spec(cfg377))
    want = {"knn_blend": 3, "knn_topk": 0, "segmented_scatter_add": 3 * mroutes["segmented"],
            "onehot_scatter_add": 3 * mroutes["onehot"]}
    if got != want:
        raise AssertionError(f"--detect_anomaly run launches {got} != {want}")
    add(got)
    phase("detect-anomaly", card=repr(nvidia_smi()), steps=3, launches=repr(got),
          check="3 full-width steps ran")

    # (d) the phase-9 bullet views as an mp4 by the port's writer
    names = sorted(glob.glob(os.path.join(HERE, "exps", "chip_smoke_patch", "novel_views",
                                          "frame_*.png")))
    if len(names) < 4:
        raise AssertionError(f"bullet frames: {names}")
    frames = [read_png(n)[..., :3] for n in names]
    out = os.path.join(HERE, "exps", "chip_smoke_patch", "bullet_mp4v.mp4")
    t0 = time.perf_counter()
    info = video.write_mp4(out, frames, fps=24)
    enc_s = time.perf_counter() - t0
    mp4 = video.read_mp4(out)
    if (len(mp4["sample_sizes"]) != len(frames) or mp4["codec"] != "mp4v"
            or (mp4["width"], mp4["height"]) != frames[0].shape[1::-1]
            or mp4["fps"] != 24.0 or min(mp4["sample_sizes"]) <= 0):
        raise AssertionError(f"mp4 read back: {mp4}")
    phase("mp4v", card=repr(nvidia_smi()), frames=len(frames),
          size=f"{frames[0].shape[1]}x{frames[0].shape[0]}", fps=24, bytes=info["bytes"],
          encode_ms_per_frame=f"{1000 * enc_s / len(frames):.1f}",
          sample_sizes=mp4["sample_sizes"], codec=mp4["codec"], brand=mp4["brand"])
    return total, results, fix_per_step, step_total


# phase 15: steps of each route from one seed-0 state, an epoch boundary
# (an lr change of the schedule) inside them
CAPTURE_STEPS = 10
CAPTURE_EP_ITER = 5


def route_run(route, cfg, batch, patch_fn, dev, knn, scatter, steps=CAPTURE_STEPS,
              state=None):
    """``steps`` steps of ``route`` ('eager' or 'captured') from ``state``
    (default a seed-0 one), step i drawing from a generator seeded i ->
    (losses, state, the step, launches)."""
    import torch
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.ops import mlp_wgrad
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train.compiled import CapturedStep
    from instant_nvr_tpu_torch.train.state import create_train_state
    from instant_nvr_tpu_torch.train.step import make_loss_weights, make_train_step
    mspec, rspec, lw = inb.build_model_spec(cfg), make_render_spec(cfg), make_loss_weights(cfg)
    if state is None:
        state = create_train_state(cfg, run.build(cfg, dev, seed=0)[2])
    step = (make_train_step(mspec, rspec, lw, patch_fn) if route == "eager"
            else CapturedStep(mspec, rspec, lw, patch_fn, n_steps=state.step + steps))
    gen = torch.Generator(device=dev)
    reset_counts(knn, scatter)
    losses = []
    for i in range(steps):
        gen.manual_seed(i)
        _, stats = step(state, batch, generator=gen)
        losses.append(stats["loss"].clone())
    torch.cuda.synchronize()
    got = launch_counts(knn, scatter)
    got["sorted_scatter_add"] = scatter.sorted_scatter_add.launches
    got["mlp_wgrad"] = mlp_wgrad.mlp_wgrad.launches
    return torch.stack(losses).cpu(), state, step, got


# the optimizers' moments, as state_bits names them
MOMENTS = (".exp_avg", ".exp_avg_sq", ".momentum_buffer")


def state_bits(state):
    """Every parameter and moment of ``state`` (Adam's and RAdam's two,
    SGD's momentum buffer), by name, on the host."""
    import torch
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"{names[id(p)]}.{k}"] = v.cpu().clone()
    return out


def params_agree(label, a, b, lr, steps):
    """Phase 6's parameter bound over ``steps`` steps: no entry apart by
    more than 2.1 lr a step; returns (worst entry distance in lr, entries
    apart by more than 1e-6)."""
    worst, moved = 0.0, 0
    for k, p in a.items():
        if k.endswith(MOMENTS):
            continue
        d = (p.float() - b[k].float()).abs()
        worst = max(worst, float(d.max()) / lr)
        moved += int((d > 1e-6).sum())
    if worst > 2.1 * steps:
        raise AssertionError(f"{label}: a parameter differs by {worst:.3f} lr "
                             f"> 2.1 lr x {steps} steps")
    return worst, moved


def graph_launches(step):
    """The launches one replay of each of ``step``'s graphs counts, by kernel."""
    from instant_nvr_tpu_torch.train import compiled
    names = [(i, f.__name__ if attr == "launches" else "exact_index_add")
             for i, (f, attr) in enumerate(compiled._COUNTERS)]
    return [{n: g.launches[i] for i, n in names if g.launches[i]}
            for g in step.graphs.values() if g.graph is not None]


def captured_training(cfg, dev, knn, scatter, routes):
    """15(a)-(b): both routes 10 steps from one seed-0 state, MSE and patch,
    then the patch step under fix_random; returns the captured runs'
    launches and each graph's launches a replay."""
    import torch
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train.loop import make_patch_loss_fn
    from instant_nvr_tpu_torch.train.step import (encoder_calls, mlp_wgrad_calls,
                                                  table_grad_launches)
    lr = cfg.train.lr
    calls = encoder_calls(make_render_spec(cfg))
    layers = mlp_wgrad_calls(inb.build_model_spec(cfg), make_render_spec(cfg))
    # a replay's encoder launches and MLP weight gradients
    encoders = {"fused_encode": calls, "fused_encode_backward": calls, "mlp_wgrad": layers}
    batches = {"mse": (train_net.synthetic_batch(cfg, dev), None),
               "patch": (train_net.to_tensors(train_net.patch_batch_np(cfg), dev),
                         make_patch_loss_fn(cfg))}
    total = {}
    per_replay = {}

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    for mode, (batch, pfn) in batches.items():
        le, se, _, got_e = route_run("eager", cfg, batch, pfn, dev, knn, scatter)
        lc, sc, step, got_c = route_run("captured", cfg, batch, pfn, dev, knn, scatter)
        add(got_c)
        want = {"knn_blend": CAPTURE_STEPS, "knn_topk": 0,
                "segmented_scatter_add": CAPTURE_STEPS * routes["segmented"],
                "onehot_scatter_add": CAPTURE_STEPS * routes["onehot"],
                "sorted_scatter_add": 0, "mlp_wgrad": CAPTURE_STEPS * layers}
        graphs = graph_launches(step)
        one = {"knn_blend": 1, "segmented_scatter_add": routes["segmented"],
               "onehot_scatter_add": routes["onehot"], **encoders}
        if got_c != want or got_e != want or graphs != [one] \
                or (step.captures, step.replays) != (1, CAPTURE_STEPS - 3):
            raise AssertionError(f"captured {mode}: launches {got_c} (eager {got_e}) != "
                                 f"{want}; a replay {graphs}; captures {step.captures}, "
                                 f"replays {step.replays}")
        per_replay[mode] = graphs[0]
        assert_workspace_zero(f"captured {mode} steps")
        rel = float(((lc - le).abs() / le.abs()).max())
        if not torch.isfinite(lc).all() or rel > 1e-3:
            raise AssertionError(f"captured {mode}: losses {lc.tolist()} vs eager "
                                 f"{le.tolist()} (rtol 1e-3)")
        worst, moved = params_agree(f"captured {mode}", state_bits(sc), state_bits(se),
                                    lr, CAPTURE_STEPS)
        phase("captured-train", card=repr(nvidia_smi()), mode=mode, steps=CAPTURE_STEPS,
              ep_iter=CAPTURE_EP_ITER,
              lr_steps=[f"{sc.schedule(t):.6e}" for t in (0, CAPTURE_EP_ITER)],
              loss_eager=[f"{v:.6f}" for v in le.tolist()],
              loss_captured=[f"{v:.6f}" for v in lc.tolist()],
              loss_max_rel_diff=f"{rel:.3e}", param_max_diff_lr=f"{worst:.4f}",
              params_differing_1e6=moved, captures=step.captures, replays=step.replays,
              launches_per_replay=repr(graphs[0]), launches=repr(got_c),
              tol=repr("loss rtol 1e-3; params <= 2.1 lr a step (phase 6)"))
        del se, sc, step

    # fix_random: every table gradient through the sorted kernel, both
    # routes bit for bit
    fcfg = cfg.merged({"fix_random": True})
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        if not train_net.apply_fix_random(fcfg):
            raise AssertionError("fix_random not applied")
        froutes = table_grad_launches(inb.build_model_spec(fcfg), make_render_spec(fcfg))
        batch, pfn = batches["patch"]
        le, se, _, got_e = route_run("eager", fcfg, batch, pfn, dev, knn, scatter)
        lc, sc, step, got_c = route_run("captured", fcfg, batch, pfn, dev, knn, scatter)
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]
    add(got_c)
    want = {"knn_blend": CAPTURE_STEPS, "knn_topk": 0, "segmented_scatter_add": 0,
            "onehot_scatter_add": 0,
            "sorted_scatter_add": CAPTURE_STEPS * FIX_ROUTES_PER_STEP,
            "mlp_wgrad": CAPTURE_STEPS * layers}
    graphs = graph_launches(step)
    if froutes != {"sorted": FIX_ROUTES_PER_STEP} or got_c != want or got_e != want \
            or graphs != [{"knn_blend": 1, "sorted_scatter_add": FIX_ROUTES_PER_STEP,
                           **encoders}]:
        raise AssertionError(f"captured fix_random: routes {froutes}, launches {got_c} "
                             f"(eager {got_e}) != {want}; a replay {graphs}")
    per_replay["fix_random"] = graphs[0]
    a, b = state_bits(sc), state_bits(se)
    differing = [k for k in a if not torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8))]
    phase("captured-fix-random", card=repr(nvidia_smi()), steps=CAPTURE_STEPS,
          losses_bit_equal=torch.equal(lc, le), tensors=len(a),
          tensors_differing=differing, launches_per_replay=repr(graphs[0]),
          check="losses, every parameter and both moments bit-equal, captured vs eager")
    if not torch.equal(lc, le) or differing:
        raise AssertionError(f"captured fix_random differs from eager: losses "
                             f"{lc.tolist()} vs {le.tolist()}, tensors {differing[:8]}")
    del se, sc, step
    return total, per_replay


def captured_resume(dev, knn, scatter):
    """15(c): phase 8's checkpoint into two states; 4 steps of each route on
    one item of its subject (the captured route's fourth its first
    replay)."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.train import checkpoint, loop
    from instant_nvr_tpu_torch.train.stages import stage_for_epoch
    from instant_nvr_tpu_torch.train.state import create_train_state
    root = os.path.join(HERE, "data", "fake_zju_smoke")
    exp = os.path.join(HERE, "exps", "chip_smoke_patch")
    cfg = patch_cfg(root, exp, epochs=3)
    ecfg = stage_for_epoch(cfg, 1)
    item = TPoseDataset(ecfg, "train").get_item(0, ratio=ecfg.ratio,
                                                rng=np.random.default_rng(3))
    batch = loop.device_batch(item, 0.1, lambda v: torch.as_tensor(np.asarray(v),
                                                                   device=dev))
    runs = {}
    for route in ("eager", "captured"):
        state = create_train_state(cfg, run.build(cfg, dev, seed=1)[2])
        meta = checkpoint.load_checkpoint(cfg.trained_model_dir, state)
        start = state.step
        losses, state, step, got = route_run(route, cfg, batch,
                                             loop.make_patch_loss_fn(cfg), dev, knn,
                                             scatter, steps=4, state=state)
        if state.step != start + 4 or (route == "captured" and (
                step.replays != 1 or int(step.dstep) != state.step)):
            raise AssertionError(f"resume {route}: step {start} -> {state.step}")
        runs[route] = (losses, state_bits(state), got)
    (le, be, _), (lc, bc, got) = runs["eager"], runs["captured"]
    rel = float(((lc - le).abs() / le.abs()).max())
    worst, moved = params_agree("captured resume", bc, be, cfg.train.lr, 4)
    phase("captured-resume", card=repr(nvidia_smi()), epoch=int(meta["epoch"]),
          from_step=start, steps=4, loss_eager=[f"{v:.6f}" for v in le.tolist()],
          loss_captured=[f"{v:.6f}" for v in lc.tolist()], loss_max_rel_diff=f"{rel:.3e}",
          param_max_diff_lr=f"{worst:.4f}", params_differing_1e6=moved,
          tol=repr("loss rtol 1e-3; params <= 2.1 lr a step (phase 6)"))
    if rel > 1e-3:
        raise AssertionError(f"captured resume: losses {lc.tolist()} vs {le.tolist()}")
    return got


def captured_eval(dev, knn, scatter):
    """15(d): one warm 512^2 test frame of phase 8's checkpoint on each
    route: bit-equal maps, untraced ms in turns, a profiled frame each
    (busy share, pageable host-to-device copies)."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.eval import runner
    from instant_nvr_tpu_torch.tools import profile_eval
    from instant_nvr_tpu_torch.train import checkpoint
    root = os.path.join(HERE, "data", "fake_zju_smoke")
    exp = os.path.join(HERE, "exps", "chip_smoke_patch")
    cfg = patch_cfg(root, exp, epochs=3, eval_ratio=1.0).replace(eval=True)
    mspec, rspec, model = run.build(cfg, dev, seed=0)
    checkpoint.load_weights(cfg.trained_model_dir, model)
    item = TPoseDataset(cfg, "test").get_item(0)
    chunk = runner.eval_chunk(cfg)
    renderers = {route: runner.AutoBudgetRenderer(
        mspec, rspec, chunk, persist_path=runner.budgets_path(cfg),
        captured=route == "captured") for route in ("eager", "captured")}
    reset_counts(knn, scatter)
    outs = {route: [r(model, item) for _ in range(3)] for route, r in renderers.items()}
    counts = launch_counts(knn, scatter)
    if counts["knn_blend"] != renderers["eager"].chunks_rendered \
            + renderers["captured"].chunks_rendered:
        raise AssertionError(f"captured eval: launches {counts}")
    frame = renderers["captured"].render_fn
    if (frame.captures, frame.replays) != (1, 2):
        raise AssertionError(f"captured eval: {frame.captures} captures, "
                             f"{frame.replays} replays")
    ms = {"eager": [], "captured": []}
    for _ in range(2):
        for route, r in renderers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[route].append(r(model, item))
            ms[route].append(1000 * (time.perf_counter() - t0))
    ref = outs["eager"][-1]
    diffs = {route: [float(np.abs(o["rgb_map"] - ref["rgb_map"]).max()) for o in o_]
             for route, o_ in outs.items()}
    equal = {route: [bool(np.array_equal(o["rgb_map"], ref["rgb_map"])
                          and np.array_equal(o["acc_map"], ref["acc_map"])) for o in o_]
             for route, o_ in outs.items()}
    profs = {route: profile_eval.profile_item(r, model, item)
             for route, r in renderers.items()}
    phase("captured-eval", card=repr(nvidia_smi()), rays=int(item["ray_o"].shape[0]),
          chunk=chunk, chunks=runner.padded_chunks(int(item["ray_o"].shape[0]), chunk),
          warm_ms_eager=[f"{t:.1f}" for t in ms["eager"]],
          warm_ms_captured=[f"{t:.1f}" for t in ms["captured"]],
          profiled_ms={k: f"{v['warm_ms']:.1f}" for k, v in profs.items()},
          device_ms={k: fmt_ms(v["device_ms"]) for k, v in profs.items()},
          busy={k: ("not measured" if v["busy"] is None else f"{v['busy']:.3f}")
                for k, v in profs.items()},
          pageable_host_to_device={k: v["copies"].get("Memcpy HtoD (Pageable -> Device)", 0)
                                   for k, v in profs.items()},
          copies={k: v["copies"] for k, v in profs.items()},
          maps_bit_equal=equal, rgb_max_abs_diff=diffs, captures=frame.captures,
          peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    if not all(all(v) for v in equal.values()):
        raise AssertionError(f"captured eval frames differ from eager: {diffs}")
    return counts


def captured_slice(dev, knn, scatter):
    """Phase 15: the captured train step and eval frame against the eager
    ones.  Returns (the launches of its captured runs, each captured
    graph's launches a replay)."""
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train.step import table_grad_launches
    cfg = make_cfg(CFG).merged({"ep_iter": CAPTURE_EP_ITER})
    routes = table_grad_launches(inb.build_model_spec(cfg), make_render_spec(cfg))
    counts, per_replay = captured_training(cfg, dev, knn, scatter, routes)
    for got in (captured_resume(dev, knn, scatter), captured_eval(dev, knn, scatter)):
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    return counts, per_replay


# phase 16: the rest of the JAX package's compiled programs; each step run
# takes CAPTURE_STEPS steps from the seed-0 state (RAdam's rectification
# switching on at the sixth, an lr change at the sixth), then timed and
# traced steps
PROGRAMS_DIR = os.path.join(HERE, "exps", "chip_smoke_programs")
PROGRAM_TIMED = 5
PROGRAM_TRACED = 3
PROGRAM_VARIANTS = (("radam", {"train": {"optim": "radam"}}),
                    ("sgd", {"train": {"optim": "sgd"}}),
                    ("remat", {"remat": True}))
NCCL_STEPS = 6                # 3 warm-up steps, the capture, 2 replays


def program_run(route, cfg, batch, pfn, dev, knn, scatter, timed=True):
    """``CAPTURE_STEPS`` steps of ``route`` ('eager' or 'captured') from the
    seed-0 state, step i drawing from a generator seeded i; with ``timed``
    then ``PROGRAM_TIMED`` steps timed on the host clock (ending in a
    synchronize) and, on the captured route, ``PROGRAM_TRACED`` in a
    profiler window.  Returns the
    losses, the state's bits and the launches after the first
    ``CAPTURE_STEPS``, the captures and replays then, ms a step, busy
    share, device ms a step, peak memory and the run's launches."""
    import torch
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.ops import mlp_wgrad
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.tools import profile_eval
    from instant_nvr_tpu_torch.train.compiled import CapturedStep
    from instant_nvr_tpu_torch.train.loop import _device_seconds
    from instant_nvr_tpu_torch.train.state import create_train_state
    from instant_nvr_tpu_torch.train.step import make_loss_weights, make_train_step
    mspec, rspec, lw = inb.build_model_spec(cfg), make_render_spec(cfg), make_loss_weights(cfg)
    # the run's own peak: its model, moments, graph pool and activations
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, run.build(cfg, dev, seed=0)[2])
    # the eager route is not traced: its timed steps are its last
    step = (make_train_step(mspec, rspec, lw, pfn) if route == "eager"
            else CapturedStep(mspec, rspec, lw, pfn, n_steps=CAPTURE_STEPS
                              + PROGRAM_TIMED + PROGRAM_TRACED))
    gen = torch.Generator(device=dev)

    def one(i):
        gen.manual_seed(i)
        return step(state, batch, generator=gen)[1]

    def counts():
        got = launch_counts(knn, scatter)
        got["sorted_scatter_add"] = scatter.sorted_scatter_add.launches
        got["mlp_wgrad"] = mlp_wgrad.mlp_wgrad.launches
        return got
    reset_counts(knn, scatter)
    losses = [one(i)["loss"].clone() for i in range(CAPTURE_STEPS)]
    torch.cuda.synchronize()
    out = {"losses": torch.stack(losses).cpu(), "bits": state_bits(state),
           "launches": counts(), "step": step,
           "optimizer": type(state.optimizer).__name__,
           "lr": [state.schedule(t) for t in (0, CAPTURE_EP_ITER)],
           "captured": (getattr(step, "captures", 0), getattr(step, "replays", 0)),
           "ms": None, "busy": None, "device_ms": None, "top": None}
    if timed:
        t0 = time.perf_counter()
        for i in range(CAPTURE_STEPS, CAPTURE_STEPS + PROGRAM_TIMED):
            one(i)
        torch.cuda.synchronize()
        out["ms"] = 1000 * (time.perf_counter() - t0) / PROGRAM_TIMED
    if timed and route == "captured":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(CAPTURE_STEPS + PROGRAM_TIMED,
                           CAPTURE_STEPS + PROGRAM_TIMED + PROGRAM_TRACED):
                one(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_s = _device_seconds(prof.events())
        if dev_s is not None:
            out.update(busy=dev_s / wall, device_ms=1000 * dev_s / PROGRAM_TRACED,
                       top=[f"{n[:48]}:{ms / PROGRAM_TRACED:.2f}ms:x{c // PROGRAM_TRACED}"
                            for n, ms, c in profile_eval.top_kernels(prof, 6)])
    out.update(peak=torch.cuda.max_memory_allocated() - base, total=counts())
    return out


def fmt_opt(x, spec=".3f"):
    return "not measured" if x is None else format(x, spec)


def programs_training(dev, knn, scatter):
    """16(c)-(d): the MSE and patch steps under RAdam, SGD and ``remat``
    (Adam), both routes from one state, then each under ``fix_random``
    (patch), bit for bit.  Returns the captured runs' launches and each
    graph's launches a replay, by variant and mode."""
    import torch
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train.loop import make_patch_loss_fn
    from instant_nvr_tpu_torch.train.step import (encoder_calls, mlp_wgrad_calls,
                                                  table_grad_launches)
    base = make_cfg(CFG).merged({"ep_iter": CAPTURE_EP_ITER})
    batches = {"mse": (train_net.synthetic_batch(base, dev), None),
               "patch": (train_net.to_tensors(train_net.patch_batch_np(base), dev),
                         make_patch_loss_fn(base))}
    smi = nvidia_smi()
    total, per_replay = {}, {}

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    def check_launches(label, run, routes, knn_per_step):
        # the forward runs each encoder as often as knn_blend (twice under
        # remat), its backward once, and the MLPs' weight gradients once
        want = {"knn_blend": CAPTURE_STEPS * knn_per_step, "knn_topk": 0,
                "segmented_scatter_add": CAPTURE_STEPS * routes["segmented"],
                "onehot_scatter_add": CAPTURE_STEPS * routes["onehot"],
                "sorted_scatter_add": CAPTURE_STEPS * routes["sorted"],
                "mlp_wgrad": CAPTURE_STEPS * layers}
        one = {k: n for k, n in (("knn_blend", knn_per_step),
                                 ("segmented_scatter_add", routes["segmented"]),
                                 ("onehot_scatter_add", routes["onehot"]),
                                 ("sorted_scatter_add", routes["sorted"]),
                                 ("fused_encode", calls * knn_per_step),
                                 ("fused_encode_backward", calls),
                                 ("mlp_wgrad", layers)) if n}
        graphs = graph_launches(run["step"]) if "captured" in label else [one]
        if run["launches"] != want or graphs != [one] or routes["exact"] or (
                "captured" in label and run["captured"] != (1, CAPTURE_STEPS - 3)):
            raise AssertionError(f"{label}: launches {run['launches']} != {want}; a replay "
                                 f"{graphs} != {one}; captures, replays {run['captured']}")
        return one

    for name, over in PROGRAM_VARIANTS:
        cfg = base.merged(over)
        routes = table_grad_launches(inb.build_model_spec(cfg), make_render_spec(cfg))
        calls = encoder_calls(make_render_spec(cfg))
        layers = mlp_wgrad_calls(inb.build_model_spec(cfg), make_render_spec(cfg))
        # remat runs the forward, and its knn_blend, again in the backward
        knn_per_step = 2 if cfg.get("remat", False) else 1
        for mode, (batch, pfn) in batches.items():
            t0 = time.perf_counter()
            e = program_run("eager", cfg, batch, pfn, dev, knn, scatter)
            c = program_run("captured", cfg, batch, pfn, dev, knn, scatter)
            check_launches(f"{name} {mode} eager", e, routes, knn_per_step)
            per_replay[f"{name}_{mode}"] = check_launches(f"{name} {mode} captured", c,
                                                          routes, knn_per_step)
            add(c["total"])
            add(e["total"])
            rel = float(((c["losses"] - e["losses"]).abs() / e["losses"].abs()).max())
            if not torch.isfinite(c["losses"]).all() or rel > 1e-3:
                raise AssertionError(f"{name} {mode}: losses {c['losses'].tolist()} vs eager "
                                     f"{e['losses'].tolist()} (rtol 1e-3)")
            worst, moved = params_agree(f"{name} {mode}", c["bits"], e["bits"],
                                        cfg.train.lr, CAPTURE_STEPS)
            n_rays = int(batch["ray_o"].shape[0])
            phase("programs-train", card=repr(smi), variant=name, mode=mode,
                  optimizer=c["optimizer"], steps=CAPTURE_STEPS, routes=repr(dict(routes)),
                  lr_steps=[f"{v:.6e}" for v in c["lr"]],
                  loss_eager=[f"{v:.6f}" for v in e["losses"].tolist()],
                  loss_captured=[f"{v:.6f}" for v in c["losses"].tolist()],
                  loss_max_rel_diff=f"{rel:.3e}", param_max_diff_lr=f"{worst:.4f}",
                  params_differing_1e6=moved, captures_replays=c["captured"],
                  launches_per_replay=repr(per_replay[f"{name}_{mode}"]),
                  rays=n_rays, ms_per_step_eager=fmt_opt(e["ms"], ".2f"),
                  ms_per_step_captured=fmt_opt(c["ms"], ".2f"),
                  busy_captured=fmt_opt(c["busy"]),
                  device_ms_per_step_captured=fmt_opt(c["device_ms"]),
                  top_kernels_captured=repr(c["top"]),
                  own_peak_mem_GB_eager=f"{e['peak'] / 1e9:.3f}",
                  own_peak_mem_GB_captured=f"{c['peak'] / 1e9:.3f}",
                  seconds=f"{time.perf_counter() - t0:.1f}",
                  tol=repr("loss rtol 1e-3; params <= 2.1 lr a step (phase 6)"))
            del e, c

        # fix_random: every table gradient through the sorted kernel, both
        # routes bit for bit
        fcfg = cfg.merged({"fix_random": True})
        froutes = table_grad_launches(inb.build_model_spec(fcfg), make_render_spec(fcfg))
        saved = (torch.are_deterministic_algorithms_enabled(),
                 torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        try:
            if not train_net.apply_fix_random(fcfg):
                raise AssertionError("fix_random not applied")
            batch, pfn = batches["patch"]
            e = program_run("eager", fcfg, batch, pfn, dev, knn, scatter, timed=False)
            c = program_run("captured", fcfg, batch, pfn, dev, knn, scatter, timed=False)
        finally:
            torch.use_deterministic_algorithms(saved[0])
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]
        if set(froutes) != {"sorted"}:
            raise AssertionError(f"{name} fix_random: routes {froutes}")
        check_launches(f"{name} fix_random eager", e, froutes, knn_per_step)
        per_replay[f"{name}_fix_random"] = check_launches(f"{name} fix_random captured", c,
                                                          froutes, knn_per_step)
        add(c["total"])
        add(e["total"])
        differing = [k for k in c["bits"] if not torch.equal(
            c["bits"][k].view(torch.uint8), e["bits"][k].view(torch.uint8))]
        moments = sorted({k.rsplit(".", 1)[1] for k in c["bits"] if k.endswith(MOMENTS)})
        phase("programs-fix-random", card=repr(smi), variant=name, steps=CAPTURE_STEPS,
              losses_bit_equal=torch.equal(c["losses"], e["losses"]), tensors=len(c["bits"]),
              moments=moments, tensors_differing=differing,
              launches_per_replay=repr(per_replay[f"{name}_fix_random"]),
              check="losses, every parameter and moment bit-equal, captured vs eager")
        if not torch.equal(c["losses"], e["losses"]) or differing:
            raise AssertionError(f"{name} fix_random: captured differs from eager: losses "
                                 f"{c['losses'].tolist()} vs {e['losses'].tolist()}, "
                                 f"tensors {differing[:8]}")
        del e, c
    assert_workspace_zero("programs steps")
    return total, per_replay


def programs_cube(dev):
    """16(a): the res-128 cube of phase 8's checkpoint, plain, deformed and
    with ``tbw``, on both routes: bit-equal, ms a cube, copies (profiler),
    peak memory; a load of other weights after the capture reaches the
    replay."""
    import numpy as np
    import torch
    from instant_nvr_tpu_torch import run
    from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
    from instant_nvr_tpu_torch.eval import mesh
    from instant_nvr_tpu_torch.tools import profile_eval
    from instant_nvr_tpu_torch.train import checkpoint
    root = os.path.join(HERE, "data", "fake_zju_smoke")
    cfg = patch_cfg(root, os.path.join(HERE, "exps", "chip_smoke_patch"), epochs=3)
    mspec, _, model = run.build(cfg, dev, seed=0)
    checkpoint.load_weights(cfg.trained_model_dir, model)
    item = TPoseDataset(cfg, "test").get_item(0)
    if np.asarray(item["tbw"]).ndim != 4:
        raise AssertionError("the fake subject's test item has no tbw volume")
    plain = {k: v for k, v in item.items() if k != "tbw"}
    smi = nvidia_smi()
    cubes = mesh.CUBES

    def cube(meta, deformed, eager):
        return mesh.occupancy_grid(cfg, mspec, model, meta, deformed, res=128,
                                   eager=eager)[0]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        return out, 1000 * (time.perf_counter() - t0)      # ends in the copy back

    def profiled(fn):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
        return profile_eval.copies(prof)

    def own_peak(fn):
        """fn() -> (its output, the memory it allocated at its peak over
        what was allocated before)"""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        return out, torch.cuda.max_memory_allocated() - base

    for name, meta, deformed in (("plain", plain, False), ("deformed", plain, True),
                                 ("tbw", item, False)):
        (want, eager_ms), eager_peak = own_peak(lambda: timed(lambda: cube(meta, deformed,
                                                                            True)))
        c0, r0 = cubes.captures, cubes.replays
        runs, peak = own_peak(lambda: [timed(lambda: cube(meta, deformed, False))
                                       for _ in range(3)])
        caps = (cubes.captures - c0, cubes.replays - r0)
        equal = [bool(np.array_equal(o, want)) for o, _ in runs]
        extra = {}
        if name == "tbw":       # the loop's case: the copies of each route
            copies = {"eager": profiled(lambda: cube(meta, deformed, True)),
                      "captured": profiled(lambda: cube(meta, deformed, False))}
            extra = {"pageable_host_to_device": {
                k: v.get("Memcpy HtoD (Pageable -> Device)", 0) for k, v in copies.items()},
                "device_to_host": {k: sum(n for c, n in v.items() if c.startswith("Memcpy DtoH"))
                                   for k, v in copies.items()},
                "copies": repr(copies)}
            if extra["device_to_host"]["captured"] > 1 \
                    or extra["pageable_host_to_device"]["captured"] > 8:
                raise AssertionError(f"cube {name}: copies {copies}")
        if name == "plain":
            # other weights, loaded in place after the capture: the replay
            # reads them, as the loop's per-epoch cube reads trained ones
            trained = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict({k: v * 0.5 if v.is_floating_point() else v
                                   for k, v in trained.items()})
            swapped = cube(meta, deformed, False)
            swapped_eager = cube(meta, deformed, True)
            model.load_state_dict(trained)
            extra = {"other_weights_bit_equal": bool(np.array_equal(swapped, swapped_eager)),
                     "other_weights_differ": not np.array_equal(swapped, want)}
            if not all(extra.values()):
                raise AssertionError(f"cube after a weight load: {extra}")
            del trained
        phase("programs-cube", card=repr(smi), case=name, res=128, deformed=deformed,
              tbw=name == "tbw", ms_eager=f"{eager_ms:.1f}",
              ms_captured=[f"{t:.1f}" for _, t in runs], captures_replays=caps,
              bit_equal=equal, own_peak_mem_GB_eager=f"{eager_peak / 1e9:.3f}",
              own_peak_mem_GB_captured=f"{peak / 1e9:.3f}",
              occupancy_range=f"[{want.min():.4f},{want.max():.4f}]", **extra)
        if not all(equal) or caps != (1, 2):
            raise AssertionError(f"cube {name}: bit-equal {equal}, captures/replays {caps}")


def programs_lpips(dev):
    """16(b): LPIPS of phase 9's 512^2 items (its comparison PNGs) through
    the evaluator on both routes: bit-equal, ms a call."""
    import glob
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.datasets.image_ops import read_image
    from instant_nvr_tpu_torch.eval import evaluator
    from instant_nvr_tpu_torch.tools import profile_eval
    comp = os.path.join(HERE, "exps", "chip_smoke_patch", "comparison")
    gts = sorted(glob.glob(os.path.join(comp, "*_gt.png")))[:2]
    if len(gts) != 2:
        raise AssertionError(f"phase 9's comparison PNGs: {gts}")
    pairs = [tuple(read_image(p).astype(np.float32) / 255.0 for p in
                   (gt.replace("_gt.png", ".png"), gt)) for gt in gts]
    if pairs[0][0].shape != (512, 512, 3):
        raise AssertionError(f"item side {pairs[0][0].shape}")
    evs = {"eager": evaluator.Evaluator(device=dev),
           "captured": evaluator.Evaluator(device=dev, captured=True)}
    lp = evaluator.LPIPS
    c0, r0 = lp.captures, lp.replays
    vals = {k: [[ev._lpips(*pair) for _ in range(3)] for pair in pairs]
            for k, ev in evs.items()}
    ms = {}
    for k, ev in evs.items():
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            ev._lpips(*pairs[0])               # ends in the host read of the scalar
            ts.append(1000 * (time.perf_counter() - t0))
        ms[k] = sorted(ts)
    copies = {}
    for k, ev in evs.items():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            ev._lpips(*pairs[0])
        copies[k] = profile_eval.copies(prof)
    equal = [all(v == vals["eager"][i][0] for v in vals["captured"][i] + vals["eager"][i])
             for i in range(len(pairs))]
    phase("programs-lpips", card=repr(nvidia_smi()), items=len(pairs), side=512,
          lpips=[f"{v[0]:.6f}" for v in vals["eager"]], bit_equal=equal,
          captures_replays=(lp.captures - c0, lp.replays - r0),
          ms_eager=[f"{t:.2f}" for t in ms["eager"]],
          ms_captured=[f"{t:.2f}" for t in ms["captured"]], copies=repr(copies))
    if not all(equal):
        raise AssertionError(f"LPIPS captured vs eager: {vals}")


def programs_nccl(world=1):
    """16(e): ``train_net --distributed`` on ``world`` NCCL ranks (one a
    card), captured and ``--eager``, ``NCCL_STEPS`` patch steps of phase
    8's subject under ``fix_random`` each, the two jobs at once (their
    processes share the cards, so their ms a step are not timings of one
    job): the routes printed, the losses, parameters and moments of the
    two runs bit-equal.  Returns the captured run's rank-0 launches."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from instant_nvr_tpu_torch.tools import multiprocess_check as mc
    from instant_nvr_tpu_torch.train.checkpoint import STATE_FILE
    root = os.path.join(HERE, "data", "fake_zju_smoke")
    opts = []
    for split in ("train_dataset", "val_dataset", "test_dataset"):
        opts += [f"{split}.data_root", root, f"{split}.ann_file",
                 os.path.join(root, "annots.npy")]
    opts += ["smpl_meta", os.path.join(root, "smpl-meta"), "num_train_frame", str(FRAMES)]
    def job(route, flags):
        exp = os.path.join(PROGRAMS_DIR, f"nccl{world}_{route}")
        work = os.path.join(PROGRAMS_DIR, f"nccl{world}_{route}_run")
        for d in (exp, work):
            shutil.rmtree(d, ignore_errors=True)
        os.makedirs(work)
        torch.save({"module": "train_net", "argv": [
            "--cfg_file", os.path.join(HERE, "configs", "inb", "inb_fake.yaml"),
            "--device", "cuda", "--distributed", "--no_resume", *flags, *opts,
            "ep_iter", str(NCCL_STEPS), "train.epoch", "1", "eval_ep", "100",
            "fix_random", "True", "result_dir", exp,
            "trained_model_dir", os.path.join(exp, "model"),
            "record_dir", os.path.join(exp, "record")]}, os.path.join(work, "inputs.pt"))
        t0 = time.perf_counter()
        ranks = mc.launch("cli", world, work, device="cuda", backend=None, timeout=600)
        wall = time.perf_counter() - t0
        with open(os.path.join(work, "rank0.log")) as f:
            printed = [ln.strip() for ln in f if ln.startswith("step route:")]
        payload = torch.load(os.path.join(exp, "model", "latest", STATE_FILE),
                             map_location="cpu", weights_only=True)
        return ranks, printed, payload, wall
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(job, "captured", []), pool.submit(job, "eager", ["--eager"])]
        (rc, pc, sc, wc), (re_, pe, se, we) = [f.result() for f in futures]
    want_route = {"captured": "step route: captured", "eager": "step route: eager (--eager)"}
    differing = [k for k, v in sc["model"].items()
                 if not torch.equal(v.view(torch.uint8), se["model"][k].view(torch.uint8))]
    moments = 0
    for i, st in sc["optimizer"]["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v) and v.ndim:
                moments += 1
                if not torch.equal(v.view(torch.uint8),
                                   se["optimizer"]["state"][i][k].view(torch.uint8)):
                    differing.append(f"state {i}.{k}")
    losses_equal = all(c["losses"] == e["losses"] for c, e in zip(rc, re_))
    phase("programs-nccl", card=repr(nvidia_smi()), ranks=world,
          backend=rc[0]["backend"], entry="train_net --distributed",
          config="inb_fake (inb_377 widths), patch LPIPS, fix_random", steps=NCCL_STEPS,
          routes_printed=[pc, pe], losses_captured=[f"{x:.6f}" for x in rc[0]["losses"]],
          losses_eager=[f"{x:.6f}" for x in re_[0]["losses"]], losses_bit_equal=losses_equal,
          parameters=len(sc["model"]), moments=moments, tensors_differing=differing[:8],
          launches=repr(rc[0]["launches"]), wall_s_at_once=[f"{wc:.1f}", f"{we:.1f}"])
    if pc != [want_route["captured"]] or pe != [want_route["eager"]] \
            or rc[0]["backend"] != "nccl" or not losses_equal or differing \
            or not np.isfinite(rc[0]["losses"]).all() or len(rc[0]["losses"]) != NCCL_STEPS:
        raise AssertionError(f"NCCL x{world}: routes {pc} / {pe}, losses "
                             f"{rc[0]['losses']} / {re_[0]['losses']}, differing "
                             f"{differing[:8]}")
    return rc[0]["launches"]


def programs_slice(dev, knn, scatter):
    """Phase 16: the cube, the eval LPIPS, and the RAdam, SGD, remat and
    NCCL train steps captured against their eager routes.  Returns (the
    phase's launches, each step graph's launches a replay)."""
    import shutil
    shutil.rmtree(PROGRAMS_DIR, ignore_errors=True)
    os.makedirs(PROGRAMS_DIR)
    reset_counts(knn, scatter)
    programs_cube(dev)
    programs_lpips(dev)
    counts = launch_counts(knn, scatter)
    if any(counts.values()):
        raise AssertionError(f"the cube and LPIPS launched kernels: {counts}")
    total, per_replay = programs_training(dev, knn, scatter)
    for k, v in programs_nccl().items():
        total[k] = total.get(k, 0) + v
    return total, per_replay


# the part budgets of a render chunk of inb377.render.eval at the budgets
# its set-up raises to (cull 0.4652 of 4,096 rays x 64 samples, each part
# raised on its own): 432,128 points a chunk (PERF.md, section 5)
RENDER_KPS = (61_056, 121_984, 121_984, 58_496, 68_608)


def tests_module(name):
    """``tests/<name>.py``, whose cases a phase runs (it imports nothing of
    JAX)."""
    import importlib.util
    path = os.path.join(HERE, "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hashgrid_cases_module():
    """``tests/test_torch_hashgrid_fused.py``, whose cases phases 17 and 18
    run."""
    return tests_module("test_torch_hashgrid_fused")


def gathered_bytes(fn):
    """Bytes of the distinct table rows the plain chain gathers in ``fn()``
    (each row once, at the table's row width)."""
    import torch
    from instant_nvr_tpu_torch.ops import hashgrid
    total, orig = [0], hashgrid._gather

    def spy(spec, table, ind, level_offsets):
        row = table.element_size() * (1 if table.ndim == 1 else table.shape[1])
        total[0] += int(torch.unique(ind).numel()) * row
        return orig(spec, table, ind, level_offsets)
    hashgrid._gather = spy
    try:
        fn()
    finally:
        hashgrid._gather = orig
    return total[0]


def hashgrid_slice(dev):
    """Phase 17 (see the module doc) -> its numbers by encoder."""
    import torch
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.models import inb
    t = hashgrid_cases_module()
    t0 = time.perf_counter()
    worst = {}
    for name, kind, specs, dtype in t.cases():
        for std in t.SCALES:
            for points, r in t.run_case(name, kind, specs, dtype, std, dev).items():
                phase("hashgrid-vs-plain", case=name, std=std, points=points,
                      max_abs_err=f"{r['max_abs_err']:.3e}", bit_equal=f"{r['bit_equal']:.6f}",
                      over_tol=r["over_tol"])
                if not r["ok"]:
                    raise AssertionError(f"hashgrid {name} std {std} {points}: {r}")
                worst[name] = max(worst.get(name, 0.0), r["max_abs_err"])
            torch.cuda.empty_cache()
    control = {std: t.control_case(std, dev) for std in t.SCALES}
    phase("hashgrid-control", lerp="bfloat16", tol=repr(t.TOL),
          **{f"std{std}": repr(r) for std, r in control.items()})
    if control[1.0]["ok"]:
        raise AssertionError("the bf16-lerp control holds the tolerance at std 1.0: "
                             "the check cannot see the lerp's precision")
    phase("hashgrid-cases", seconds=f"{time.perf_counter() - t0:.1f}")

    # the render chunk's shape
    mspec = inb.build_model_spec(make_cfg(CFG))
    Kps = RENDER_KPS
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"max_abs_err": worst, "control": control}
    for enc, kind, specs, dtype, segs in (
            ("parts", "multi", mspec.part_embeds, torch.bfloat16, Kps),
            ("deformer", "single", (mspec.deformer.embed,), torch.float32, (sum(Kps),))):
        tables = t.draw_tables(specs, 0.1, dtype, gen, dev)
        pts, bounds, segs = t.draw_points(specs, kind, gen, dev, segs)["box"]
        M, D = sum(segs), specs[0].out_dim
        with torch.no_grad():
            fused = lambda: t.encode(kind, specs, tables, pts, bounds, segs)  # noqa: E731
            plain = lambda: t.encode(kind, specs, tables, pts, bounds, segs, plain=True)  # noqa: E731
            r = t.compare(fused(), plain())
            if not r["ok"]:
                raise AssertionError(f"hashgrid {enc} at the render chunk's shape: {r}")
            ms, plain_ms = cuda_median_ms(fused), cuda_median_ms(plain)
            split = device_split(fused)
            dev_ms = sum(split.values()) if split else None
            plain_dev_ms = device_ms(plain)
            nbytes = 12 * M + 24 * len(specs) + 4 * D * M + gathered_bytes(plain)
        bnd = bound(0, nbytes)
        share = None if dev_ms is None else bnd[0] / dev_ms
        out[enc] = {"points": M, "segments": list(segs), "ms": ms, "device_ms": dev_ms,
                    "kernels": sorted(kernel_name(k) for k in split),
                    "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms,
                    "max_abs_err": r["max_abs_err"], "bit_equal": r["bit_equal"],
                    "bound_ms": bnd[0], "bound_by": bnd[1], "share": share}
        phase("hashgrid-time", card=repr(nvidia_smi()), encoder=enc, points=M,
              segments=list(segs), max_abs_err=f"{r['max_abs_err']:.3e}",
              bit_equal=f"{r['bit_equal']:.6f}", ms=fmt_ms(ms), device_ms=fmt_ms(dev_ms),
              kernels=repr(out[enc]["kernels"]), plain_ms=fmt_ms(plain_ms),
              plain_device_ms=fmt_ms(plain_dev_ms), bound_ms=f"{bnd[0]:.4f}",
              bound_by=bnd[1], share=("not measured" if share is None else f"{share:.1%}"),
              speedup=f"{plain_ms / ms:.1f}x")
        del tables, pts
        torch.cuda.empty_cache()
    return out


def hashgrid_backward_slice(dev):
    """Phase 18 (see the module doc) -> its numbers by encoder call."""
    import torch
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.models import inb
    from instant_nvr_tpu_torch.ops import hashgrid
    t = hashgrid_cases_module()
    t0 = time.perf_counter()
    out = {"cases": {}}
    for case in t.BACKWARD_CASES:
        for std in t.SCALES:
            r = t.backward_case(case, dev, std=std)
            out["cases"][f"{case}@{std}"] = r
            phase("hashgrid-backward-vs-plain", case=case, std=std, points=r["points"],
                  records=r["records"], records_equal=r["records_equal"],
                  forward_equal=r["forward_equal"],
                  points_bit_equal_twin=r["points_bit_equal_twin"],
                  points_vs_float64=repr(r["points_vs_float64"]),
                  plain_vs_float64=repr(r["plain_vs_float64"]),
                  bf16_lerp_vs_float64=repr(r.get("bf16_lerp_vs_float64")),
                  limit=f"{t.POINTS_LIMIT:g} of the term scale")
            bad = (not (r["records_equal"] and r["forward_equal"] and r["points_bit_equal_twin"]
                        and r["points_vs_float64"]["ok"])
                   or r["points_vs_float64"]["cells_differ"] >= 0.001 * r["points"]
                   or r.get("bf16_lerp_vs_float64", {"ok": False})["ok"])
            if bad:
                raise AssertionError(f"hashgrid backward {case} std {std}: {r}")
            torch.cuda.empty_cache()
    phase("hashgrid-backward-cases", seconds=f"{time.perf_counter() - t0:.1f}")

    # each encoder call of a fit step at its shape: forward and backward
    # through the plain chain's autograd and through the Function, and the
    # backward kernel alone
    mspec = inb.build_model_spec(make_cfg(CFG))
    gen = torch.Generator(device=dev).manual_seed(0)
    fit = (sum(t.FIT_SEGMENTS),)
    for enc, kind, specs, dtype, segs in (
            ("parts", "multi", mspec.part_embeds, torch.bfloat16, t.FIT_SEGMENTS),
            ("deformer", "single", (mspec.deformer.embed,), torch.float32, fit),
            ("pair_deformer", "single", (mspec.deformer.embed,), torch.float32,
             (t.PAIR_SLOTS,))):
        tables = t.draw_tables(specs, 0.1, dtype, gen, dev)
        pts, bounds, segs = t.draw_points(specs, kind, gen, dev, segs)["box"]
        b = bounds if kind == "multi" else bounds[:1]
        M, D = sum(segs), specs[0].out_dim
        need_pts = kind == "multi"      # the fit asks the part grids' points alone
        leaves = t.leaf_tables(tables)
        x = pts.clone().requires_grad_(need_pts)
        wrt = [v for tab in leaves for v in tab.values()] + ([x] if need_pts else [])
        g = torch.randn((M, D), generator=gen, device=dev)

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(kind, specs, leaves, x, bounds, segs), wrt, g)
        plain, fused = fwd_bwd(t.plain_fn), fwd_bwd(t.function_fn)
        dtype_p = hashgrid.payload_dtype(specs[0], dtype)
        kernel = lambda: hashgrid.fused_encode_backward(  # noqa: E731
            specs, tables, pts, b, segs, g, kind == "multi", need_pts, dtype_p)
        plain_ms, fused_ms = cuda_median_ms(plain), cuda_median_ms(fused)
        split = device_split(fused)
        kernel_split = device_split(kernel)
        bwd_ms = sum(v for k, v in kernel_split.items() if "hashgrid_backward_kernel" in k)
        fwd_ms = sum(v for k, v in split.items() if "hashgrid_encode_kernel" in k)
        scatter_ms = sum(v for k, v in split.items()
                         if any(n in k for n in ("segmented", "onehot", "sorted_scatter")))
        plain_dev = device_ms(plain)
        V = 1 if specs[0].scalar else specs[0].n_features
        L = specs[0].n_levels
        with torch.no_grad():
            rows = gathered_bytes(lambda: t.plain_fn(kind, specs, tables, pts, bounds, segs))
        nbytes = (12 * M + 4 * D * M + 4 * L * 8 * M + dtype_p.itemsize * V * L * 8 * M
                  + (12 * M + rows if need_pts else 0))
        bnd = bound(0, nbytes)
        share = bnd[0] / bwd_ms if bwd_ms else None
        out[enc] = {"points": M, "plain_ms": plain_ms, "plain_device_ms": plain_dev,
                    "fused_ms": fused_ms, "fused_device_ms": sum(split.values()) or None,
                    "forward_kernel_device_ms": fwd_ms or None,
                    "backward_kernel_device_ms": bwd_ms or None,
                    "scatter_device_ms": scatter_ms or None,
                    "backward_kernels": sorted(kernel_name(k) for k in kernel_split),
                    "bound_ms": bnd[0], "bound_by": bnd[1], "share": share}
        phase("hashgrid-backward-time", card=repr(nvidia_smi()), encoder=enc, points=M,
              points_grad=need_pts, plain_ms=fmt_ms(plain_ms), plain_device_ms=fmt_ms(plain_dev),
              fused_ms=fmt_ms(fused_ms), fused_device_ms=fmt_ms(out[enc]["fused_device_ms"]),
              forward_kernel_device_ms=fmt_ms(out[enc]["forward_kernel_device_ms"]),
              backward_kernel_device_ms=fmt_ms(out[enc]["backward_kernel_device_ms"]),
              scatter_device_ms=fmt_ms(out[enc]["scatter_device_ms"]),
              backward_kernels=repr(out[enc]["backward_kernels"]),
              bound_ms=f"{bnd[0]:.4f}", bound_by=bnd[1],
              share=("not measured" if share is None else f"{share:.1%}"),
              speedup=f"{plain_ms / fused_ms:.1f}x")
        del tables, leaves, pts, x, g
        torch.cuda.empty_cache()
    return out


def mlp_wgrad_slice(dev):
    """Phase 19 (see the module doc) -> its numbers by layer."""
    import torch
    from instant_nvr_tpu_torch.ops import mlp_wgrad as mw
    t = tests_module("test_torch_mlp_wgrad")
    t0 = time.perf_counter()
    out = {"limit": t.LIMIT, "cases": {}, "layers": {}}
    for shape in t.fit_layers() + list(t.EDGE_LAYERS):
        r = t.layer_case(*shape, dev)
        out["cases"][shape[0]] = r
        phase("mlp-wgrad-vs-float64", layer=shape[0], parts=r["parts"], rows=r["rows"],
              din=r["din"], dout=r["dout"], kernel=f"{r['kernel']:.3e}",
              cublas=f"{r['cublas']:.3e}", bf16_cotangent=f"{r['control']:.3e}",
              repeat_bit_equal=r["repeat_bit_equal"],
              limit=f"{t.LIMIT:.3e} of the element's sum of |x g|")
        if not r["ok"]:
            raise AssertionError(f"mlp_wgrad {shape}: {r}")
        torch.cuda.empty_cache()
    phase("mlp-wgrad-cases", seconds=f"{time.perf_counter() - t0:.1f}")

    # each layer of a fit step at its shape: the kernel, and the calls the
    # port no longer makes, cuBLAS's x^T g and the bias's sum (the yardstick)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = {"kernel_device_ms": 0.0, "cublas_device_ms": 0.0, "bias_sum_device_ms": 0.0,
            "bound_ms": 0.0}
    for name, stacked, P, N, din, dout in t.fit_layers():
        x, g = t.draw_operands(stacked, P, N, din, dout, gen, dev)
        kernel = lambda: mw.weight_grads(x, g)  # noqa: E731
        if stacked:
            library = lambda: torch.bmm(x.transpose(1, 2), g)  # noqa: E731
            bias = lambda: g.sum(1)  # noqa: E731
        else:
            library = lambda: x.t().mm(g)  # noqa: E731
            bias = lambda: g.sum(0)  # noqa: E731
        split, lib_split = device_split(kernel), device_split(library)
        dev_ms = sum(split.values()) or None
        lib_ms = sum(lib_split.values()) or None
        bias_ms = device_ms(bias)
        ms = cuda_median_ms(kernel)
        bnd = bound(2 * P * N * (din + 1) * dout, 4 * P * (N * (din + dout) + (din + 1) * dout))
        share = None if dev_ms is None else bnd[0] / dev_ms
        out["layers"][name] = {
            "parts": P, "rows": N, "din": din, "dout": dout, "ms": ms, "device_ms": dev_ms,
            "kernels": {kernel_name(k): v for k, v in split.items()},
            "library_ms": lib_ms, "library_kernels": sorted(lib_split),
            "bias_sum_ms": bias_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "share": share}
        for k, v in (("kernel_device_ms", dev_ms), ("cublas_device_ms", lib_ms),
                     ("bias_sum_device_ms", bias_ms), ("bound_ms", bnd[0])):
            step[k] = None if step[k] is None or v is None else step[k] + v
        phase("mlp-wgrad-time", card=repr(nvidia_smi()), layer=name, parts=P, rows=N, din=din,
              dout=dout, ms=fmt_ms(ms), device_ms=fmt_ms(dev_ms),
              kernels=repr(out["layers"][name]["kernels"]), library_ms=fmt_ms(lib_ms),
              library_kernels=repr(sorted(kernel_name(k) for k in lib_split)),
              bias_sum_ms=fmt_ms(bias_ms), bound_ms=f"{bnd[0]:.4f}", bound_by=bnd[1],
              share=("not measured" if share is None else f"{share:.1%}"))
        del x, g
        torch.cuda.empty_cache()
    step["share"] = (None if step["kernel_device_ms"] is None
                     else step["bound_ms"] / step["kernel_device_ms"])
    out["step"] = step
    phase("mlp-wgrad-step", card=repr(nvidia_smi()), layers=len(t.fit_layers()),
          **{k: (f"{v:.4f}" if k != "share" else f"{v:.1%}") if v is not None
             else "not measured" for k, v in step.items()})
    return out


def nccl_ranks_only(world: int) -> int:
    """``python3 chip_smoke.py --nccl-ranks N``: only phase 16(e), on N
    NCCL ranks, one a card (N cards), after the kernels' build and phase
    8's subject."""
    import torch
    from instant_nvr_tpu_torch import cuda_build
    from instant_nvr_tpu_torch.datasets import jpeg
    from instant_nvr_tpu_torch.datasets.fake_zju import write_fake_dataset
    from instant_nvr_tpu_torch.utils import native
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"--nccl-ranks {world}: {torch.cuda.device_count()} cards")
    kind = torch.cuda.get_device_name(0)
    phase("device", name=repr(kind), count=torch.cuda.device_count(),
          nvidia_smi=repr(nvidia_smi()), torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    cuda_build.build_libraries()            # once, before the ranks load them
    native.load()
    jpeg.load()
    write_fake_dataset(os.path.join(HERE, "data", "fake_zju_smoke"), n_frames=FRAMES,
                       n_views=3, n_verts=2000, H=512, W=512, supersample=1)
    phase("build", kernels=len(cuda_build.KERNELS), seconds=f"{time.perf_counter() - t0:.2f}")
    launches = programs_nccl(world)
    print(json.dumps({"nccl_ranks": world, "rank0_launches": launches}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    if argv:
        if len(argv) != 2 or argv[0] != "--nccl-ranks":
            print("usage: python3 chip_smoke.py [--nccl-ranks N]", file=sys.stderr)
            return 2
    # phase 13c's fix_random runs: cuBLAS reads its workspace setting once,
    # at its first handle, so it is set here as train_net's fix_random sets
    # it before its first step
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, HERE)
    import numpy as np
    import instant_nvr_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            instant_nvr_tpu_torch.__file__))) != HERE:
        raise RuntimeError("instant_nvr_tpu_torch must come from this checkout")
    if argv:
        return nccl_ranks_only(int(argv[1]))
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.eval.runner import AutoBudgetRenderer, eval_chunk
    from instant_nvr_tpu_torch.ops import hashgrid, knn, mlp_wgrad, scatter
    from instant_nvr_tpu_torch import cuda_build, run
    from instant_nvr_tpu_torch.utils import native
    from instant_nvr_tpu_torch.datasets import jpeg
    from instant_nvr_tpu_torch.train import orbax_format
    from instant_nvr_tpu_torch.eval import video

    # 1. device
    dev = run.resolve_device("cuda")            # also turns TF32 off
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", name=repr(kind), count=torch.cuda.device_count(),
          nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: every kernel at once, then load each
    t0 = time.perf_counter()
    cuda_build.build_libraries()
    knn.load_kernel()
    knn.load_topk_kernel()
    scatter.load_segmented_kernel()
    scatter.load_onehot_kernel()
    scatter.load_sorted_kernel()
    hashgrid.load_fused_kernel()
    mlp_wgrad.load_kernel()
    for name in cuda_build.KERNELS:
        ptxas = [ln.strip() for ln in cuda_build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", kernel=name, ptxas=repr(ptxas))
    phase("build", kernels=len(cuda_build.KERNELS),
          seconds=f"{time.perf_counter() - t0:.2f}")
    # the data layer's native host libraries (g++), before any loader runs
    t0 = time.perf_counter()
    native.load()
    jpeg.load()
    orbax_format.load()
    video.load()
    phase("build", host_library=os.path.relpath(native.library_path(), HERE),
          image_decoder=os.path.relpath(jpeg.library_path(), HERE),
          zstd_decoder=os.path.relpath(orbax_format.library_path(), HERE),
          video_encoder=os.path.relpath(video.library_path(), HERE),
          seconds=f"{time.perf_counter() - t0:.2f}")

    # 3. kernel vs plain, at the render and train paths' shapes
    cfg = make_cfg(CFG)
    rng = np.random.default_rng(0)
    cases = knn_inputs(dev, rng)
    blend = {n: knn_case(n, c, knn) for n, c in cases.items()}
    epilogue_err = epilogue_cases(cases["inb_377-chunk"], knn)
    topk = {n: topk_case(n, c, knn) for n, c in cases.items()}
    scatter_res = scatter_cases(cfg, dev, rng)

    # 4. the render slice: full-width inb_377 through run --type render's
    #    functions
    torch.cuda.reset_peak_memory_stats()
    reset_counts(knn, scatter)
    r = run.render_frames(cfg, dev, frames=3, seed=0)
    launches = knn.knn_blend.launches
    if scatter.segmented_scatter_add.launches or scatter.onehot_scatter_add.launches:
        raise AssertionError("the render path launched a scatter kernel")
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
    enc = (hashgrid.fused_encode.launches, hashgrid.fused_encode_backward.launches)
    if enc != (2 * r["chunks_rendered"], 0):
        raise AssertionError(f"the render's encoders: (forward, backward) launches "
                             f"{enc} for {r['chunks_rendered']} chunks")
    if mlp_wgrad.mlp_wgrad.launches:
        raise AssertionError(f"the render launched mlp_wgrad "
                             f"{mlp_wgrad.mlp_wgrad.launches} times")
    warm_ms = 1000.0 * float(np.median(r["frame_s"][1:]))
    phase("slice", config="inb_377", side=int(round(1024 * cfg.eval_ratio)),
          rays_per_frame=r["rays"], chunk=r["chunk"], frames=len(r["frame_s"]),
          chunks_rendered=r["chunks_rendered"], knn_launches=launches,
          encode_launches=enc[0], encode_backward_launches=enc[1],
          mlp_wgrad_launches=mlp_wgrad.mlp_wgrad.launches, frame_ms=[f"{1000 * s:.1f}" for s in r["frame_s"]],
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
    del model, gpu, cpu

    # 5. the train slice: full-width inb_377 MSE steps
    counts, routes = train_slice(cfg, dev, knn, scatter)
    counts["knn_blend"] += launches
    assert_workspace_zero("train slice")

    # 6. one train step, card vs CPU
    card_vs_cpu_step(cfg, dev)

    # 7. the self-check entry point, in this process
    counts = {k: counts.get(k, 0) + v
              for k, v in selfcheck(dev, knn, scatter, routes).items()}
    assert_workspace_zero("self-check")

    # 8. the patch slice: the training run on the fake subject
    patch_launches, patch_steps, patch_timed = patch_slice(dev, knn, scatter)
    counts = {k: counts[k] + patch_launches[k] for k in counts}
    # whole: check_patch_run held every count to the routing times the steps
    per_step = {k: v // patch_steps for k, v in patch_launches.items()}

    # 9. the eval slice on phase 8's checkpoint
    t0 = time.perf_counter()
    eval_launches, eval_knn, eval_per_frame = eval_slice(dev, knn, scatter)
    phase("eval-slice", seconds=f"{time.perf_counter() - t0:.1f}")
    counts = {k: counts[k] + eval_launches[k] for k in counts}

    # 10. the data-parallel slice: two ranks on the card, one NCCL rank
    t0 = time.perf_counter()
    dp_launches = dp_slice(dev, knn, scatter)
    phase("dp-slice", seconds=f"{time.perf_counter() - t0:.1f}",
          launches_per_rank=repr(dp_launches))
    counts = {k: counts[k] + sum(r.get(k, 0) for r in dp_launches) for k in counts}

    # 11. the real-subject slice: JPEG data, the bf16 moment, the .pth import
    t0 = time.perf_counter()
    real_launches = real_slice(dev, knn, scatter)
    phase("real-slice", seconds=f"{time.perf_counter() - t0:.1f}",
          launches=repr(real_launches))
    counts = {k: counts[k] + real_launches[k] for k in counts}

    # 12. the JAX package's orbax checkpoints: the corpus, the committed
    #     tiny checkpoints against JAX, a full-width resume and evaluation
    t0 = time.perf_counter()
    orbax_launches = orbax_slice(dev, knn, scatter)
    phase("orbax-slice", seconds=f"{time.perf_counter() - t0:.1f}",
          launches=repr(orbax_launches))
    counts = {k: counts[k] + orbax_launches[k] for k in counts}

    # 13. the completed modules: partition mode, packed JAX tables,
    #     fix_random on the sorted kernel, --detect_anomaly, the mp4 writer
    t0 = time.perf_counter()
    completion_launches, sorted_res, fix_per_step, fix_step = completion_slice(dev, knn,
                                                                               scatter)
    phase("completion-slice", card=repr(nvidia_smi()),
          seconds=f"{time.perf_counter() - t0:.1f}",
          launches=repr(completion_launches))
    counts = {k: counts.get(k, 0) + v for k, v in completion_launches.items()}

    # 15. the captured train step and eval frame against the eager ones
    t0 = time.perf_counter()
    captured_launches, per_replay = captured_slice(dev, knn, scatter)
    phase("captured-slice", card=repr(nvidia_smi()),
          seconds=f"{time.perf_counter() - t0:.1f}", launches=repr(captured_launches))
    counts = {k: v + captured_launches.get(k, 0) for k, v in counts.items()}

    # 16. the cube, the eval LPIPS, and the RAdam, SGD, remat and NCCL steps
    #     captured against their eager routes
    t0 = time.perf_counter()
    programs_launches, programs_replay = programs_slice(dev, knn, scatter)
    phase("programs-slice", card=repr(nvidia_smi()),
          seconds=f"{time.perf_counter() - t0:.1f}", launches=repr(programs_launches))
    counts = {k: v + programs_launches.get(k, 0) for k, v in counts.items()}

    # 17. the fused hash-grid encoding against the plain chain, and its times
    hashgrid_res = hashgrid_slice(dev)

    # 18. its backward at a fit step's shapes against the plain chain's
    #     autograd and a float64 chain, and its times
    backward_res = hashgrid_backward_slice(dev)

    # 19. the MLPs' weight gradients at a fit step's shapes against float64,
    #     and their times beside cuBLAS's
    wgrad_res = mlp_wgrad_slice(dev)

    def row(name, source, replaces, err, ms, plain_ms, bnd, library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"instant_nvr_tpu_torch/csrc/{source}",
                "replaces": f"instant_nvr_tpu/ops/pallas/{replaces}",
                "launches": counts.get(name, 0), "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "bounded_by": bnd[1], "library_ms": library_ms}
    # no single PyTorch call computes a per-part 4-NN over ragged lengths:
    # the two KNN rows have no library time; their times are the render
    # chunk's, the train step's shape beside them
    rows = []
    for name, src, replaces, res in (("knn_blend", "knn_blend.cu", "knn_pallas.py:111", blend),
                                     ("knn_topk", "knn_topk.cu", "knn_pallas.py:36", topk)):
        chunk, train = res["inb_377-chunk"], res["train-shape"]
        errs = [v[0] for v in res.values()] + ([epilogue_err] if res is blend else [])
        r = row(name, src, replaces, max(errs), *chunk[1:4])
        r.update(device_ms=chunk[4], train_shape_ms=train[1],
                 train_shape_device_ms=train[4])
        rows.append(r)
    for name, src, replaces in (
            ("segmented_scatter_add", "segmented_scatter.cu",
             "segmented_scatter.py:156"),
            ("onehot_scatter_add", "onehot_scatter.cu", "onehot_scatter.py:77")):
        err, ms, pms, lib_ms, bnd, dev_ms, lib_dev_ms, rec = scatter_res[name]
        r = row(name, src, replaces, err, ms, pms, bnd, lib_ms)
        r.update(device_ms=dev_ms, library_device_ms=lib_dev_ms,
                 train_records_ms=rec[1], train_records_device_ms=rec[5],
                 train_records_plain_ms=rec[2], train_records_library_ms=rec[3],
                 train_records_library_device_ms=rec[6])
        rows.append(r)
    # the sorted kernel (fix_random): its uniform-keys case, the train
    # step's records beside it
    err, ms, pms, lib_ms, bnd, dev_ms, lib_dev_ms, _, det = sorted_res[0]
    r = row("sorted_scatter_add", "sorted_scatter.cu", "segmented_scatter.py:382", err, ms,
            pms, bnd, lib_ms)
    r.update(device_ms=dev_ms, library_device_ms=lib_dev_ms,
             det_ms=det["kernel_det"][0], det_queued_ms=det["kernel_det"][1],
             library_det_ms=det["index_add_det"][0],
             library_det_queued_ms=det["index_add_det"][1],
             max_abs_err=max(x[0] for x in sorted_res),
             rows_one_ulp_vs_cpu_plain=[x[7] for x in sorted_res],
             fix_random_patch_step_launches=fix_per_step,
             fix_random_step_sorted_event_ms=fix_step[1],
             fix_random_step_sorted_queued_ms=fix_step[2],
             fix_random_step_index_add_det_queued_ms=fix_step[3])
    rec = sorted_res[1]
    r.update(train_records_ms=rec[1], train_records_device_ms=rec[5],
             train_records_plain_ms=rec[2], train_records_library_ms=rec[3],
             train_records_library_device_ms=rec[6])
    rows.append(r)
    # the patch path: launches a step, and each kernel on one patch step's
    # own inputs
    for r in rows:
        r["patch_step_launches"] = per_step.get(r["name"], 0)
        if r["name"] == "knn_blend":
            err, ms, pms, bnd, dev_ms = patch_timed["knn_blend"]
            lib_ms = None
        elif r["name"] in patch_timed:
            err, ms, pms, lib_ms, bnd, dev_ms, _ = patch_timed[r["name"]]
        else:
            continue
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.update(patch_shape_ms=ms, patch_shape_device_ms=dev_ms,
                 patch_shape_plain_ms=pms, patch_shape_library_ms=lib_ms,
                 patch_shape_bound_ms=bnd[0], patch_shape_bound_by=bnd[1])
        if r["name"] == "knn_blend":
            # the eval path: launches per 512^2 eval frame (read from the
            # counter), and the kernel on one eval chunk's own inputs
            err, ms, pms, bnd, dev_ms = eval_knn
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r.update(eval_frame_launches=eval_per_frame, eval_shape_ms=ms,
                     eval_shape_device_ms=dev_ms, eval_shape_plain_ms=pms,
                     eval_shape_bound_ms=bnd[0], eval_shape_bound_by=bnd[1])
    for r in rows:
        # phase 10's launches in each rank (rank 0's with the NCCL rank's)
        r["dp_launches_per_rank"] = [d.get(r["name"], 0) for d in dp_launches]
        r["orbax_launches"] = orbax_launches.get(r["name"], 0)
        r["completion_launches"] = completion_launches[r["name"]]
        # phase 15's, and its graphs' launches a replay (MSE, patch,
        # fix_random patch)
        r["captured_launches"] = captured_launches.get(r["name"], 0)
        r["captured_replay_launches"] = {m: g.get(r["name"], 0)
                                         for m, g in per_replay.items()}
        # phase 16's, and its step graphs' launches a replay (RAdam, SGD,
        # remat; MSE, patch, fix_random patch)
        r["programs_launches"] = programs_launches.get(r["name"], 0)
        r["programs_replay_launches"] = {m: g.get(r["name"], 0)
                                         for m, g in programs_replay.items()}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"hashgrid_encode": hashgrid_res}))
    print(json.dumps({"hashgrid_backward": backward_res}))
    print(json.dumps({"mlp_wgrad": wgrad_res}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
