"""``fix_random`` and ``--detect_anomaly`` in the port, on the CPU.

- ``sorted_scatter_add``'s plain version (the stable sort, then each row's
  records added in order in float32) is bit for bit the JAX package's
  reference scatter (``segmented_scatter_add_ref``: an f32 XLA scatter in
  record order, rounded to bf16 once) and drops keys outside the table;
- the kernel's host plan (``sorted_plan``: regime, tiles, chunks, splits,
  radix passes, shared memory, workspace) matches the source's field
  order and constants, fits the card and bounds every data-dependent
  count; ``sorted_scatter_add_ordered`` (the kernel's summation order in
  plain PyTorch) is within one bf16 ulp of the plain version, and bit for
  bit where the sums are exact; the CPU wrapper is the plain version,
  launches nothing and allocates no workspace, and the kernel's
  allocations are not filled under the deterministic flag;
- under ``fix_random`` every table gradient the atomic kernels would take
  routes to it, carried by the specs ``build_model_spec`` builds (18 a
  flagship step), an exact float32 table keeps ``index_add_``, and a tiny train
  step gives bit for bit the gradients and parameters of the default
  routing (the plain versions add in the same order);
- ``train_net.apply_fix_random`` sets the deterministic switches;
- ``--detect_anomaly`` parses, a tiny run takes its steps, and a NaN put
  into one step's loss raises in backward naming the op;
- the port's eval scripts run ``train_net`` and ``run --type evaluate``
  for each subject, passing their arguments through.

The kernel itself runs on the card only (``chip_smoke.py`` phase 13c holds
it against this plain version, bit for bit against
``sorted_scatter_add_ordered``, and two runs bit-equal).
"""
import re
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from __graft_entry__ import _flagship  # noqa: E402
from instant_nvr_tpu.ops.pallas.segmented_scatter import segmented_scatter_add_ref  # noqa: E402
from instant_nvr_tpu_torch import run, train_net  # noqa: E402
from instant_nvr_tpu_torch.config import Config, make_cfg  # noqa: E402
from instant_nvr_tpu_torch.models import inb  # noqa: E402
from instant_nvr_tpu_torch.ops import hashgrid as hg  # noqa: E402
from instant_nvr_tpu_torch.ops import scatter  # noqa: E402
from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec  # noqa: E402
from instant_nvr_tpu_torch.train import state as tstate  # noqa: E402
from instant_nvr_tpu_torch.train import step as tstep  # noqa: E402

CPU = torch.device("cpu")


def _records(rng, R, F, n_rows, hot=False):
    keys = rng.integers(0, 8 if hot else n_rows, R).astype(np.int32)
    payload = rng.standard_normal((R, F)).astype(np.float32)
    return keys, payload


@pytest.mark.parametrize("R,F,n_rows,hot", [(5000, 1, 3000, False), (5000, 1, 3000, True),
                                            (2000, 16, 700, False), (777, 128, 50, True)])
def test_sorted_plain_matches_jax_reference(rng, R, F, n_rows, hot):
    keys, payload = _records(rng, R, F, n_rows, hot)
    pay16 = torch.from_numpy(payload).to(torch.bfloat16)
    got = scatter.sorted_scatter_add_plain(torch.from_numpy(keys), pay16, n_rows)
    want = segmented_scatter_add_ref(jnp.asarray(keys), jnp.asarray(pay16.float().numpy(),
                                                                    jnp.bfloat16), n_rows)
    assert got.dtype == torch.bfloat16 and got.shape == (n_rows, F)
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    # the CPU wrapper is the plain version
    assert torch.equal(scatter.sorted_scatter_add(torch.from_numpy(keys), pay16, n_rows), got)


def test_sorted_plain_drops_outside_keys_and_sums_float32(rng):
    """Keys outside the table are dropped; the rest are summed in float32
    in record order and rounded to bf16 once."""
    keys, payload = _records(rng, 3000, 4, 500)
    keys[::10] = -1
    keys[5::10] = 500 + keys[5::10]
    pay16 = torch.from_numpy(payload).to(torch.bfloat16)
    got = scatter.sorted_scatter_add_plain(torch.from_numpy(keys), pay16, 500)
    assert got.dtype == torch.bfloat16
    inside = torch.from_numpy((keys >= 0) & (keys < 500))
    want = torch.zeros(500, 4).index_add_(0, torch.from_numpy(keys)[inside].long(),
                                          pay16[inside].float())
    assert torch.equal(got, want.to(torch.bfloat16))


def test_sorted_wrapper_refuses_other_devices():
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        scatter.sorted_scatter_add(keys, torch.zeros(4, 1, dtype=torch.bfloat16, device="meta"), 8)


# -- the sorted kernel's host plan ------------------------------------------------

SMEM_MAX = 232448          # the dynamic shared memory a block may opt into on sm_90


def test_sorted_plan_fields_and_constants_match_the_source():
    """The wrapper passes the plan as an int64 array in the order of the
    source's ``PlanField``; the sizes it derives from must be the source's."""
    src = open(os.path.join(ROOT, "instant_nvr_tpu_torch", "csrc", "sorted_scatter.cu")).read()
    enum = re.search(r"enum PlanField \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "kPlanFields"
    snake = ["_".join(re.findall(r"[A-Z][a-z0-9]*", n[1:])).lower() for n in names[:-1]]
    assert snake == [f.lower() for f in scatter.SortedPlan._fields]
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kThreads"]) == scatter.SORTED_THREADS
    assert int(const["kSliceElems"]) == scatter.SORTED_SLICE
    assert int(const["kMaxDigitBits"]) == scatter.SORTED_MAX_DIGIT_BITS
    assert int(const["kScratchWords"]) == scatter._SORTED_SCRATCH_WORDS


def _splits_of(plan, per_tile):
    """(work items, partial tiles, tiles of several splits) of a call whose
    tiles hold ``per_tile`` records."""
    ns = [scatter.sorted_splits(n, plan.split) for n in per_tile]
    multi = [n for n in ns if n > 1]
    return sum(ns), sum(multi), len(multi)


def _check_plan(plan, R, F, n_rows):
    assert plan.R == R and 1 << plan.log2_f == F and plan.n_rows == n_rows
    assert plan.tile_smem <= SMEM_MAX and plan.scatter_smem <= SMEM_MAX
    elems = scatter.SORTED_TILED_CHUNK_ELEMS if plan.tiled else scatter.SORTED_CHUNK_ELEMS
    assert plan.chunk * F == elems and plan.chunk < 2 ** 16
    assert plan.split % plan.chunk == 0 and plan.split * F >= scatter.SORTED_CHUNK_ELEMS
    quarter = -(-plan.tile_elems // (4 * plan.chunk))
    if plan.tiled:
        assert 4 * plan.split >= plan.tile_elems
    else:
        assert plan.split == plan.chunk * max(1, min(quarter, R // (128 * plan.chunk)))
    assert plan.tile_rows * plan.tiles >= n_rows > plan.tile_rows * (plan.tiles - 1)
    assert plan.row_bits <= 16 and (1 << plan.row_bits) > (plan.tile_rows - plan.tiled)
    if plan.tiled:
        assert n_rows * F > scatter.SORTED_SMALL_ELEMS
        assert plan.tile_elems == scatter.SORTED_TILE_ELEMS
        assert plan.tile_rows == 1 << plan.log2_tile
        lo, hi = scatter.SORTED_BLOCK_RECORDS
        assert lo <= plan.block_records <= hi and plan.block_records % 256 == 0
        assert plan.blocks * plan.block_records >= R
        if plan.passes == 1:
            assert plan.bins_lo == plan.tiles <= scatter.SORTED_MAX_BINS
        else:
            assert plan.passes == 2 and plan.bins_lo == 1 << plan.bits_lo
            assert plan.bins_lo * plan.bins_hi >= plan.tiles
            assert max(plan.bins_lo, plan.bins_hi) <= scatter.SORTED_MAX_BINS
        # the data-dependent counts stay inside their bounds, whatever the keys
        layouts = [[R] + [0] * (plan.tiles - 1), [R // plan.tiles] * plan.tiles]
        k = min(plan.tiles, R // (plan.split + 1))
        layouts.append([plan.split + 1] * k + [0] * (plan.tiles - k))
        for per_tile in layouts:
            work, slots, multi = _splits_of(plan, per_tile)
            assert work <= plan.work_max and slots <= plan.slots_max
            assert multi <= plan.combine_max
    else:
        assert n_rows * F <= scatter.SORTED_SMALL_ELEMS and plan.tiles == 1
        assert plan.small_splits == scatter.sorted_splits(R, plan.split) == plan.work_max
        assert plan.slots_max == (plan.small_splits if plan.small_splits > 1 else 0)
    assert (plan.combine_grid > 0) == (plan.combine_max > 0) and plan.combine_grid <= 1024
    offs = [v for f, v in zip(plan._fields, plan) if f.startswith("off_")]
    assert offs == sorted(offs) and all(o % 256 == 0 for o in offs)
    assert plan.off_partials + 4 * plan.slots_max * plan.tile_elems <= plan.workspace_bytes
    if plan.tiled:
        assert plan.off_pay - plan.off_keys >= 4 * R
        assert plan.off_tmp_keys - plan.off_pay >= (0 if plan.bucket_packed else 2 * R * F)
        assert plan.bucket_packed == (F == 1 and plan.passes == 1)
        assert plan.off_partials - plan.off_tmp_pay >= (2 * R * F if plan.passes == 2 else 0)


@pytest.mark.parametrize("R,F,n_rows", [
    (655_360, 1, 10_485_830), (2_621_440, 1, 10_485_830), (4_325_376, 1, 12_276),
    (100_003, 1, 200_000), (262_144, 1, 16_419), (1_081_344, 2, 12_276),
    (262_144, 16, 50_000), (0, 1, 50_000), (0, 2, 10), (1, 1, 1), (777, 128, 50),
    (655_360, 1, 2100 * 8192 + 7), (5, 128, 2 ** 31 // 128 - 1), (40_000, 1, 36_864),
    (40_000, 1, 36_865), (2 ** 31 - 1, 1, 12_276)])
def test_sorted_plan_bounds(R, F, n_rows):
    _check_plan(scatter.sorted_plan(R, F, n_rows), R, F, n_rows)


def test_sorted_plan_of_the_main_path():
    """A fix_random patch step's 18 sorted calls: the deformer's tables and
    the arms' dense tables are one tile each (no bucket pass), the other
    part tables are tiled in one radix pass; the body hash table's plan."""
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged({"fix_random": True})
    mspec = inb.build_model_spec(cfg)
    small = set()
    for spec, points in [(s, 32_768) for s in mspec.part_embeds] + [(mspec.deformer.embed,
                                                                     90_112)]:
        for _, rows, offs in spec.tables():
            R = (len(offs) - 1) * 8 * points
            plan = scatter.sorted_plan(R, 1, rows)
            _check_plan(plan, R, 1, rows)
            assert plan.passes == (0 if rows <= scatter.SORTED_SMALL_ELEMS else 1)
            if not plan.tiled:
                small.add(rows)
    assert small == {12_276, 32_822, 28_143}
    body = scatter.sorted_plan(2_621_440, 1, 10_485_830)
    assert (body.tiles, body.tile_rows, body.blocks, body.block_records) == (1281, 8192, 640, 4096)
    assert (body.split, body.chunk, body.tile_smem) == (4096, 2048, 55_440)
    assert body.bucket_packed and body.passes == 1
    dense = scatter.sorted_plan(4_325_376, 1, 12_276)
    assert (dense.small_splits, dense.split, dense.slots_max) == (256, 4096, 256)


@pytest.mark.parametrize("case", ["tiled", "tiled-F16", "pileup", "small-hot", "small-oob",
                                  "F128", "two-pass", "bucket-at-chunk", "empty"])
def test_sorted_ordered_model_against_plain(rng, case):
    """The kernel's summation order, in plain PyTorch: within one bf16 ulp of
    the plain version (record order) and the f32 reordering bound, bit for
    bit with small-integer payloads, keys outside the table dropped."""
    R, F, n_rows, exact = 20_000, 1, 100_005, False
    keys = rng.integers(0, n_rows, R)
    if case == "tiled-F16":
        F, n_rows = 16, 20_000
        keys = rng.integers(0, n_rows, R)
    elif case == "pileup":
        keys, exact = np.full(R, 12_345), True
    elif case == "small-hot":
        n_rows, exact = 3_000, True
        keys = np.concatenate([rng.integers(0, 8, R // 2), rng.integers(0, n_rows, R // 2)])
    elif case == "small-oob":
        n_rows = 5_000
        keys = rng.integers(-3, n_rows + 3, R)
        keys[::97] = rng.choice([-(2 ** 31), 2 ** 31 - 1], keys[::97].shape)
    elif case == "F128":
        R, F, n_rows = 600, 128, 700
        keys = rng.integers(0, n_rows, R)
    elif case == "two-pass":
        R, n_rows = 5_000, 2100 * 8192 + 7
        keys = rng.integers(0, n_rows, R)
    elif case == "bucket-at-chunk":
        n_rows = 6 * 8192
        keys = np.concatenate([rng.integers(t * 8192, (t + 1) * 8192, 4096 + extra)
                               for t, extra in ((1, 0), (3, 1), (4, 0))])
        rng.shuffle(keys)
        R = len(keys)
    elif case == "empty":
        R = 0
        keys = keys[:0]
    pay = (rng.integers(-8, 9, (R, F)) if exact else rng.standard_normal((R, F)))
    k = torch.from_numpy(np.asarray(keys, np.int32))
    p = torch.from_numpy(np.asarray(pay, np.float32)).to(torch.bfloat16)
    got = scatter.sorted_scatter_add_ordered(k, p, n_rows)
    want = scatter.sorted_scatter_add_plain(k, p, n_rows)
    assert got.dtype == torch.bfloat16 and got.shape == (n_rows, F)
    g, w = got.float(), want.float()
    if exact:
        assert torch.equal(g, w)
    keep = (k >= 0) & (k < n_rows)
    count = torch.zeros(n_rows).index_add_(0, k[keep].long(), torch.ones(int(keep.sum())))
    mass = torch.zeros(n_rows, F).index_add_(0, k[keep].long(), p[keep].float().abs())
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    assert ((g - w).abs() <= ulp + count[:, None] * 2.0 ** -24 * mass).all()
    assert torch.equal(g[count == 1], w[count == 1]) and not g[count == 0].any()


def test_sorted_wrapper_on_the_cpu_is_the_plain_version_and_launches_nothing(rng):
    keys, payload = _records(rng, 4000, 2, 50_000)
    k, p = torch.from_numpy(keys), torch.from_numpy(payload).to(torch.bfloat16)
    before = (scatter.sorted_scatter_add.launches, dict(scatter._sorted_workspaces),
              "sorted" in scatter._launch)
    got = scatter.sorted_scatter_add(k, p, 50_000)
    assert torch.equal(got, scatter.sorted_scatter_add_plain(k, p, 50_000))
    assert (scatter.sorted_scatter_add.launches, dict(scatter._sorted_workspaces),
            "sorted" in scatter._launch) == before


def test_kernel_allocations_are_not_filled_under_the_deterministic_flag(monkeypatch):
    """Under ``use_deterministic_algorithms`` PyTorch fills every
    ``torch.empty``; the sorted kernel writes its output and workspace
    whole, so the wrapper allocates them with the fill off, and puts it
    back."""
    seen, empty = [], torch.empty

    def spy(*a, **kw):
        seen.append(torch.utils.deterministic.fill_uninitialized_memory)
        return empty(*a, **kw)
    monkeypatch.setattr(torch, "empty", spy)
    saved = torch.are_deterministic_algorithms_enabled()
    try:
        for flag in (True, False):
            torch.use_deterministic_algorithms(flag)
            out = scatter._empty((7, 2), torch.bfloat16, CPU)
            assert out.shape == (7, 2) and out.dtype == torch.bfloat16
            assert torch.utils.deterministic.fill_uninitialized_memory
    finally:
        torch.use_deterministic_algorithms(saved)
    assert seen == [False, True]


def test_sorted_workspace_grows_and_never_shrinks():
    dev, stream = CPU, -54321                       # a key no wrapper uses
    try:
        a = scatter.sorted_workspace(dev, 1000, stream)
        assert a.dtype == torch.uint8 and a.numel() == 1000
        assert scatter.sorted_workspace(dev, 10, stream) is a
        b = scatter.sorted_workspace(dev, 3000, stream)
        assert b.numel() == 3000 and scatter.sorted_workspace(dev, 1000, stream) is b
        assert scatter.sorted_workspace(dev, 10, stream - 1) is not b
    finally:
        for key in [k for k in scatter._sorted_workspaces if k[1] in (stream, stream - 1)]:
            del scatter._sorted_workspaces[key]


def test_fix_random_routes_every_table_to_the_sorted_kernel():
    lo = (0, 16_411, 32_822)
    for dtype, rounded in ((torch.float32, True), (torch.bfloat16, False)):
        assert hg.grad_route(32_822, 1, lo, dtype, rounded, sorted_grads=True) == "sorted"
        assert hg.grad_route(32_822, 1, lo, dtype, rounded) != "sorted"
    # an exact float32 table keeps index_add_, deterministic under the flag
    for det in (False, True):
        assert hg.grad_route(32_822, 1, lo, torch.float32, False, sorted_grads=det) == "exact"
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml"))
    base = tstep.table_grad_launches(inb.build_model_spec(cfg), make_render_spec(cfg))
    fixed = cfg.merged({"fix_random": True})
    mspec = inb.build_model_spec(fixed)
    assert all(s.sorted_grads for s in mspec.part_embeds) and mspec.deformer.embed.sorted_grads
    routes = tstep.table_grad_launches(mspec, make_render_spec(fixed))
    assert base == {"segmented": 8, "onehot": 10}
    assert routes == {"sorted": 18}


@pytest.mark.parametrize("mode", [{}, {"mlp_dtype": "float32", "grid_compute_dtype": "float32"}])
def test_fix_random_step_equals_the_default_step_on_the_cpu(mode):
    """The plain versions of the sorted and the atomic routes add each row
    in record order, so on the CPU the routing changes no bit; the float32
    mode's exact tables keep ``index_add_`` under either."""
    cfg_j, *_, batch_np = _flagship(tiny=True)
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()}
    results = []
    for fix in (False, True):
        cfg = Config(cfg_j.merged(mode).merged({"fix_random": fix}).to_dict())
        mspec, rspec, model = run.build(cfg, CPU, seed=0)
        assert mspec.part_embeds[0].sorted_grads is fix
        state = tstate.create_train_state(cfg, model)
        step = tstep.make_train_step(mspec, rspec, tstep.make_loss_weights(cfg))
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            _, stats = step(state, batch, generator=gen)
        results.append((float(stats["loss"]), {n: p.detach().clone()
                                               for n, p in model.named_parameters()},
                        {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert results[0][0] == results[1][0]
    for i in (1, 2):
        for n in results[0][i]:
            assert torch.equal(results[0][i][n], results[1][i][n]), n


def test_apply_fix_random_sets_the_deterministic_switches(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        assert not train_net.apply_fix_random(Config({"fix_random": False}))
        assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
        assert train_net.apply_fix_random(Config({"fix_random": True}))
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]


@pytest.fixture
def anomaly_off():
    yield
    torch.autograd.set_detect_anomaly(False)


def test_detect_anomaly_parses_and_runs(capsys, anomaly_off):
    assert train_net.parse_args(["--detect_anomaly"]).detect_anomaly
    assert not train_net.parse_args([]).detect_anomaly
    train_net.main(["--device", "cpu", "--tiny", "--steps", "2", "--detect_anomaly"])
    assert torch.is_anomaly_enabled()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2 and "nan" not in lines[-1]


def test_detect_anomaly_names_the_op_of_an_injected_nan(monkeypatch, anomaly_off):
    real = tstep.compute_losses
    calls = []

    def poisoned(*args, **kw):
        loss, stats = real(*args, **kw)
        calls.append(1)
        if len(calls) == 2:          # the second step's loss
            loss = loss * torch.tensor(float("nan"))
        return loss, stats
    monkeypatch.setattr(tstep, "compute_losses", poisoned)
    with pytest.raises(RuntimeError, match=r"Function 'MulBackward0' returned nan"):
        train_net.main(["--device", "cpu", "--tiny", "--steps", "3", "--detect_anomaly"])
    assert len(calls) == 2


STUB = """#!/bin/sh
printf '%s\\n' "$*" >> "$STUB_LOG"
"""


@pytest.mark.parametrize("script,subjects", [
    ("eval_zjumocap.sh", ["377", "386", "387", "392", "393", "394"]),
    ("eval_monocap.sh", ["lan", "marc", "olek", "vlad"])])
def test_eval_scripts_run_the_ports_commands(tmp_path, script, subjects):
    """The port's counterparts of ``scripts/eval_*.sh``, with a stub
    ``python`` first on PATH that records its arguments."""
    import subprocess
    (tmp_path / "python").write_text(STUB)
    (tmp_path / "python").chmod(0o755)
    log = tmp_path / "calls.txt"
    env = {**os.environ, "PATH": f"{tmp_path}:{os.environ['PATH']}", "STUB_LOG": str(log)}
    res = subprocess.run(["sh", os.path.join(ROOT, "instant_nvr_tpu_torch", "scripts", script),
                          "--device", "cpu", "train.epoch", "2"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    want = []
    for sub in subjects:
        cfg = f"configs/inb/inb_{sub}.yaml"
        assert os.path.exists(os.path.join(ROOT, cfg))
        want += [f"-m instant_nvr_tpu_torch.train_net --cfg_file {cfg} --device cpu train.epoch 2",
                 f"-m instant_nvr_tpu_torch.run --type evaluate --cfg_file {cfg} "
                 "--device cpu train.epoch 2"]
    assert log.read_text().splitlines() == want
