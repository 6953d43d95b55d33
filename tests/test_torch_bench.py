"""The port's benchmark (``instant_nvr_tpu_torch/bench.py``) against the
repo's ``bench.py``, on the CPU.

The flagship's config and batches are held bit for bit to
``__graft_entry__._flagship`` and to the arrays ``bench.py`` builds.  One
bench MSE step and one bench patch step at tiny widths (the patch step with
``use_lpips`` merged in, as at inb_377's widths) run against JAX's
``make_train_step`` from the same weights (``bridge.params_from_jax``) and
the draws of the key ``bench.py`` gives step 0 (``draws=``), with
``tests/test_torch_train.py``'s tolerances: in float32 mode the loss rtol
1e-5 and the updated parameters rtol 1e-4 / atol 1e-6 of the leaf's largest
entry; in the flagship's bf16 mode (JAX's table gradients through its
kernels' reference) the loss rtol 1e-3 and the parameters within 2.1 x lr.
``main`` runs at ``--device cpu --tiny`` with 2 windows of 2 steps.
"""
import ast
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship
from instant_nvr_tpu.datasets import synthetic as jsynthetic
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.renderer import inb_renderer as jrend
from instant_nvr_tpu.train import loop as jloop
from instant_nvr_tpu.train import state as jstate
from instant_nvr_tpu.train import step as jstep
from instant_nvr_tpu_torch import bench, bridge
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.renderer import inb_renderer as rend
from instant_nvr_tpu_torch.tools import analyze_trace
from instant_nvr_tpu_torch.train import loop
from instant_nvr_tpu_torch.train.step import make_loss_weights, make_train_step
from test_torch_train import F32_MODE, _close_f32, _kernel_route_grads, _pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/inb/inb_377.yaml")
CPU = torch.device("cpu")
# bench.py's keys: the primary metric (bench.py:83-90, 120-127) and the
# patch keys beside it (bench.py:129-134)
PRIMARY = {"metric", "value", "unit", "vs_baseline", "windows", "steps_per_window",
           "min", "max"}
PATCH = {"train_rays_per_sec_patch", "patch_min", "patch_max", "vs_baseline_patch"}
CARD = {"device", "power_limit"}
# the port's own: the step's route and the graphs it captured
ROUTE = {"route", "captures"}


def _plain(cfg):
    """A config as plain data (each package's Config inside lists too)."""
    return json.loads(json.dumps(cfg.to_dict(), default=lambda c: c.to_dict()))


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# -- the flagship and its batches ----------------------------------------------------

def test_flagship_tiny_is_the_graft_entrys():
    cfg_j, mspec_j, rspec_j, lw_j, _, batch_np = _flagship(tiny=True)
    fl = bench.flagship(CFG, CPU, tiny=True)
    for p in ("body", "leg", "head", "larm", "rarm"):
        assert (fl.cfg.partnet[p].embedder.kwargs.to_dict()
                == cfg_j.partnet[p].embedder.kwargs.to_dict()), p
    assert (fl.cfg.tpose_deformer.embedder.kwargs.to_dict()
            == cfg_j.tpose_deformer.embedder.kwargs.to_dict())
    for k in ("N_samples", "N_rand", "use_lpips", "patch_size"):
        assert fl.cfg[k] == cfg_j[k], k
    assert _plain(fl.cfg) == _plain(cfg_j)
    assert fl.rspec.n_samples == rspec_j.n_samples == 8
    assert fl.lw.use_patch == lw_j.use_patch is False
    assert len(fl.mspec.part_embeds) == len(mspec_j.part_embeds)
    _assert_batches_equal(fl.batch_np, batch_np)
    _assert_batches_equal({k: v.numpy() for k, v in fl.batch.items()}, batch_np)
    assert all(v.device == CPU for v in fl.batch.values())


def test_full_width_mse_batch_is_bench_pys():
    """``_flagship(tiny=False)``'s batch: host arrays and specs only."""
    cfg_j, *_, batch_np = _flagship(tiny=False)
    fl = bench.flagship(CFG, CPU)
    assert fl.cfg.N_rand == 1024 and fl.rspec.n_samples == 64 and fl.lw.use_patch
    _assert_batches_equal(fl.batch_np, batch_np)


@pytest.mark.parametrize("tiny", [False, True])
def test_patch_batch_is_bench_pys(tiny):
    """bench.py:96-100's 4,096-ray patch, whatever the widths."""
    cfg = bench.flagship(CFG, CPU, tiny=tiny).cfg
    n = cfg.patch_size ** 2
    assert n == 4096
    scene = jsynthetic.make_scene(n_verts=1200, grid=32)
    view = jsynthetic.render_gt(scene, H=128, W=128)
    want = jsynthetic.make_batch(scene, view, n_rays=n)
    want["ray_mask"] = np.ones(n, np.float32)
    _assert_batches_equal(bench.patch_batch_np(cfg), want)


# -- one bench step against JAX's make_train_step ------------------------------------

def _tiny(mode, patch):
    """The bench's tiny flagship in ``mode`` (the patch step with LPIPS) and
    JAX's config of it."""
    fl = bench.flagship(CFG, CPU, tiny=True)
    over = dict(F32_MODE if mode == "float32" else {}, **({"use_lpips": True} if patch else {}))
    cfg = fl.cfg.merged(over)
    return (fl._replace(cfg=cfg, mspec=inb.build_model_spec(cfg),
                        rspec=rend.make_render_spec(cfg), lw=make_loss_weights(cfg)),
            _flagship(tiny=True)[0].merged(over))


def _jax_step(cfg_j, batch_np, patch, rng):
    mspec_j = jinb.build_model_spec(cfg_j)
    opt, _ = jstate.make_optimizer(cfg_j)
    params = jinb.init_params(jax.random.key(0), mspec_j)
    state = jstate.create_train_state(params, opt, mspec_j)
    fn = jloop.make_patch_loss_fn(cfg_j) if patch else None
    step = jax.jit(jstep.make_train_step(mspec_j, jrend.make_render_spec(cfg_j),
                                         jstep.make_loss_weights(cfg_j), opt, fn))
    new, stats = step(state, {k: jnp.asarray(v) for k, v in batch_np.items()}, rng)
    return params, new.params, stats


@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
@pytest.mark.parametrize("patch", [False, True], ids=["mse", "patch"])
def test_bench_step_matches_jax(mode, patch):
    fl, cfg_j = _tiny(mode, patch)
    assert fl.lw.use_patch == patch
    assert _plain(fl.cfg) == _plain(cfg_j)
    batch_np = bench.patch_batch_np(fl.cfg) if patch else fl.batch_np
    rng = jax.random.key(0)                  # bench.py's rngs[0] for step 0
    if mode == "bfloat16":
        with _kernel_route_grads():
            params, jparams, jstats = _jax_step(cfg_j, batch_np, patch, rng)
    else:
        params, jparams, jstats = _jax_step(cfg_j, batch_np, patch, rng)

    state = bench.new_state(fl.cfg, CPU)
    state.model.load_state_dict(bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                                       fl.mspec))
    step = make_train_step(fl.mspec, fl.rspec, fl.lw,
                           loop.make_patch_loss_fn(fl.cfg) if patch else None)
    R, S = batch_np["ray_o"].shape[0], fl.rspec.n_samples
    k_strat, k_pair = jax.random.split(rng)
    B = rend.pair_budget(fl.mspec, fl.rspec, R * S)
    noise = (jax.random.uniform(k_pair, (B, 3), jnp.float32) - 0.5) * fl.rspec.pair_range
    draws = {"t_rand": torch.from_numpy(np.array(
                 jax.random.uniform(k_strat, (R, S), jnp.float32))),
             "pair_noise": torch.from_numpy(np.array(noise))}
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    _, stats = step(state, batch, draws=draws)
    assert state.step == 1
    if patch:
        assert float(stats["patch_loss"]) > 0 and "patch_loss" in jstats
    lr = fl.cfg.train.lr
    for k, got, want in _pairs(jax.tree.map(np.asarray, jparams),
                               bridge.tree_from_model(state.model, "data")):
        if mode == "float32":
            _close_f32(got, want, what=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2.1 * lr, err_msg=k)
    rtol = 1e-5 if mode == "float32" else 1e-3
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=rtol)


# -- the command ---------------------------------------------------------------------

@pytest.fixture
def short(monkeypatch):
    """2 windows of 2 steps, no trace."""
    monkeypatch.setattr(bench, "WINDOWS", 2)
    monkeypatch.setattr(bench, "STEPS_PER_WINDOW", 2)
    monkeypatch.delenv("BENCH_TRACE", raising=False)
    monkeypatch.delenv("BENCH_TRACE_PATCH", raising=False)
    return monkeypatch


def _last_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


def test_key_sets_are_bench_pys():
    """The keys of every dict literal in the root bench.py's main."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = {k.value for d in ast.walk(main) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}
    assert keys == PRIMARY | PATCH


@pytest.mark.parametrize("mode", ["mse", "patch", "both"])
def test_main_prints_bench_pys_keys(short, capsys, mode):
    short.setenv("BENCH_MODE", mode)
    out = bench.main(["--device", "cpu", "--tiny", "--cfg_file", CFG])
    lines, last = _last_line(capsys)
    assert last == out
    want = PRIMARY | CARD | ROUTE | (PATCH if mode == "both" else set())
    assert set(last) == want
    assert last["device"] == "cpu" and last["power_limit"] is None
    assert last["route"] == "eager" and last["captures"] == 0
    assert last["unit"] == "rays/s" and last["windows"] == 2 and last["steps_per_window"] == 2
    assert last["metric"] == ("train_patch_rays_per_sec" if mode == "patch"
                              else "train_rays_per_sec")
    rates = [(last["value"], last["min"], last["max"], last["vs_baseline"])]
    if mode == "both":
        rates.append((last["train_rays_per_sec_patch"], last["patch_min"],
                      last["patch_max"], last["vs_baseline_patch"]))
    for value, lo, hi, vs in rates:
        assert all(math.isfinite(x) and x > 0 for x in (value, lo, hi, vs))
        assert lo <= value <= hi
        assert abs(vs - value / bench.BASELINE_RAYS_PER_SEC) <= 1e-3
    # one line a mode, each with 3 warm-up and 2 x 2 timed steps
    modes = ("mse", "patch") if mode == "both" else (mode,)
    assert [l.split()[0] for l in lines[:-1]] == [f"[bench-{m}]" for m in modes]
    assert all(" steps=7 " in l and "routes_per_step=" in l and "launches=" in l
               for l in lines[:-1])


def test_trace_windows_on_the_cpu(short, capsys, tmp_path):
    """BENCH_TRACE / BENCH_TRACE_PATCH: 5 more steps each, traces that
    analyze_trace reads and finds no device events in."""
    short.setenv("BENCH_MODE", "both")
    short.setenv("BENCH_TRACE", str(tmp_path / "mse"))
    short.setenv("BENCH_TRACE_PATCH", str(tmp_path / "patch"))
    bench.main(["--device", "cpu", "--tiny", "--cfg_file", CFG])
    lines, _ = _last_line(capsys)
    assert all(" steps=12 " in l for l in lines[:-1])
    for name in ("mse", "patch"):
        path = analyze_trace.find_trace(str(tmp_path / name))
        assert path == str(tmp_path / name / f"bench_{name}.json")
        with open(path) as f:
            assert json.load(f)["traceEvents"]
        summary = analyze_trace.summarize(path)
        assert summary["device_ms"] is None and summary["busy"] is None
    assert "no device events" in capsys.readouterr().out


def test_cuda_without_a_card_raises(short):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs there")
    short.setenv("BENCH_MODE", "mse")
    for argv in ([], ["--device", "cuda", "--tiny"]):
        with pytest.raises(RuntimeError, match="cuda"):
            bench.main(argv + ["--cfg_file", CFG])


def test_unknown_mode_raises(short):
    short.setenv("BENCH_MODE", "lpips")
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.main(["--device", "cpu", "--tiny", "--cfg_file", CFG])


def test_measure_reseeds_each_step_and_sorts(monkeypatch):
    monkeypatch.setattr(bench, "WINDOWS", 3)
    monkeypatch.setattr(bench, "STEPS_PER_WINDOW", 10)
    seeds, losses = [], []

    def step(state, batch, generator=None):
        seeds.append(generator.initial_seed())
        return state, {"loss": torch.rand((), generator=generator)}

    gen = torch.Generator()
    rates = bench.measure(step, None, {"ray_o": torch.zeros(7, 3)}, gen, losses)
    assert len(rates) == 3 and rates == sorted(rates) and min(rates) > 0
    assert seeds == [i % 8 for i in range(10)] * 3
    assert len(losses) == 30
    # the same seed gives the same draws: steps 0 and 8 of a window
    assert float(losses[0]) == float(losses[8]) == float(losses[10])


def test_check_launches():
    routes = {"segmented": 8, "onehot": 10}
    good = {"knn_blend": 3, "segmented": 24, "onehot": 30, "sorted": 0, "exact": 0}
    bench.check_launches(good, routes, 3)
    for k, v in (("knn_blend", 2), ("segmented", 23), ("exact", 1), ("sorted", 1)):
        with pytest.raises(RuntimeError, match="launches"):
            bench.check_launches(dict(good, **{k: v}), routes, 3)


GUARD = r"""
import json, sys
BLOCKED = ("jax", "jaxlib", "instant_nvr_tpu", "__graft_entry__")
for name in BLOCKED:
    sys.modules[name] = None            # any import of them raises ImportError
from instant_nvr_tpu_torch import bench
bench.WINDOWS, bench.STEPS_PER_WINDOW = 1, 1
out = bench.main(["--device", "cpu", "--tiny", "--cfg_file", sys.argv[1]])
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok", sorted(out))
"""


def test_bench_runs_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "BENCH_TRACE", "BENCH_TRACE_PATCH")}
    env["BENCH_MODE"] = "both"
    res = subprocess.run([sys.executable, "-c", GUARD, CFG], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "ok " + str(sorted(PRIMARY | PATCH | CARD | ROUTE))
    assert set(json.loads(lines[-2])) == PRIMARY | PATCH | CARD | ROUTE
