"""``fix_random`` and ``--detect_anomaly`` in the port, on the CPU.

- ``sorted_scatter_add``'s plain version (the stable sort, then each row's
  records added in order in float32) is bit for bit the JAX package's
  reference scatter (``segmented_scatter_add_ref``: an f32 XLA scatter in
  record order, rounded to bf16 once) and drops keys outside the table;
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
it against this plain version and two runs bit-equal).
"""
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
