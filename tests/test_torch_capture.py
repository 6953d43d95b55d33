"""The port's captured programs on the CPU: the constants that the forward
builds once on the device (``utils/constants.py``), the optimizer update
read from a device schedule (``train/state.py:OptaxAdam.step_device``), the
capturable step body (``train/step.py:make_step_body``), the static-buffer
eval frame (``eval/runner.py:CapturedFrame``), the routes and the launch
bookkeeping of ``train/compiled.py``.  A CUDA graph runs only on the card
(``chip_smoke.py`` phase 15 replays both programs against the eager ones);
here each part runs eagerly, on the same inputs as the JAX package.

Tolerances:
  * the cached constants equal the tensors the inline code built, bit for
    bit (values, dtype, shape); the forward with them twice bit-equal and
    within ``tests/test_torch_model.py``'s tolerance of JAX's forward
    (float32 rtol 1e-4 / atol 1e-5, bf16 atol 1e-3), the train-mode render
    within ``tests/test_torch_train.py``'s (rtol 1e-4 / atol 1e-6);
  * the device-schedule update equals the host-scalar update bit for bit
    (the same sweeps, each scalar the same float32), and optax within
    ``test_optimizer_matches_optax``'s rtol 1e-5 / atol 1e-7 (float32
    moment) and ``test_bf16_moment_matches_optax``'s rtol 1e-6 / atol 1e-9
    (bf16 moment).  ``torch.optim.Adam``, which the port's Adam replaced,
    is held to it at rtol 1e-5 only: it fuses its last product into
    ``addcdiv``, one rounding where the optax order takes two;
  * the step body equals the eager step bit for bit on the CPU, and JAX's
    step within ``tests/test_torch_train.py``'s tolerances (3 MSE steps,
    float32 and bf16) and ``tests/test_torch_patch.py``'s float32 ones
    (2 patch steps: stats rtol 1e-5, parameters rtol 1e-4 / atol 1e-6 of
    the leaf's largest entry);
  * the static-buffer frame equals ``make_chunked_renderer``'s bit for bit
    and JAX's ``render_full_image`` at float32 rtol 1e-4 / atol 1e-5.
"""
import contextlib
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instant_nvr_tpu.config import make_cfg as jax_make_cfg
from instant_nvr_tpu.eval import runner as jrunner
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.renderer import inb_renderer as jrend
from instant_nvr_tpu.train import loop as jloop
from instant_nvr_tpu.train import state as jstate
from instant_nvr_tpu.train import step as jstep
from instant_nvr_tpu_torch import bench, bridge, run, train_net
from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.eval import runner
from instant_nvr_tpu_torch.models import deformer, inb, lpips
from instant_nvr_tpu_torch.ops import grid_sample, hashgrid as hg, knn, mlp_wgrad, scatter
from instant_nvr_tpu_torch.renderer import inb_renderer as rend
from instant_nvr_tpu_torch.train import compiled, loop
from instant_nvr_tpu_torch.train import state as tstate
from instant_nvr_tpu_torch.train import step as tstep
from instant_nvr_tpu_torch.utils import constants
from test_torch_model import TOL, _check_telemetry, _item, _samples, jax_forward
from test_torch_model import tiny as model_tiny
from test_torch_patch import _leaves as patch_leaves
from test_torch_patch import _patch_case, subject  # noqa: F401 (fixture)
from test_torch_train import _leaves as train_leaves
from test_torch_train import _named, _run_steps, _toy
from test_torch_train import tiny as train_tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/inb/inb_377.yaml")
CPU = torch.device("cpu")


def _cached(key):
    return constants._constants[(key, CPU)]


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got, want)
    assert torch.equal(got, want)


# -- constants ------------------------------------------------------------------

def test_device_constant_is_made_once():
    calls = []

    def make():
        calls.append(1)
        return np.arange(5)
    a = constants.device_constant(("test-once", 5), CPU, make, torch.int32)
    b = constants.device_constant(("test-once", 5), "cpu", make, torch.int32)
    assert a is b and len(calls) == 1 and a.dtype == torch.int32
    _same(constants.arange(7, CPU), torch.arange(7))
    assert constants.arange(7, CPU) is constants.arange(7, CPU)


def test_device_constant_refuses_a_first_use_under_capture(monkeypatch):
    """Capture cannot copy from the host: a constant's first use inside one
    raises, naming it (the warm-up must have made it)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="test-capture"):
        constants.device_constant("test-capture", torch.device("cuda", 0),
                                  lambda: np.zeros(1))


def test_inb_constants_equal_the_inline_tensors():
    c = model_tiny("float32")
    wpts, vd = _samples(c.batch_np, 8)
    with torch.no_grad():
        inb.forward(c.mspec, c.model, torch.from_numpy(wpts), torch.from_numpy(vd),
                    c.batch, train=True)
    K, Kps = inb.budgets(c.mspec, wpts.shape[0])
    P, Kmax = c.mspec.num_parts, max(Kps)
    _same(_cached(("part_budgets", Kps)), torch.tensor(Kps))
    _same(_cached(("part_ids", Kps)), torch.as_tensor(np.repeat(np.arange(P), Kps)))
    for _, ids in c.mspec.rgb_groups():
        _same(_cached(("rgb_group", ids)), torch.tensor(ids))
    _same(_cached(("tocc_idx", Kps)), torch.as_tensor(np.concatenate(
        [p * Kmax + np.arange(Kps[p]) for p in range(P)])))
    for n in (Kmax, P):
        _same(_cached(("arange", n, torch.int64)), torch.arange(n))


def test_hashgrid_constants_equal_the_inline_tensors(rng):
    specs = [hg.make_hashgrid_spec(n_levels=6, n_features_per_level=2,
                                   log2_hashmap_size=8, base_resolution=2 + p, b=1.5)
             for p in range(3)]
    seg = (5, 3, 4)
    tables = [hg.hashgrid_init(s, torch.Generator().manual_seed(p), CPU)
              for p, s in enumerate(specs)]
    pts = torch.from_numpy(rng.uniform(-1, 1, (sum(seg), 3)).astype(np.float32))
    bounds = torch.tensor([[[-1.0] * 3, [1.0] * 3]] * 3)
    hg.multi_hashgrid_encode(specs, tables, pts, bounds, seg)
    hg.hashgrid_encode(specs[0], tables[0], pts, bounds[0])
    _same(_cached("corner_bits"), torch.as_tensor(hg._corner_bits()))
    s = specs[0]
    _same(_cached(("entries_num", s.entries_num)),
          torch.tensor(s.entries_num, dtype=torch.int32)[:, None])
    for s in specs:
        assert s.start_hash > 0 and s.n_hash_levels > 0
        _same(hg._dense_offsets(s, CPU), torch.tensor(s.dense_offsets)[:, None, None])
        _same(hg._hash_offsets(s, CPU),
              (torch.arange(s.n_hash_levels) * s.table_size)[:, None, None])
    _same(_cached(("part_ids", seg)), torch.as_tensor(np.repeat(np.arange(3), seg)))
    e_np = np.asarray([s.entries_num for s in specs], np.int32)[
        np.repeat(np.arange(3), seg)].T
    _same(_cached(("part_entries_num", tuple(s.entries_num for s in specs), seg)),
          torch.as_tensor(e_np))


def test_deformer_lpips_and_volume_constants_equal_the_inline_tensors(rng):
    c = model_tiny("float32")
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (16, 3)).astype(np.float32))
    b = c.batch
    host = deformer.deformer_apply(c.mspec.deformer, c.model.deformer, pts, b["tuv"],
                                   b["tbounds"], 0.375)
    dev = deformer.deformer_apply(c.mspec.deformer, c.model.deformer, pts, b["tuv"],
                                  b["tbounds"], torch.tensor(0.375))
    assert torch.equal(host, dev)
    _same(_cached(("frame_t", 0.375, torch.float32)), torch.as_tensor(0.375))
    _same(_cached(("unit_box", torch.float32)),
          torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]))
    img = torch.from_numpy(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    lpips.lpips_distance(img, img.flip(0))
    _same(_cached("lpips_shift"), torch.tensor(lpips._SHIFT))
    _same(_cached("lpips_scale"), torch.tensor(lpips._SCALE))
    vol = torch.from_numpy(rng.normal(size=(4, 5, 6, 2)).astype(np.float32))
    grid_sample.grid_sample_3d(vol, pts)
    _same(_cached(("volume_sizes", 4, 5, 6)),
          torch.tensor([4, 5, 6], dtype=torch.int32))


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_forward_with_cached_constants_matches_jax(mode):
    """A second forward reads every constant from the cache: the same bits
    as the first, and JAX's forward within test_torch_model's tolerance."""
    c = model_tiny(mode)
    wpts, vd = _samples(c.batch_np, 8)
    ref = jax_forward(c.mspec_j, c.params_j, jnp.array(wpts), jnp.array(vd),
                      c.batch_j, False)
    outs = []
    for _ in range(2):
        with torch.no_grad():
            outs.append(inb.forward(c.mspec, c.model, torch.from_numpy(wpts),
                                    torch.from_numpy(vd), c.batch))
    for k in ("raw", "occ"):
        assert torch.equal(outs[0][k], outs[1][k]), k
        np.testing.assert_allclose(outs[1][k].numpy(), np.asarray(ref[k]), **TOL[mode],
                                   err_msg=k)
    _check_telemetry(outs[1], ref)


def test_train_render_with_cached_constants_matches_jax():
    c = train_tiny("float32", occ_bias=0.0)
    rng = jax.random.key(4)
    ref = jax.jit(jrend.render_rays, static_argnums=(0, 1, 4))(
        c.mspec_j, c.rspec_j, c.params_j, c.batch_j, True, rng)
    model = c.model()
    with torch.no_grad():
        got = [rend.render_rays(c.mspec, c.rspec, model, c.batch, train=True,
                                draws=c.draws(rng)) for _ in range(2)]
    for k in ("rgb_map", "acc_map", "weights", "occ", "resd", "reg_distortion"):
        assert torch.equal(got[0][k], got[1][k]), k
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


# -- the optimizer read from a device schedule ----------------------------------

def _opt_cfg(moment, wd, mlp_scale=0.5):
    over = {"train": {"moment_dtype": moment, "weight_decay": wd, "lr": 1e-2,
                      "scheduler": {"type": "exponential", "gamma": 0.1,
                                    "decay_epochs": 3}},
            "ep_iter": 2, "mlp_weight_decay": mlp_scale}
    return jax_make_cfg(CFG).merged(over), make_cfg(CFG).merged(over)


@pytest.mark.parametrize("moment,wd", [("float32", 0.0), ("float32", 1e-3),
                                       ("bfloat16", 0.0), ("bfloat16", 1e-3)])
def test_device_schedule_update_equals_the_host_update_and_optax(moment, wd):
    """6 steps over 3 epochs of 2 (two lr changes): the device-indexed
    update, its step counter a 0-d tensor, bit-equal to the eager one."""
    cfg_j, cfg = _opt_cfg(moment, wd)
    tree, model_h = _toy()
    _, model_d = _toy()
    host, dev = (tstate.create_train_state(cfg, m) for m in (model_h, model_d))
    cls = tstate.AdamBf16Mu if moment == "bfloat16" else tstate.OptaxAdam
    assert type(host.optimizer) is cls and type(dev.optimizer) is cls
    sched = tstate.DeviceSchedule(dev.optimizer, dev.schedule, 8, CPU)
    dstep = torch.zeros((), dtype=torch.int64)
    opt, _ = jstate.make_optimizer(cfg_j)
    params = jax.tree.map(jnp.asarray, tree)
    ost = opt.init(params)
    rng = np.random.default_rng(9)
    lrs = set()
    for i in range(6):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        upd, ost = opt.update(jax.tree.map(jnp.asarray, grads), ost, params)
        params = optax.apply_updates(params, upd)
        for model in (model_h, model_d):
            for (_, g), p in zip(train_leaves(grads), _named(model, grads)):
                p.grad = torch.from_numpy(g.copy())
        host.set_lr()
        host.optimizer.step()
        host.step += 1
        dev.optimizer.step_device(sched, dstep)
        dstep.add_(1)
        dev.optimizer.advance_steps()
        dev.step += 1
        lrs.add(host.schedule(i))
        for ph, pd in zip(model_h.parameters(), model_d.parameters()):
            assert torch.equal(ph, pd), f"step {i}"
            sh, sd = host.optimizer.state[ph], dev.optimizer.state[pd]
            assert sh["step"] == sd["step"] == i + 1
            assert torch.equal(sh["exp_avg"], sd["exp_avg"])
            assert torch.equal(sh["exp_avg_sq"], sd["exp_avg_sq"])
        tol = dict(rtol=1e-6, atol=1e-9) if moment == "bfloat16" else \
            dict(rtol=1e-5, atol=1e-7)
        for (k, want), p in zip(train_leaves(params), _named(model_d, grads)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), **tol,
                                       err_msg=f"step {i} {k}")
    assert len(lrs) == 3


def test_device_schedule_tables_are_the_host_scalars():
    _, cfg = _opt_cfg("float32", 0.0, mlp_scale=0.25)
    state = tstate.create_train_state(cfg, _toy()[1])
    sched = tstate.DeviceSchedule(state.optimizer, state.schedule, 7, CPU)
    assert sched.n_steps == 7 and len(sched.neg_lr) == len(state.optimizer.param_groups)
    for t in range(7):
        assert sched.bc1[t].item() == np.float32(tstate.bias_correction(0.9, t + 1))
        assert sched.bc2[t].item() == np.float32(tstate.bias_correction(0.999, t + 1))
        for g, table in zip(state.optimizer.param_groups, sched.neg_lr):
            assert table[t].item() == np.float32(-(state.schedule(t) * g["lr_scale"]))
    assert sched.neg_lr[0][1] == sched.neg_lr[0][0] != sched.neg_lr[0][2]


def test_port_adam_against_torch_adam():
    """The port's Adam (optax's order) against the ``torch.optim.Adam`` it
    replaced: the same update to rtol 1e-5, not bit for bit (torch fuses
    -lr/bc1 * mu/den into one addcdiv rounding)."""
    _, cfg = _opt_cfg("float32", 0.0, mlp_scale=1.0)
    tree, model_p = _toy()
    _, model_t = _toy()
    port = tstate.create_train_state(cfg, model_p)
    ref = torch.optim.Adam(model_t.parameters(), lr=1e-2, eps=cfg.train.eps)
    rng = np.random.default_rng(3)
    for i in range(4):
        for pp, pt in zip(model_p.parameters(), model_t.parameters()):
            g = torch.from_numpy(rng.normal(size=tuple(pp.shape)).astype(np.float32))
            pp.grad, pt.grad = g.clone(), g.clone()
        port.set_lr()
        port.optimizer.step()
        port.step += 1
        ref.param_groups[0]["lr"] = port.schedule(i)
        ref.step()
    for pp, pt in zip(model_p.parameters(), model_t.parameters()):
        np.testing.assert_allclose(pp.detach().numpy(), pt.detach().numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_optax_adam_resumes_a_torch_adam_state():
    """A checkpoint of the earlier ``torch.optim.Adam`` (its step a tensor)
    loads into the port's Adam, whose steps continue from it."""
    _, cfg = _opt_cfg("float32", 0.0)
    _, model = _toy()
    # the groups of make_optimizer, as the earlier port's Adam had them
    ref = torch.optim.Adam(tstate._param_groups(model, 0.5), lr=1e-2)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    ref.step()
    ref.step()
    state = tstate.create_train_state(cfg, model)
    sd = ref.state_dict()
    sd["param_groups"] = state.optimizer.state_dict()["param_groups"]
    state.optimizer.load_state_dict(sd)
    state.step = 2
    state.set_lr()
    state.optimizer.step()
    assert all(st["step"] == 3 and st["exp_avg"].dtype == torch.float32
               for st in state.optimizer.state.values())


# -- the capturable step body -----------------------------------------------------

class _BodyStep:
    """``make_step_body`` as ``make_train_step``'s step: inputs copied into
    static buffers, the draws given or drawn, the device step counter and
    schedule beside it, run eagerly on the CPU."""

    def __init__(self, mspec, rspec, lw, patch_loss_fn=None):
        self.args = (mspec, rspec, lw)
        self.body = tstep.make_step_body(mspec, rspec, lw, patch_loss_fn)
        self.static = None

    def __call__(self, state, batch, generator=None, draws=None):
        mspec, rspec, _ = self.args
        if draws is None:
            draws = tstep.draw_render(mspec, rspec, batch["ray_o"].shape[0],
                                      generator, CPU)
        if self.static is None:
            self.static = (compiled.static_copy(batch), compiled.static_copy(draws))
            self.sched = tstate.DeviceSchedule(state.optimizer, state.schedule, 16, CPU)
            self.dstep = torch.full((), state.step, dtype=torch.int64)
        compiled.fill(self.static[0], batch)
        compiled.fill(self.static[1], draws)
        stats = self.body(state, *self.static, self.sched, self.dstep)
        state.optimizer.advance_steps()
        state.step += 1
        assert int(self.dstep) == state.step
        return state, stats


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_step_body_matches_jax_over_three_mse_steps(mode, monkeypatch):
    """test_torch_train's three-step comparison with JAX, its port step the
    body on static buffers."""
    monkeypatch.setattr(tstep, "make_train_step", _BodyStep)
    _run_steps(train_tiny(mode), 3, mode)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_step_body_equals_the_eager_step(mode):
    """Bit for bit, 3 steps from one generator over an lr change."""
    c = train_tiny(mode)
    cfg = c.cfg.merged({"ep_iter": 1})
    runs = []
    for make in (tstep.make_train_step, _BodyStep):
        state = tstate.create_train_state(cfg, c.model())
        step = make(c.mspec, c.rspec, c.lw)
        gen = torch.Generator().manual_seed(7)
        losses = [step(state, c.batch, generator=gen)[1]["loss"].clone()
                  for _ in range(3)]
        runs.append((losses, state))
    (la, sa), (lb, sb) = runs
    assert sa.schedule(0) != sa.schedule(2)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for pa, pb in zip(sa.model.parameters(), sb.model.parameters()):
        assert torch.equal(pa, pb)
        assert torch.equal(sa.optimizer.state[pa]["exp_avg"], sb.optimizer.state[pb]["exp_avg"])


def test_step_body_matches_jax_over_two_patch_steps(subject):
    """Two LPIPS patch steps in float32 (test_torch_patch's case), body vs
    JAX's make_train_step with optax, from the same weights and draws."""
    cfg_j, cfg, batch_np = _patch_case(subject, "lpips")
    mspec_j, rspec_j = jinb.build_model_spec(cfg_j), jrend.make_render_spec(cfg_j)
    lw_j = jstep.make_loss_weights(cfg_j)
    opt, _ = jstate.make_optimizer(cfg_j)
    params = jinb.init_params(jax.random.key(0), mspec_j)
    jstate_ = jstate.create_train_state(params, opt)
    jfn = jax.jit(jstep.make_train_step(mspec_j, rspec_j, lw_j, opt,
                                        jloop.make_patch_loss_fn(cfg_j)))
    batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
    mspec, rspec = inb.build_model_spec(cfg), rend.make_render_spec(cfg)
    model = inb.InbModel(mspec)
    model.load_state_dict(bridge.params_from_jax(jax.tree.map(np.asarray, params), mspec))
    state = tstate.create_train_state(cfg, model)
    step = _BodyStep(mspec, rspec, tstep.make_loss_weights(cfg), loop.make_patch_loss_fn(cfg))
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()}
    R, S = 64, rspec.n_samples
    B = rend.pair_budget(mspec, rspec, R * S)
    for i in range(2):
        rng = jax.random.key(10 + i)
        jstate_, jstats = jfn(jstate_, batch_j, rng)
        k_strat, k_pair = jax.random.split(rng)
        draws = {"t_rand": torch.from_numpy(np.array(
                     jax.random.uniform(k_strat, (R, S), jnp.float32))),
                 "pair_noise": torch.from_numpy(np.array(
                     (jax.random.uniform(k_pair, (B, 3), jnp.float32) - 0.5)
                     * rspec_j.pair_range))}
        _, stats = step(state, batch, draws=draws)
        for k in ("loss", "patch_loss", "img_loss", "pair_loss", "reg_dist",
                  "offset_loss"):
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"step {i} {k}")
        got = dict(patch_leaves(bridge.tree_from_model(model, "data")))
        for k, want in patch_leaves(jax.tree.map(np.asarray, jstate_.params)):
            want = want[:got[k].shape[0]]          # JAX tables' zero tile padding
            np.testing.assert_allclose(got[k], want, rtol=1e-4,
                                       atol=1e-6 * max(np.abs(want).max(), 1e-30),
                                       err_msg=f"step {i} {k}")
    assert state.step == 2


# -- the eval frame ---------------------------------------------------------------

@pytest.mark.parametrize("n_rays", [100, 256])
def test_static_buffer_frame_matches_the_chunked_renderer_and_jax(n_rays):
    c = model_tiny("float32")
    item = _item(n_rays)
    rspec_j, rspec = jrend.RenderSpec(n_samples=8), rend.RenderSpec(n_samples=8)
    jfn = jrunner.make_chunked_renderer(c.mspec_j, rspec_j, chunk=64)
    ref = jrunner.render_full_image(jfn, c.params_j, item, jrunner.META_KEYS, 64)
    eager = runner.render_full_image(runner.make_chunked_renderer(c.mspec, rspec, 64),
                                     c.model, item, runner.META_KEYS, 64)
    frame = runner.CapturedFrame(c.mspec, rspec, 64)
    static = {}

    def on_static(model, rays, meta):
        """What the frame's graph replays: its function on static buffers."""
        for name, d in (("rays", rays), ("meta", meta)):
            if name not in static:
                static[name] = compiled.static_copy(d, CPU)
            compiled.fill(static[name], d)
        return frame.render_image(model, static["rays"], static["meta"])
    for _ in range(2):
        got = runner.render_full_image(on_static, c.model, item, runner.META_KEYS, 64)
        for k in eager:
            np.testing.assert_array_equal(got[k], eager[k], err_msg=k)
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(got[k], ref[k], **TOL["float32"], err_msg=k)
    _check_telemetry(got, ref)


def test_captured_frame_and_routes_on_the_cpu():
    c = model_tiny("float32")
    frame = runner.CapturedFrame(c.mspec, rend.RenderSpec(n_samples=8), 64)
    item = _item(100)
    with pytest.raises(RuntimeError, match="CUDA device"):
        runner.render_full_image(frame, c.model, item, runner.META_KEYS, 64)
    assert runner.frame_route("cuda") == ("captured", "")
    assert runner.frame_route("cuda", eager=True) == ("eager", "--eager")
    assert runner.frame_route("cpu").name == "eager"
    r = runner.AutoBudgetRenderer(c.mspec, rend.RenderSpec(n_samples=8), 64, captured=True)
    assert isinstance(r.render_fn, runner.CapturedFrame)
    r = runner.AutoBudgetRenderer(c.mspec, rend.RenderSpec(n_samples=8), 64)
    assert not isinstance(r.render_fn, runner.CapturedFrame)


# -- routes -----------------------------------------------------------------------

# (config, overrides, step_route's arguments, the case, its route: captured
# or a word of the eager route's reason); every optimizer, remat and NCCL
# ranks are captured, Gloo ranks are not
_ROUTES = [
    ("inb_377", {}, {}, "captured", "captured"),
    ("inb_fake", {}, {}, "captured", "captured"),
    ("inb_377", {"train": {"moment_dtype": "bfloat16"}}, {}, "captured", "captured"),
    ("inb_377", {"train": {"optim": "radam"}}, {}, "optim radam", "captured"),
    ("inb_377", {"train": {"optim": "sgd"}}, {}, "optim sgd", "captured"),
    ("inb_377", {}, {"world": 2, "backend": "nccl"}, "--distributed", "captured"),
    ("inb_377", {"remat": True}, {}, "remat", "captured"),
    ("inb_377", {}, {"eager": True}, "--eager", "--eager"),
    ("inb_377", {}, {"device": "cpu"}, "CUDA device", "CUDA device"),
    ("inb_377", {}, {"world": 2, "backend": "gloo"}, "gloo", "only NCCL"),
]


@pytest.mark.parametrize("name,over,kw,want", [c[:3] + c[4:] for c in _ROUTES],
                         ids=[f"{c[0]}-over{i}-kw{i}-{c[3]}" for i, c in enumerate(_ROUTES)])
def test_step_route(name, over, kw, want):
    cfg = make_cfg(os.path.join(ROOT, f"configs/inb/{name}.yaml")).merged(over)
    route = compiled.step_route(cfg, kw.pop("device", "cuda"), **kw)
    if want == "captured":
        assert route == ("captured", "") and str(route) == "captured"
    else:
        assert route.name == "eager" and want in route.reason
        assert str(route).startswith("eager (")


def test_step_route_under_detect_anomaly():
    cfg = make_cfg(CFG)
    with torch.autograd.set_detect_anomaly(True):
        route = compiled.step_route(cfg, "cuda")
    assert route.name == "eager" and "--detect_anomaly" in route.reason
    assert compiled.step_route(cfg, "cuda").name == "captured"


def test_captured_step_refuses_the_cpu():
    fl = bench.flagship(CFG, CPU, tiny=True)
    step = compiled.CapturedStep(fl.mspec, fl.rspec, fl.lw)
    state = bench.new_state(fl.cfg, CPU)
    with pytest.raises(RuntimeError, match="CUDA device"):
        step(state, fl.batch, generator=torch.Generator().manual_seed(0))
    assert state.step == 0 and step.captures == 0


def test_eager_flags_on_the_cpu(capsys):
    """``--eager`` on train_net, run and bench; the CPU's routes are eager."""
    train_net.main(["--device", "cpu", "--tiny", "--steps", "1", "--eager",
                    "--cfg_file", CFG])
    assert "step route eager (--eager)" in capsys.readouterr().out
    run.main(["--type", "network", "--device", "cpu", "--eager", "N_rand", "32",
              "N_samples", "8"])
    assert "route eager (--eager)" in capsys.readouterr().out
    assert run.parse_args(["--eager"]).eager and not run.parse_args([]).eager
    assert bench.parse_args(["--eager"]).eager
    assert train_net.parse_args(["--eager"]).eager


# -- launches through a stub graph ---------------------------------------------------

class _StubGraph:
    replays = 0

    def replay(self):
        _StubGraph.replays += 1


@contextlib.contextmanager
def _stub_capture(graph, stream=None, capture_error_mode=None):
    yield


def test_capture_and_replay_count_each_graphs_launches(monkeypatch):
    """The capture records the launches its function made and leaves the
    counters as they were; each replay adds them."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    counters = [(knn.knn_blend, "launches"), (scatter.segmented_scatter_add, "launches"),
                (scatter.onehot_scatter_add, "launches"),
                (scatter.sorted_scatter_add, "launches"),
                (scatter.exact_scatter_add, "calls"),
                (hg.fused_encode, "launches"), (hg.fused_encode_backward, "launches"),
                (mlp_wgrad.mlp_wgrad, "launches")]
    for fn, attr in counters:
        monkeypatch.setattr(fn, attr, 5)

    def fake_step():
        knn.knn_blend.launches += 1
        scatter.segmented_scatter_add.launches += 8
        scatter.onehot_scatter_add.launches += 10
        hg.fused_encode.launches += 3
        hg.fused_encode_backward.launches += 3
        mlp_wgrad.mlp_wgrad.launches += 13
        return {"loss": torch.zeros(())}
    graph, out, launches = compiled.capture(fake_step, stream=None)
    assert set(out) == {"loss"}
    assert [getattr(f, a) for f, a in counters] == [5] * 8
    assert dict(zip([f"{f.__name__}.{a}" for f, a in compiled._COUNTERS], launches)) == {
        "knn_blend.launches": 1, "knn_topk.launches": 0,
        "segmented_scatter_add.launches": 8, "onehot_scatter_add.launches": 10,
        "sorted_scatter_add.launches": 0, "exact_scatter_add.calls": 0,
        "fused_encode.launches": 3, "fused_encode_backward.launches": 3,
        "mlp_wgrad.launches": 13}
    _StubGraph.replays = 0
    for _ in range(3):
        compiled.replay(graph, launches)
    assert _StubGraph.replays == 3
    assert [getattr(f, a) for f, a in counters] == [8, 29, 35, 5, 5, 14, 14, 44]


def test_workspaces_refuse_a_first_use_under_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    dev = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="warm up"):
        scatter.workspace(dev, 16, stream=12345)
    with pytest.raises(RuntimeError, match="warm up"):
        scatter.sorted_workspace(dev, 16, stream=12345)
    assert (dev, 12345) not in scatter._workspaces


def test_held_tensors_change_with_a_loaded_optimizer_state():
    """A replay checks that the parameters and moments it holds are still
    the state's: an optimizer ``load_state_dict`` makes new moments."""
    _, cfg = _opt_cfg("float32", 0.0)
    state = tstate.create_train_state(cfg, _toy()[1])
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    held = compiled.held_tensors(state)
    assert compiled.same_tensors(held, compiled.held_tensors(state))
    assert len(held) == 3 * len(list(state.model.parameters()))
    # its own state dict loads the very same tensors back: still held
    state.optimizer.load_state_dict(state.optimizer.state_dict())
    assert compiled.same_tensors(held, compiled.held_tensors(state))
    # a copy (a checkpoint read back) makes other moments
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    assert not compiled.same_tensors(held, compiled.held_tensors(state))
    assert not compiled.same_tensors(held, held[:-1])


def test_a_replaced_workspace_stays_alive():
    """A graph captured with a workspace holds its address: a larger one
    replaces it in the cache, but the old one is kept, never freed."""
    dev, stream = CPU, -67890                       # a key no wrapper uses
    try:
        a = scatter.workspace(dev, 10, stream)
        b = scatter.workspace(dev, 20, stream)
        s = scatter.sorted_workspace(dev, 10, stream)
        t = scatter.sorted_workspace(dev, 20, stream)
        assert b is not a and t is not s
        assert any(w is a for w in scatter._retired) and any(w is s for w in scatter._retired)
        assert scatter.workspace(dev, 20, stream) is b
    finally:
        for d in (scatter._workspaces, scatter._sorted_workspaces):
            d.pop((dev, stream), None)


def test_signature_and_static_buffers():
    batch = {"a": torch.zeros(3, 2), "b": torch.ones((), dtype=torch.int64)}
    sig = compiled.signature(batch)
    assert sig == compiled.signature(dict(reversed(list(batch.items()))))
    assert sig != compiled.signature(dict(batch, a=torch.zeros(4, 2)))
    assert sig != compiled.signature(dict(batch, b=torch.ones((), dtype=torch.int32)))
    g = compiled.Graph({"batch": batch}, device="cpu")
    assert g.warm == 0 and g.graph is None
    g.fill({"batch": {"a": torch.full((3, 2), 2.0), "b": torch.tensor(7)}})
    static = g.inputs["batch"]
    assert torch.equal(static["a"], torch.full((3, 2), 2.0)) and int(static["b"]) == 7
    assert static["a"] is not batch["a"] and static["b"].dtype == torch.int64
