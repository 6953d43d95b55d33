"""The rest of the JAX package's compiled programs, as the port captures
them, on the CPU: the occupancy cube (``eval/mesh.py:CapturedCube``, the
JAX package's jitted ``occ_chunk``), the eval LPIPS
(``eval/evaluator.py:CapturedLpips``, its ``_lpips_jit``), and the train
step under RAdam, SGD, ``remat`` and across ranks
(``train/compiled.py:step_route``), with the optimizers that update from a
device schedule (``train/state.py:OptaxRAdam``, ``OptaxSGD``).  A CUDA
graph runs only on the card (``chip_smoke.py`` phase 16 replays each
program against its eager route); here each graph's body runs eagerly on
its static buffers, on the same inputs as the JAX package.

Tolerances:
  * the device-built grid points equal ``np.meshgrid`` of the
    ``np.linspace`` axes bit for bit; the cube on static buffers equals the
    eager cube bit for bit and JAX's ``occupancy_grid`` within
    ``tests/test_torch_mesh.py``'s atol 1e-5;
  * RAdam and SGD against ``optax.radam`` / ``optax.sgd`` over 8 steps
    (RAdam's ρ_t crosses 5 at the sixth), jitted as the JAX package's step
    runs them: ``test_optimizer_matches_optax``'s rtol 1e-5 / atol 1e-7.
    (Near the threshold ρ_t is 1999 less a term near 1993, so r_t in
    float32 moves with the last bit of b2^t: XLA's jitted and op-by-op
    programs give r_6 = 0.0256741 and 0.0255229.  The port's is the
    jitted one, bit for bit.)  The device-schedule update equals the host
    one bit for bit (the same sweeps, each scalar the same float32);
  * a resumed step from a JAX radam / sgd checkpoint:
    ``tests/test_torch_orbax.py``'s float32 tolerances (loss rtol 1e-5;
    parameters rtol 1e-4, atol 1e-6 of the leaf's largest entry);
  * the step body equals the eager step bit for bit on the CPU, also under
    ``remat`` and across two Gloo ranks.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instant_nvr_tpu.eval import mesh as jmesh
from instant_nvr_tpu.renderer import inb_renderer as jrend
from instant_nvr_tpu.train import checkpoint as jck
from instant_nvr_tpu.train import state as jstate
from instant_nvr_tpu.train import step as jstep
from instant_nvr_tpu_torch import bridge, run, train_net
from instant_nvr_tpu_torch.config import Config, make_cfg
from instant_nvr_tpu_torch.eval import evaluator, mesh, runner
from instant_nvr_tpu_torch.models import inb, lpips
from instant_nvr_tpu_torch.tools import multiprocess_check
from instant_nvr_tpu_torch.train import checkpoint, compiled
from instant_nvr_tpu_torch.train import state as tstate
from instant_nvr_tpu_torch.train import step as tstep
from test_torch_capture import _BodyStep
from test_torch_mesh import item, setup  # noqa: F401 (fixtures)
from test_torch_orbax import F32_MODE, _close, _draws, jax_train, tiny_batch, tiny_cfg
from test_torch_train import _leaves, _named, _toy
from test_torch_train import tiny as train_tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/inb/inb_377.yaml")
CPU = torch.device("cpu")


# -- the occupancy cube -------------------------------------------------------------

@pytest.mark.parametrize("res", [11, 24, 37])
def test_grid_points_equal_the_host_meshgrid(res):
    """Chunks of the device grid (the last one padded with zeros) against the
    points the JAX package builds on the host, bit for bit."""
    rng = np.random.default_rng(res)
    lo = rng.uniform(-1.2, -0.1, 3).astype(np.float32)
    tb = np.stack([lo, lo + rng.uniform(0.3, 2.0, 3).astype(np.float32)])
    axes = [np.linspace(tb[0, d], tb[1, d], res, dtype=np.float32) for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    want = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    assert np.array_equal(mesh.grid_axes(tb, res), np.stack(axes))
    chunk, n = 1000, res ** 3
    dev_axes = torch.from_numpy(mesh.grid_axes(tb, res))
    got = torch.cat([mesh.grid_points(dev_axes, i, chunk)
                     for i in range(0, -(-n // chunk) * chunk, chunk)]).numpy()
    assert np.array_equal(got[:n].view(np.uint32), want.view(np.uint32))
    assert not got[n:].any()


def _static_cube(cfg, mspec, model, meta_np, deformed, res):
    """What a CapturedCube's graph replays: a function that runs ``_cube``
    on static buffers filled once from the host inputs."""
    axes, meta, thresh = mesh.cube_inputs(cfg, meta_np, res, CPU)
    g = compiled.Graph({"axes": {"axes": axes}, "meta": meta}, CPU)
    g.fill({"axes": {"axes": axes}, "meta": meta})

    def run_():
        with torch.no_grad():
            occ = mesh._cube(mspec, model, g.inputs["axes"]["axes"], g.inputs["meta"],
                             deformed, thresh, mesh.OCC_CHUNK)
        return occ[:res ** 3].numpy().reshape(res, res, res)
    return run_


@pytest.mark.parametrize("deformed", [False, True], ids=["tmesh", "tdmesh"])
@pytest.mark.parametrize("tbw", [True, False], ids=["tbw", "no_tbw"])
def test_cube_on_static_buffers_matches_the_eager_cube_and_jax(setup, item,  # noqa: F811
                                                               deformed, tbw):
    meta = dict(item) if tbw else {k: v for k, v in item.items() if k != "tbw"}
    cfg = setup.port_cfg(setup.ckpt)
    res = 16
    want, _ = jmesh.occupancy_grid(cfg, setup.mspec_j, setup.params_j, meta, deformed,
                                   res=res)
    eager, _ = mesh.occupancy_grid(cfg, setup.mspec, setup.model, meta, deformed, res=res,
                                   eager=True)
    replay = _static_cube(cfg, setup.mspec, setup.model, meta, deformed, res)
    for _ in range(2):
        np.testing.assert_array_equal(replay(), eager)
    np.testing.assert_allclose(eager, want, rtol=0, atol=1e-5)
    assert eager.std() > 0 and (eager == 0).any() == tbw


def test_cube_reads_the_weights_the_optimizer_and_a_load_wrote(setup, item):  # noqa: F811
    """The graph holds the parameters by address: an optimizer step and a
    ``load_state_dict`` write them in place, so the same static buffers give
    the cube of the weights of the moment."""
    cfg = setup.port_cfg(setup.ckpt)
    model = copy.deepcopy(setup.model)
    replay = _static_cube(cfg, setup.mspec, model, item, False, 12)
    before = replay()
    ptrs = [p.data_ptr() for p in model.parameters()]
    state = tstate.create_train_state(cfg, model)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    state.set_lr()
    state.optimizer.step()
    stepped = replay()
    want, _ = mesh.occupancy_grid(cfg, setup.mspec, model, item, False, res=12, eager=True)
    np.testing.assert_array_equal(stepped, want)
    assert not np.array_equal(stepped, before)
    model.load_state_dict(setup.model.state_dict())
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    np.testing.assert_array_equal(replay(), before)


def test_eager_reaches_the_mesh_types(setup, tmp_path, monkeypatch, capsys):  # noqa: F811
    """``run --type prune | tmesh | tdmesh --eager`` runs the cube on the
    eager route and prints it (the cubes cut to res 12)."""
    orig = mesh.occupancy_grid
    monkeypatch.setattr(mesh, "occupancy_grid", lambda cfg, mspec, model, meta, deformed,
                        *_, eager=False, **__: orig(cfg, mspec, model, meta, deformed,
                                                    res=12, eager=eager))
    for type_ in ("prune", "tmesh", "tdmesh"):
        for flags, reason in ((["--eager"], "--eager"), ([], "CUDA device")):
            exp = str(tmp_path / f"{type_}{len(flags)}")
            run.main(["--cfg_file", setup.yaml, "--type", type_, "--device", "cpu"] + flags
                     + setup.opts(exp, model_dir=setup.ckpt))
            out = capsys.readouterr().out
            assert f"cube route: {mesh.cube_route(CPU, bool(flags))}\n" in out, (type_, out)
            assert reason in out


# -- the eval LPIPS --------------------------------------------------------------------

def test_lpips_on_static_buffers_equals_the_eager_lpips():
    rng = np.random.default_rng(5)
    imgs = [torch.from_numpy(rng.uniform(0, 1, (40, 48, 3)).astype(np.float32))
            for _ in range(4)]
    g = compiled.Graph({"images": {"pred": imgs[0], "gt": imgs[1]}}, CPU)
    for a, b in ((imgs[0], imgs[1]), (imgs[2], imgs[3])):
        g.fill({"images": {"pred": a, "gt": b}})
        with torch.no_grad():
            got = lpips.lpips_distance(g.inputs["images"]["pred"], g.inputs["images"]["gt"])
            want = lpips.lpips_distance(a, b)
        assert torch.equal(got, want) and float(got) > 0
    ev = evaluator.Evaluator(device=CPU)
    assert not ev.captured
    assert ev._lpips(imgs[0].numpy(), imgs[1].numpy()) == float(
        lpips.lpips_distance(imgs[0], imgs[1]))


# -- routes and the CPU ----------------------------------------------------------------

def test_program_routes():
    for route in (mesh.cube_route, evaluator.lpips_route, runner.frame_route):
        assert route("cuda") == ("captured", "") and str(route("cuda")) == "captured"
        assert route("cuda", eager=True) == ("eager", "--eager")
        assert route("cpu").name == "eager" and "CUDA device" in route("cpu").reason


@pytest.mark.parametrize("over,kw,want", [
    ({"train": {"optim": "radam"}}, {}, "captured"),
    ({"train": {"optim": "sgd"}}, {}, "captured"),
    ({"remat": True}, {}, "captured"),
    ({}, {"world": 2, "backend": "nccl"}, "captured"),
    ({}, {"world": 4, "backend": "nccl"}, "captured"),
    ({}, {"world": 2, "backend": "gloo"}, "gloo"),
    ({"train": {"optim": "radam"}}, {"eager": True}, "--eager"),
    ({"train": {"optim": "sgd"}}, {"device": "cpu"}, "CUDA device"),
], ids=["radam", "sgd", "remat", "nccl-2", "nccl-4", "gloo-2", "eager", "cpu"])
def test_step_routes_of_the_new_programs(over, kw, want):
    route = compiled.step_route(make_cfg(CFG).merged(over), kw.pop("device", "cuda"), **kw)
    if want == "captured":
        assert route == ("captured", "")
    else:
        assert route.name == "eager" and want in route.reason
    if "remat" in over:
        with torch.autograd.set_detect_anomaly(True):
            assert "--detect_anomaly" in compiled.step_route(
                make_cfg(CFG).merged(over), "cuda").reason


@pytest.mark.parametrize("program", ["step", "frame", "cube", "lpips"])
def test_captured_programs_refuse_the_cpu(program):
    cfg = make_cfg(CFG).merged(train_net.TINY)
    t = train_net.build_trainer(cfg, CPU, tiny=True)
    model = t.state.model
    if program == "step":
        call = lambda: compiled.CapturedStep(t.mspec, t.rspec, t.lw)(
            t.state, t.batch, generator=torch.Generator())
    elif program == "frame":
        rays = {k: t.batch[k] for k in runner.RAY_KEYS}
        meta = {k: t.batch[k] for k in runner.META_KEYS if k in t.batch}
        call = lambda: runner.CapturedFrame(t.mspec, t.rspec, 64)(model, rays, meta)
    elif program == "cube":
        args = mesh.cube_inputs(cfg, train_net.synthetic_batch_np(cfg, tiny=True), 8, CPU)
        cube = mesh.CapturedCube()
        call = lambda: cube(t.mspec, model, args[0], args[1], False, args[2],
                            mesh.OCC_CHUNK)
    else:
        img = torch.zeros((32, 32, 3))
        call = lambda: evaluator.CapturedLpips()(img, img, "", CPU)
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()
    if program == "cube":
        assert not cube.graphs and cube.captures == 0


# -- RAdam and SGD from a device schedule ------------------------------------------

def _opt_cfgs(optim, wd):
    from instant_nvr_tpu.config import make_cfg as jax_make_cfg
    over = {"train": {"optim": optim, "weight_decay": wd, "lr": 1e-2,
                      "scheduler": {"type": "exponential", "gamma": 0.1,
                                    "decay_epochs": 3}},
            "ep_iter": 2, "mlp_weight_decay": 0.5}
    return jax_make_cfg(CFG).merged(over), make_cfg(CFG).merged(over)


def _moments(opt, p):
    return {k: v for k, v in opt.state[p].items() if torch.is_tensor(v)}


@pytest.mark.parametrize("wd", [0.0, 1e-3])
@pytest.mark.parametrize("optim", ["radam", "sgd"])
def test_optimizer_and_its_device_schedule_match_optax(optim, wd):
    """8 steps over 4 lr epochs: the host update and the device-schedule
    update (its step counter a 0-d tensor) bit-equal, both within optax's
    tolerance; RAdam's rectification switches on at the sixth step."""
    cfg_j, cfg = _opt_cfgs(optim, wd)
    tree, model_h = _toy()
    _, model_d = _toy()
    host, dev = (tstate.create_train_state(cfg, m) for m in (model_h, model_d))
    cls = {"radam": tstate.OptaxRAdam, "sgd": tstate.OptaxSGD}[optim]
    assert type(host.optimizer) is cls and type(dev.optimizer) is cls
    sched = tstate.DeviceSchedule(dev.optimizer, dev.schedule, 10, CPU)
    if optim == "radam":
        assert sched.rectify.tolist() == [False] * 5 + [True] * 5
        assert sched.rect.dtype == torch.float32 and torch.isfinite(sched.rect[5:]).all()
    else:                                   # SGD reads only its rate
        assert not hasattr(sched, "bc1") and len(sched.neg_lr) == 2
    dstep = torch.zeros((), dtype=torch.int64)
    opt, _ = jstate.make_optimizer(cfg_j)
    update = jax.jit(opt.update)      # as the JAX package's jitted step runs it
    params = jax.tree.map(jnp.asarray, tree)
    ost = opt.init(params)
    rng = np.random.default_rng(9)
    for i in range(8):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        upd, ost = update(jax.tree.map(jnp.asarray, grads), ost, params)
        params = optax.apply_updates(params, upd)
        for model in (model_h, model_d):
            for (_, g), p in zip(_leaves(grads), _named(model, grads)):
                p.grad = torch.from_numpy(g.copy())
        host.set_lr()
        host.optimizer.step()
        host.step += 1
        dev.optimizer.step_device(sched, dstep)
        dstep.add_(1)
        dev.optimizer.advance_steps()
        dev.step += 1
        for ph, pd in zip(model_h.parameters(), model_d.parameters()):
            assert torch.equal(ph, pd), f"step {i}"
            mh, md = _moments(host.optimizer, ph), _moments(dev.optimizer, pd)
            assert mh.keys() == md.keys() == ({"momentum_buffer"} if optim == "sgd"
                                              else {"exp_avg", "exp_avg_sq"})
            assert all(torch.equal(mh[k], md[k]) for k in mh)
            if optim == "radam":
                assert host.optimizer.state[ph]["step"] == dev.optimizer.state[pd]["step"] \
                    == i + 1
        for (k, want), p in zip(_leaves(params), _named(model_d, grads)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("optim", ["radam", "sgd"])
def test_a_torch_optimizer_checkpoint_resumes(optim, tmp_path):
    """A ``state.pt`` of the ``torch.optim.RAdam`` / ``SGD`` the port used
    before (2 steps) resumes into the port's optimizer, whose 4 more steps
    (RAdam's rectification switching on) match optax's 6."""
    cfg_j, cfg = _opt_cfgs(optim, 0.0)
    tree, model_t = _toy()
    _, model_p = _toy()
    groups = tstate._param_groups(model_t, 0.5)
    sched = tstate.create_train_state(cfg, model_p).schedule
    ref = (torch.optim.RAdam(groups, lr=1e-2, eps=cfg.train.eps) if optim == "radam"
           else torch.optim.SGD(groups, lr=1e-2, momentum=0.9))
    opt, _ = jstate.make_optimizer(cfg_j)
    update = jax.jit(opt.update)      # as the JAX package's jitted step runs it
    params = jax.tree.map(jnp.asarray, tree)
    ost = opt.init(params)
    rng = np.random.default_rng(4)
    state = None
    for i in range(6):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        upd, ost = update(jax.tree.map(jnp.asarray, grads), ost, params)
        params = optax.apply_updates(params, upd)
        if i == 2:
            checkpoint.save_checkpoint(str(tmp_path), 0, tstate.TrainState(
                2, model_t, ref, sched), {"epoch": 0, "step": 2})
            state = tstate.create_train_state(cfg, model_p)
            assert checkpoint.load_checkpoint(str(tmp_path), state) == {"epoch": 0,
                                                                         "step": 2}
            assert state.step == 2 and type(state.optimizer).__name__ == \
                {"radam": "OptaxRAdam", "sgd": "OptaxSGD"}[optim]
            for pt, pp in zip(model_t.parameters(), model_p.parameters()):
                mt, mp = _moments(ref, pt), _moments(state.optimizer, pp)
                assert mt.keys() >= mp.keys() and all(torch.equal(mt[k], mp[k]) for k in mp)
        model = model_t if state is None else model_p
        for (_, g), p in zip(_leaves(grads), _named(model, grads)):
            p.grad = torch.from_numpy(g.copy())
        if state is None:
            for g in ref.param_groups:
                g["lr"] = sched(i) * g["lr_scale"]
            ref.step()
        else:
            state.set_lr()
            state.optimizer.step()
            state.step += 1
    for (k, want), p in zip(_leaves(params), _named(model_p, tree)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("optim", ["radam", "sgd"])
def test_a_jax_checkpoint_resumes_across_the_threshold(optim, tmp_path):
    """5 JAX steps under radam / sgd, saved by the JAX package; its sixth
    step (RAdam's first rectified one) resumed in both packages from that
    directory, the port's on its host update and on its device schedule."""
    cfg_j, cfg = tiny_cfg({"train": {"optim": optim}}, F32_MODE)
    batch_np = tiny_batch()
    mspec_j, opt, st = jax_train(cfg_j, 5, batch_np)
    d = str(tmp_path / "model")
    jck.save_checkpoint(d, 0, st, {"step": 5, "epoch": 0})
    step = jax.jit(jstep.make_train_step(mspec_j, jrend.make_render_spec(cfg_j),
                                         jstep.make_loss_weights(cfg_j), opt))
    jnext, jstats = step(st, {k: jnp.asarray(v) for k, v in batch_np.items()},
                         jax.random.key(5))
    moment = "trace" if optim == "sgd" else "mu"
    for make in (tstep.make_train_step, _BodyStep):
        mspec, rspec, model = run.build(cfg, CPU, seed=4)
        state = tstate.create_train_state(cfg, model)
        assert checkpoint.load_checkpoint(d, state) == {"epoch": 0, "step": 5}
        first = state.optimizer.state[model.embed["body"].hash]
        got = first["momentum_buffer" if optim == "sgd" else "exp_avg"].numpy()
        want = np.asarray(getattr(st.opt_state[0], moment)["embed"]["body"]["hash"])
        assert np.array_equal(got, want[:got.shape[0]])
        _, stats = make(mspec, rspec, tstep.make_loss_weights(cfg))(
            state, {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()},
            draws=_draws(cfg_j, mspec, rspec, batch_np, jax.random.key(5)))
        assert state.step == 6 == int(jnext.step)
        for k in ("loss", "img_loss", "psnr"):
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        want = bridge.params_from_jax(jax.tree.map(np.asarray, jnext.params), mspec)
        for k, v in model.state_dict().items():
            _close(v.numpy(), want[k].numpy(), f"{make.__name__} param {k}")


# -- the step body under the new routes ---------------------------------------------------

@pytest.mark.parametrize("optim,remat", [("radam", False), ("sgd", False),
                                         ("adam", True), ("radam", True)])
def test_step_body_equals_the_eager_step(optim, remat):
    """Bit for bit, 7 steps from one generator over lr changes (RAdam's
    rectification switching on at the sixth), with and without ``remat``."""
    c = train_tiny("bfloat16")
    cfg = c.cfg.merged({"ep_iter": 2, "train": {"optim": optim}})
    lw = c.lw._replace(remat=remat)
    runs = []
    for make in (tstep.make_train_step, _BodyStep):
        state = tstate.create_train_state(cfg, c.model())
        step = make(c.mspec, c.rspec, lw)
        gen = torch.Generator().manual_seed(7)
        losses = [step(state, c.batch, generator=gen)[1]["loss"].clone()
                  for _ in range(7)]
        runs.append((losses, state))
    (la, sa), (lb, sb) = runs
    assert sa.schedule(0) != sa.schedule(6)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for pa, pb in zip(sa.model.parameters(), sb.model.parameters()):
        assert torch.equal(pa, pb)
        ma, mb = _moments(sa.optimizer, pa), _moments(sb.optimizer, pb)
        assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)


def test_step_body_across_gloo_ranks_equals_the_eager_step(tmp_path):
    """Two Gloo ranks, 2 RAdam steps each way: the body (its gradient
    all-reduce, counts and stats collectives, as a captured step on NCCL
    replays them) against the eager step, bit for bit on every rank."""
    inputs = multiprocess_check.tiny_step_inputs()
    # radam's tables are non-scalar: its own model, with tiny_step_inputs'
    # occupancy bias 0
    cfg = Config(inputs["cfg"]).merged({"train": {"optim": "radam"}})
    model = inb.init_params(inb.build_model_spec(cfg), torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        model.occ[-1].b[:, 0] = 0.0
    inputs.update(cfg=cfg.to_dict(), state=model.state_dict(), steps=2)
    ranks = {}
    for body in (False, True):
        torch.save(dict(inputs, body=body), os.path.join(tmp_path, "inputs.pt"))
        ranks[body] = multiprocess_check.launch("step", 2, str(tmp_path))
    for eager, body in zip(ranks[False], ranks[True]):
        assert eager["world"] == body["world"] == 2 and body["equal"]
        assert eager["losses"] == body["losses"]
        for k in eager["params0"]:
            assert torch.equal(eager["params0"][k], body["params0"][k]), k
        for k in eager["stats0"]:
            assert torch.equal(eager["stats0"][k], body["stats0"][k]), k
