"""The port's data-parallel layer (``instant_nvr_tpu_torch/parallel``) on
the CPU: real Gloo ranks, each a process started by
``instant_nvr_tpu_torch/tools/multiprocess_check.py:launch`` (which blocks
cv2, imageio, PIL, jax and the JAX package in every rank and fails if any
was imported), held against the port's one-process step or run and against
the JAX package's 8-device sharded step.

Tolerances:
  * the 2-rank step against the port's one-process step, float32 widths:
    loss and stats rtol 1e-5; per-leaf gradients and post-Adam parameters
    rtol 1e-4 / atol 1e-6 of the leaf's largest entry (float32 sums in
    another order: the ranks' partial sums and the all-reduce).  The
    deformer's leaves, which the pair regularizer reaches, within 2^-23 /
    pair_loss of their largest entry: that gradient runs through the unit
    vector (v1 - v0) / |v1 - v0| of two residual directions a mean
    pair_loss apart, which a float32 rounding of a residual (2^-23, as a
    batch of another size gives) turns by 2^-23 / pair_loss; an entry
    whose gradient is within that bound of 0 may take Adam's first step
    (lr x sign) either way, so its parameter is held within 2.1 x lr;
  * against JAX's sharded step (``tests/test_parallel.py``'s bounds): loss
    rtol 2e-4, parameters rtol 2e-3 / atol 2e-5, with the same exception;
  * metrics and the ranks' parameters: exactly equal.
Every case uses budgets that do not overflow, except the one that shows
what happens when they do.
"""
import glob
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _flagship
from instant_nvr_tpu.parallel import mesh as jmesh
from instant_nvr_tpu.renderer import inb_renderer as jrend
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.train import state as jstate
from instant_nvr_tpu.train import step as jstep
from instant_nvr_tpu_torch import bridge, run, train_net
from instant_nvr_tpu_torch.config import Config, make_cfg
from instant_nvr_tpu_torch.datasets.fake_zju import fake_cfg_overrides, write_fake_dataset
from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.parallel import mesh as pmesh
from instant_nvr_tpu_torch.renderer import inb_renderer as rend
from instant_nvr_tpu_torch.tools import multiprocess_check as mc
from instant_nvr_tpu_torch.train import loop
from instant_nvr_tpu_torch.train.step import draw_render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
F32 = {"mlp_dtype": "float32", "grid_compute_dtype": "float32"}
NO_OVERFLOW = {"cull_budget": 1.0, "part_budget": 1.0}
LR = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).train.lr


def _grad_tol(one):
    """Per-leaf absolute gradient tolerance of the module doc."""
    pair = float(one["stats0"]["pair_loss"])
    return {k: (2.0 ** -23 / pair if k.startswith("deformer.") and pair > 0 else 1e-6)
            * max(float(g.abs().max()), 1e-30) for k, g in one["grads0"].items()}


def _close_params(got, want, grad, gtol, lr, rtol, atol, what):
    """``got`` against ``want``, entries whose gradient is within ``gtol``
    of 0 within 2.1 x lr (Adam's first step may go either way)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    near_zero = np.abs(np.asarray(grad)) <= gtol
    np.testing.assert_allclose(got[~near_zero], want[~near_zero], rtol=rtol, atol=atol,
                               err_msg=what)
    assert np.abs(got - want).max() <= 2.1 * lr, what


def _launch(tmp, case, world, inputs=None, **kw):
    os.makedirs(tmp, exist_ok=True)
    if inputs is not None:
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    return mc.launch(case, world, tmp, timeout=110, **kw)


# -- the mesh contract, against JAX's --------------------------------------------

def _batch(rng, n, mask):
    b = {"ray_o": rng.standard_normal((n, 3)).astype(np.float32),
         "ray_d": rng.standard_normal((n, 3)).astype(np.float32),
         "near": rng.random(n).astype(np.float32),
         "far": 1 + rng.random(n).astype(np.float32),
         "rgb": rng.random((n, 3)).astype(np.float32),
         "coord": rng.integers(0, 64, (n, 2)).astype(np.int32),
         "R": np.eye(3, dtype=np.float32), "latent_index": np.int32(1)}
    if mask:
        b["ray_mask"] = (rng.random(n) < 0.8).astype(np.float32)
    return b


@pytest.mark.parametrize("n,mult,mask", [(100, 64, False), (100, 3, True),
                                         (96, 8, True), (7, 2, False)])
def test_pad_rays_to_multiple_matches_jax(rng, n, mult, mask):
    batch = _batch(rng, n, mask)
    got, want = pmesh.pad_rays_to_multiple(batch, mult), jmesh.pad_rays_to_multiple(batch, mult)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["ray_o"].shape[0] % mult == 0


@pytest.mark.parametrize("world", [2, 4, 8])
def test_shard_batch_matches_jax_process_slices(rng, monkeypatch, world):
    """Each rank's slice is the process-local slice of JAX's put_global
    (the multi-process branch, with the process index set and the
    assembly replaced by the local slice it is given)."""
    batch = pmesh.pad_rays_to_multiple(_batch(rng, 61, True), 8)
    mesh = jmesh.make_mesh()
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "make_array_from_process_local_data",
                        lambda sharding, local, shape: np.asarray(local))
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = jmesh.shard_batch(mesh, batch)
        got = pmesh.shard_batch(batch, r, world)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_shard_batch_refuses_an_indivisible_ray_axis(rng):
    with pytest.raises(ValueError, match="pad_rays_to_multiple"):
        pmesh.shard_batch(_batch(rng, 10, False), 0, 3)
    batch = _batch(rng, 10, False)
    assert pmesh.shard_batch(batch, 0, 1) is batch


# -- the MSE step ------------------------------------------------------------------

@pytest.fixture(scope="module")
def mse(tmp_path_factory):
    """The tiny flagship (float32, budgets that cannot overflow, occupancy
    bias 0 so the pair regularizer has valid pairs): JAX's weights and
    draws, JAX's 8-device sharded step, the port's one-process step and
    the port's 2-rank step, 3 steps each of the port's."""
    cfg_j, *_, batch_np = _flagship(tiny=True)
    cfg_j = cfg_j.merged(F32).merged(NO_OVERFLOW)
    mspec_j, rspec_j = jinb.build_model_spec(cfg_j), jrend.make_render_spec(cfg_j)
    params = jinb.init_params(jax.random.key(0), mspec_j)
    params["occ"][-1]["b"] = params["occ"][-1]["b"].at[:, 0].set(0.0)
    # the same config through the port's own loader (the JAX one's dict
    # holds the JAX package's objects)
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(
        train_net.TINY).merged(F32).merged(NO_OVERFLOW)
    mspec, rspec = inb.build_model_spec(cfg), rend.make_render_spec(cfg)
    assert mspec == inb.build_model_spec(Config(cfg_j.to_dict()))
    rng = jax.random.key(3)
    R, S = batch_np["ray_o"].shape[0], rspec.n_samples
    k_strat, k_pair = jax.random.split(rng)
    B = rend.pair_budget(mspec, rspec, R * S)
    draws = {"t_rand": torch.from_numpy(np.array(jax.random.uniform(k_strat, (R, S)))),
             "pair_noise": torch.from_numpy(np.array(
                 (jax.random.uniform(k_pair, (B, 3)) - 0.5) * rspec_j.pair_range))}
    inputs = {"cfg": cfg.to_dict(), "batch": {k: np.asarray(v) for k, v in batch_np.items()},
              "state": bridge.params_from_jax(jax.tree.map(np.asarray, params), mspec),
              "draws": draws, "seed": 5, "steps": 3}

    opt, _ = jstate.make_optimizer(cfg_j)
    step_j = jstep.make_train_step(mspec_j, rspec_j, jstep.make_loss_weights(cfg_j), opt)
    mesh = jmesh.make_mesh()
    state8 = jax.device_put(jstate.create_train_state(params, opt, mspec_j),
                            jmesh.replicated(mesh))
    state8, stats8 = jax.jit(step_j)(state8, jmesh.shard_batch(mesh, batch_np), rng)
    tmp = str(tmp_path_factory.mktemp("mse"))
    return {"jax": (float(stats8["loss"]), jax.tree.map(np.asarray, state8.params)),
            "one": mc.case_step(inputs, CPU), "ranks": _launch(tmp, "step", 2, inputs),
            "mspec": mspec}


def _tree(mspec, state_dict):
    """Leaf path -> array of a state dict (missing entries, a gradient's
    unused tables, as zeros)."""
    model = inb.InbModel(mspec)
    full = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    model.load_state_dict(dict(full, **state_dict))
    return dict(_leaves(bridge.tree_from_model(model, "data")))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float32)


def _match_one_process(one, ranks):
    """Each rank's first step against the one-process step (module doc)."""
    assert [r["rank"] for r in ranks] == [0, 1] and ranks[0]["world"] == 2
    assert float(one["stats0"]["pair_loss"]) > 0    # valid pairs on both ranks' shares
    for r in ranks:
        assert r["stats0"].keys() == one["stats0"].keys()
        for k, want in one["stats0"].items():
            if k.endswith("_need"):     # the neediest rank's share of its samples
                assert (r["stats0"][k] >= want).all(), k
                continue
            np.testing.assert_allclose(r["stats0"][k].numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        assert r["grads0"].keys() == one["grads0"].keys()
        gtol = _grad_tol(one)
        for k, want in one["grads0"].items():
            np.testing.assert_allclose(r["grads0"][k].numpy(), want.numpy(), rtol=1e-4,
                                       atol=gtol[k], err_msg=f"grad {k}")
            _close_params(r["params0"][k], one["params0"][k], want, gtol[k], LR, 1e-4,
                          1e-6 * float(one["params0"][k].abs().max()), f"param {k}")
    assert float(one["stats0"]["cull_overflow"]) == 0.0
    assert float(one["stats0"]["part_overflow"]) == 0.0


def test_two_rank_step_matches_the_one_process_step(mse):
    _match_one_process(mse["one"], mse["ranks"])


def test_overflowing_pair_budget_matches_the_one_process_step(tmp_path):
    """More valid pair candidates than the pair budget's slots (512 rays,
    occupancies all near 0.5): one process keeps the first 1,024 in
    ``pair_order``; each rank's own top-k holds its members of those, and
    the rest are masked, so the 2-rank step is the one-process step."""
    inputs = mc.tiny_step_inputs(512)
    w = inputs["state"]["occ.1.w"].clone()
    w[..., 0] *= 0.1
    inputs["state"] = dict(inputs["state"], **{"occ.1.w": w})
    cfg = Config(inputs["cfg"])
    mspec, rspec = inb.build_model_spec(cfg), rend.make_render_spec(cfg)
    model = inb.InbModel(mspec, CPU)
    model.load_state_dict(inputs["state"])
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in inputs["batch"].items()}
    n_samples = 512 * rspec.n_samples
    budget = rend.pair_budget(mspec, rspec, n_samples)
    # the candidates below the threshold: a selection without the cap
    uncapped = rspec._replace(pair_budget=sum(inb.budgets(mspec, n_samples)[1]))
    with torch.no_grad():
        ret = rend.render_rays(mspec, uncapped, model, batch, train=True, draws=draw_render(
            mspec, uncapped, 512, torch.Generator().manual_seed(1), CPU))
    assert int(ret["pair_valid"].sum()) > budget == 1024
    _match_one_process(mc.case_step(inputs, CPU), _launch(str(tmp_path), "step", 2, inputs))


def test_ranks_hold_bit_equal_parameters(mse):
    """After 3 steps (the last two from the generator's draws), by rank
    0's broadcast; the gradients each rank stepped with are the same
    all-reduced sum."""
    ranks = mse["ranks"]
    assert all(r["equal"] for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for k, g in ranks[0]["grads0"].items():
        assert torch.equal(g, ranks[1]["grads0"][k]), k
    assert ranks[0]["allreduce_bytes"] == 4 * sum(g.numel() for g in ranks[0]["grads0"].values())


def test_two_rank_step_matches_jax_sharded_step(mse):
    loss_j, params_j = mse["jax"]
    r0, one = mse["ranks"][0], mse["one"]
    np.testing.assert_allclose(r0["losses"][0], loss_j, rtol=2e-4)
    got = _tree(mse["mspec"], r0["params0"])
    grads = _tree(mse["mspec"], one["grads0"])
    gtol = _tree(mse["mspec"], {k: torch.full_like(one["grads0"][k], v)
                                for k, v in _grad_tol(one).items()})
    for k, want in _leaves(params_j):
        g = got[k]
        _close_params(g, want[:g.shape[0]], grads[k], gtol[k], LR, 2e-3, 2e-5, k)


def test_pair_order_is_score_then_part_then_distance():
    """The pair selection's keys order by score (clamped to 1), ties by
    part, then by part distance, so that a rank orders its candidates as
    one process orders the union (the 2-rank steps above hold the rest)."""
    g = torch.Generator().manual_seed(0)
    score = torch.rand(200, generator=g) * 0.04
    score[:40] = score[40:80]                            # ties
    score[150:] = float("inf")                           # not candidates
    part = torch.randint(0, 5, (200,), generator=g)
    dist = torch.rand(200, generator=g)
    keys = rend.pair_order(score, part, dist)
    assert len(torch.unique(keys)) == 200
    want = np.lexsort((dist.numpy(), part.numpy(), np.minimum(score.numpy(), 1.0)))
    np.testing.assert_array_equal(torch.argsort(keys).numpy(), want)


# -- patch mode -------------------------------------------------------------------

@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zju_parallel"))
    write_fake_dataset(root, n_frames=2, n_views=2, H=96, W=96)
    return root


def test_two_rank_patch_step_matches_the_one_process_step(subject, tmp_path):
    """A 16x16 LPIPS patch, 128 rays a rank: the patch is gathered with
    autograd and its loss counts 1/2 on each rank."""
    over = dict(train_net.TINY, use_lpips=True, patch_size=16, **F32, **NO_OVERFLOW)
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(
        fake_cfg_overrides(subject, n_frames=2)).merged(over)
    item = TPoseDataset(cfg, "train").get_item(1, rng=np.random.default_rng(2))
    assert item["rgb"].shape == (256, 3) and item["ray_mask"].sum() > 0
    batch = {k: np.asarray(item[k]) for k in loop.DEVICE_KEYS if k in item}
    batch["reg_dist_weight"] = np.float32(0.1)
    inputs = {"cfg": cfg.to_dict(), "batch": batch, "seed": 7, "steps": 1}
    one = mc.case_step(inputs, CPU)
    ranks = _launch(str(tmp_path), "step", 2, inputs)
    assert float(one["stats0"]["patch_loss"]) > 0
    for r in ranks:
        for k in ("loss", "patch_loss", "img_loss", "psnr", "pair_loss", "reg_dist",
                  "offset_loss", "ray_error"):
            np.testing.assert_allclose(r["stats0"][k].numpy(), one["stats0"][k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        gtol = _grad_tol(one)
        for k, want in one["grads0"].items():
            np.testing.assert_allclose(r["grads0"][k].numpy(), want.numpy(), rtol=1e-4,
                                       atol=gtol[k], err_msg=f"grad {k}")
            _close_params(r["params0"][k], one["params0"][k], want, gtol[k], LR, 1e-4,
                          1e-6 * float(one["params0"][k].abs().max()), f"param {k}")
    assert ranks[0]["equal"]


# -- budgets ----------------------------------------------------------------------

def test_overflowing_budgets_select_per_rank(tmp_path):
    """The expected divergence (ROADMAP.md §C): a cull budget that
    overflows selects per rank, from each rank's own samples, so the
    2-rank step is not the one-process step; the overflow telemetry is
    the whole batch's: counts summed over the ranks, demand the largest
    rank's."""
    inputs = mc.tiny_step_inputs()
    inputs["cfg"] = Config(inputs["cfg"]).merged({"cull_budget": 0.1}).to_dict()
    inputs["telemetry"] = True
    one = mc.case_step(inputs, CPU)
    ranks = _launch(str(tmp_path), "step", 2, inputs)
    assert float(one["stats0"]["cull_overflow"]) > 0
    counts = sum(r["telemetry"]["budget_counts"].double() for r in ranks)
    true_c, sel_c, flag, sel_p = counts.tolist()
    assert true_c > sel_c
    for r in ranks:
        s = r["stats0"]
        np.testing.assert_allclose(float(s["cull_overflow"]), (true_c - sel_c) / true_c,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(s["part_overflow"]),
                                   (flag - sel_p) / max(flag, 1.0), rtol=1e-6, atol=1e-9)
        assert float(s["cull_need"]) == max(float(q["telemetry"]["cull_need"]) for q in ranks)
        torch.testing.assert_close(s["part_need"], torch.maximum(
            ranks[0]["telemetry"]["part_need"], ranks[1]["telemetry"]["part_need"]))
    # the divergence: each rank kept its own nearest samples
    assert abs(ranks[0]["losses"][0] - one["losses"][0]) > 1e-4 * one["losses"][0]


def test_auto_budget_is_rank0s_broadcast(tmp_path):
    """Rank 0 probes (stubbed to known budgets) and broadcasts; every rank
    gets the same budgets, and only rank 0 writes ``budgets.json``."""
    out = _launch(str(tmp_path), "budget", 2)
    assert [o["probes"] for o in out] == [1, 0]
    assert out[0]["budgets"] == out[1]["budgets"] == [
        0.31, 0.41, [1.0, 0.8, 0.6, 0.4, 0.2]]
    assert [os.path.basename(p) for p in out[0]["writes"]] == ["budgets.json"]
    assert out[1]["writes"] == []


# -- evaluation -------------------------------------------------------------------

def test_allgather_metrics_over_uneven_shards(tmp_path):
    """5 items over 3 ranks (2, 2, 1): every rank gets the one-process
    lists, a genuine NaN included, and rank 0 writes them."""
    one = mc.case_metrics({}, CPU, str(tmp_path / "one"))
    out = _launch(str(tmp_path / "three"), "metrics", 3)
    assert [o["mine"] for o in out] == [[0, 1], [2, 3], [4]]
    for o in out:
        for k, want in one["merged"].items():
            np.testing.assert_array_equal(o["merged"][k], want, err_msg=k)
    a = np.load(str(tmp_path / "one" / "metrics.npy"), allow_pickle=True).item()
    b = np.load(str(tmp_path / "three" / "metrics.npy"), allow_pickle=True).item()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


TINY_EMBED = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=10,
                  base_resolution=4, b=1.38)


def _yaml(base, root, n_frames):
    """The tiny widths on the subject at ``root`` (one test view)."""
    path = os.path.join(base, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(fake_cfg_overrides(root, n_frames=n_frames), **{
            "partnet": {p: {"embedder": {"kwargs": TINY_EMBED}} for p in
                        ("body", "leg", "head", "larm", "rarm")},
            "tpose_deformer": {"embedder": {"kwargs": dict(TINY_EMBED, sum=False)}},
            "network": {"occ": {"d_hidden": 32, "n_layers": 1},
                        "color": {"d_hidden": 32, "n_layers": 2}},
            "N_samples": 8, "N_rand": 128, "render_chunk": 512,
            "geo_feature_dim": 8, "latent_code_dim": 8, "num_latent_code": n_frames,
            **F32, "test": {"frame_sampler_interval": 1}, "exp_name": "dp"}), f)
    return path


def _not_rank0s(writes, base):
    return [p for p in writes if os.path.abspath(p).startswith(base)
            and not os.path.basename(p).startswith(("frame", "eval_budgets.json.rank"))]


def test_three_rank_evaluation_writes_the_one_process_metrics(tmp_path):
    """``run --type evaluate --distributed`` on 5 test items over 3 Gloo
    ranks (random weights from the seed, as every rank draws them) against
    the same command in one process."""
    base = str(tmp_path)
    root = os.path.join(base, "zju")
    write_fake_dataset(root, n_frames=5, n_views=2, H=64, W=64)
    cfg_file = _yaml(base, root, 5)
    res = {}
    for name, world, extra in (("one", 1, []), ("three", 3, ["--distributed"])):
        argv = ["--cfg_file", cfg_file, "--type", "evaluate", "--device", "cpu",
                *extra, "result_dir", os.path.join(base, name),
                "trained_model_dir", os.path.join(base, name, "model")]
        res[name] = _launch(os.path.join(base, f"run_{name}"), "cli", world,
                            {"module": "run", "argv": argv}, backend=None)
    files = {n: glob.glob(os.path.join(base, n, "**", "metrics.npy"), recursive=True)
             for n in res}
    assert len(files["one"]) == len(files["three"]) == 1
    a = np.load(files["one"][0], allow_pickle=True).item()
    b = np.load(files["three"][0], allow_pickle=True).item()
    assert len(a["psnr"]) == 5
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # each rank wrote its own items' PNGs; only rank 0 the metrics
    three = res["three"]
    assert any(p.endswith("metrics.npy") for p in three[0]["writes"])
    for r in three[1:]:
        assert _not_rank0s(r["writes"], os.path.join(base, "three")) == []
        assert len([p for p in r["writes"] if p.endswith("_gt.png")]) in (1, 2)


# -- the loop, recorder and checkpoint ---------------------------------------------

def test_distributed_training_run_writes_on_rank0_and_resumes(subject, tmp_path):
    """``train_net --distributed --device cpu``: 2 Gloo ranks train 1 epoch
    of 2 steps, then resume for a second.  Only rank 0 writes (config,
    records, checkpoints); both ranks load its checkpoint after the
    barrier and hold bit-equal parameters after loading and after
    training."""
    base = str(tmp_path)
    cfg_file = _yaml(base, subject, 2)
    exp = os.path.join(base, "exp")
    argv = ["--cfg_file", cfg_file, "--device", "cpu", "--distributed",
            "ep_iter", "2", "save_latest_ep", "1", "eval_ep", "100",
            "result_dir", exp, "trained_model_dir", os.path.join(exp, "model"),
            "record_dir", os.path.join(exp, "record")]
    first = _launch(os.path.join(base, "run1"), "cli", 2, {
        "module": "train_net", "argv": argv[:4] + ["--no_resume"] + argv[4:]
        + ["train.epoch", "1"]}, backend=None)
    second = _launch(os.path.join(base, "run2"), "cli", 2, {
        "module": "train_net", "argv": argv + ["train.epoch", "2"]}, backend=None)
    for run_, epochs in ((first, [0]), (second, [1])):
        for r in run_:
            assert r["world"] == 2 and r["backend"] == "gloo" and r["epochs"] == epochs
            assert r["equal_after_train"] and np.isfinite(r["losses"]).all()
            assert r["losses"] == run_[0]["losses"]
        assert "state.pt" in [os.path.basename(p) for p in run_[0]["writes"]]
        assert _not_rank0s(run_[1]["writes"], exp) == []
    assert all(r["equal_after_load"] for r in second)
    assert second[0]["step"] == 4
    assert glob.glob(os.path.join(exp, "**", "model", "0", "state.pt"), recursive=True)


# -- no fallback ------------------------------------------------------------------

def test_distributed_never_falls_back(monkeypatch):
    """``--distributed`` on cuda without a card raises (this machine has
    none), as does the standalone check, which runs on cuda unless asked
    for the CPU; without NCCL it raises, and ``run`` refuses types it
    cannot shard."""
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="not available"):
        train_net.main(["--distributed", "--device", "cuda", "--steps", "1"])
    with pytest.raises(RuntimeError, match="not available"):
        run.main(["--distributed", "--type", "evaluate", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="not available"):
        mc.main([])                        # the standalone check: cuda by default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        pmesh.init_distributed("cuda")
    with pytest.raises(SystemExit, match="--distributed"):
        run.main(["--distributed", "--type", "bullet", "--device", "cpu"])
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        pmesh.init_distributed("cpu")
    assert not torch.distributed.is_initialized()


def test_the_standalone_check(tmp_path):
    """``python -m instant_nvr_tpu_torch.tools.multiprocess_check``'s own
    assertions: 2 ranks against one process, the merge, the broadcast."""
    line = mc.check(2, "cpu", str(tmp_path))
    assert line.startswith("OK 2-rank") and "metrics=5/5" in line
