"""The port's synthetic train step (``instant_nvr_tpu_torch/train_net.py``)
against the repo's ``bench.py`` and the JAX package, on the CPU, and the
rule that every entry point defaults to the card.

``train_net``'s tiny config (``--tiny``) and trainer, its full-width MSE
batch and its patch batch are held bit for bit to
``__graft_entry__._flagship`` and to the arrays the root ``bench.py``
builds.  One MSE step and one patch step at tiny widths (the patch step
with ``use_lpips`` merged in, as at inb_377's widths) run against JAX's
``make_train_step`` from the same weights (``bridge.params_from_jax``) and
the draws of the key ``bench.py`` gives step 0 (``draws=``), with
``tests/test_torch_train.py``'s tolerances: in float32 mode the loss rtol
1e-5 and the updated parameters rtol 1e-4 / atol 1e-6 of the leaf's largest
entry; in the flagship's bf16 mode (JAX's table gradients through its
kernels' reference) the loss rtol 1e-3 and the parameters within 2.1 x lr.
"""
import json
import os

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
from instant_nvr_tpu_torch import bridge, run, train_net
from instant_nvr_tpu_torch.renderer import inb_renderer as rend
from instant_nvr_tpu_torch.tools import (cuda_selfcheck, import_jax_ckpt, import_torch_ckpt,
                                         multiprocess_check, profile_eval)
from instant_nvr_tpu_torch.train import loop
from instant_nvr_tpu_torch.train.step import make_loss_weights, make_train_step
from test_torch_train import F32_MODE, _close_f32, _kernel_route_grads, _pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/inb/inb_377.yaml")
CPU = torch.device("cpu")


def _config(tiny):
    """``train_net``'s config of the flagship (``--tiny``: the CPU tests' widths)."""
    return train_net.load_config(train_net.parse_args(
        ["--cfg_file", CFG] + (["--tiny"] if tiny else [])))


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


# -- the config and its batches --------------------------------------------------------

def test_tiny_trainer_is_the_graft_entrys():
    cfg_j, mspec_j, rspec_j, lw_j, _, batch_np = _flagship(tiny=True)
    cfg = _config(tiny=True)
    t = train_net.build_trainer(cfg, CPU, tiny=True)
    for p in ("body", "leg", "head", "larm", "rarm"):
        assert (cfg.partnet[p].embedder.kwargs.to_dict()
                == cfg_j.partnet[p].embedder.kwargs.to_dict()), p
    assert (cfg.tpose_deformer.embedder.kwargs.to_dict()
            == cfg_j.tpose_deformer.embedder.kwargs.to_dict())
    for k in ("N_samples", "N_rand", "use_lpips", "patch_size"):
        assert cfg[k] == cfg_j[k], k
    assert _plain(cfg) == _plain(cfg_j)
    assert t.rspec.n_samples == rspec_j.n_samples == 8
    assert t.lw.use_patch == lw_j.use_patch is False
    assert len(t.mspec.part_embeds) == len(mspec_j.part_embeds)
    _assert_batches_equal(train_net.synthetic_batch_np(cfg, tiny=True), batch_np)
    _assert_batches_equal({k: v.numpy() for k, v in t.batch.items()}, batch_np)
    assert all(v.device == CPU for v in t.batch.values())


def test_full_width_mse_batch_is_bench_pys():
    """``_flagship(tiny=False)``'s batch: host arrays and specs only."""
    *_, batch_np = _flagship(tiny=False)
    cfg = _config(tiny=False)
    assert (cfg.N_rand == 1024 and rend.make_render_spec(cfg).n_samples == 64
            and make_loss_weights(cfg).use_patch)
    _assert_batches_equal(train_net.synthetic_batch_np(cfg), batch_np)


@pytest.mark.parametrize("tiny", [False, True])
def test_patch_batch_is_bench_pys(tiny):
    """bench.py:96-100's 4,096-ray patch, whatever the widths."""
    cfg = _config(tiny)
    n = cfg.patch_size ** 2
    assert n == 4096
    scene = jsynthetic.make_scene(n_verts=1200, grid=32)
    view = jsynthetic.render_gt(scene, H=128, W=128)
    want = jsynthetic.make_batch(scene, view, n_rays=n)
    want["ray_mask"] = np.ones(n, np.float32)
    _assert_batches_equal(train_net.patch_batch_np(cfg), want)


# -- one synthetic step against JAX's make_train_step ---------------------------------

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
def test_synthetic_step_matches_jax(mode, patch):
    """The tiny trainer in ``mode`` (the patch step with LPIPS) against
    JAX's config of it."""
    over = dict(F32_MODE if mode == "float32" else {}, **({"use_lpips": True} if patch else {}))
    cfg, cfg_j = _config(tiny=True).merged(over), _flagship(tiny=True)[0].merged(over)
    t = train_net.build_trainer(cfg, CPU, tiny=True)
    assert t.lw.use_patch == patch
    assert _plain(cfg) == _plain(cfg_j)
    batch_np = (train_net.patch_batch_np(cfg) if patch
                else train_net.synthetic_batch_np(cfg, tiny=True))
    rng = jax.random.key(0)                  # bench.py's rngs[0] for step 0
    if mode == "bfloat16":
        with _kernel_route_grads():
            params, jparams, jstats = _jax_step(cfg_j, batch_np, patch, rng)
    else:
        params, jparams, jstats = _jax_step(cfg_j, batch_np, patch, rng)

    state = t.state
    state.model.load_state_dict(bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                                       t.mspec))
    step = make_train_step(t.mspec, t.rspec, t.lw,
                           loop.make_patch_loss_fn(cfg) if patch else None)
    R, S = batch_np["ray_o"].shape[0], t.rspec.n_samples
    k_strat, k_pair = jax.random.split(rng)
    B = rend.pair_budget(t.mspec, t.rspec, R * S)
    noise = (jax.random.uniform(k_pair, (B, 3), jnp.float32) - 0.5) * t.rspec.pair_range
    draws = {"t_rand": torch.from_numpy(np.array(
                 jax.random.uniform(k_strat, (R, S), jnp.float32))),
             "pair_noise": torch.from_numpy(np.array(noise))}
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    _, stats = step(state, batch, draws=draws)
    assert state.step == 1
    if patch:
        assert float(stats["patch_loss"]) > 0 and "patch_loss" in jstats
    lr = cfg.train.lr
    for k, got, want in _pairs(jax.tree.map(np.asarray, jparams),
                               bridge.tree_from_model(state.model, "data")):
        if mode == "float32":
            _close_f32(got, want, what=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2.1 * lr, err_msg=k)
    rtol = 1e-5 if mode == "float32" else 1e-3
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=rtol)


# -- every entry point defaults to the card ---------------------------------------------

# each entry point whose --device defaults to cuda, with the fewest arguments
# that reach run.resolve_device (the paths are never read)
ENTRY_POINTS = {
    "train_net": (train_net.main, ["--cfg_file", CFG]),
    "run": (run.main, ["--cfg_file", CFG]),
    "profile_eval": (profile_eval.main, ["--cfg_file", CFG]),
    "cuda_selfcheck": (cuda_selfcheck.main, []),
    "import_jax_ckpt": (import_jax_ckpt.main,
                        ["--cfg_file", CFG, "--src", "absent", "--out", "absent"]),
    "import_torch_ckpt": (import_torch_ckpt.main,
                          ["--cfg_file", CFG, "--ckpt", "absent", "--out", "absent"]),
    "multiprocess_check": (multiprocess_check.main, []),
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run there")
    main, argv = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
