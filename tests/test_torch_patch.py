"""Patch mode against the JAX package's, on the CPU: the VGG perceptual
loss and LPIPS distance, SSIM, the four patch losses, the patch-mode train
step and the remat step.

Tolerances: ``perceptual_loss`` and ``lpips_distance`` rtol 1e-5 (float32
convolutions summed in another order); ``ssim_loss`` rtol 1e-5;
``ssim_skimage`` (a numpy copy) exactly; each patch loss rtol 1e-5 and its
gradient with respect to the rendered colours rtol 1e-4 / atol 1e-6 of
the largest entry.  The patch-mode step runs in float32 (``mlp_dtype`` and
``grid_compute_dtype``) on a 8x8 patch of a fake subject, from JAX's
weights and draws: loss and stats rtol 1e-5, every gradient rtol 1e-4 /
atol 1e-6 of the leaf's largest entry, as ``tests/test_torch_train.py``'s
float32 mode; the Fourier loss's gradients atol 1e-5 of it (the phase
term's gradient scales with 1 / |F|^2 of each frequency, and the two FFTs
sum in other orders).  The remat step's gradients equal the eager step's bit for
bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nvr_tpu.config import make_cfg as jax_make_cfg
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.models import lpips as jlpips
from instant_nvr_tpu.ops import ssim as jssim
from instant_nvr_tpu.renderer import inb_renderer as jrend
from instant_nvr_tpu.train import loop as jloop
from instant_nvr_tpu.train import step as jstep
from instant_nvr_tpu_torch import bridge, train_net
from instant_nvr_tpu_torch.config import Config
from instant_nvr_tpu_torch.datasets.fake_zju import fake_cfg_overrides, write_fake_dataset
from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
from instant_nvr_tpu_torch.models import inb, lpips
from instant_nvr_tpu_torch.ops import ssim
from instant_nvr_tpu_torch.renderer import inb_renderer as rend
from instant_nvr_tpu_torch.train import loop
from instant_nvr_tpu_torch.train import state as tstate
from instant_nvr_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("lpips", "ssim", "fourier", "tv_image")


def _images(rng, side, n=2):
    return [rng.random((side, side, 3)).astype(np.float32) for _ in range(n)]


# -- VGG losses ------------------------------------------------------------------

def test_vgg_init_is_the_jax_packages(rng):
    for seed, plan, n in ((1234, lpips._VGG19_PLAN, 2), (4321, lpips._VGG16_PLAN, 5)):
        got, want = lpips.vgg_init(seed, plan, n), jlpips.vgg_init(seed, plan, n)
        assert len(got) == len(want) == n
        for gs, ws in zip(got, want):
            for g, w in zip(gs, ws):
                np.testing.assert_array_equal(g["w"], w["w"])
                np.testing.assert_array_equal(g["b"], w["b"])


@pytest.mark.parametrize("side", [32, 64])
def test_perceptual_loss_and_lpips_match_jax(rng, side):
    a, b = _images(rng, side)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(lpips.perceptual_loss(ta, tb)),
                               float(jlpips.perceptual_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(lpips.lpips_distance(ta, tb)),
                               float(jlpips.lpips_distance(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    assert float(lpips.lpips_distance(ta, ta)) == 0.0


def test_vgg_weights_from_npz_match_jax(rng, tmp_path):
    """An npz in the exporter's HWIO layout, with LPIPS' linear weights:
    both packages load it (the port transposes to OIHW)."""
    arrays = {}
    for s, (c_out, n) in enumerate(jlpips._VGG16_PLAN):
        c_in = 3 if s == 0 else jlpips._VGG16_PLAN[s - 1][0]
        for i in range(n):
            arrays[f"w_{s}_{i}"] = (0.1 * rng.standard_normal((3, 3, c_in, c_out))
                                    ).astype(np.float32)
            arrays[f"b_{s}_{i}"] = (0.01 * rng.standard_normal(c_out)).astype(np.float32)
            c_in = c_out
        arrays[f"lin_{s}"] = rng.random(c_out).astype(np.float32)
    path = str(tmp_path / "vgg16.npz")
    np.savez(path, **arrays)
    a, b = _images(rng, 32)
    got = lpips.lpips_distance(torch.from_numpy(a), torch.from_numpy(b), path)
    want = jlpips.lpips_distance(jnp.asarray(a), jnp.asarray(b), path)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_array_equal(lpips.vgg_load_npz(path, lpips._VGG16_PLAN, 5)[2][1]["w"],
                                  arrays["w_2_1"])


def test_ssim_matches_jax(rng):
    a, b = _images(rng, 40)
    np.testing.assert_allclose(float(ssim.ssim_loss(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jssim.ssim_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    assert ssim.ssim_skimage(a, b) == jssim.ssim_skimage(a, b)
    assert ssim.ssim_skimage(a[..., 0], b[..., 0], data_range=2.0) == \
        jssim.ssim_skimage(a[..., 0], b[..., 0], data_range=2.0)


@pytest.mark.parametrize("kind", KINDS)
def test_patch_losses_match_jax(rng, kind):
    """Each patch loss and its gradient with respect to the rendered
    colours, some rays masked out."""
    size = 16
    cfg = Config({"patch_size": size, f"use_{kind}": True})
    pred, gt = (rng.random((size * size, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.random(size * size) < 0.8).astype(np.float32)
    fn, jfn = loop.make_patch_loss_fn(cfg), jloop.make_patch_loss_fn(
        jax_make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(
            {"patch_size": size, "use_lpips": kind == "lpips", f"use_{kind}": True}))
    batch = {"ray_mask": torch.from_numpy(mask), "rgb": torch.from_numpy(gt)}
    jbatch = {"ray_mask": jnp.asarray(mask), "rgb": jnp.asarray(gt)}
    p = torch.from_numpy(pred).requires_grad_()
    got = fn({"rgb_map": p}, batch)
    got.backward()
    want, jgrad = jax.value_and_grad(lambda x: jfn({"rgb_map": x}, jbatch))(jnp.asarray(pred))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(p.grad.numpy(), jgrad, rtol=1e-4,
                               atol=1e-6 * np.abs(jgrad).max())


# -- the patch-mode step ---------------------------------------------------------

@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zju_patch"))
    write_fake_dataset(root, n_frames=2, n_views=2, H=96, W=96)
    return root


def _patch_case(root, kind):
    """(JAX cfg, port cfg, numpy batch): inb_377 at the tiny widths in
    float32, patch mode of ``kind`` on 8x8 patches of the subject."""
    over = dict(train_net.TINY, use_lpips=False, patch_size=8,
                mlp_dtype="float32", grid_compute_dtype="float32")
    over[f"use_{kind}"] = True
    cfg_j = jax_make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(
        fake_cfg_overrides(root, n_frames=2)).merged(over)
    cfg = Config(cfg_j.to_dict())
    item = TPoseDataset(cfg, "train").get_item(1, rng=np.random.default_rng(2))
    assert item["rgb"].shape == (64, 3) and item["ray_mask"].sum() > 0
    batch = {k: item[k] for k in loop.DEVICE_KEYS if k in item}
    batch["reg_dist_weight"] = np.float32(0.1)
    return cfg_j, cfg, batch


@pytest.mark.parametrize("kind", KINDS)
def test_patch_step_matches_jax(subject, kind):
    cfg_j, cfg, batch_np = _patch_case(subject, kind)
    mspec_j, rspec_j = jinb.build_model_spec(cfg_j), jrend.make_render_spec(cfg_j)
    lw_j = jstep.make_loss_weights(cfg_j)
    assert lw_j.use_patch and lw_j.patch_kind == kind
    params = jinb.init_params(jax.random.key(0), mspec_j)
    batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
    rng = jax.random.key(3)
    jfn = jloop.make_patch_loss_fn(cfg_j)

    def loss_fn(p):
        return jstep.compute_losses(mspec_j, rspec_j, lw_j, p, batch_j, rng, jfn, step=0)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    mspec, rspec = inb.build_model_spec(cfg), rend.make_render_spec(cfg)
    lw = tstep.make_loss_weights(cfg)
    model = inb.InbModel(mspec)
    model.load_state_dict(bridge.params_from_jax(jax.tree.map(np.asarray, params), mspec))
    state = tstate.create_train_state(cfg, model)
    step = tstep.make_train_step(mspec, rspec, lw, loop.make_patch_loss_fn(cfg))
    R, S = 64, rspec.n_samples
    k_strat, k_pair = jax.random.split(rng)
    B = rend.pair_budget(mspec, rspec, R * S)
    draws = {"t_rand": torch.from_numpy(np.array(
                 jax.random.uniform(k_strat, (R, S), jnp.float32))),
             "pair_noise": torch.from_numpy(np.array(
                 (jax.random.uniform(k_pair, (B, 3), jnp.float32) - 0.5)
                 * rspec_j.pair_range))}
    _, stats = step(state, {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()},
                    draws=draws)
    assert float(stats["patch_loss"]) > 0
    for k in ("loss", "patch_loss", "img_loss", "psnr", "pair_loss", "reg_dist",
              "offset_loss", "ray_error"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got = dict(_leaves(bridge.tree_from_model(model, "grad")))
    atol = 1e-5 if kind == "fourier" else 1e-6
    n = 0
    for k, want in _leaves(jax.tree.map(np.asarray, jgrads)):
        g = got[k]
        want = want[:g.shape[0]]                # JAX tables' zero tile padding
        np.testing.assert_allclose(g, want, rtol=1e-4,
                                   atol=atol * max(np.abs(want).max(), 1e-30), err_msg=k)
        n += 1
    assert n == len(got)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float32)


@pytest.mark.parametrize("mode", ["draws", "generator"])
def test_remat_step_equals_the_eager_step(subject, mode):
    """remat recomputes the render in the backward: the gradients equal the
    eager step's.  With a generator the draws are made before the
    checkpointed region, from the same stream the eager step draws with
    ``draw_render``, so the recompute replays them."""
    _, cfg, batch_np = _patch_case(subject, "lpips")
    mspec, rspec = inb.build_model_spec(cfg), rend.make_render_spec(cfg)
    lw = tstep.make_loss_weights(cfg)
    model0 = inb.init_params(mspec, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()}
    out = []
    for remat in (False, True):
        model = inb.InbModel(mspec)
        model.load_state_dict(model0.state_dict())
        state = tstate.create_train_state(cfg, model)
        step = tstep.make_train_step(mspec, rspec, lw._replace(remat=remat),
                                     loop.make_patch_loss_fn(cfg))
        gen = torch.Generator().manual_seed(11)
        if mode == "draws" or not remat:
            _, stats = step(state, batch, draws=tstep.draw_render(
                mspec, rspec, 64, gen, torch.device("cpu")))
        else:
            _, stats = step(state, batch, generator=gen)
        out.append((stats, dict(_leaves(bridge.tree_from_model(model, "grad")))))
    (s0, g0), (s1, g1) = out
    assert float(s0["loss"]) == float(s1["loss"])
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)
    assert any(g.any() for g in g0.values())
