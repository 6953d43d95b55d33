"""The port's model, renderer and chunked eval renderer against the JAX
package, on the CPU, on weights carried across by ``bridge.params_from_jax``.

Fixtures: the tiny flagship of ``__graft_entry__._flagship(tiny=True)``
(inb_377 with narrow hash grids, 8 samples per ray) and the full inb_377
widths on 16 rays.  Tolerances:
  * float32 mode (``mlp_dtype``/``grid_compute_dtype: float32``): rtol 1e-4,
    atol 1e-5 — the same float32 ops, with sums (matmuls, corner lerps,
    compositing) taken in other orders;
  * bf16 mode (the flagship's): atol 1e-3 — both sides round the same
    operands to bf16 (measured: the outputs agree to ~1e-7), but a last-ulp
    float32 difference in a hidden activation can flip its bf16 rounding
    (2^-8 relative) before the next layer; the bound leaves room for that.
  * telemetry (counts of selected and dropped samples): equal, in both
    modes (it depends on f32 geometry only).
Selections are compared through their outputs, never by index order (top-k
ties, see instant_nvr_tpu_torch/ops/select.py).
"""
import functools
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
from instant_nvr_tpu.eval import runner as jrunner
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.renderer import inb_renderer as jrend
from instant_nvr_tpu_torch import bridge, run
from instant_nvr_tpu_torch.config import Config, make_cfg
from instant_nvr_tpu_torch.datasets import synthetic
from instant_nvr_tpu_torch.eval import runner
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.renderer import inb_renderer as rend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=0.0, atol=1e-3)}
TELEMETRY = ("cull_overflow", "part_overflow", "cull_need", "part_need")
F32_MODE = {"mlp_dtype": "float32", "grid_compute_dtype": "float32"}

# jit the JAX references: one compile per spec instead of one per primitive
jax_forward = jax.jit(jinb.forward, static_argnums=(0, 5))
jax_render_rays = jax.jit(jrend.render_rays, static_argnums=(0, 1, 4))


class Case:
    """One model on both sides: JAX spec + params, port spec + model."""

    def __init__(self, cfg_j, batch_np, seed=0):
        self.cfg_j = cfg_j
        self.mspec_j = jinb.build_model_spec(cfg_j)
        self.mspec = inb.build_model_spec(Config(cfg_j.to_dict()))
        self.params_j = jinb.init_params(jax.random.key(seed), self.mspec_j)
        self.model = inb.InbModel(self.mspec)
        self.model.load_state_dict(bridge.params_from_jax(
            jax.tree.map(np.asarray, self.params_j), self.mspec))
        self.batch_np = batch_np
        self.batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
        self.batch = {k: torch.as_tensor(np.asarray(v))
                      for k, v in batch_np.items()}


@functools.cache
def tiny(mode: str) -> Case:
    cfg_j, *_, batch_np = _flagship(tiny=True)
    if mode == "float32":
        cfg_j = cfg_j.merged(F32_MODE)
    return Case(cfg_j, batch_np)


@functools.cache
def full_width() -> Case:
    from instant_nvr_tpu.config import make_cfg as jax_make_cfg
    cfg_j = jax_make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml"))
    scene = jsynthetic.make_scene(n_verts=1200, grid=32)
    view = jsynthetic.render_gt(scene, H=64, W=64)
    # half the rays on the subject, half anywhere in its box
    batch_np = jsynthetic.make_batch(scene, view, n_rays=16)
    return Case(cfg_j, batch_np)


def _samples(batch_np, S):
    t = np.linspace(0.0, 1.0, S, dtype=np.float32)
    z = batch_np["near"][:, None] * (1 - t) + batch_np["far"][:, None] * t
    wpts = batch_np["ray_o"][:, None] + batch_np["ray_d"][:, None] * z[..., None]
    vd = np.repeat(batch_np["ray_d"], S, axis=0)
    return wpts.reshape(-1, 3).astype(np.float32), vd.astype(np.float32)


def _check_telemetry(got, ref):
    for k in TELEMETRY:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0, err_msg=k)


# -- model forward ------------------------------------------------------------

@pytest.mark.parametrize("mode,aggr", [("float32", ""), ("bfloat16", ""),
                                       ("float32", "mean"), ("float32", "dist")])
def test_forward_matches_jax(mode, aggr):
    """aggr: '' (the configs' max-occupancy winner) and the two alternative
    part aggregations of the JAX model."""
    c = tiny(mode)
    wpts, vd = _samples(c.batch_np, 8)
    ref = jax_forward(c.mspec_j._replace(aggr=aggr), c.params_j,
                      jnp.array(wpts), jnp.array(vd), c.batch_j, False)
    with torch.no_grad():
        got = inb.forward(c.mspec._replace(aggr=aggr), c.model,
                          torch.from_numpy(wpts), torch.from_numpy(vd), c.batch)
    assert got["raw"].shape == (wpts.shape[0], 4)
    # the tiny fixture must exercise the model: culled and part-selected
    # samples with non-trivial output
    assert float(ref["cull_need"]) > 0 and np.abs(np.asarray(ref["raw"])).max() > 0.01
    for k in ("raw", "occ"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   **TOL[mode], err_msg=k)
    _check_telemetry(got, ref)


def _render_both(c, S):
    ref = jax_render_rays(c.mspec_j, jrend.RenderSpec(n_samples=S, perturb=False),
                          c.params_j, c.batch_j, False, jax.random.key(0))
    with torch.no_grad():
        got = rend.render_rays(c.mspec, rend.RenderSpec(n_samples=S), c.model,
                               c.batch, train=False)
    return got, ref


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_render_rays_matches_jax(mode):
    c = tiny(mode)
    got, ref = _render_both(c, c.cfg_j.N_samples)
    for k in ("rgb_map", "acc_map", "weights", "occ"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   **TOL[mode], err_msg=k)
    _check_telemetry(got, ref)


def test_render_rays_full_width_matches_jax():
    """inb_377 at its published widths (16 levels, 2^20-row tables, bf16),
    16 rays x 64 samples; the bridge strips the JAX tables' tile padding."""
    c = full_width()
    assert c.params_j["embed"]["body"]["hash"].shape[0] > c.mspec.part_embeds[0].hash_rows
    got, ref = _render_both(c, 64)
    assert np.asarray(ref["acc_map"]).max() > 0.01
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   **TOL["bfloat16"], err_msg=k)
    _check_telemetry(got, ref)


def test_render_rays_train_not_ported():
    """render_rays(train=True) is ported now (held against JAX in
    tests/test_torch_train.py), and so are patch mode and remat
    (tests/test_torch_patch.py): the remat losses equal the eager ones on
    the same draws."""
    from instant_nvr_tpu_torch.train import step as tstep
    c = tiny("float32")
    rspec = rend.RenderSpec(n_samples=8)
    with torch.no_grad():
        out = rend.render_rays(c.mspec, rspec, c.model, c.batch, train=True,
                               generator=torch.Generator().manual_seed(0))
    assert {"resd", "pair_resd0", "pair_resd1", "pair_valid",
            "reg_distortion"} <= set(out)
    draws = tstep.draw_render(c.mspec, rspec, c.batch["ray_o"].shape[0],
                              torch.Generator().manual_seed(0), torch.device("cpu"))
    lw = tstep.LossWeights()
    with torch.no_grad():
        eager, _ = tstep.compute_losses(c.mspec, rspec, lw, c.model, c.batch,
                                        draws=draws)
        remat, _ = tstep.compute_losses(c.mspec, rspec, lw._replace(remat=True),
                                        c.model, c.batch, draws=draws)
    assert torch.isfinite(eager) and torch.equal(eager, remat)


# -- chunked eval renderer ------------------------------------------------------

def _item(n_rays):
    scene = jsynthetic.make_scene(n_verts=600, grid=16)
    view = jsynthetic.render_gt(scene, H=32, W=32)
    return jsynthetic.make_batch(scene, view, n_rays=n_rays, split="test")


@pytest.mark.parametrize("n_rays", [100, 256])
def test_chunked_renderer_matches_jax(n_rays):
    c = tiny("float32")
    item = _item(n_rays)
    jfn = jrunner.make_chunked_renderer(c.mspec_j, jrend.RenderSpec(n_samples=8),
                                        chunk=64)
    ref = jrunner.render_full_image(jfn, c.params_j, item, jrunner.META_KEYS, 64)
    fn = runner.make_chunked_renderer(c.mspec, rend.RenderSpec(n_samples=8),
                                      chunk=64)
    got = runner.render_full_image(fn, c.model, item, runner.META_KEYS, 64)
    assert got["rgb_map"].shape == (n_rays, 3)
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(got[k], ref[k], **TOL["float32"], err_msg=k)
    _check_telemetry(got, ref)


def test_auto_budget_renderer_raises_like_jax():
    """Starved budgets: both raise to the same budgets, render the same
    image, and end with zero overflow (tests/test_eval_overflow.py)."""
    c = tiny("float32")
    item = _item(256)
    starve = dict(cull_frac=0.02, part_frac=0.05,
                  part_budget_scales=(1.0, 0.1, 0.1, 0.1, 0.1))
    jr = jrunner.AutoBudgetRenderer(c.mspec_j._replace(**starve),
                                    jrend.RenderSpec(n_samples=8), chunk=64)
    ref = jr(c.params_j, item)
    r = runner.AutoBudgetRenderer(c.mspec._replace(**starve),
                                  rend.RenderSpec(n_samples=8), chunk=64)
    got = r(c.model, item)
    assert got["cull_overflow"] <= 0 and got["part_overflow"] <= 0
    assert r.mspec.cull_frac > starve["cull_frac"]
    np.testing.assert_allclose(r.mspec.cull_frac, jr.mspec.cull_frac, rtol=1e-6)
    np.testing.assert_allclose(r.mspec.part_frac, jr.mspec.part_frac, rtol=1e-6)
    np.testing.assert_allclose(r.mspec.part_budget_scales,
                               jr.mspec.part_budget_scales, rtol=1e-6)
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(got[k], ref[k], **TOL["float32"], err_msg=k)
    # every render, re-renders included, is 4 chunks of 64 rays
    assert r.chunks_rendered % 4 == 0 and r.chunks_rendered >= 8

    # a second image renders overflow-free on the first try
    before = r.mspec
    r(c.model, item)
    assert r.mspec is before

    # and equals the render through generous budgets
    generous = runner.AutoBudgetRenderer(
        c.mspec._replace(cull_frac=1.0, part_frac=1.0,
                         part_budget_scales=(1.0,) * 5),
        rend.RenderSpec(n_samples=8), chunk=64)(c.model, item)
    np.testing.assert_allclose(got["rgb_map"], generous["rgb_map"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cull_need,part_need", [
    (0.4, (0.5, 0.1, 0.01, 0.01, 0.01)),
    (0.01, (0.01,) * 5),
    (1.0, (1.0,) * 5),
])
def test_raise_and_merge_budgets_match_jax(cull_need, part_need):
    c = tiny("float32")
    base = dict(cull_frac=0.1, part_frac=0.2,
                part_budget_scales=(1.0, 0.5, 0.5, 0.25, 0.25))
    got = runner.raise_budgets(c.mspec._replace(**base), cull_need, part_need)
    ref = jrunner.raise_budgets(c.mspec_j._replace(**base), cull_need, part_need)
    assert (got.cull_frac, got.part_frac, got.part_budget_scales) == \
        (ref.cull_frac, ref.part_frac, ref.part_budget_scales)
    m = runner.merge_budgets(c.mspec._replace(**base), cull_need, 0.7,
                             part_need)
    jm = jrunner.merge_budgets(c.mspec_j._replace(**base), cull_need, 0.7,
                               part_need)
    assert (m.cull_frac, m.part_frac, m.part_budget_scales) == \
        (jm.cull_frac, jm.part_frac, jm.part_budget_scales)


def test_eval_chunk_and_meta_keys():
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml"))
    assert runner.eval_chunk(cfg) == 4096
    assert runner.eval_chunk(cfg.merged({"eval_render_chunk": 16384})) == 16384
    assert runner.META_KEYS == jrunner.META_KEYS


# -- parameters ---------------------------------------------------------------

def test_model_spec_matches_jax():
    c = tiny("bfloat16")
    for f in inb.ModelSpec._fields:
        if f in ("part_embeds", "deformer"):
            continue
        assert getattr(c.mspec, f) == getattr(c.mspec_j, f), f
    assert c.mspec.rgb_groups() == c.mspec_j.rgb_groups()
    assert c.mspec.embed_dim == c.mspec_j.embed_dim


def test_init_params_names_shapes_and_distributions():
    c = tiny("bfloat16")
    model = inb.init_params(c.mspec, torch.Generator().manual_seed(0), "cpu")
    ref = bridge.params_from_jax(jax.tree.map(np.asarray, c.params_j), c.mspec)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k in sd:
        assert sd[k].shape == ref[k].shape, k
    assert (model.occ[-1].b[:, 0] == -3.0).all()
    for layer in [*model.occ, *model.deformer.mlp]:
        bound = 1.0 / np.sqrt(layer.w.shape[-2])
        assert layer.w.abs().max() <= bound and layer.b[..., 1:].abs().max() <= bound
    lat = model.latent.detach()
    want = np.sqrt(2.0 / (lat.shape[1] * lat.shape[2]))
    assert abs(float(lat.std()) / want - 1) < 0.2


def test_bridge_refuses_packed_and_nonzero_padding():
    c = tiny("float32")
    tree = jax.tree.map(np.array, c.params_j)
    d = tree["deformer"]["embed"]
    F = d["hash"].shape[1]
    d["hash"] = np.concatenate([d["hash"], np.zeros((64, F), np.float32)])
    bridge.params_from_jax(tree, c.mspec)          # zero padding: accepted
    d["hash"][-1] = 1.0
    with pytest.raises(ValueError, match="not zero"):
        bridge.params_from_jax(tree, c.mspec)
    # a packed table (flat.reshape(-1, 128), hashgrid.py:391-392) reads
    # back (tests/test_torch_packed.py); a width that is no packing of
    # F = 4 features, nor F itself, is refused naming the leaf
    d["hash"] = np.zeros((d["hash"].shape[0] * F // 128, 128), np.float32)
    bridge.params_from_jax(tree, c.mspec)
    d["hash"] = np.zeros((d["hash"].shape[0] * 2, 64), np.float32)
    with pytest.raises(ValueError, match="deformer.embed.hash.*packed"):
        bridge.params_from_jax(tree, c.mspec)


def test_synthetic_copy_matches_jax():
    a = synthetic.make_scene(n_verts=300, grid=8)
    b = jsynthetic.make_scene(n_verts=300, grid=8)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- entry point and imports ----------------------------------------------------

def test_run_network_and_render_on_cpu(capsys):
    run.main(["--type", "network", "--device", "cpu", "N_rand", "32",
              "N_samples", "8"])
    run.main(["--type", "render", "--device", "cpu", "--frames", "1",
              "eval_ratio", "0.0078125", "N_samples", "8"])
    out = capsys.readouterr().out
    assert "forward:" in out and "render: 64 rays/frame" in out


def test_run_rejects_unknown_type_and_missing_card(monkeypatch):
    """An unknown --type exits listing every type (the JAX dispatch's and
    ``render``); every type, on a machine without a card, raises."""
    with pytest.raises(SystemExit, match="unknown --type mesh") as e:
        run.main(["--type", "mesh"])
    for t in list(run.DISPATCH) + ["render"]:
        assert repr(t) in str(e.value)
    assert set(run.DISPATCH) == {"evaluate", "dataset", "network", "vis", "bullet",
                                 "prune", "exportdecoder", "exportpart", "tmesh",
                                 "tdmesh"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run.resolve_device("cuda")
    for t in list(run.DISPATCH) + ["render"]:
        with pytest.raises(RuntimeError, match="torch.cuda is not available"):
            run.main(["--type", t, "--cfg_file",
                      os.path.join(ROOT, "configs/inb/inb_fake.yaml")])


def test_port_never_imports_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import instant_nvr_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'instant_nvr_tpu.')) or m == 'instant_nvr_tpu')\n"
            "assert not bad, bad\n"
            "print('ok', len([m for m in sys.modules "
            "if m.startswith('instant_nvr_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok ")
