"""The port's train step against the JAX package's, on the CPU.

Both sides start from the same weights (JAX's init, carried over by
``bridge.params_from_jax``) and the same random draws (the jitter and the
pair noise that JAX's ``render_rays`` draws from its key are passed to the
port as ``draws=``).  The port's table gradients go through the plain
versions of its scatter kernels (f32 sums, bf16 result) where the card
would launch the kernels.  Tolerances:

  * float32 mode (``mlp_dtype`` and ``grid_compute_dtype`` float32, so
    ``exact_grads``): loss and stats rtol 1e-5; per-leaf gradients and
    post-Adam parameters rtol 1e-4 / atol 1e-6 of the leaf's largest entry
    (float32 sums in other orders; measured agreement is ~1e-6 relative).
  * bf16 mode (the flagship's): loss rtol 1e-3.  Gradients: relative L2
    error per leaf <= 2e-2 and max error <= 5e-2 of the leaf's largest
    entry: a last-ulp f32 difference before a bf16 operand can flip its
    rounding (2^-8).  Post-Adam parameters: within 2.1 x lr x steps of each
    other.  Adam's first update is lr x g / (|g| + eps), so an entry whose
    gradient is ~0 on one side and a bf16 rounding residue on the other
    moves by up to lr, either way; later updates are bounded alike.
  * bf16 table gradients: the JAX package's accelerator path sums them in
    f32 and rounds once (its Pallas kernels, whose XLA reference is
    ``segmented_scatter_add_ref``); on the CPU it scatters in bf16 instead
    (ROADMAP C1).  The bf16 steps here take JAX's kernel-routed backward
    through that reference (:func:`_kernel_route_grads`), so both sides sum
    alike, as the port's plain versions and kernels do.
  * full inb_377 widths (one step): the finest hash levels have ~2,000
    cells per unit, so a point's trilinear weights carry ~2,000x its
    position's rounding error.  Table gradients: float32 mode within 1e-3
    of the leaf's largest entry (max and relative L2); bf16 tables within
    2e-2 of it plus 2^-7 of the largest record the port scattered into the
    table (two records of opposite sign that cancel in a row leave one bf16
    ulp of the records as residue).  Other leaves as above.  Post-Adam
    parameters rtol 1e-4 / atol 1e-5 x lr: the update lr x g / (|g| + eps)
    carries eps / |g| times g's relative error, which reaches 1e-5 where
    |g| ~ 1e-10; an entry whose gradient is within its table's bound of
    zero may differ by 2.1 x lr.  The bf16-table case runs its MLPs in
    float32: a bf16 MLP's last-bit difference flips the rounding of a
    point's deformation (~4e-4), which moves its corners to other rows at
    ~2,000 cells per unit; the tiny flagship covers bf16 MLPs.
  * hash-grid gradients alone: f32 rtol 1e-5 / atol 1e-7 of the largest
    entry; bf16 tables as the bf16 gradients above.
"""
import contextlib
import functools
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship
from instant_nvr_tpu.config import make_cfg as jax_make_cfg
from instant_nvr_tpu.datasets import synthetic as jsynthetic
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.ops import hashgrid as jhg
from instant_nvr_tpu.ops import ray as jray
from instant_nvr_tpu.ops.pallas.segmented_scatter import segmented_scatter_add_ref
from instant_nvr_tpu.ops import rendering as jrendering
from instant_nvr_tpu.renderer import inb_renderer as jrend
from instant_nvr_tpu.train import state as jstate
from instant_nvr_tpu.train import step as jstep
from instant_nvr_tpu_torch import bridge, train_net
from instant_nvr_tpu_torch.config import Config, make_cfg
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.ops import hashgrid as hg
from instant_nvr_tpu_torch.ops import ray, rendering, scatter
from instant_nvr_tpu_torch.renderer import inb_renderer as rend
from instant_nvr_tpu_torch.train import state as tstate
from instant_nvr_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_MODE = {"mlp_dtype": "float32", "grid_compute_dtype": "float32"}
MODES = {"float32": F32_MODE, "bfloat16": {},
         "bf16-tables": {"mlp_dtype": "float32"}}
PRIMES = (1, 19349663, 83492791)


# -- helpers --------------------------------------------------------------------

def _leaves(tree, prefix=""):
    """(path, array) of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float32)


def _pairs(jax_tree, port_tree):
    """Matching leaves; JAX tables lose their (zero) tile padding."""
    j = dict(_leaves(jax_tree))
    p = dict(_leaves(port_tree))
    assert j.keys() == p.keys()
    for k in j:
        a, b = p[k], j[k]
        if a.shape != b.shape:
            assert a.ndim == b.ndim and a.shape[1:] == b.shape[1:], k
            assert not b[a.shape[0]:].any(), k
            b = b[:a.shape[0]]
        yield k, a, b


def _close_f32(got, want, rtol=1e-4, atol_rel=1e-6, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale,
                               err_msg=what)


def _close_rel(got, want, tol, what=""):
    """max and relative L2 error within ``tol`` of the leaf's largest entry
    and norm."""
    err = got.astype(np.float64) - want
    assert np.abs(err).max() <= tol * np.abs(want).max(), (what, np.abs(err).max())
    assert np.linalg.norm(err) <= tol * np.linalg.norm(want), what


def _table_windows(mspec):
    """Leaf path -> level row offsets of every hash-grid table."""
    out = {f"/deformer/embed/{t}": o for t, _, o in mspec.deformer.embed.tables()}
    for name, spec in zip(mspec.partnames, mspec.part_embeds):
        out.update({f"/embed/{name}/{t}": o for t, _, o in spec.tables()})
    return out


def _close_bf16(got, want, what=""):
    scale = float(np.abs(want).max())
    if scale == 0:
        assert not got.any(), what
        return
    err = got.astype(np.float64) - want
    rel_l2 = np.linalg.norm(err) / max(np.linalg.norm(want), 1e-30)
    assert rel_l2 <= 2e-2, (what, rel_l2)
    assert np.abs(err).max() <= 5e-2 * scale, (what, np.abs(err).max() / scale)


class Case:
    """One model on both sides: JAX spec + params, port spec + model."""

    def __init__(self, cfg_j, batch_np, seed=0, occ_bias=None):
        self.cfg_j = cfg_j
        self.cfg = Config(cfg_j.to_dict())
        self.mspec_j = jinb.build_model_spec(cfg_j)
        self.rspec_j = jrend.make_render_spec(cfg_j)
        self.lw_j = jstep.make_loss_weights(cfg_j)
        self.mspec = inb.build_model_spec(self.cfg)
        self.rspec = rend.make_render_spec(self.cfg)
        self.lw = tstep.make_loss_weights(self.cfg)
        self.params_j = jinb.init_params(jax.random.key(seed), self.mspec_j)
        if occ_bias is not None:
            b = self.params_j["occ"][-1]["b"]
            self.params_j["occ"][-1]["b"] = b.at[:, 0].set(occ_bias)
        self.batch_np = batch_np
        self.batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
        self.batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()}

    def model(self):
        m = inb.InbModel(self.mspec)
        m.load_state_dict(bridge.params_from_jax(
            jax.tree.map(np.asarray, self.params_j), self.mspec))
        return m

    def draws(self, rng):
        """JAX render_rays' draws for key ``rng``, for the port's draws=."""
        R, S = self.batch_np["ray_o"].shape[0], self.rspec.n_samples
        k_strat, k_pair = jax.random.split(rng)
        B = rend.pair_budget(self.mspec, self.rspec, R * S)
        noise = (jax.random.uniform(k_pair, (B, 3), jnp.float32) - 0.5) \
            * self.rspec_j.pair_range
        return {"t_rand": torch.from_numpy(np.array(
                    jax.random.uniform(k_strat, (R, S), jnp.float32))),
                "pair_noise": torch.from_numpy(np.array(noise))}


@functools.cache
def tiny(mode: str, occ_bias=None) -> Case:
    cfg_j, *_, batch_np = _flagship(tiny=True)
    return Case(cfg_j.merged(MODES[mode]), batch_np, occ_bias=occ_bias)


@functools.cache
def full_width(mode: str = "bfloat16") -> Case:
    cfg_j = jax_make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml"))
    cfg_j = cfg_j.merged(MODES[mode])
    scene = jsynthetic.make_scene(n_verts=1200, grid=32)
    view = jsynthetic.render_gt(scene, H=64, W=64)
    return Case(cfg_j, jsynthetic.make_batch(scene, view, n_rays=16))


@contextlib.contextmanager
def _kernel_route_grads():
    """JAX's scalar-table gathers with the backward its accelerator path
    gives kernel-routed tables (bf16 tables, and f32 tables that allow a
    rounded gradient): f32 sums rounded to bf16 once, through the Pallas
    kernels' XLA reference.  Restored on exit; only jits traced inside see
    it."""
    fwd, bwd = jhg._scalar_gather_fwd, jhg._scalar_gather_bwd

    def kernel_bwd(n_levels, level_offsets, allow_rounded, wide, res, g):
        table, idx = res
        if table.dtype != jnp.bfloat16 and not allow_rounded:
            return bwd(n_levels, level_offsets, allow_rounded, wide, res, g)
        grad = segmented_scatter_add_ref(idx, g.astype(jnp.bfloat16)[:, None],
                                         table.shape[0])[:, 0]
        return grad.astype(table.dtype), None

    jhg.scalar_table_gather.defvjp(fwd, kernel_bwd)
    try:
        yield
    finally:
        jhg.scalar_table_gather.defvjp(fwd, bwd)


def _jax_ref_step(c: Case):
    """JAX's make_train_step body, also returning the gradients (the
    forward casts the part tables itself: the bf16 shadow gives the same
    numbers)."""
    opt, _ = jstate.make_optimizer(c.cfg_j)

    def step(params, opt_state, batch, rng, i):
        def loss_fn(p):
            return jstep.compute_losses(c.mspec_j, c.rspec_j, c.lw_j, p, batch,
                                        rng, None, step=i)
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, stats, grads

    return opt, jax.jit(step)


STAT_KEYS = ("img_loss", "psnr", "pair_loss", "reg_dist", "offset_loss",
             "loss", "cull_overflow", "part_overflow", "ray_error")


def _run_steps(c: Case, n_steps: int, mode: str, full_width: bool = False):
    """n_steps on both sides; checks every step; returns the port's stats.
    ``full_width``: the tolerances of the module doc for inb_377."""
    if mode == "float32":
        return _run_steps_checked(c, n_steps, mode, full_width, {})
    peaks = {}
    with _kernel_route_grads(), _record_peaks(peaks):
        return _run_steps_checked(c, n_steps, mode, full_width, peaks)


@contextlib.contextmanager
def _record_peaks(peaks):
    """Largest |record| each table gradient of the port's plain scatters
    adds, by table rows, into ``peaks``."""
    plain = scatter._scatter_plain

    def spy(keys, payload, n_rows):
        peak = float(payload.float().abs().max()) if len(payload) else 0.0
        peaks[n_rows] = max(peaks.get(n_rows, 0.0), peak)
        return plain(keys, payload, n_rows)

    scatter._scatter_plain = spy
    try:
        yield
    finally:
        scatter._scatter_plain = plain


def _run_steps_checked(c: Case, n_steps: int, mode: str, full_width: bool,
                       peaks: dict):
    opt, jstep_fn = _jax_ref_step(c)
    params, opt_state = c.params_j, opt.init(c.params_j)
    model = c.model()
    state = tstate.create_train_state(c.cfg, model)
    step_fn = tstep.make_train_step(c.mspec, c.rspec, c.lw)
    lr = c.cfg.train.lr
    windows = _table_windows(c.mspec) if full_width else {}
    out = []
    for i in range(n_steps):
        rng = jax.random.key(i)
        params, opt_state, jstats, jgrads = jstep_fn(params, opt_state,
                                                     c.batch_j, rng, i)
        peaks.clear()
        _, stats = step_fn(state, c.batch, draws=c.draws(rng))
        assert state.step == i + 1
        keys = STAT_KEYS + tuple(k for k in ("free_loss", "occ_loss") if k in jstats)
        assert set(keys) <= set(stats), set(keys) - set(stats)
        for k in keys:
            got, want = stats[k].numpy(), np.asarray(jstats[k])
            if mode != "bfloat16":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {i} {k}")
            elif k in ("cull_overflow", "part_overflow"):
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6,
                                           err_msg=f"step {i} {k}")
        grads, gtol = {}, {}
        for k, got, want in _pairs(jax.tree.map(np.asarray, jgrads),
                                   bridge.tree_from_model(model, "grad")):
            grads[k] = want
            what = f"step {i} grad {k}"
            if k in windows and mode == "float32":
                _close_rel(got, want, 1e-3, what)
                gtol[k] = 1e-3 * np.abs(want).max()
            elif k in windows:
                # records of opposite sign that cancel in a row leave up to
                # one bf16 ulp of the records (2^-7 relative) of residue
                gtol[k] = 2e-2 * np.abs(want).max() + 2.0 ** -7 * peaks[len(got)]
                err = np.abs(got.astype(np.float64) - want).max()
                assert err <= gtol[k], (what, err, gtol[k])
            elif mode == "float32":
                _close_f32(got, want, what=what)
            else:
                _close_bf16(got, want, what=what)
        for k, got, want in _pairs(jax.tree.map(np.asarray, params),
                                   bridge.tree_from_model(model, "data")):
            what = f"step {i} param {k}"
            if full_width:
                near_zero = np.abs(grads[k]) <= gtol.get(k, 0.0)
                np.testing.assert_allclose(got[~near_zero], want[~near_zero],
                                           rtol=1e-4, atol=1e-5 * lr, err_msg=what)
                assert np.abs(got - want).max() <= 2.1 * lr, what
            elif mode == "float32":
                _close_f32(got, want, what=what)
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=2.1 * lr * (i + 1), err_msg=what)
        out.append(stats)
    return out


# -- the train step -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_tiny_flagship_three_steps_match_jax(mode):
    """__graft_entry__._flagship(tiny=True): loss, stats, per-leaf grads and
    post-Adam params after each of 3 steps."""
    c = tiny(mode)
    before = scatter.exact_scatter_add.calls
    stats = _run_steps(c, 3, mode)
    # the exact f32 scatter serves float32 mode only
    assert (scatter.exact_scatter_add.calls > before) == (mode == "float32")
    assert float(stats[-1]["loss"]) < float(stats[0]["loss"])


def test_tiny_step_with_freespace_and_occ_losses():
    """The gated BCE terms on the mask-background and -foreground rays."""
    cfg_j, *_, batch_np = _flagship(tiny=True)
    over = {"use_freespace_loss": True, "use_occ_loss": True,
            "free_loss_weight": 0.3, "occ_loss_weight": 0.2}
    c = Case(cfg_j.merged(F32_MODE).merged(over), batch_np)
    assert c.lw.use_freespace and c.lw.use_occ and "occupancy" in batch_np
    stats = _run_steps(c, 1, "float32")
    assert float(stats[0]["free_loss"]) > 0 and float(stats[0]["occ_loss"]) > 0


@pytest.mark.parametrize("step", [0, 25_000])
def test_variant_losses_match_jax(rng, step):
    """Every model-variant term, gated on its key (the inb model emits
    none; the SDF / normal / residual variants do)."""
    n = 40
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    ret = {"rgb_map": f(n, 3), "rgb_res": f(n, 3), "fw_resd": f(n, 3),
           "bw_resd": f(n, 3), "pred_pbw": f(n, 24), "smpl_tbw": f(n, 24),
           "msk_sdf": 0.05 * f(n), "msk_label": (rng.random(n) < 0.5).astype(np.float32),
           "surf_normal": f(n, 3), "gradients": f(n, 3),
           "observed_gradients": f(n, 3),
           "resd_jacobian": np.eye(3, dtype=np.float32) + 0.1 * f(n, 3, 3)}
    batch = {"normal": f(n, 3), "ray_d": f(n, 3), "latent_index": 0}
    lw = tstep.LossWeights(num_trained_mask=1)
    jlw = jstep.LossWeights(num_trained_mask=1)
    loss, stats = tstep.variant_losses(
        {k: torch.from_numpy(v) for k, v in ret.items()},
        {k: torch.as_tensor(v) for k, v in batch.items()}, lw, step)
    jloss, jstats = jstep.variant_losses(
        {k: jnp.asarray(v) for k, v in ret.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jlw, step)
    assert set(stats) == set(jstats) and len(stats) == 8
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("mode", ["float32", "bf16-tables"])
def test_full_width_step_matches_jax(mode):
    """inb_377 at its published widths (5 x 16 levels, 2^20-row tables),
    one step on 16 rays x 64 samples."""
    c = full_width(mode)
    assert c.params_j["embed"]["body"]["hash"].shape[0] > c.mspec.part_embeds[0].hash_rows
    _run_steps(c, 1, mode, full_width=True)


def test_render_rays_train_matches_jax_with_valid_pairs():
    """Occupancy bias 0 on both sides puts the occupancy near 0.5, so the
    pair regularizer has valid slots; the JAX draws go in as draws=."""
    c = tiny("float32", occ_bias=0.0)
    rng = jax.random.key(3)
    ref = jax.jit(jrend.render_rays, static_argnums=(0, 1, 4))(
        c.mspec_j, c.rspec_j, c.params_j, c.batch_j, True, rng)
    with torch.no_grad():
        got = rend.render_rays(c.mspec, c.rspec, c.model(), c.batch, train=True,
                               draws=c.draws(rng))
    tol = dict(rtol=1e-4, atol=1e-6)
    for k in ("rgb_map", "acc_map", "weights", "occ", "resd", "reg_distortion"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **tol,
                                   err_msg=k)
    n_valid = int(np.asarray(ref["pair_valid"]).sum())
    assert n_valid > 10 and int(got["pair_valid"].sum()) == n_valid
    # valid slots come first (smallest scores) in both selections
    for k in ("pair_resd0", "pair_resd1"):
        np.testing.assert_allclose(got[k][:n_valid].numpy(),
                                   np.asarray(ref[k])[:n_valid], **tol, err_msg=k)
    keys = ("pair_resd0", "pair_resd1", "pair_valid")
    mine = [got[k] for k in keys]
    theirs = [torch.from_numpy(np.array(ref[k])) for k in keys]
    loss = float(rend.pair_reg_loss(*mine))
    want = float(jrend.pair_reg_loss(*(ref[k] for k in keys)))
    assert want > 0
    # the loss function alone: the port's on JAX's own residuals
    np.testing.assert_allclose(float(rend.pair_reg_loss(*theirs)), want, rtol=1e-5)
    # End to end the loss is ill-conditioned: it is the mean distance of the
    # unit directions of two nearly parallel ~1e-3 residuals, so the
    # residuals' few-1e-6 relative error (held above) comes out ~60x larger
    # in the loss (1.75e-4 relative on these inputs).  That error,
    # propagated to first order through the loss's gradient at JAX's
    # residuals (float64), predicts the gap; what is left of it must be
    # each side's float32 evaluation (rtol 1e-5, as just checked).
    r_jax = [t[:n_valid].double().requires_grad_() for t in theirs[:2]]
    torch.autograd.backward(rend.pair_reg_loss(*r_jax, theirs[2][:n_valid]))
    predicted = sum(float(torch.sum(r.grad * (m[:n_valid].double() - r.detach())))
                    for r, m in zip(r_jax, mine))
    assert abs(loss - want - predicted) <= 2e-5 * want, (loss, want, predicted)


def test_render_rays_train_draws_from_a_generator():
    c = tiny("float32")
    model = c.model()
    outs = []
    for _ in range(2):
        with torch.no_grad():
            outs.append(rend.render_rays(c.mspec, c.rspec, model, c.batch,
                                         train=True,
                                         generator=torch.Generator().manual_seed(5)))
    B = rend.pair_budget(c.mspec, c.rspec, c.batch["ray_o"].shape[0] * c.rspec.n_samples)
    assert outs[0]["pair_resd1"].shape == (B, 3)
    for k in ("rgb_map", "pair_resd1", "reg_distortion"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    with torch.no_grad():
        eval_out = rend.render_rays(c.mspec, c.rspec, model, c.batch)
    assert set(eval_out) < set(outs[0]) and "resd" not in eval_out


# -- hash-grid gradients --------------------------------------------------------

GRIDS = {
    # the flagship deformer grid: F=2 tables read per feature column
    "deformer": dict(n_levels=8, n_features_per_level=2, log2_hashmap_size=14,
                     base_resolution=4, b=1.38, sum=False),
    # a part grid: scalar table
    "scalar-part": dict(n_levels=8, n_features_per_level=4,
                        log2_hashmap_size=10, base_resolution=4, b=1.38),
}


def _grid_case(rng, mode, dtype, exact):
    kw = dict(GRIDS[mode], exact_grads=exact)
    jspec = jhg.make_hashgrid_spec(primes=PRIMES, **kw)
    spec = hg.make_hashgrid_spec(primes=PRIMES, **kw)
    jp = jhg.hashgrid_init(jax.random.key(1), jspec)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jp.items()}
    bounds = np.array([[-0.4, -0.5, -0.3], [0.6, 0.5, 0.7]], np.float32)
    xyz = rng.uniform(-0.5, 0.8, size=(301, 3)).astype(np.float32)
    w = rng.standard_normal((301, jspec.out_dim)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jloss(params, x):
        p = {k: v.astype(jd) for k, v in params.items()}
        return jnp.sum(jhg.hashgrid_encode(jspec, p, x, jnp.asarray(bounds)) * w)

    with _kernel_route_grads():
        jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(xyz))
    x = torch.from_numpy(xyz).requires_grad_()
    out = hg.hashgrid_encode(spec, {k: v.to(td) for k, v in tp.items()}, x,
                             torch.from_numpy(bounds))
    torch.sum(out * torch.from_numpy(w)).backward()
    return ({k: (tp[k].grad.numpy(), np.asarray(jg[k])) for k in jp},
            (x.grad.numpy(), np.asarray(jgx)))


@pytest.mark.parametrize("mode,dtype,exact", [
    ("deformer", "float32", True),       # grid_compute_dtype float32
    ("scalar-part", "float32", False),   # scalar f32 tables: always exact
    ("deformer", "float32", False),      # f32 tables, bf16-rounded gradients
    ("scalar-part", "bfloat16", False),
    ("deformer", "bfloat16", False),
])
def test_hashgrid_encode_grads_match_jax(rng, mode, dtype, exact):
    tables, (gx, jgx) = _grid_case(rng, mode, dtype, exact)
    # bf16 and rounded gradients: one bf16 rounding of f32 sums on both
    # sides, whose f32 inputs may differ in the last bit
    tight = dtype == "float32" and (exact or mode == "scalar-part")
    for k, (got, want) in tables.items():
        assert np.abs(want).max() > 0
        if tight:
            _close_f32(got, want, rtol=1e-5, atol_rel=1e-7, what=k)
        else:
            _close_bf16(got, want, what=k)
    # the point gradient flows through the trilinear weights
    if tight:
        _close_f32(gx, jgx, rtol=1e-4, atol_rel=1e-6, what="xyz")
    else:
        _close_bf16(gx, jgx, what="xyz")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_hashgrid_encode_grads_match_jax(rng, dtype):
    """Five scalar part grids of different sizes, as the flagship."""
    part_kw = [dict(base_resolution=16, log2_hashmap_size=12),
               dict(base_resolution=2, log2_hashmap_size=12),
               dict(base_resolution=2, log2_hashmap_size=10),
               dict(base_resolution=2, log2_hashmap_size=8),
               dict(base_resolution=2, log2_hashmap_size=8)]
    common = dict(n_levels=10, n_features_per_level=4, b=1.38)
    jspecs = tuple(jhg.make_hashgrid_spec(primes=PRIMES, **common, **kw)
                   for kw in part_kw)
    specs = tuple(hg.make_hashgrid_spec(primes=PRIMES, **common, **kw)
                  for kw in part_kw)
    jps = [jhg.hashgrid_init(jax.random.key(10 + i), s) for i, s in enumerate(jspecs)]
    tps = [{k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in p.items()}
           for p in jps]
    seg = (64, 48, 32, 16, 16)
    bounds = np.stack([np.stack([c - 0.4, c + 0.4]) for c in
                       rng.uniform(-0.3, 0.3, size=(5, 3))]).astype(np.float32)
    pid = np.repeat(np.arange(5), seg)
    pts = (bounds[pid, 0] + rng.uniform(-0.05, 1.05, size=(len(pid), 3))
           * (bounds[pid, 1] - bounds[pid, 0])).astype(np.float32)
    w = rng.standard_normal((len(pid), specs[0].out_dim)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jloss(ps):
        ps = [{k: v.astype(jd) for k, v in p.items()} for p in ps]
        return jnp.sum(jhg.multi_hashgrid_encode(jspecs, ps, jnp.asarray(pts),
                                                 jnp.asarray(bounds), seg) * w)

    with _kernel_route_grads():
        jg = jax.jit(jax.grad(jloss))(jps)
    out = hg.multi_hashgrid_encode(specs, [{k: v.to(td) for k, v in p.items()}
                                           for p in tps],
                                   torch.from_numpy(pts), torch.from_numpy(bounds), seg)
    torch.sum(out * torch.from_numpy(w)).backward()
    for p in range(5):
        for k in ("dense", "hash"):
            got, want = tps[p][k].grad.numpy(), np.asarray(jg[p][k])
            if dtype == "float32":
                _close_f32(got, want, rtol=1e-5, atol_rel=1e-7, what=f"{p} {k}")
            else:
                _close_bf16(got, want, what=f"{p} {k}")


def test_table_gather_whole_rows(rng):
    """Non-scalar tables of KERNEL_MIN_ROWS rows or more gather whole rows
    (one F-wide scatter); the gradient is the f32 sum rounded to bf16."""
    spec = hg.make_hashgrid_spec(n_levels=2, n_features_per_level=2,
                                 log2_hashmap_size=17, base_resolution=2,
                                 separate_dense=False, sum=False)
    rows, offs = spec.hash_rows, spec.tables()[0][2]
    assert hg.gather_plan(spec, rows) == "rows" and rows >= hg.KERNEL_MIN_ROWS
    table = torch.zeros((rows, 2), requires_grad=True)
    idx = torch.from_numpy(np.stack([rng.integers(offs[l], offs[l + 1], 500)
                                     for l in range(2)]))
    g = torch.from_numpy(rng.standard_normal((2, 500, 2)).astype(np.float32))
    for dt, rounded in ((torch.bfloat16, False), (torch.float32, True),
                        (torch.float32, False)):
        table.grad = None
        torch.sum(hg.table_gather(table.to(dt), idx, offs, rounded) * g).backward()
        want = torch.zeros((rows, 2)).index_add_(0, idx.reshape(-1),
                                                 g.reshape(-1, 2))
        if dt == torch.bfloat16 or rounded:
            want = scatter.segmented_scatter_add_plain(
                idx.reshape(-1).int(), g.reshape(-1, 2).to(torch.bfloat16),
                rows).float()
        assert torch.equal(table.grad, want), (dt, rounded)


# -- leaf ops of the train path --------------------------------------------------

def test_jittered_sampler_matches_jax():
    near = jnp.asarray(np.linspace(0.5, 1.0, 37, dtype=np.float32))
    far = near + 1.3
    key = jax.random.key(7)
    want = np.asarray(jray.stratified_z_vals(key, near, far, 16, True))
    t_rand = torch.from_numpy(np.array(jax.random.uniform(key, (37, 16), jnp.float32)))
    n, f = torch.from_numpy(np.array(near)), torch.from_numpy(np.array(far))
    got = ray.stratified_z_vals(n, f, 16, perturb=True, t_rand=t_rand)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # from a generator: each sample stays inside its stratum
    z = ray.stratified_z_vals(n, f, 16, perturb=True,
                              generator=torch.Generator().manual_seed(0))
    even = ray.stratified_z_vals(n, f, 16)
    mids = 0.5 * (even[:, 1:] + even[:, :-1])
    assert (z[:, 1:] >= mids).all() and (z[:, :-1] <= mids).all()
    assert (torch.diff(z, dim=-1) >= 0).all() and not torch.equal(z, even)


def test_distortion_and_pair_losses_match_jax(rng):
    w = rng.uniform(0, 0.2, (33, 16)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 2.5, (33, 16)), axis=-1).astype(np.float32)
    np.testing.assert_allclose(
        rendering.distortion_loss(torch.from_numpy(w), torch.from_numpy(z)).numpy(),
        np.asarray(jrendering.distortion_loss(jnp.asarray(w), jnp.asarray(z))),
        rtol=1e-5, atol=1e-7)
    r0 = rng.normal(size=(64, 3)).astype(np.float32) * 0.01
    r1 = rng.normal(size=(64, 3)).astype(np.float32) * 0.01
    r0[:5] = 0.0                                  # masked residuals are zero
    valid = rng.random(64) < 0.6
    got = rend.pair_reg_loss(torch.from_numpy(r0), torch.from_numpy(r1),
                             torch.from_numpy(valid))
    want = jrend.pair_reg_loss(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = rend.pair_reg_loss(torch.from_numpy(r0), torch.from_numpy(r1),
                              torch.zeros(64, dtype=torch.bool))
    assert float(none) == 0.0


# -- optimizer and schedules -----------------------------------------------------

def _toy():
    """A toy tree with an 'embed' subtree (and a nested one, like the
    deformer's) beside plain weights."""
    rng = np.random.default_rng(4)
    tree = {"embed": {"a": rng.normal(size=(6,)).astype(np.float32)},
            "mlp": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            "deformer": {"embed": {"h": rng.normal(size=(5, 2)).astype(np.float32)},
                         "b": rng.normal(size=(4,)).astype(np.float32)}}

    def module(t):
        if isinstance(t, dict):
            m = torch.nn.Module()
            for k, v in t.items():
                setattr(m, k, module(v))
            return m
        return torch.nn.Parameter(torch.from_numpy(t.copy()))

    return tree, module(tree)


@pytest.mark.parametrize("optim,wd,mlp_scale", [
    ("adam", 0.0, 1.0), ("adam", 0.0, 0.5), ("adam", 1e-3, 0.5),
    ("radam", 0.0, 0.5), ("sgd", 1e-3, 0.5)])
def test_optimizer_matches_optax(optim, wd, mlp_scale):
    over = {"train": {"optim": optim, "weight_decay": wd,
                      "scheduler": {"type": "exponential", "gamma": 0.1,
                                    "decay_epochs": 3}},
            "ep_iter": 2, "mlp_weight_decay": mlp_scale}
    cfg_j = jax_make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(over)
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(over)
    tree, model = _toy()
    opt, _ = jstate.make_optimizer(cfg_j)
    params = jax.tree.map(jnp.asarray, tree)
    ost = opt.init(params)
    state = tstate.create_train_state(cfg, model)
    rng = np.random.default_rng(9)
    for i in range(8):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        upd, ost = opt.update(jax.tree.map(jnp.asarray, grads), ost, params)
        params = optax.apply_updates(params, upd)
        for (k, g), p in zip(_leaves(grads), _named(model, grads)):
            p.grad = torch.from_numpy(g.copy())
        state.set_lr()
        state.optimizer.step()
        state.step += 1
        for (k, want), p in zip(_leaves(params), _named(model, grads)):
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")


def _named(model, tree, prefix=""):
    """The model's parameters in _leaves order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(getattr(model, k), tree[k])
    else:
        yield model


def test_schedules_match_jax():
    for args in ((5e-4, 0.1, 1000, 500), (1e-3, 0.5, 3, 1)):
        a, b = tstate.make_lr_schedule(*args), jstate.make_lr_schedule(*args)
        for s in (0, 1, 499, 500, 1500, 10 ** 6):
            # JAX evaluates in float32, which underflows to 0 where the
            # port's float64 still holds ~1e-53
            np.testing.assert_allclose(a(s), float(b(jnp.int32(s))), rtol=1e-6,
                                       atol=1e-38)
    for method in ("linear", "constant"):
        args = (0.01, [8, 12], 0.1, 1.0 / 3, 5, method, 10)
        a, b = tstate.make_warmup_multi_step(*args), jstate.make_warmup_multi_step(*args)
        for s in range(0, 170, 7):
            np.testing.assert_allclose(a(s), float(b(jnp.int32(s))), rtol=1e-6)
    bounds = {20: 0.5, 40: 0.5}
    a, b = tstate.multi_step(1e-3, bounds), optax.piecewise_constant_schedule(1e-3, bounds)
    for s in (0, 19, 20, 39, 40, 41, 100):
        np.testing.assert_allclose(a(s), float(b(s)), rtol=1e-6)


def test_unported_training_options_raise():
    c = tiny("bfloat16")
    # patch losses and remat are ported (tests/test_torch_patch.py)
    tstep.make_train_step(c.mspec, c.rspec, c.lw, patch_loss_fn=lambda r, b: 0)
    tstep.make_train_step(c.mspec, c.rspec, c.lw._replace(remat=True))
    # the bf16 first moment is ported (tests/test_torch_realdata.py); an
    # unknown optimizer still raises
    opt, _ = tstate.make_optimizer(c.cfg.merged({"train": {"moment_dtype": "bfloat16"}}),
                                   c.model())
    assert isinstance(opt, tstate.AdamBf16Mu)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstate.make_optimizer(c.cfg.merged({"train": {"optim": "lamb"}}), c.model())


# -- bridge and entry point ------------------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "full-width"])
def test_tree_from_model_round_trip(which):
    """params_from_jax then tree_from_model gives the JAX arrays back bit
    for bit, without the tile padding."""
    c = tiny("bfloat16") if which == "tiny" else full_width()
    tree = bridge.tree_from_model(c.model())
    n = 0
    for k, got, want in _pairs(jax.tree.map(np.asarray, c.params_j), tree):
        np.testing.assert_array_equal(got, want, err_msg=k)
        n += 1
    assert n == len(jax.tree.leaves(c.params_j))
    grads = bridge.tree_from_model(c.model(), "grad")
    assert all(not a.any() for _, a in _leaves(grads))
    with pytest.raises(ValueError):
        bridge.tree_from_model(c.model(), "adam")


def test_train_net_cli_on_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        train_net.main(["--device", "cpu", "--tiny", "--steps", "2",
                        "--cfg_file", os.path.join(ROOT, "configs/inb/inb_377.yaml")])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 2 and all("loss" in l and "psnr" in l and " ms " in l
                                   for l in lines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_net.main(["--steps", "1"])


def test_train_modules_never_import_jax():
    code = ("import sys\n"
            "import instant_nvr_tpu_torch.train_net, instant_nvr_tpu_torch.train.step\n"
            "import instant_nvr_tpu_torch.train.state, instant_nvr_tpu_torch.train.crit\n"
            "import instant_nvr_tpu_torch.ops.scatter, instant_nvr_tpu_torch.bridge\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'instant_nvr_tpu.')) or m == 'instant_nvr_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
