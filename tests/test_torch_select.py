"""``select_mode: partition``, the per-part oracle ``forward_parts`` and the
spec's routing keys of the port, against the JAX package on the CPU.

Inputs come from ``numpy.random.default_rng(seed)`` or the tiny flagship of
``__graft_entry__._flagship(tiny=True)`` (inb_377 at narrow widths, 64 rays
of 64 samples), with weights carried across by ``bridge.params_from_jax``.
Tolerances:
  * ``partition_select`` and ``_fixed_perm``: bit for bit (integer work);
  * ``inb.forward`` / ``render_rays(train=True)`` against JAX, float32 mode:
    ``tests/test_torch_model.py``'s rtol 1e-4, atol 1e-5 for the model and
    ``tests/test_torch_train.py``'s rtol 1e-4, atol 1e-6 for the renderer
    (the same float32 ops, sums in other orders); the telemetry equal.  The
    partition's slots are JAX's slot for slot, so the per-slot outputs
    compare element by element, also when every budget overflows;
  * the port's ``forward`` against its ``forward_parts``: the JAX package's
    own rtol 2e-4, atol 1e-5 (``tests/test_model.py:233-245``), outputs and
    every parameter's gradient.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from __graft_entry__ import _flagship  # noqa: E402
from instant_nvr_tpu.models import inb as jinb  # noqa: E402
from instant_nvr_tpu.ops import select as jselect  # noqa: E402
from instant_nvr_tpu.renderer import inb_renderer as jrend  # noqa: E402
from instant_nvr_tpu_torch import bridge, run, train_net  # noqa: E402
from instant_nvr_tpu_torch.config import Config  # noqa: E402
from instant_nvr_tpu_torch.models import inb  # noqa: E402
from instant_nvr_tpu_torch.ops import select  # noqa: E402
from instant_nvr_tpu_torch.renderer import inb_renderer as rend  # noqa: E402

F32_MODE = {"mlp_dtype": "float32", "grid_compute_dtype": "float32"}
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
RENDER_TOL = dict(rtol=1e-4, atol=1e-6)
PARTS_TOL = dict(rtol=2e-4, atol=1e-5)
TELEMETRY = ("cull_overflow", "part_overflow", "cull_need", "part_need")
# budgets raised until nothing overflows, and cut until each one does
# (64 samples a ray: budgets are multiples of 128 slots, so fewer samples
# cannot overflow a part's)
AMPLE = {"cull_budget": 1.0, "part_budget": 1.0, "part_budget_scales": [1.0] * 5}
SCARCE = {"cull_budget": 0.25, "part_budget": 0.05}
N_SAMPLES = 64
PAIR_BUDGET = 16

jax_forward = jax.jit(jinb.forward, static_argnums=(0, 5))
jax_forward_parts = jax.jit(jinb.forward_parts, static_argnums=(0, 5))
jax_render_rays = jax.jit(jrend.render_rays, static_argnums=(0, 1, 4))


class Case:
    """One model on both sides, its weights from JAX's init."""

    def __init__(self, overrides, occ_bias=None):
        cfg_j, *_, batch_np = _flagship(tiny=True)
        self.cfg_j = cfg_j.merged(F32_MODE).merged({"N_samples": N_SAMPLES, **overrides})
        self.mspec_j = jinb.build_model_spec(self.cfg_j)
        self.mspec = inb.build_model_spec(Config(self.cfg_j.to_dict()))
        self.params_j = jinb.init_params(jax.random.key(0), self.mspec_j)
        if occ_bias is not None:      # occupancy near 0.5: valid pairs
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

    def samples(self, S=N_SAMPLES):
        b = self.batch_np
        t = np.linspace(0.0, 1.0, S, dtype=np.float32)
        z = b["near"][:, None] * (1 - t) + b["far"][:, None] * t
        wpts = b["ray_o"][:, None] + b["ray_d"][:, None] * z[..., None]
        vd = np.repeat(b["ray_d"], S, axis=0)
        return wpts.reshape(-1, 3).astype(np.float32), vd.astype(np.float32)


@functools.cache
def case(mode: str, budgets: str, occ_bias=None) -> Case:
    return Case({"select_mode": mode, **(AMPLE if budgets == "ample" else SCARCE)},
                occ_bias)


# -- the selection ops ------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 128, 1000, 65_537])
def test_fixed_perm_matches_jax(n):
    got = select._fixed_perm(n)
    assert np.array_equal(got.numpy(), np.asarray(jselect._fixed_perm(n)))
    assert select._fixed_perm(n) is got            # made once per (n, device)


@pytest.mark.parametrize("name,N,budget,thresh", [
    ("under-budget", 1000, 256, 0.1),
    ("overflow", 1000, 128, 0.5),
    ("thresh-0", 1000, 128, 0.0),
    ("budget-N", 777, 777, 0.6),
    ("budget-N-overflow", 257, 257, 2.0),
])
def test_partition_select_matches_jax(name, N, budget, thresh):
    score = np.random.default_rng(N + budget).uniform(0, 1, N).astype(np.float32)
    want_idx, want_valid = jselect.partition_select(jnp.asarray(score), budget, thresh)
    idx, valid = select.partition_select(torch.from_numpy(score), budget, thresh)
    assert np.array_equal(idx.numpy(), np.asarray(want_idx)), name
    assert np.array_equal(valid.numpy(), np.asarray(want_valid)), name
    n_pass = int((score < thresh).sum())
    assert int(valid.sum()) == min(n_pass, budget)
    if name == "thresh-0":
        assert not valid.any()


def test_select_ops_agree():
    """``tests/test_model.py::test_select_ops_agree`` on the port."""
    score = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, 257).astype(np.float32))
    for budget, thresh in ((64, 0.2), (256, 0.9), (128, 0.0)):
        ti, tv = select.topk_select(score, budget, thresh)
        pi, pv = select.partition_select(score, budget, thresh)
        assert int(tv.sum()) == int(pv.sum())
        if int(tv.sum()) < budget:   # no overflow: identical sets
            assert set(ti[tv].tolist()) == set(pi[pv].tolist())


def test_scatter_back_keeps_the_value_of_a_valid_row_0():
    """A compaction's spare slots hold index 0; row 0 keeps its value."""
    idx = torch.tensor([0, 3, 0, 0])
    valid = torch.tensor([True, True, False, False])
    vals = torch.tensor([[1.0], [2.0], [9.0], [9.0]])
    out = select.scatter_back(torch.zeros(5, 1), idx, vals, valid)
    assert out[:, 0].tolist() == [1.0, 0.0, 0.0, 2.0, 0.0]


# -- the model and the renderer under partition -------------------------------------

@pytest.mark.parametrize("budgets", ["ample", "scarce"])
def test_forward_partition_matches_jax(budgets):
    c = case("partition", budgets)
    wpts, vd = c.samples()
    ref = jax_forward(c.mspec_j, c.params_j, jnp.asarray(wpts), jnp.asarray(vd),
                      c.batch_j, True)
    with torch.no_grad():
        got = inb.forward(c.mspec, c.model(), torch.from_numpy(wpts),
                          torch.from_numpy(vd), c.batch, train=True)
    overflow = float(ref["cull_overflow"]) > 0 and float(ref["part_overflow"]) > 0
    assert overflow == (budgets == "scarce")
    assert int(np.asarray(ref["tflag"]).sum()) > 0
    for k in ("raw", "occ", "resd", "tpts", "tocc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **MODEL_TOL,
                                   err_msg=k)
    assert np.array_equal(got["tflag"].numpy(), np.asarray(ref["tflag"]))
    assert np.array_equal(got["cull_valid"].numpy(), np.asarray(ref["cull_valid"]))
    for k in TELEMETRY:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("budgets", ["ample", "scarce"])
def test_render_rays_train_partition_matches_jax(budgets):
    """The pair selection too: occupancy bias 0 gives valid pairs; with
    scarce budgets the pair budget is cut to 16 slots as well, so more
    candidates pass the threshold than it holds."""
    c = case("partition", budgets, occ_bias=0.0)
    rspec_j = jrend.make_render_spec(c.cfg_j)
    rspec = rend.make_render_spec(Config(c.cfg_j.to_dict()))
    if budgets == "scarce":
        rspec_j = rspec_j._replace(pair_budget=PAIR_BUDGET)
        rspec = rspec._replace(pair_budget=PAIR_BUDGET)
    rng = jax.random.key(3)
    ref = jax_render_rays(c.mspec_j, rspec_j, c.params_j, c.batch_j, True, rng)
    R, S = c.batch_np["ray_o"].shape[0], rspec.n_samples
    k_strat, k_pair = jax.random.split(rng)
    B = rend.pair_budget(c.mspec, rspec, R * S)
    draws = {"t_rand": torch.from_numpy(np.array(jax.random.uniform(k_strat, (R, S)))),
             "pair_noise": torch.from_numpy(np.array(
                 (jax.random.uniform(k_pair, (B, 3)) - 0.5) * rspec_j.pair_range))}
    model = c.model()
    with torch.no_grad():
        got = rend.render_rays(c.mspec, rspec, model, c.batch, train=True, draws=draws)
    n_valid = int(np.asarray(ref["pair_valid"]).sum())
    assert n_valid > 0 and np.array_equal(got["pair_valid"].numpy(),
                                          np.asarray(ref["pair_valid"]))
    if budgets == "scarce":
        # more candidates than slots: the budget is full
        with torch.no_grad():
            net = inb.forward(c.mspec, model, *(torch.from_numpy(
                a) for a in c.samples(S)), c.batch, train=True)
        cand = net["tflag"] & ((net["tocc"][:, 0] - 0.5).abs() < rspec.pair_thresh)
        assert int(cand.sum()) > B == n_valid
    for k in ("rgb_map", "acc_map", "weights", "occ", "resd", "reg_distortion",
              "pair_resd0", "pair_resd1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **RENDER_TOL,
                                   err_msg=k)
    for k in TELEMETRY:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                                   atol=0, err_msg=k)


def test_partition_equals_topk_without_overflow():
    """``tests/test_model.py::test_partition_select_matches_topk_without_overflow``
    on the port: the same outputs, per-point extras permuted."""
    wpts, vd = case("topk", "ample").samples()
    outs = {}
    for mode in ("partition", "topk"):
        c = case(mode, "ample")
        with torch.no_grad():
            outs[mode] = inb.forward(c.mspec, c.model(), torch.from_numpy(wpts),
                                     torch.from_numpy(vd), c.batch, train=True)
    for k in ("raw", "occ"):
        np.testing.assert_allclose(outs["partition"][k].numpy(), outs["topk"][k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("resd", "tocc"):
        a = np.sort(outs["partition"][k].numpy().ravel())
        b = np.sort(outs["topk"][k].numpy().ravel())
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(outs["partition"]["tflag"].sum()) == int(outs["topk"]["tflag"].sum())


# -- forward_parts --------------------------------------------------------------------

def test_forward_matches_forward_parts():
    """The fused forward against the unrolled oracle: outputs and every
    parameter's gradient (loss: sum raw^2 + sum resd^2)."""
    c = case("topk", "scarce")
    wpts, vd = (torch.from_numpy(a) for a in c.samples())
    outs, grads = {}, {}
    for name, fwd in (("forward", inb.forward), ("parts", inb.forward_parts)):
        model = c.model()
        r = fwd(c.mspec, model, wpts, vd, c.batch, train=True)
        (torch.sum(r["raw"] ** 2) + torch.sum(r["resd"] ** 2)).backward()
        outs[name] = {k: v.detach() for k, v in r.items()}
        grads[name] = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                       for n, p in model.named_parameters()}
    for k in ("raw", "occ", "resd", "tpts", "tocc", "tflag", "cull_overflow",
              "part_overflow"):
        np.testing.assert_allclose(outs["forward"][k].numpy(), outs["parts"][k].numpy(),
                                   **PARTS_TOL, err_msg=k)
    assert float(np.abs(grads["forward"]["embed.body.dense"].numpy()).max()) > 0
    for n in grads["forward"]:
        np.testing.assert_allclose(grads["forward"][n].numpy(), grads["parts"][n].numpy(),
                                   **PARTS_TOL, err_msg=n)


def test_forward_parts_matches_jax():
    c = case("topk", "scarce")
    wpts, vd = c.samples()
    ref = jax_forward_parts(c.mspec_j, c.params_j, jnp.asarray(wpts), jnp.asarray(vd),
                            c.batch_j, True)
    with torch.no_grad():
        got = inb.forward_parts(c.mspec, c.model(), torch.from_numpy(wpts),
                                torch.from_numpy(vd), c.batch, train=True)
    assert float(ref["part_overflow"]) > 0
    for k in ("raw", "occ"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **MODEL_TOL,
                                   err_msg=k)
    # per-slot extras: top-k ties may order the invalid slots differently
    tflag = np.asarray(ref["tflag"])
    assert int(got["tflag"].sum()) == int(tflag.sum())
    for k in ("resd", "tpts", "tocc"):
        np.testing.assert_allclose(got[k].numpy()[tflag], np.asarray(ref[k])[tflag],
                                   **MODEL_TOL, err_msg=k)
    for k in TELEMETRY:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                                   atol=0, err_msg=k)


# -- the spec's keys ----------------------------------------------------------------

def _spec(**kw):
    cfg_j, *_ = _flagship(tiny=True)
    return inb.build_model_spec(Config(cfg_j.merged(kw).to_dict()))


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_knn_backend_kernel_routes_are_read(backend):
    """Both name knn_blend's kernel on the card: the spec is the default's."""
    assert _spec(knn_backend=backend) == _spec()


def test_knn_backend_xla_raises_naming_the_key():
    with pytest.raises(ValueError, match="knn_backend: xla.*one KNN route per device"):
        _spec(knn_backend="xla")


def test_knn_backend_unknown_raises_naming_the_key():
    with pytest.raises(ValueError, match="knn_backend: 'cuda'"):
        _spec(knn_backend="cuda")


def test_select_mode_is_read_and_unknown_raises():
    assert _spec().select_mode == "topk"
    assert _spec(select_mode="partition").select_mode == "partition"
    with pytest.raises(ValueError, match="select_mode: 'sorted'"):
        _spec(select_mode="sorted")


def test_distributed_partition_raises_naming_the_key():
    with pytest.raises(ValueError, match="select_mode: partition"):
        train_net.main(["--distributed", "--device", "cpu", "--tiny", "--steps", "1",
                        "select_mode", "partition"])
    with pytest.raises(ValueError, match="select_mode: partition"):
        run.main(["--type", "evaluate", "--distributed", "--device", "cpu",
                  "--cfg_file", os.path.join(ROOT, "configs/inb/inb_377.yaml"),
                  "select_mode", "partition"])
