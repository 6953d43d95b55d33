"""JAX checkpoints whose hash tables are stored packed, read by the port.

The JAX package stores a non-scalar table of F < 128 features packed,
``flat.reshape(-1, 128)`` of its tile-padded (rows, F) array, once it has
``kernel_min_rows`` rows (``instant_nvr_tpu/ops/hashgrid.py:_is_packed``,
190,000 on the TPU).  Tables are non-scalar under radam, sgd or weight
decay.  These tests lower the JAX package's threshold (and its tile
padding), as its own tests do, so the tiny widths are stored packed, and
hold the port's reading of them to JAX:

- ``bridge.params_from_jax`` of a packed init equals, bit for bit, that of
  the same init stored plain (the same draws);
- ``optimizer_state_from_jax`` (through ``load_checkpoint`` on an orbax
  directory the JAX package wrote) gives each moment as
  ``reshape(-1, F)[:rows]`` of the packed leaf, the inverse of
  ``hashgrid.py:391-392``;
- ``load_weights`` and one resumed step on such a directory agree with
  the JAX package's resumed step at ``tests/test_torch_orbax.py``'s
  float32 tolerances (loss rtol 1e-5; parameters rtol 1e-4, atol 1e-6 of
  the leaf's largest entry).
"""
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

from instant_nvr_tpu.models import inb as jinb  # noqa: E402
from instant_nvr_tpu.ops import hashgrid as jhg  # noqa: E402
from instant_nvr_tpu.renderer import inb_renderer as jrend  # noqa: E402
from instant_nvr_tpu.train import checkpoint as jck  # noqa: E402
from instant_nvr_tpu.train import state as jstate  # noqa: E402
from instant_nvr_tpu.train import step as jstep  # noqa: E402
from instant_nvr_tpu_torch import bridge  # noqa: E402
from instant_nvr_tpu_torch.models import inb  # noqa: E402
from instant_nvr_tpu_torch.run import build  # noqa: E402
from instant_nvr_tpu_torch.train import checkpoint  # noqa: E402
from instant_nvr_tpu_torch.train import state as tstate  # noqa: E402
from instant_nvr_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_orbax import (F32_MODE, _close, _draws, jax_state, jax_train,  # noqa: E402
                              tiny_batch, tiny_cfg)

CPU = torch.device("cpu")
# the optimizer settings under which the JAX package's tables are not scalar
OPTIMS = {"radam": {"train": {"optim": "radam"}},
          "sgd": {"train": {"optim": "sgd"}},
          "weight_decay": {"train": {"weight_decay": 1e-4}}}


@pytest.fixture
def packed(monkeypatch):
    """The JAX package stores every tiny table of 1,024 rows or more packed
    (its own tests' monkeypatch, hashgrid.py:48-49)."""
    monkeypatch.setattr(jhg, "KERNEL_MIN_ROWS", 1024)
    monkeypatch.setattr(jhg, "TILE_ROWS", 128)


def _packed_leaves(tree):
    return [k for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]
            if v.ndim == 2 and v.shape[1] == 128]


def _unpack(leaf, rows, F):
    """A packed leaf as its (rows, F) table: the inverse of
    hashgrid.py:391-392, as the JAX kernel unpacks its own output
    (onehot_scatter.py:169); any other leaf as it is."""
    a = np.asarray(leaf, np.float32)
    if a.ndim == 2 and a.shape[1] == 128 and F < 128:
        return a.reshape(-1, F)[:rows]
    return a


def _zero_padding(leaf, shape):
    """A packed leaf with its tile-padding rows beyond shape's rows zeroed."""
    a = np.array(leaf)
    if a.ndim == 2 and a.shape[1] == 128 and shape.shape[-1] < 128:
        a.reshape(-1, shape.shape[-1])[shape.shape[0]:] = 0
    return jnp.asarray(a)


@pytest.mark.parametrize("optim", sorted(OPTIMS))
def test_packed_params_equal_the_plain_init(optim, monkeypatch):
    cfg_j, cfg = tiny_cfg(OPTIMS[optim])
    mspec_j, mspec = jinb.build_model_spec(cfg_j), inb.build_model_spec(cfg)
    plain = jax.tree.map(np.asarray, jinb.init_params(jax.random.key(0), mspec_j))
    assert not _packed_leaves(plain)
    monkeypatch.setattr(jhg, "KERNEL_MIN_ROWS", 1024)
    monkeypatch.setattr(jhg, "TILE_ROWS", 128)
    packed = jax.tree.map(np.asarray, jinb.init_params(jax.random.key(0), mspec_j))
    # every part grid's two tables and the deformer's hash table
    assert len(_packed_leaves(packed)) >= 2 * mspec.num_parts
    want = bridge.params_from_jax(plain, mspec)
    got = bridge.params_from_jax(packed, mspec)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("optim", sorted(OPTIMS))
def test_packed_moments_map(optim, monkeypatch, tmp_path):
    """Every moment of a JAX state filled with seeded values, read through
    the port's load_checkpoint from the orbax directory JAX wrote, equals
    the port's mapping of the same moments unpacked by hand."""
    cfg_j, cfg = tiny_cfg(OPTIMS[optim])
    mspec_j = jinb.build_model_spec(cfg_j)
    shapes = jax.eval_shape(lambda: jinb.init_params(jax.random.key(0), mspec_j))
    monkeypatch.setattr(jhg, "KERNEL_MIN_ROWS", 1024)
    monkeypatch.setattr(jhg, "TILE_ROWS", 128)
    _, _, st = jax_state(cfg_j, fill=np.random.default_rng(2))
    assert _packed_leaves(st.params)
    # the fill reaches packed tile padding, which JAX's moments keep zero
    fields = ({"momentum_buffer": "trace"} if optim == "sgd"
              else {"exp_avg": "mu", "exp_avg_sq": "nu"})
    moment = next(iter(fields.values()))

    def zero(node):                     # the moment's state in optax's chain
        if hasattr(node, moment):
            return node._replace(**{leaf: jax.tree.map(_zero_padding, getattr(node, leaf),
                                                       shapes)
                                    for leaf in fields.values()})
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(zero(c) for c in node)
        return node
    st = st._replace(opt_state=zero(st.opt_state))
    jck.save_checkpoint(str(tmp_path), 0, st, {"step": 7, "epoch": 0})
    _, _, model = build(cfg, CPU, seed=1)
    state = tstate.create_train_state(cfg, model)
    assert checkpoint.load_checkpoint(str(tmp_path), state) == {"epoch": 0, "step": 7}
    names = {id(p): n for n, p in model.named_parameters()}
    for field, leaf in fields.items():
        node = [n for n in jax.tree_util.tree_leaves(
            st.opt_state, is_leaf=lambda n: hasattr(n, moment)) if hasattr(n, moment)][0]
        plain = jax.tree.map(lambda a, s: _unpack(a, s.shape[0], s.shape[-1]),
                             getattr(node, leaf), shapes)
        want = bridge.params_from_jax(plain, model.spec)
        for p, s in state.optimizer.state.items():
            n = names[id(p)]
            assert torch.equal(s[field].float(), want[n]), (field, n)
    assert len(state.optimizer.state) == len(list(model.parameters()))


@pytest.mark.parametrize("optim", sorted(OPTIMS))
def test_resumed_step_from_packed_checkpoint_matches_jax(optim, packed, tmp_path):
    """2 JAX steps with packed tables, saved; one more step in the JAX
    package (its load_checkpoint) and in the port (load_weights, then
    load_checkpoint on the same directory), float32 mode."""
    cfg_j, cfg = tiny_cfg(OPTIMS[optim], F32_MODE)
    batch_np = tiny_batch()
    mspec_j, opt, st = jax_train(cfg_j, 2, batch_np)
    assert _packed_leaves(st.params)
    d = str(tmp_path / "model")
    jck.save_checkpoint(d, 0, st, {"step": 2, "epoch": 0})
    jtemplate = jstate.create_train_state(jinb.init_params(jax.random.key(3), mspec_j),
                                          opt, mspec_j)
    jresumed, _ = jck.load_checkpoint(d, jtemplate)
    step = jax.jit(jstep.make_train_step(mspec_j, jrend.make_render_spec(cfg_j),
                                         jstep.make_loss_weights(cfg_j), opt))
    jnext, jstats = step(jresumed, {k: jnp.asarray(v) for k, v in batch_np.items()},
                         jax.random.key(2))

    mspec, rspec, model = build(cfg, CPU, seed=4)
    checkpoint.load_weights(d, model)
    want0 = bridge.params_from_jax(jax.tree.map(np.asarray, st.params), mspec)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want0[k]), k
    state = tstate.create_train_state(cfg, model)
    assert checkpoint.load_checkpoint(d, state) == {"epoch": 0, "step": 2}
    _, stats = tstep.make_train_step(mspec, rspec, tstep.make_loss_weights(cfg))(
        state, {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()},
        draws=_draws(cfg_j, mspec, rspec, batch_np, jax.random.key(2)))
    for k in ("loss", "img_loss", "psnr"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jnext.params), mspec)
    for k, v in model.state_dict().items():
        _close(v.numpy(), want[k].numpy(), f"param {k}")
