"""The MLPs' weight and bias gradients: ``models/nn.py``'s autograd
Function and ``ops/mlp_wgrad.py`` (``csrc/mlp_wgrad.cu`` on the card).

Card tests (marker ``card``) skip without a CUDA card; on the card:

    python -m pytest --noconftest -m card tests/test_torch_mlp_wgrad.py

(``chip_smoke.py`` phase 19 runs the same cases and times each of a fit
step's layers beside cuBLAS's call).  At each linear layer shape of an
inb_377 fit step (:func:`fit_layers`) and at a few shapes that reach the
kernel's edges (:data:`EDGE_LAYERS`), the kernel's weight and bias
gradients are held to a float64 ``x^T g`` within :data:`LIMIT` of the
element's sum of |x g| (:func:`gaps`); cuBLAS's float32 product must pass
the same limit and a control that rounds g to bfloat16 before the products
must fail it; two launches must be bit-equal.

CPU tests: the Function's forward and its three gradients bit-equal to
autograd through the plain ops, in every case the MLPs run; the no-grad
route; a tiny fit step through the Function, counting its layers; the
refusals; the launch's arguments through a stub launch function.  This file
imports nothing of JAX, so the card's machine runs it.
"""
from __future__ import annotations

import contextlib
import os
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.models import nn as mnn
from instant_nvr_tpu_torch.models.embedders import freq_out_dim
from instant_nvr_tpu_torch.ops import mlp_wgrad as mw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "inb", "inb_377.yaml")
# The kernel's weight and bias gradients against a float64 x^T g, in units
# of the element's sum over the rows of |x g|: 2^-20, 8 float32 units in
# the last place of that sum.  With cotangents of either sign, a float32
# sum errs by about a quarter of a unit of it in any order (each partial
# sum's rounding is at most half a unit of the partial sum, and partial
# sums of terms of either sign stay far under the sum of their sizes),
# and cuBLAS's sequential sum over up to 90,112 rows passes too; rounding
# g to bfloat16 moves each term by up to 2^-9 of itself, the sum by about
# 2^-9 / sqrt(3 N) of the sum of |x g|: 2.1e-6 at N = 90,112 rows, above
# the limit at every shape of a fit step.
LIMIT = 2.0 ** -20


def fit_layers(cfg_path: str = CFG):
    """[(name, stacked, P, N, Din, Dout)] of every linear layer of one
    patch-mode fit step of ``cfg_path`` (64 x 64 rays), in the order the
    forward runs them: the stacked occupancy head over every part's
    budget slots (padded to the largest part's), each colour group's
    stacked head, then the deformer's layers over the budget slots and
    over the pair regularizer's."""
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec, pair_budget
    cfg = make_cfg(cfg_path)
    spec, rspec = inb.build_model_spec(cfg), make_render_spec(cfg)
    n_samples = 64 * 64 * rspec.n_samples
    Kps = inb.budgets(spec, n_samples)[1]
    Kmax, M = max(Kps), sum(Kps)

    def dims(d_in, d_hidden, n_layers, d_out):
        d = [d_in] + [d_hidden] * n_layers + [d_out]
        return list(zip(d[:-1], d[1:]))
    out = [(f"occ.{i}", True, spec.num_parts, Kmax, a, b) for i, (a, b) in
           enumerate(dims(spec.embed_dim, *spec.occ_arch, 1 + spec.geo_feature_dim))]
    rgb_in = (spec.embed_dim + freq_out_dim(spec.viewdir_res) + spec.geo_feature_dim
              + spec.latent_dim)
    for (dh, nl), ids in spec.rgb_groups():
        out += [(f"rgb.h{dh}_l{nl}.{i}", True, len(ids), Kmax, a, b)
                for i, (a, b) in enumerate(dims(rgb_in, dh, nl, 3))]
    d = spec.deformer
    for tag, rows in (("deformer", M), ("pair_deformer", pair_budget(spec, rspec, n_samples))):
        out += [(f"{tag}.{i}", False, 1, rows, a, b)
                for i, (a, b) in enumerate(dims(d.embed.out_dim, d.d_hidden, d.n_layers, 3))]
    return out


# shapes at the kernel's edges: rows that are no multiple of 4 and of a
# width whose stages start off 16-byte boundaries, one row, an output of
# one column, and outputs too large for one block's tile (several tiles
# along the rows, and along the columns too with an odd column count)
EDGE_LAYERS = (("odd-rows", True, 3, 1_001, 19, 17), ("one-row", False, 1, 1, 5, 8),
               ("one-column", True, 2, 5_000, 64, 1), ("tiles", False, 1, 3_000, 300, 500),
               ("tiles-odd", True, 2, 2_000, 130, 301))


def draw_operands(stacked, P, N, din, dout, gen, device):
    """x as a hidden layer's bf16-rounded softplus output, g standard
    normal (cotangents of either sign); (N, Din) / (N, Dout) unless
    ``stacked``."""
    x = F.softplus(torch.randn((P, N, din), generator=gen, device=device))
    x = x.to(torch.bfloat16).float()
    g = torch.randn((P, N, dout), generator=gen, device=device)
    return (x, g) if stacked else (x[0], g[0])


def gaps(got, x, g) -> float:
    """The largest gap of (dw, db) from float64's x^T g and g's sum, each
    element's over its sum of |x g|."""
    x64, g64 = x.double(), g.double()
    if x64.dim() == 2:
        x64, g64 = x64[None], g64[None]
    want = (torch.bmm(x64.transpose(1, 2), g64), g64.sum(1))
    scale = (torch.bmm(x64.abs().transpose(1, 2), g64.abs()), g64.abs().sum(1))
    worst = 0.0
    for a, w, s in zip(got, want, scale):
        d = (a.double().reshape(w.shape) - w).abs()
        worst = max(worst, float((d / s.clamp_min(1e-300)).max()))
    return worst


def layer_case(name, stacked, P, N, din, dout, device, seed=0) -> dict:
    """The kernel (through :func:`mw.weight_grads`) at one layer shape:
    its gap (:func:`gaps`), cuBLAS's (:func:`mw.wgrad_plain` on the card)
    and the bf16-cotangent control's, and whether two launches agree bit
    for bit."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x, g = draw_operands(stacked, P, N, din, dout, gen, device)
    k1, k2 = mw.weight_grads(x, g), mw.weight_grads(x, g)
    r = {"layer": name, "parts": P, "rows": N, "din": din, "dout": dout,
         "kernel": gaps(k1, x, g), "cublas": gaps(mw.wgrad_plain(x, g), x, g),
         "control": gaps(mw.weight_grads(x, g.to(torch.bfloat16).float()), x, g),
         "repeat_bit_equal": all(torch.equal(a, b) for a, b in zip(k1, k2))}
    r["ok"] = (r["kernel"] <= LIMIT and r["cublas"] <= LIMIT and r["control"] > LIMIT
               and r["repeat_bit_equal"])
    return r


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the weight-gradient kernel runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("layer", [f[0] for f in fit_layers()] + [e[0] for e in EDGE_LAYERS])
def test_kernel_holds_float64_limit(card, layer):
    shape = {f[0]: f for f in fit_layers() + list(EDGE_LAYERS)}[layer]
    r = layer_case(*shape, card)
    assert r["ok"], r


@pytest.mark.card
def test_kernel_reads_operands_off_16_byte_boundaries(card):
    """x and g one float past a 16-byte boundary: the same bits as aligned
    copies (the copies' width does not change the sums' order)."""
    gen = torch.Generator(device=card).manual_seed(1)
    x, g = draw_operands(True, 2, 3_001, 64, 32, gen, card)
    xo = torch.empty(x.numel() + 1, device=card)[1:].view_as(x).copy_(x)
    go = torch.empty(g.numel() + 1, device=card)[1:].view_as(g).copy_(g)
    assert xo.data_ptr() % 16 and go.data_ptr() % 16
    for a, b in zip(mw.weight_grads(xo, go), mw.weight_grads(x, g)):
        assert torch.equal(a, b)


@pytest.mark.card
def test_kernel_refuses_what_it_cannot_read(card):
    x, g = torch.rand((2, 64, 16), device=card), torch.rand((2, 64, 8), device=card)
    before = mw.mlp_wgrad.launches
    with pytest.raises(ValueError, match="not contiguous"):
        mw.weight_grads(x.transpose(1, 2).contiguous().transpose(1, 2), g)
    with pytest.raises(ValueError, match="float32"):
        mw.weight_grads(x.double(), g)
    assert mw.mlp_wgrad.launches == before


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------

def _plain_linear(p, x, compute_dtype, stacked):
    """Today's ops without the Function: autograd's own backward."""
    xo, wo = mnn._operand(x, compute_dtype), mnn._operand(p.w, compute_dtype)
    if stacked:
        return torch.bmm(xo, wo) + p.b.float()[:, None, :]
    return torch.matmul(xo, wo) + p.b.float()


@pytest.mark.parametrize("rows", (61, 1_024))
@pytest.mark.parametrize("x_grad", (True, False))
@pytest.mark.parametrize("compute_dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("stacked", (False, True))
def test_function_matches_autograd(stacked, compute_dtype, x_grad, rows):
    """The deformer's first layer (19 -> 32) and a colour head's (3 parts,
    70 -> 64): output, and x's, w's and b's gradients bit-equal to autograd
    through the plain ops; 1,024 rows is the pair regularizer's call."""
    gen = torch.Generator().manual_seed(rows)
    lead, din, dout = ((3,), 70, 64) if stacked else ((), 19, 32)
    w0 = torch.randn(lead + (din, dout), generator=gen)
    b0 = torch.randn(lead + (dout,), generator=gen)
    x0 = torch.randn(lead + (rows, din), generator=gen)
    g = torch.randn(lead + (rows, dout), generator=gen)
    got = []
    for fn in (None, _plain_linear):
        p = SimpleNamespace(w=w0.clone().requires_grad_(), b=b0.clone().requires_grad_())
        x = x0.clone().requires_grad_(x_grad)
        if fn is None:
            y = (mnn.linear_apply_stacked if stacked else mnn.linear_apply)(p, x, compute_dtype)
            assert y.grad_fn.name() == "_LinearBackward"
        else:
            y = fn(p, x, compute_dtype, stacked)
        y.backward(g)
        got.append((y.detach(), p.w.grad, p.b.grad, x.grad))
    for name, a, b in zip(("y", "w", "b", "x"), *got):
        if name == "x" and not x_grad:
            assert a is None and b is None
        else:
            assert torch.equal(a, b), name


def test_no_grad_calls_take_the_plain_ops(monkeypatch):
    """No gradient asked (no_grad, or nothing that requires one): no
    Function node, no weight-gradient call, the plain ops' numbers."""
    calls = []
    monkeypatch.setattr(mnn, "weight_grads", lambda x, g: calls.append(1))
    gen = torch.Generator().manual_seed(0)
    p = SimpleNamespace(w=torch.randn(3, 16, 8, generator=gen).requires_grad_(),
                        b=torch.randn(3, 8, generator=gen).requires_grad_())
    x = torch.randn(3, 40, 16, generator=gen)
    with torch.no_grad():
        y = mnn.linear_apply_stacked(p, x, torch.bfloat16)
    assert y.grad_fn is None
    assert torch.equal(y, _plain_linear(p, x, torch.bfloat16, True).detach())
    frozen = SimpleNamespace(w=p.w.detach(), b=p.b.detach())
    assert mnn.linear_apply_stacked(frozen, x, torch.bfloat16).grad_fn is None
    assert not calls


@pytest.mark.parametrize("remat", (False, True))
def test_fit_step_takes_the_function_on_every_layer(monkeypatch, remat):
    """One tiny train step on the CPU through the Function against the
    plain ops from the same state and draws: the loss and every gradient
    bit-equal, and ``train.step.mlp_wgrad_calls`` weight-gradient calls (a
    remat step recomputes the forward, not the backward)."""
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train.step import forward_backward, mlp_wgrad_calls
    cfg = make_cfg(CFG).merged(train_net.TINY).merged({"remat": remat})
    trainer = train_net.build_trainer(cfg, torch.device("cpu"), seed=0, tiny=True, eager=True)

    def grads(plain):
        calls, fn = [], mnn.weight_grads
        if plain:
            monkeypatch.setattr(mnn, "_linear", lambda x, w, b, stacked: _plain_linear(
                SimpleNamespace(w=w, b=b), x, None, stacked))
        monkeypatch.setattr(mnn, "weight_grads", lambda x, g: calls.append(1) or fn(x, g))
        for p in trainer.state.model.parameters():
            p.grad = None
        stats = forward_backward(trainer.mspec, trainer.rspec, trainer.lw, trainer.state,
                                 trainer.batch, torch.Generator().manual_seed(5))
        monkeypatch.undo()
        return (float(stats["loss"].detach()), len(calls),
                {n: p.grad.clone() for n, p in trainer.state.model.named_parameters()})
    loss_p, calls_p, g_p = grads(True)
    loss_f, calls_f, g_f = grads(False)
    assert calls_p == 0 and loss_f == loss_p
    assert calls_f == mlp_wgrad_calls(trainer.mspec, make_render_spec(cfg)) == 13
    for name, want in g_p.items():
        assert torch.equal(g_f[name], want), name


class _Fake:
    """What :func:`mw.wgrad_refusal` reads of a tensor."""

    def __init__(self, shape, dtype=torch.float32, device="cuda:0", contiguous=True):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device(device)
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous


@pytest.mark.parametrize("what,x,g", [
    ("float32", _Fake((2, 8, 4), torch.bfloat16), _Fake((2, 8, 4))),
    ("one CUDA device", _Fake((2, 8, 4), device="cpu"), _Fake((2, 8, 4))),
    (r"\(P, N, Din\)", _Fake((2, 8, 4)), _Fake((2, 9, 4))),
    ("not contiguous", _Fake((2, 8, 4), contiguous=False), _Fake((2, 8, 4))),
    ("widths", _Fake((2, 8, 1000)), _Fake((2, 8, 25))),
    ("parts", _Fake((70_000, 8, 4)), _Fake((70_000, 8, 4))),
])
def test_refusals(what, x, g):
    import re
    assert re.search(what, mw.wgrad_refusal(x, g))
    assert mw.wgrad_refusal(_Fake((2, 8, 4)), _Fake((2, 8, 3))) is None


def test_launch_arguments(monkeypatch):
    """The wrapper passes the operands, a scratch buffer of parts x slabs x
    (Din + 1) x Dout floats, the outputs, the sizes, the slab count and
    the current stream, and counts the launch; no rows, no launch."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(mw, "load_kernel", lambda: (launch, None))
    monkeypatch.setattr(mw, "_slabs", lambda dev, P, N, din, dout: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(mw.mlp_wgrad, "launches", 0)
    empty = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty.append(a[0]) or real_empty(*a, **k))
    x, g = torch.rand(3, 50, 19), torch.rand(3, 50, 17)
    dw, db = mw.mlp_wgrad(x, g)
    assert (dw.shape, db.shape) == ((3, 19, 17), (3, 17))
    assert empty[-1] == 3 * 7 * 20 * 17
    (args,) = calls
    assert args[:2] == (x.data_ptr(), g.data_ptr())
    assert args[3:] == (dw.data_ptr(), db.data_ptr(), 3, 50, 19, 17, 7, 1234)
    assert mw.mlp_wgrad.launches == 1
    dw, db = mw.mlp_wgrad(torch.rand(2, 0, 5), torch.rand(2, 0, 4))
    assert len(calls) == 1 and mw.mlp_wgrad.launches == 1
    assert not dw.any() and not db.any() and dw.shape == (2, 5, 4)


def test_fit_layers_are_a_steps_thirteen():
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train.step import mlp_wgrad_calls
    layers = fit_layers()
    cfg = make_cfg(CFG)
    assert len(layers) == mlp_wgrad_calls(inb.build_model_spec(cfg), make_render_spec(cfg))
    assert [(f[2], f[3], f[4], f[5]) for f in layers] == [
        (5, 32_768, 19, 64), (5, 32_768, 64, 17), (2, 32_768, 70, 64), (2, 32_768, 64, 64),
        (2, 32_768, 64, 3), (3, 32_768, 70, 64), (3, 32_768, 64, 3), (1, 90_112, 19, 32),
        (1, 90_112, 32, 32), (1, 90_112, 32, 3), (1, 1_024, 19, 32), (1, 1_024, 32, 32),
        (1, 1_024, 32, 3)]
