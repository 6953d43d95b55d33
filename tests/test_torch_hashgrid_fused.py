"""The fused hash-grid encoding (``csrc/hashgrid_encode.cu``), forward and
backward, against the plain chain, and the encoders' route.

Card tests (marker ``card``) skip without a CUDA card; on the card:

    python -m pytest --noconftest -m card tests/test_torch_hashgrid_fused.py

(``chip_smoke.py`` phase 17 runs the same cases, with the kernel's and the
plain chain's times at the render chunk's shape).  Every case holds the
kernel to ``tests/test_torch_hashgrid.py``'s tolerance against the plain
chain on the card: inb_377's five part grids (bf16 and float32 tables), the
deformer's F=2 concat grid (float32), non-scalar part grids, and one spec of
each other mode, with tables drawn at an initial model's scale and at a
trained one's (std 0.1 and 1.0), over 1.1 M points, some outside the box
and some on cell boundaries, in segments that are not multiples of the
kernel's 32-point blocks.  A control, the plain chain with its lerp and
corner sum in bfloat16, must fail that tolerance at the trained scale: the
test sees the lerp's precision.

The backward (``hashgrid_backward_kernel``, through the autograd Function
``hg.fused_autograd_encode``): on the card at the fit step's shapes (the
part grids over the 90,112 budget slots, the deformer over the same slots
and over the pair term's 1,024) the records it hands the scatter kernels
are bit-equal to those the plain chain's autograd hands them, its points'
gradient is bit-equal to its plain PyTorch twin
(``hg.encode_backward_plain``) run on the card, and within
:data:`POINTS_LIMIT` of the element's term scale (:func:`term_scale`) of a
float64 plain chain, which a bfloat16 lerp fails (``chip_smoke.py`` phase
18 runs the same cases and times them).  On the CPU the twin is held to
autograd through the plain chain in every gather layout: records and table
gradients bit-equal, the points' gradient within TOL in units of the term
scale.

CPU tests: the route rule, the gradient state that feeds it, the counters,
the refusals (a CUDA call the kernels cannot take raises), and the
launches' arguments through stub launch functions.  This file imports
nothing of JAX, so the card's machine runs it.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.ops import hashgrid as hg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "inb", "inb_377.yaml")
TOL = dict(rtol=1e-5, atol=1e-6)       # tests/test_torch_hashgrid.py's
SCALES = (0.1, 1.0)                    # table std: an initial model's, a trained one's
# part-major segments, none a multiple of the kernel's 32-point blocks
SEGMENTS = (400_001, 300_003, 200_007, 100_011, 100_013)
BOUNDARY_POINTS = 20_011               # a part's points on cell boundaries


def model_spec():
    return inb.build_model_spec(make_cfg(CFG))


def part_bounds() -> np.ndarray:
    """(5, 2, 3) inb_377's part boxes (its ``partnet.<part>.bbox``)."""
    cfg = make_cfg(CFG)
    return np.asarray([cfg.partnet[p].bbox for p in inb.lbs.PARTNAMES], np.float32)


CASES = ("parts-bf16", "parts-f32", "deformer-f32", "parts-rows-bf16", "body-cube-f32",
         "body-rows-f32", "level-sum-f32")


def cases():
    """[(name, kind, specs, table dtype)] in :data:`CASES`' order: ``multi``
    cases go through :func:`hg.multi_hashgrid_encode`, ``single`` through
    :func:`hg.hashgrid_encode` (one spec)."""
    spec = model_spec()
    parts = tuple(spec.part_embeds)
    rows = tuple(s._replace(scalar=False) for s in parts)   # RAdam's or SGD's tables
    body = parts[0]
    level_sum = hg.make_hashgrid_spec(n_levels=16, n_features_per_level=4,
                                      log2_hashmap_size=15, base_resolution=2,
                                      sum=True, sum_over_features=False)
    return [("parts-bf16", "multi", parts, torch.bfloat16),
            ("parts-f32", "multi", parts, torch.float32),
            ("deformer-f32", "single", (spec.deformer.embed,), torch.float32),
            ("parts-rows-bf16", "multi", rows, torch.bfloat16),
            ("body-cube-f32", "single", (body,), torch.float32),
            ("body-rows-f32", "single", (rows[0],), torch.float32),
            ("level-sum-f32", "single", (level_sum,), torch.float32)]


def draw_tables(specs, std: float, dtype, gen, device):
    """Each spec's {'dense', 'hash'}: N(0, std^2), drawn in float32, then
    cast to ``dtype`` (as ``models/inb.py:_cast_tables`` casts)."""
    out = []
    for s in specs:
        cols = () if s.scalar else (s.n_features,)
        out.append({name: (std * torch.randn((rows,) + cols, generator=gen,
                                             device=device)).to(dtype)
                    for name, rows in (("dense", s.dense_rows), ("hash", s.hash_rows))})
    return out


def draw_points(specs, kind: str, gen, device, segs=None):
    """(pts, bounds, seg_sizes) of two sets: 'box', points with x01 in
    [-0.05, 1.05] in each part's box (inb_377's part boxes; the unit box
    for a single spec), in segments ``segs`` (default :data:`SEGMENTS`);
    'boundary', points in the unit box whose coordinates are k / 64 or
    float32(k / (res - 1)) for the specs' level sizes, so that x01 (res - 1)
    is integral or one ulp off it."""
    P = len(specs)
    if segs is None:
        segs = SEGMENTS[:P] if kind == "multi" else (sum(SEGMENTS),)
    segs = tuple(int(n) for n in segs)
    unit = np.tile(np.asarray([[0, 0, 0], [1, 1, 1]], np.float32), (P, 1, 1))
    boxes = part_bounds()[:P] if kind == "multi" else unit
    b = torch.from_numpy(boxes).to(device)
    x01 = -0.05 + 1.1 * torch.rand((sum(segs), 3), generator=gen, device=device)
    pid = torch.repeat_interleave(torch.arange(P, device=device),
                                  torch.tensor(segs, device=device))
    box = b[pid, 0] + x01 * (b[pid, 1] - b[pid, 0])
    # boundary coordinates: dyadic ones, and k / (res - 1) of every level
    cand = [np.arange(65, dtype=np.float64) / 64]
    for s in specs:
        for n in s.entries_num:
            cand.append(np.arange(n, dtype=np.float64) / max(n - 1, 1))
    cand = torch.from_numpy(np.concatenate(cand).astype(np.float32)).to(device)
    bsegs = (BOUNDARY_POINTS,) * P
    pick = torch.randint(0, cand.numel(), (sum(bsegs), 3), generator=gen, device=device)
    boundary = cand[pick]
    return {"box": (box, b.reshape(P, 2, 3), segs),
            "boundary": (boundary, torch.from_numpy(unit).to(device), bsegs)}


def encode(kind, specs, tables, pts, bounds, segs, plain=False):
    if kind == "multi":
        fn = hg.multi_hashgrid_encode_plain if plain else hg.multi_hashgrid_encode
        return fn(specs, tables, pts, bounds, segs)
    fn = hg.hashgrid_encode_plain if plain else hg.hashgrid_encode
    return fn(specs[0], tables[0], pts, bounds[0])


def bf16_lerp_parts(specs, tables, pts, bounds, segs):
    """The control: :func:`hg.multi_hashgrid_encode_plain` with its lerp and
    its corner sum in bfloat16 (same corners, rows and weights)."""
    P, dev = len(specs), pts.device
    pid = torch.repeat_interleave(torch.arange(P, device=dev), torch.tensor(segs, device=dev))
    b = bounds[pid]
    x01 = (pts - b[:, 0]) / (b[:, 1] - b[:, 0])
    offs = np.cumsum((0,) + tuple(segs))
    outs = []
    for p, s in enumerate(specs):
        o, e = int(offs[p]), int(offs[p + 1])
        res = torch.tensor(s.entries_num, dtype=torch.int32, device=dev)[:, None]
        idx3, w = hg._corners(x01[o:e], res)
        S = s.start_hash
        blocks = []
        for name, _, _ in s.tables():
            if name == "dense":
                n = res[:S].long()[:, :, None]
                ind = idx3[0][:S] * (n * n) + idx3[1][:S] * n + idx3[2][:S]
                ind, ws = ind + hg._dense_offsets(s, dev), w[:S]
            else:
                ind = hg._hash_index([i[S:] for i in idx3], s.primes, s.table_size)
                ind, ws = ind + hg._hash_offsets(s, dev), w[S:]
            v = tables[p][name][ind].to(torch.bfloat16)
            v = v * s.n_features if s.scalar else torch.sum(v, dim=-1)
            blocks.append(torch.sum(ws.to(torch.bfloat16) * v, dim=1))
        outs.append(torch.cat(blocks, dim=0).T.float())
    return torch.cat([x01, torch.cat(outs, dim=0)], dim=-1)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Max abs error, the share of bit-equal values, and whether ``got``
    holds TOL against ``want``."""
    err = (got - want).abs()
    bad = err > TOL["atol"] + TOL["rtol"] * want.abs()
    return {"max_abs_err": float(err.max()), "bit_equal": float((got == want).float().mean()),
            "over_tol": int(bad.sum()), "ok": not bool(bad.any())}


def run_case(name, kind, specs, dtype, std, device, seed=0):
    """The kernel (through the public route, under no_grad) against the
    plain chain on both point sets -> {set: compare(...)}; raises if the
    call did not launch the kernel exactly once."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = draw_tables(specs, std, dtype, gen, device)
    res = {}
    for set_name, (pts, bounds, segs) in draw_points(specs, kind, gen, device).items():
        with torch.no_grad():
            before = (hg.fused_encode.launches, hg.fused_encode_backward.launches)
            got = encode(kind, specs, tables, pts, bounds, segs)
            after = (hg.fused_encode.launches, hg.fused_encode_backward.launches)
            if after != (before[0] + 1, before[1]):
                raise AssertionError(f"{name}: the call did not launch the forward alone "
                                     f"(launches, backward launches) {before} -> {after}")
            want = encode(kind, specs, tables, pts, bounds, segs, plain=True)
        res[set_name] = compare(got, want)
    return res


def control_case(std, device, seed=0):
    """The bf16-lerp control on inb_377's part grids (bf16 tables) against
    the plain chain: compare(...) of the box points."""
    _, _, specs, dtype = cases()[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = draw_tables(specs, std, dtype, gen, device)
    pts, bounds, segs = draw_points(specs, "multi", gen, device)["box"]
    with torch.no_grad():
        want = hg.multi_hashgrid_encode_plain(specs, tables, pts, bounds, segs)
        return compare(bf16_lerp_parts(specs, tables, pts, bounds, segs), want)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("std", SCALES)
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_chain(card, case, std):
    name, kind, specs, dtype = cases()[CASES.index(case)]
    for set_name, r in run_case(name, kind, specs, dtype, std, card).items():
        assert r["ok"], (name, std, set_name, r)


@pytest.mark.card
def test_bf16_lerp_control_fails_tolerance(card):
    """The check sees the lerp's precision: bfloat16 there fails TOL at a
    trained model's table scale."""
    assert not control_case(1.0, card)["ok"]


# --------------------------------------------------------------------------
# on the CPU: the route
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device_type,needs_grad,refusal,want", [
    ("cuda", False, None, "fused"),
    ("cuda", False, "a reason", ValueError),
    ("cuda", True, None, "grad"),
    ("cuda", True, "a reason", ValueError),
    ("cpu", False, None, "plain"),
    ("cpu", False, "a reason", "plain"),
    ("cpu", True, None, "plain"),
    ("cpu", True, "a reason", "plain"),
])
def test_encode_route_rule(device_type, needs_grad, refusal, want):
    """CUDA points take the forward kernel with no gradient asked and the
    autograd Function of both kernels with one, and raise with the reason
    where the kernels refuse the call; the CPU takes the plain chain."""
    if want is ValueError:
        with pytest.raises(ValueError, match=refusal):
            hg.encode_route(device_type, needs_grad, refusal)
    else:
        assert hg.encode_route(device_type, needs_grad, refusal) == want


def _tiny(scalar=True, **kw):
    spec = hg.make_hashgrid_spec(n_levels=4, n_features_per_level=2, log2_hashmap_size=6,
                                 base_resolution=2, scalar_tables=scalar, **kw)
    tables = hg.HashTables(spec)
    tables.reset_parameters(torch.Generator().manual_seed(0))
    return spec, tables


@pytest.mark.parametrize("grad_mode", ["no_grad", "inference_mode", "detached",
                                       "enabled_table", "enabled_points"])
def test_route_follows_the_gradient_state(monkeypatch, grad_mode):
    """On a CUDA decision, no_grad, inference_mode and inputs that require
    no gradient take the forward kernel; with gradients enabled, a table or
    points that require one take the autograd Function; deciding launches
    nothing."""
    monkeypatch.setattr(hg.fused_encode, "launches", 0)
    monkeypatch.setattr(hg.fused_encode_backward, "launches", 0)
    spec, tables = _tiny()
    pts = torch.rand(10, 3)
    bounds = torch.tensor([[0.0, 0, 0], [1, 1, 1]])
    tabs = tables.tables()
    ctx = contextlib.nullcontext()
    if grad_mode == "no_grad":
        ctx = torch.no_grad()
    elif grad_mode == "inference_mode":
        ctx = torch.inference_mode()
    elif grad_mode == "detached":
        tabs = {k: v.detach() for k, v in tabs.items()}
    elif grad_mode == "enabled_points":
        tabs = {k: v.detach() for k, v in tabs.items()}
        pts.requires_grad_(True)
    with ctx:
        route = hg._route("cuda", [pts, bounds, *tabs.values()], lambda: None)
    want = "grad" if grad_mode.startswith("enabled") else "fused"
    assert route == want
    assert (hg.fused_encode.launches, hg.fused_encode_backward.launches) == (0, 0)


def test_route_raises_on_a_refused_no_grad_cuda_call(monkeypatch):
    """A CUDA call the kernels cannot take raises with the reason, with or
    without a gradient asked, and launches nothing; a CPU call never asks
    the kernels."""
    monkeypatch.setattr(hg.fused_encode, "launches", 0)
    monkeypatch.setattr(hg.fused_encode_backward, "launches", 0)
    asked = []

    def refusal():
        asked.append(1)
        return "the reason"
    pts = torch.rand(4, 3)
    with torch.no_grad():
        with pytest.raises(ValueError, match="the reason"):
            hg._route("cuda", [pts], refusal)
        assert hg._route("cpu", [pts], refusal) == "plain"
    assert len(asked) == 1
    with pytest.raises(ValueError, match="the reason"):
        hg._route("cuda", [pts.requires_grad_(True)], refusal)
    assert hg._route("cpu", [pts], refusal) == "plain"
    assert len(asked) == 2
    assert (hg.fused_encode.launches, hg.fused_encode_backward.launches) == (0, 0)


def _stub_launch(monkeypatch):
    """A launch function that records its arguments by name (host arrays
    copied) and launches nothing; the CUDA device context and stream
    stubbed for CPU tensors."""
    calls = []
    names = ("pts", "out", "n_points", "n_parts", "seg", "ptrs", "ints", "n_levels",
             "n_features", "values_per_row", "bf16", "mode", "multi_order", "include_input",
             "out_dim", "primes", "stream")

    def launch(*args):
        a = dict(zip(names, args))
        P, L = a["n_parts"], a["n_levels"]
        for key, dtype, n in (("seg", np.int32, P + 1), ("ptrs", np.uint64, 3 * P),
                              ("ints", np.int32, P * (2 + 2 * L)), ("primes", np.uint32, 3)):
            buf = (ctypes.c_char * (np.dtype(dtype).itemsize * n)).from_address(a[key])
            a[key] = np.frombuffer(bytes(buf), dtype=dtype).copy()
        calls.append(a)
        return 0
    monkeypatch.setattr(hg, "load_fused_kernel", lambda: launch)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(hg.fused_encode, "launches", 0)
    return calls


def test_cpu_points_take_the_plain_chain(monkeypatch):
    """On the CPU the encoders give the plain chain's output and launch and
    count nothing, whatever the gradient state."""
    calls = _stub_launch(monkeypatch)
    monkeypatch.setattr(hg.fused_encode_backward, "launches", 0)
    spec, tables = _tiny()
    pts = torch.rand(40, 3)
    bounds = torch.tensor([[0.0, 0, 0], [1, 1, 1]])
    with torch.no_grad():
        got = hg.hashgrid_encode(spec, tables.tables(), pts, bounds)
        want = hg.hashgrid_encode_plain(spec, tables.tables(), pts, bounds)
        multi = hg.multi_hashgrid_encode((spec, spec), [tables.tables()] * 2, pts,
                                         torch.stack([bounds, bounds]), (15, 25))
        multi_want = hg.multi_hashgrid_encode_plain((spec, spec), [tables.tables()] * 2,
                                                    pts, torch.stack([bounds, bounds]),
                                                    (15, 25))
    assert torch.equal(got, want) and torch.equal(multi, multi_want)
    grad = hg.hashgrid_encode(spec, tables.tables(), pts, bounds)
    assert grad.requires_grad and grad.grad_fn.name() != "_FusedEncodeBackward"
    assert torch.equal(grad.detach(), want)
    grad.sum().backward()
    assert not calls and hg.fused_encode.launches == 0
    assert hg.fused_encode_backward.launches == 0


def test_fused_encode_launch_arguments(monkeypatch):
    """One launch a call with the part-major segments, each part's tables,
    bounds row and level constants, the mode of the calling order, and the
    stream; the counter counts it; no launch for no points."""
    calls = _stub_launch(monkeypatch)
    spec = model_spec()
    parts = spec.part_embeds
    tables = [{"dense": torch.zeros(s.dense_rows, dtype=torch.bfloat16),
               "hash": torch.zeros(s.hash_rows, dtype=torch.bfloat16)} for s in parts]
    segs = (33, 1, 0, 70, 5)
    pts = torch.rand(sum(segs), 3)
    bounds = torch.from_numpy(part_bounds())
    assert hg.fused_refusal(parts, tables, pts, bounds, segs) is None
    out = hg.fused_encode(parts, tables, pts, bounds, segs)
    assert out.shape == (sum(segs), parts[0].out_dim) and out.dtype == torch.float32
    assert hg.fused_encode.launches == 1 and len(calls) == 1
    a = calls[0]
    L = parts[0].n_levels
    assert (a["pts"], a["out"], a["n_points"], a["n_parts"]) == (
        pts.data_ptr(), out.data_ptr(), sum(segs), 5)
    assert (a["n_levels"], a["n_features"], a["values_per_row"], a["bf16"], a["mode"],
            a["multi_order"], a["include_input"], a["out_dim"], a["stream"]) == (
                L, 16, 1, 1, hg._SCALAR, 1, 1, 19, 1234)
    assert a["seg"].tolist() == [0, 33, 34, 34, 104, 109]
    ptrs = a["ptrs"].reshape(5, 3)
    for p, t in enumerate(tables):
        assert ptrs[p].tolist() == [t["dense"].data_ptr(), t["hash"].data_ptr(),
                                    bounds.data_ptr() + 24 * p]
    ints = a["ints"].reshape(5, -1)
    for p, s in enumerate(parts):
        assert ints[p, :2].tolist() == [s.start_hash, s.table_size]
        assert ints[p, 2:2 + L].tolist() == list(s.entries_num)
        assert ints[p, 2 + L:2 + L + s.start_hash].tolist() == list(s.dense_offsets)
    assert a["primes"].tolist() == list(parts[0].primes)
    # the deformer's concat grid through hashgrid_encode's order; no points
    d = spec.deformer.embed
    dt = {"dense": torch.zeros(d.dense_rows, 2), "hash": torch.zeros(d.hash_rows, 2)}
    hg.fused_encode((d,), (dt,), torch.rand(7, 3), torch.rand(1, 2, 3), (7,), multi=False)
    a = calls[-1]
    assert (a["values_per_row"], a["bf16"], a["mode"], a["multi_order"], a["out_dim"]) == (
        2, 0, hg._CONCAT, 0, 19)
    assert hg.fused_encode((d,), (dt,), torch.rand(0, 3), torch.rand(1, 2, 3), (0,)).shape == (0, 19)
    assert hg.fused_encode.launches == 2


@pytest.mark.parametrize("what", ["f16_tables", "mixed_dtypes", "strided_table", "wide_concat",
                                  "f64_points", "features_3", "too_many_parts"])
def test_fused_route_refuses(what, monkeypatch):
    """What the kernel does not take has a reason, and a no-grad CUDA call
    of it raises with that reason and launches nothing."""
    spec, tables = _tiny(scalar=False, sum=False)
    specs, tabs = [spec], [dict(tables.tables())]
    pts, bounds, segs = torch.rand(8, 3), torch.rand(1, 2, 3), (8,)
    assert hg.fused_refusal(specs, tabs, pts, bounds, segs) is None
    if what == "f16_tables":
        tabs = [{k: v.half() for k, v in tabs[0].items()}]
    elif what == "mixed_dtypes":
        tabs[0]["hash"] = tabs[0]["hash"].bfloat16()
    elif what == "strided_table":
        tabs[0]["dense"] = torch.zeros(tabs[0]["dense"].shape[::-1]).T
    elif what == "wide_concat":
        specs = [hg.make_hashgrid_spec(n_levels=32, n_features_per_level=16,
                                       log2_hashmap_size=6, sum=False)]
        tabs = [{"dense": torch.zeros(specs[0].dense_rows, 16),
                 "hash": torch.zeros(specs[0].hash_rows, 16)}]
    elif what == "f64_points":
        pts = pts.double()
    elif what == "features_3":
        specs = [hg.make_hashgrid_spec(n_levels=4, n_features_per_level=3,
                                       log2_hashmap_size=6, sum=False)]
        tabs = [{"dense": torch.zeros(specs[0].dense_rows, 3),
                 "hash": torch.zeros(specs[0].hash_rows, 3)}]
    elif what == "too_many_parts":         # scalar part grids, as multi_hashgrid_encode takes
        spec, tables = _tiny()
        specs, tabs = [spec] * 9, [dict(tables.tables())] * 9
        bounds, segs = torch.rand(9, 2, 3), (1,) * 8 + (0,)
    reason = hg.fused_refusal(specs, tabs, pts, bounds, segs)
    assert isinstance(reason, str) and reason
    calls = _stub_launch(monkeypatch)
    route = hg._route            # the CPU points decided as CUDA points
    monkeypatch.setattr(hg, "_route", lambda device_type, *a: route("cuda", *a))
    with torch.no_grad(), pytest.raises(ValueError, match=re.escape(reason)):
        if len(specs) == 1:
            hg.hashgrid_encode(specs[0], tabs[0], pts, bounds[0])
        else:
            hg.multi_hashgrid_encode(specs, tabs, pts, bounds, segs)
    assert not calls and hg.fused_encode.launches == 0


def test_mode_by_spec():
    spec = model_spec()
    part, d = spec.part_embeds[0], spec.deformer.embed
    assert hg._fused_mode(part) == hg._SCALAR
    assert hg._fused_mode(part._replace(scalar=False)) == hg._LEVEL_SUM
    assert hg._fused_mode(d) == hg._CONCAT
    level_sum = hg.make_hashgrid_spec(n_levels=4, n_features_per_level=2, sum=True,
                                      sum_over_features=False)
    assert hg._fused_mode(level_sum) == hg._FEATURE_SUM


# --------------------------------------------------------------------------
# the backward
# --------------------------------------------------------------------------

# the fit step's encoder calls: the part grids over the budget slots (cull
# 0.25 of 262,144 samples, part budgets 0.5 x [1, 0.75, 0.5, 0.25, 0.25]),
# the deformer over the same slots and over the pair term's
FIT_SEGMENTS = (32_768, 24_576, 16_384, 8_192, 8_192)
PAIR_SLOTS = 1_024
# the points' gradient against a float64 plain chain, in units of the
# element's term scale (term_scale).  float32 rounding of the forward's own
# inputs (x01, x01 (res - 1)) moves each offset by up to 2^-24 (res - 1),
# which reads up to 1.2e-4 of the scale on the plain chain and on the
# kernel's twin alike (80,035 points, median 8.6e-7); a bfloat16 lerp reads
# a median of 2.8e-4 and a 99th percentile of 1.7e-3.
POINTS_LIMIT = 1e-3


@contextlib.contextmanager
def spy_scatters():
    """Every record set handed to the table-gradient scatters inside the
    block, as (route, int32 keys, payload, n_rows, level_offsets), copied."""
    from instant_nvr_tpu_torch.ops import scatter
    got, kernels, exact = [], dict(hg._SCATTER), scatter.exact_scatter_add

    def spy(route, fn):
        def call(keys, payload, n_rows, level_offsets=()):
            got.append((route, keys.clone(), payload.clone(), n_rows, tuple(level_offsets)))
            return fn(keys, payload, n_rows, level_offsets)
        return call

    def spy_exact(keys, g, n_rows):
        got.append(("exact", keys.reshape(-1).to(torch.int32), g.clone(), n_rows, ()))
        return exact(keys, g, n_rows)
    spy_exact.calls = exact.calls       # the original counts through the module's name
    hg._SCATTER.update({route: spy(route, fn) for route, fn in kernels.items()})
    scatter.exact_scatter_add = spy_exact
    try:
        yield got
    finally:
        hg._SCATTER.update(kernels)
        scatter.exact_scatter_add = exact
        exact.calls = spy_exact.calls


def _record_key(r):
    route, keys, payload, n_rows, offs = r
    return (route, n_rows, offs, keys.cpu().numpy().tobytes(),
            payload.float().cpu().numpy().tobytes())


def records_equal(a, b) -> bool:
    """Two spied record sets hold the same calls, in any order: route,
    table, keys and payload (dtype, shape and bits)."""
    if len(a) != len(b):
        return False
    for x, y in zip(sorted(a, key=_record_key), sorted(b, key=_record_key)):
        if x[0] != y[0] or x[3:] != y[3:] or not torch.equal(x[1], y[1]):
            return False
        if x[2].dtype != y[2].dtype or x[2].shape != y[2].shape:
            return False
        if not torch.equal(x[2].view(-1).cpu().float(), y[2].view(-1).cpu().float()):
            return False
    return True


def pool_tables(specs, std, dtype, gen, device):
    """Each spec's {'dense', 'hash'} at std ``std``: a pool of 65,537 normal
    draws repeated over the rows (the full-size part tables in a tenth of
    the time of a draw each)."""
    pool = std * torch.randn(65_537, generator=gen)
    out = []
    for s in specs:
        cols = () if s.scalar else (s.n_features,)
        tabs = {}
        for name, rows in (("dense", s.dense_rows), ("hash", s.hash_rows)):
            n = rows * (1 if s.scalar else s.n_features)
            tabs[name] = (pool.repeat(-(-n // pool.numel()))[:n].reshape((rows,) + cols)
                          .to(device=device, dtype=dtype))
        out.append(tabs)
    return out


def leaf_tables(tables):
    return [{k: v.detach().clone().requires_grad_(True) for k, v in t.items()} for t in tables]


def autograd_run(fn, kind, specs, tables, pts, bounds, segs, g, need_pts=True):
    """``fn`` (the plain chain or the Function) forward and backward with
    cotangent ``g`` -> (output, spied records, points' gradient, tables'
    gradients)."""
    leaves = leaf_tables(tables)
    x = pts.detach().clone().requires_grad_(need_pts)
    with spy_scatters() as records:
        out = fn(kind, specs, leaves, x, bounds, segs)
        out.backward(g)
    return out.detach(), records, x.grad, [v.grad for t in leaves for v in t.values()]


def plain_fn(kind, specs, tables, pts, bounds, segs):
    return encode(kind, specs, tables, pts, bounds, segs, plain=True)


def function_fn(kind, specs, tables, pts, bounds, segs):
    b = bounds if kind == "multi" else bounds[0]
    return hg.fused_autograd_encode(specs, tables, pts, b, segs, multi=kind == "multi")


def term_scale(kind, specs, tables, pts, bounds, segs, g) -> torch.Tensor:
    """(M, 3) float64: each point's sum over levels and corners of
    |g v d w / d x|, the cotangent of the level's value(s) times the
    corner's row value(s) (for scalar grids times F) times the derivative of
    the corner's weight along x: the size of the terms its gradient sums."""
    out = torch.zeros((pts.shape[0], 3), dtype=torch.float64, device=pts.device)
    b = bounds.reshape(-1, 2, 3)
    offs = np.cumsum((0,) + tuple(segs))
    cb = torch.from_numpy(hg._corner_bits()).to(pts.device).bool()
    for p, s in enumerate(specs):
        o, e = int(offs[p]), int(offs[p + 1])
        if e == o:
            continue
        x01 = (pts[o:e] - b[p, 0]) / (b[p, 1] - b[p, 0])
        res = torch.tensor(s.entries_num, dtype=torch.int32, device=pts.device)[:, None]
        idx3, _ = hg._corners(x01, res)
        S, L = s.start_hash, s.n_levels
        ind = torch.empty_like(idx3[0])
        n = res.long()[:, :, None]
        ind[:S] = (idx3[0][:S] * n[:S] * n[:S] + idx3[1][:S] * n[:S] + idx3[2][:S]
                   + hg._dense_offsets(s, pts.device))
        ind[S:] = (hg._hash_index([i[S:] for i in idx3], s.primes, s.table_size)
                   + hg._hash_offsets(s, pts.device))
        V = 1 if s.scalar else s.n_features
        v = torch.empty(ind.shape + (V,), dtype=torch.float64, device=pts.device)
        for name, lo, hi in (("dense", 0, S), ("hash", S, L)):
            v[lo:hi] = tables[p][name][ind[lo:hi]].reshape((hi - lo,) + ind.shape[1:] + (V,)).double()
        ge = hg._level_cotangent(s, g[o:e].double())                      # (L, V, kp)
        gv = (ge.permute(0, 2, 1)[:, None] * v).abs().sum(-1)              # (L, 8, kp)
        if s.scalar:
            gv = gv * s.n_features
        scale = res.double() - 1.0
        wd = []
        for d in range(3):
            fd = x01[:, d].double()[None] * scale
            lo_d = torch.clamp(x01[:, d][None].float().mul(scale.float()).to(torch.int32).long(),
                               min=0).minimum(res.long() - 1).double()
            off = fd - lo_d
            wd.append(torch.where(cb[:, d][None, :, None], off[:, None], 1 - off[:, None]).abs())
        dw = (wd[1] * wd[2], wd[0] * wd[2], wd[0] * wd[1])
        for d in range(3):
            ext = float(b[p, 1, d] - b[p, 0, d])
            out[o:e, d] = (gv * dw[d] * scale[:, :, None]).sum((0, 1)) / abs(ext)
    return out


def float64_points_grad(kind, specs, tables, pts, bounds, segs, g, lerp=None):
    """The points' gradient of a float64 plain chain, taking the
    normalised points as float32 computes them (x01, then the float64
    chain on the unit box), and the points whose corner cells agree with
    float32's at every level (where the gradient is the same function).
    ``lerp``: the float32 chain to differentiate in float64's place (the
    bfloat16 control)."""
    P = len(specs)
    b = bounds.reshape(-1, 2, 3)
    pid = torch.repeat_interleave(torch.arange(P, device=pts.device),
                                  torch.tensor(segs, device=pts.device))
    ext = b[pid, 1] - b[pid, 0]
    x01 = (pts - b[pid, 0]) / ext
    if lerp is not None:
        x = pts.detach().clone().requires_grad_(True)
        lerp(specs, tables, x, bounds, segs).backward(g)
        grad = x.grad.double()
    else:
        x = x01.double().requires_grad_(True)
        unit = torch.tensor([[0.0, 0, 0], [1, 1, 1]], dtype=torch.float64, device=pts.device)
        t64 = [{k: v.double() for k, v in t.items()} for t in tables]
        out = (hg.multi_hashgrid_encode_plain(specs, t64, x, unit.expand(P, 2, 3), segs)
               if kind == "multi" else hg.hashgrid_encode_plain(specs[0], t64[0], x, unit))
        out.backward(g.double())
        grad = x.grad / ext.double()
    same = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    offs = np.cumsum((0,) + tuple(segs))
    for p, s in enumerate(specs):
        o, e = int(offs[p]), int(offs[p + 1])
        res = torch.tensor(s.entries_num, dtype=torch.int32, device=pts.device)[:, None]
        a, _ = hg._corners(x01[o:e], res)
        c, _ = hg._corners(x01[o:e].double(), res)
        for i in range(3):
            same[o:e] &= (a[i] == c[i]).all(0).all(0)
    return grad, same


def points_gap(got, want, scale, same) -> dict:
    """The gap of a points' gradient to the float64 one in units of the
    term scale, over the points whose cells agree."""
    r = ((got.double() - want).abs() / scale)[same]
    return {"max_over_scale": float(r.max()), "median_over_scale": float(r.median()),
            "over_limit": int((r > POINTS_LIMIT).sum()), "cells_differ": int((~same).sum()),
            "ok": bool((r <= POINTS_LIMIT).all())}


BACKWARD_CASES = ("parts-fit", "deformer-fit", "pair-deformer-fit")


def backward_case(name, device, std=0.1, seed=0):
    """The Function's backward on the card at a fit step's shape
    (:data:`BACKWARD_CASES`) against the plain chain's autograd: the
    records bit-equal, the points' gradient bit-equal to the twin on the
    same device and within :data:`POINTS_LIMIT` of the float64 chain (the
    part grids' points only take a gradient in the fit; the deformer's are
    held too).  Returns the readings; raises if the backward kernel did not
    launch once."""
    spec = model_spec()
    if name == "parts-fit":
        kind, specs, dtype, segs = "multi", spec.part_embeds, torch.bfloat16, FIT_SEGMENTS
    else:
        kind, specs, dtype = "single", (spec.deformer.embed,), torch.float32
        segs = (sum(FIT_SEGMENTS),) if name == "deformer-fit" else (PAIR_SLOTS,)
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = draw_tables(specs, std, dtype, gen, device)
    pts, bounds, segs = draw_points(specs, kind, gen, device, segs)["box"]
    g = torch.randn((sum(segs), specs[0].out_dim), generator=gen, device=device)
    before = hg.fused_encode_backward.launches
    out_f, rec_f, x_f, _ = autograd_run(function_fn, kind, specs, tables, pts, bounds, segs, g)
    if hg.fused_encode_backward.launches != before + 1:
        raise AssertionError(f"{name}: {hg.fused_encode_backward.launches - before} "
                             f"backward launches, not 1")
    out_p, rec_p, x_p, _ = autograd_run(plain_fn, kind, specs, tables, pts, bounds, segs, g)
    b = bounds if kind == "multi" else bounds[:1]
    _, _, x_twin = hg.encode_backward_plain(specs, tables, pts, b, segs, g, kind == "multi",
                                            True, hg.payload_dtype(specs[0], dtype))
    scale = term_scale(kind, specs, tables, pts, b, segs, g)
    want, same = float64_points_grad(kind, specs, tables, pts, b, segs, g)
    res = {"points": sum(segs), "records": len(rec_f),
           "records_equal": records_equal(rec_f, rec_p),
           "forward_equal": bool(torch.equal(out_f, out_p)),
           "points_bit_equal_twin": bool(torch.equal(x_f, x_twin)),
           "points_vs_float64": points_gap(x_f, want, scale, same),
           "plain_vs_float64": points_gap(x_p, want, scale, same)}
    if kind == "multi":
        ctl, _ = float64_points_grad(kind, specs, tables, pts, b, segs, g, lerp=bf16_lerp_parts)
        res["bf16_lerp_vs_float64"] = points_gap(ctl, want, scale, same)
    return res


@pytest.mark.card
@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_backward_kernel_at_fit_shapes(card, case):
    r = backward_case(case, card)
    assert r["records_equal"] and r["forward_equal"], (case, r)
    assert r["points_bit_equal_twin"] and r["points_vs_float64"]["ok"], (case, r)
    assert r["points_vs_float64"]["cells_differ"] < 0.001 * r["points"], (case, r)
    if "bf16_lerp_vs_float64" in r:
        assert not r["bf16_lerp_vs_float64"]["ok"], (case, r)


# on the CPU: the twin against autograd through the plain chain

TWIN_CASES = ("parts-scalar", "single-scalar", "deformer-columns", "parts-rows",
              "exact-grads", "sorted-grads")


def twin_case(name):
    """(kind, specs, table dtype, segments) of a gather layout: inb_377's
    five scalar part grids (bf16, Adam's), one scalar grid, the deformer's
    F=2 concat read by column, non-scalar part grids whose large dense
    table is read by row and the others by column (RAdam's and SGD's), and the part
    grids under ``grid_compute_dtype: float32`` (f32 tables, exact
    gradients) and ``fix_random`` (the sorted kernel's route)."""
    spec = model_spec()
    parts, segs5 = spec.part_embeds, (70, 50, 30, 20, 13)
    if name == "parts-scalar":
        return "multi", parts, torch.bfloat16, segs5
    if name == "single-scalar":
        return "single", parts[:1], torch.bfloat16, (97,)
    if name == "deformer-columns":
        return "single", (spec.deformer.embed,), torch.float32, (97,)
    if name == "parts-rows":
        rows = tuple(hg.make_hashgrid_spec(n_levels=12, n_features_per_level=4,
                                           log2_hashmap_size=l, scalar_tables=False,
                                           primes=parts[0].primes) for l in (17, 10))
        assert [hg.gather_plan(rows[0], r) for _, r, _ in rows[0].tables()] == ["rows", "columns"]
        return "multi", rows, torch.bfloat16, (60, 41)
    if name == "exact-grads":
        return "multi", tuple(s._replace(exact_grads=True) for s in parts), torch.float32, segs5
    return "multi", tuple(s._replace(sorted_grads=True) for s in parts), torch.bfloat16, segs5


@pytest.mark.parametrize("case", TWIN_CASES)
def test_backward_twin_matches_autograd(case):
    """The Function on CPU tensors (the plain forward and
    ``encode_backward_plain``) against autograd through the plain chain:
    the same output, the records handed to the scatters bit-equal (keys,
    payload dtype and bits, route, table), the tables' gradients bit-equal,
    and the points' gradient within TOL with ``atol`` in units of the
    element's term scale: where terms of ~100 cancel to ~0.06, both sides
    sit 3e-4 from a float64 chain and 3.5e-6 from each other, which no
    fixed atol of 1e-6 holds."""
    kind, specs, dtype, segs = twin_case(case)
    gen = torch.Generator().manual_seed(1)
    tables = pool_tables(specs, 1.0, dtype, gen, "cpu")
    pts, bounds, segs = draw_points(specs, kind, gen, "cpu", segs)["box"]
    g = torch.randn((sum(segs), specs[0].out_dim), generator=gen)
    out_p, rec_p, x_p, t_p = autograd_run(plain_fn, kind, specs, tables, pts, bounds, segs, g)
    out_f, rec_f, x_f, t_f = autograd_run(function_fn, kind, specs, tables, pts, bounds, segs, g)
    assert torch.equal(out_f, out_p)
    routes = {"sorted-grads": {"sorted"}, "exact-grads": {"exact"}}.get(case)
    assert rec_p and (routes is None or {r[0] for r in rec_p} == routes)
    assert records_equal(rec_f, rec_p)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(t_f, t_p))
    scale = term_scale(kind, specs, tables, pts, bounds if kind == "multi" else bounds[:1],
                       segs, g)
    gap = (x_f - x_p).abs()
    assert (gap <= TOL["atol"] * scale + TOL["rtol"] * x_p.abs()).all(), float(gap.max())


@pytest.mark.parametrize("std", SCALES)
def test_backward_twin_points_hold_float64_limit(std):
    """The twin's points' gradient on inb_377's part grids sits within
    POINTS_LIMIT of the float64 chain at an initial and a trained table
    scale, and the bfloat16-lerp control does not."""
    specs = model_spec().part_embeds
    gen = torch.Generator().manual_seed(2)
    tables = pool_tables(specs, std, torch.bfloat16, gen, "cpu")
    pts, bounds, segs = draw_points(specs, "multi", gen, "cpu", (300, 200, 100, 100, 100))["box"]
    g = torch.randn((sum(segs), specs[0].out_dim), generator=gen)
    _, _, x_f, _ = autograd_run(function_fn, "multi", specs, tables, pts, bounds, segs, g)
    scale = term_scale("multi", specs, tables, pts, bounds, segs, g)
    want, same = float64_points_grad("multi", specs, tables, pts, bounds, segs, g)
    ctl, _ = float64_points_grad("multi", specs, tables, pts, bounds, segs, g,
                                 lerp=bf16_lerp_parts)
    assert points_gap(x_f, want, scale, same)["ok"]
    assert not points_gap(ctl, want, scale, same)["ok"]


def _stub_backward_launch(monkeypatch):
    """A backward launch function that records its arguments by name (host
    arrays copied) and launches nothing."""
    calls = []
    names = ("pts", "g", "idx", "payload", "pts_grad", "n_points", "n_parts", "seg", "ptrs",
             "ints", "fmajor", "n_levels", "n_features", "values_per_row", "bf16", "mode",
             "multi_order", "include_input", "out_dim", "primes", "payload_bf16",
             "need_pts", "stream")

    def launch(*args):
        a = dict(zip(names, args))
        P, L = a["n_parts"], a["n_levels"]
        for key, dtype, n in (("seg", np.int32, P + 1), ("ptrs", np.uint64, 3 * P),
                              ("ints", np.int32, P * (2 + 2 * L)), ("fmajor", np.int32, 2 * P),
                              ("primes", np.uint32, 3)):
            buf = (ctypes.c_char * (np.dtype(dtype).itemsize * n)).from_address(a[key])
            a[key] = np.frombuffer(bytes(buf), dtype=dtype).copy()
        calls.append(a)
        return 0
    monkeypatch.setattr(hg, "load_backward_kernel", lambda: launch)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=4321))
    monkeypatch.setattr(hg.fused_encode_backward, "launches", 0)
    return calls


def test_fused_encode_backward_launch_arguments(monkeypatch):
    """One launch a call with the forward's arguments, the cotangent, the
    record buffers (one int32 row and V payload values a (level, corner,
    point)), the payload dtype, each table's payload layout and the points'
    gradient where asked; no launch for no points."""
    calls = _stub_backward_launch(monkeypatch)
    spec = model_spec()
    parts = spec.part_embeds
    tables = [{"dense": torch.zeros(s.dense_rows, dtype=torch.bfloat16),
               "hash": torch.zeros(s.hash_rows, dtype=torch.bfloat16)} for s in parts]
    segs = (33, 1, 0, 70, 5)
    M, L = sum(segs), parts[0].n_levels
    pts, g = torch.rand(M, 3), torch.rand(M, parts[0].out_dim)
    bounds = torch.from_numpy(part_bounds())
    idx, payload, pts_grad = hg.fused_encode_backward(parts, tables, pts, bounds, segs, g, True,
                                                      True, torch.bfloat16)
    assert idx.shape == (L * 8 * M,) and idx.dtype == torch.int32
    assert payload.shape == (L * 8 * M,) and payload.dtype == torch.bfloat16
    assert pts_grad.shape == (M, 3) and pts_grad.dtype == torch.float32
    assert hg.fused_encode_backward.launches == 1 and len(calls) == 1
    a = calls[0]
    assert (a["pts"], a["g"], a["idx"], a["payload"], a["pts_grad"], a["n_points"],
            a["n_parts"]) == (pts.data_ptr(), g.data_ptr(), idx.data_ptr(),
                              payload.data_ptr(), pts_grad.data_ptr(), M, 5)
    assert (a["n_levels"], a["n_features"], a["values_per_row"], a["bf16"], a["mode"],
            a["multi_order"], a["include_input"], a["out_dim"], a["payload_bf16"],
            a["need_pts"], a["stream"]) == (L, 16, 1, 1, hg._SCALAR, 1, 1, 19, 1, 1, 4321)
    assert a["seg"].tolist() == [0, 33, 34, 34, 104, 109]
    assert a["fmajor"].tolist() == [0] * 10
    assert a["primes"].tolist() == list(parts[0].primes)
    # the deformer: float32 tables read by column, no points' gradient
    d = spec.deformer.embed
    dt = {"dense": torch.zeros(d.dense_rows, 2), "hash": torch.zeros(d.hash_rows, 2)}
    idx, payload, pts_grad = hg.fused_encode_backward(
        (d,), (dt,), torch.rand(7, 3), torch.rand(1, 2, 3), (7,), torch.rand(7, 19), False,
        False, torch.bfloat16)
    a = calls[-1]
    assert pts_grad is None and a["pts_grad"] == 0 and a["need_pts"] == 0
    assert payload.shape == (8 * 8 * 7 * 2,) and a["fmajor"].tolist() == [1, 1]
    assert (a["values_per_row"], a["bf16"], a["mode"], a["multi_order"]) == (2, 0, hg._CONCAT, 0)
    out = hg.fused_encode_backward((d,), (dt,), torch.rand(0, 3), torch.rand(1, 2, 3), (0,),
                                   torch.rand(0, 19), False, True, torch.float32)
    assert out[0].numel() == 0 and out[2].shape == (0, 3)
    assert hg.fused_encode_backward.launches == 2


def test_record_tables_and_payload_dtype():
    """The records' layout: part by part, dense levels then hashed, each
    table's records contiguous; payloads float32 only where the tables'
    gradient is exact."""
    spec = model_spec()
    parts, d = spec.part_embeds, spec.deformer.embed
    segs = (5, 0, 3, 2, 1)
    tabs = hg.record_tables(parts, segs)
    assert [(t.part, t.name) for t in tabs] == [(p, n) for p in range(5)
                                               for n in ("dense", "hash")]
    first = 0
    for t in tabs:
        s = parts[t.part]
        assert t.first == first and t.kp == segs[t.part]
        assert t.rows == (t.levels[1] - t.levels[0]) * 8 * t.kp
        assert t.levels == ((0, s.start_hash) if t.name == "dense" else (s.start_hash, 16))
        assert t.plan == "scalar" and t.n_rows == (s.dense_rows if t.name == "dense"
                                                   else s.hash_rows)
        first += t.rows
    assert first == 16 * 8 * sum(segs)
    assert [t.plan for t in hg.record_tables((d,), (4,))] == ["columns", "columns"]
    assert hg.payload_dtype(parts[0], torch.bfloat16) == torch.bfloat16
    assert hg.payload_dtype(parts[0], torch.float32) == torch.float32
    assert hg.payload_dtype(d, torch.float32) == torch.bfloat16
    assert hg.payload_dtype(d._replace(exact_grads=True), torch.float32) == torch.float32


def test_function_routes_gradients_of_the_inputs_asked():
    """The Function returns a gradient for exactly the inputs that ask for
    one: the points only where they require it, each table only where it
    does."""
    spec = model_spec().deformer.embed
    gen = torch.Generator().manual_seed(3)
    tables = leaf_tables(draw_tables((spec,), 0.1, torch.float32, gen, "cpu"))
    tables[0]["dense"].requires_grad_(False)
    pts = torch.rand(50, 3, generator=gen)
    out = hg.fused_autograd_encode((spec,), tables, pts, torch.tensor([[0.0, 0, 0], [1, 1, 1]]),
                                   (50,), multi=False)
    assert out.grad_fn.name() == "_FusedEncodeBackward"
    out.sum().backward()
    assert tables[0]["dense"].grad is None and tables[0]["hash"].grad is not None
    assert pts.grad is None


def test_fit_step_takes_the_function_on_every_encoder_call(monkeypatch):
    """One tiny train step on the CPU with the encoders routed as on the
    card (the Function for every call that asks a gradient) against the
    plain route, from the same state and draws: the Function takes each of
    ``train.step.encoder_calls`` calls, the part grids' points ask for a
    gradient and the deformer's do not, the loss and the part grids'
    gradients are bit-equal, and the other leaves' gradients, which the
    points' gradient reaches through the deformer, sit within 1e-5 of the
    largest entry of their leaf (the last deformer layer's bias reads
    4e-8, every other leaf 0)."""
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
    from instant_nvr_tpu_torch.train.step import encoder_calls, forward_backward
    cfg = make_cfg(CFG).merged(train_net.TINY)
    trainer = train_net.build_trainer(cfg, torch.device("cpu"), seed=0, tiny=True, eager=True)

    def grads(routed):
        calls, route = [], hg._route
        if routed:
            def as_card(device_type, tensors, refusal):
                r = route(device_type, tensors, refusal)
                return "grad" if r == "plain" and torch.is_grad_enabled() and any(
                    t.requires_grad for t in tensors) else r
            monkeypatch.setattr(hg, "_route", as_card)
            fn = hg.fused_autograd_encode

            def spy(specs, params_list, pts, *a, **k):
                calls.append((len(specs), pts.requires_grad))
                return fn(specs, params_list, pts, *a, **k)
            monkeypatch.setattr(hg, "fused_autograd_encode", spy)
        state = trainer.state
        torch.manual_seed(0)
        stats = forward_backward(trainer.mspec, trainer.rspec, trainer.lw, state,
                                 trainer.batch, torch.Generator().manual_seed(5))
        monkeypatch.undo()
        return (float(stats["loss"].detach()), calls,
                {n: p.grad.clone() for n, p in state.model.named_parameters()})
    loss_p, calls_p, g_p = grads(False)
    loss_f, calls_f, g_f = grads(True)
    assert not calls_p and loss_f == loss_p
    assert len(calls_f) == encoder_calls(make_render_spec(cfg)) == 3
    assert sorted(calls_f) == [(1, False), (1, False), (5, True)]
    for name, want in g_p.items():
        got = g_f[name]
        if name.startswith("embed."):
            assert torch.equal(got, want), name
        else:
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), name


def test_grad_route_refuses_bounds_that_ask_a_gradient(monkeypatch):
    """The backward kernel gives the points' gradient alone: a CUDA call
    whose bounds require a gradient raises with the reason and launches
    nothing; under no_grad the same bounds are taken."""
    spec, tables = _tiny()
    tabs = tables.tables()
    pts = torch.rand(8, 3)
    bounds = torch.tensor([[0.0, 0, 0], [1, 1, 1]], requires_grad=True)
    reason = hg.fused_refusal((spec,), (tabs,), pts, bounds, (8,))
    assert reason and "bounds" in reason
    with torch.no_grad():
        assert hg.fused_refusal((spec,), (tabs,), pts, bounds, (8,)) is None
    calls = _stub_launch(monkeypatch)
    backward = _stub_backward_launch(monkeypatch)
    route = hg._route
    monkeypatch.setattr(hg, "_route", lambda device_type, *a: route("cuda", *a))
    with pytest.raises(ValueError, match=re.escape(reason)):
        hg.hashgrid_encode(spec, tabs, pts, bounds)
    assert not calls and not backward
