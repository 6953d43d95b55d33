"""The fused hash-grid encoding forward (``csrc/hashgrid_encode.cu``)
against the plain chain, and the encoders' route.

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

CPU tests: the route rule, the gradient state that feeds it, the counters,
the refusals (a no-grad CUDA call the kernel cannot take raises),
and the launch's arguments through a stub launch function.  This file
imports nothing of JAX, so the card's machine runs it.
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
            before = (hg.fused_encode.launches, hg.fused_encode.plain_cuda_calls)
            got = encode(kind, specs, tables, pts, bounds, segs)
            after = (hg.fused_encode.launches, hg.fused_encode.plain_cuda_calls)
            if after != (before[0] + 1, before[1]):
                raise AssertionError(f"{name}: the call took the plain chain "
                                     f"(launches, plain calls) {before} -> {after}")
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
    ("cuda", True, None, "plain"),
    ("cuda", True, "a reason", "plain"),
    ("cpu", False, None, "plain"),
    ("cpu", False, "a reason", "plain"),
    ("cpu", True, None, "plain"),
    ("cpu", True, "a reason", "plain"),
])
def test_encode_route_rule(device_type, needs_grad, refusal, want):
    """CUDA points with no gradient asked take the kernel, and raise with
    its reason where it refuses the call; everything else the plain chain."""
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
    no gradient take the kernel; with gradients enabled, a table or points
    that require one take the plain chain, and the plain-call counter
    counts it."""
    monkeypatch.setattr(hg.fused_encode, "plain_cuda_calls", 0)
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
    want = "plain" if grad_mode.startswith("enabled") else "fused"
    assert route == want
    assert hg.fused_encode.plain_cuda_calls == (1 if want == "plain" else 0)


def test_route_raises_on_a_refused_no_grad_cuda_call(monkeypatch):
    """A no-grad CUDA call the kernel cannot take raises with the reason and
    counts nothing; a gradient call and a CPU call never ask the kernel."""
    monkeypatch.setattr(hg.fused_encode, "plain_cuda_calls", 0)
    asked = []

    def refusal():
        asked.append(1)
        return "the reason"
    pts = torch.rand(4, 3)
    with torch.no_grad():
        with pytest.raises(ValueError, match="the reason"):
            hg._route("cuda", [pts], refusal)
        assert hg._route("cpu", [pts], refusal) == "plain"
    assert hg.fused_encode.plain_cuda_calls == 0 and len(asked) == 1
    assert hg._route("cuda", [pts.requires_grad_(True)], refusal) == "plain"
    assert hg.fused_encode.plain_cuda_calls == 1 and len(asked) == 1


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
    monkeypatch.setattr(hg.fused_encode, "plain_cuda_calls", 0)
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
    assert not calls and hg.fused_encode.launches == 0
    assert hg.fused_encode.plain_cuda_calls == 0


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
