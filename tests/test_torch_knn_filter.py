"""The KNN kernels' distance filter (``csrc/knn_select.cuh``) on the CPU.

The kernels test each (query, vertex) pair with three FMAs of the expanded
form |v|^2 - 2 q.v against a threshold widened by a margin, and re-check
the pairs that pass with the exact (dx^2 + dy^2) + dz^2.  The margin's
claim: no vertex whose exact d^2 is at or below the query's current 4th is
ever rejected.  ``tools/knn_filter.py`` emulates the filter in plain
PyTorch (an FMA as the float64 product of float32 operands plus the addend,
rounded once to float32) with the constants read from the header's text;
these tests hold the emulation to the claim on seeded adversarial inputs
(large offsets, duplicated vertices, queries on vertices and midpoints,
tiny and huge coordinates), and the emulated scan (coarse-to-fine order,
groups of 32, lexicographic insertion) to the plain version's selection.
The CUDA kernels themselves are held to the plain version on the card by
chip_smoke.py phase 3 and the self-check's [1].
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from instant_nvr_tpu_torch.ops import knn
from instant_nvr_tpu_torch.tools import knn_filter as kf

K = kf.constants()


def _adversarial(seed, offset, scale, n=300, C=256, dup=True):
    """Vertices at ``offset`` + ``scale`` * normal on a coarse lattice (so
    distances repeat), every third a copy of the one before; queries on
    vertices, on midpoints between a vertex and another, and near them."""
    rng = np.random.default_rng(seed)
    v = offset + scale * np.round(rng.normal(size=(n, 3)) * 8) / 8
    v = v.astype(np.float32)
    if dup:
        v[1::3] = v[0:-1:3][:len(v[1::3])]
    a = v[rng.integers(0, n, C)]
    b = v[rng.integers(0, n, C)]
    kind = rng.integers(0, 3, C)
    q = np.where((kind == 0)[:, None], a,
                 np.where((kind == 1)[:, None], (a + b) * np.float32(0.5),
                          a + np.float32(scale * 1e-3) * rng.normal(size=(C, 3))))
    return torch.from_numpy(q.astype(np.float32)), torch.from_numpy(v)


# name: (offset, scale); the margin (~1e-6 (|q|^2 + |v|^2), at least
# 2^-120) is far below the distances only in the first three
CASES = {
    "unit": (0.0, 0.3),
    "offset-2m": (2.0, 0.3),
    "offset-100m": (100.0, 0.3),
    "offset-1e4": (1.0e4, 1.0),
    "tiny": (0.0, 1e-20),
    "huge": (1.0e12, 1.0e9),
}
REJECTS = ("unit", "offset-2m", "offset-100m")


def test_header_constants_meet_the_proof():
    """The margin's constants are the header's, and as large as the
    header's proof needs."""
    assert K["kUlp"] == 2.0 ** -24
    assert K["kMarginV"] >= 11 and K["kMarginQ"] >= 10 and K["kMarginB"] >= 10
    assert 0 < K["kMarginAbs"] <= 2.0 ** -100
    assert K["kFilterMax"] == 2.0 ** 100
    assert K["kGroup"] == kf.GROUP and K["kFarInit"] == kf.FAR_INIT == knn.FAR_INIT
    assert K["kK"] == knn.KERNEL_K


@pytest.mark.parametrize("name", sorted(CASES))
def test_filter_passes_every_vertex_at_or_below_the_4th(name):
    """For every pair, with the query's current 4th set to the pair's own
    exact d^2 (the tightest threshold under which the pair must pass), the
    filter passes it: so no vertex at or below any current 4th is
    rejected."""
    q, v = _adversarial(0, *CASES[name])
    e = kf.exact_d2(q[:, None], v[None])                     # (C, n)
    assert torch.isfinite(e).all()
    ok = kf.passes(q[:, None], v[None], e, K)
    assert ok.all(), f"{int((~ok).sum())} pairs rejected"
    if name in REJECTS:
        # the filter does reject: half the pair's distance as the 4th fails
        # most pairs (the claim would hold trivially otherwise)
        far = e > 1e-3 * e.amax()
        assert (~kf.passes(q[:, None], v[None], e * 0.5, K))[far].float().mean() > 0.5


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 2 ** 32 - 1), st.floats(-40, 40), st.floats(-40, 10))
def test_filter_claim_random_exponents(seed, log_offset, log_scale):
    """The claim at random magnitudes: offsets and spreads from 2^-40 to
    2^40 (inside kFilterMax), queries near the vertices."""
    rng = np.random.default_rng(seed)
    offset = np.float32(2.0 ** log_offset) * rng.choice([-1, 1], 3)
    scale = 2.0 ** log_scale
    v = (offset + scale * rng.normal(size=(64, 3))).astype(np.float32)
    q = (v[rng.integers(0, 64, 32)]
         + scale * rng.normal(size=(32, 3)) * rng.choice([0.0, 1e-4, 1.0], (32, 1)))
    q, v = torch.from_numpy(q.astype(np.float32)), torch.from_numpy(v)
    e = kf.exact_d2(q[:, None], v[None])
    assert kf.passes(q[:, None], v[None], e, K).all()


def test_filter_passes_out_of_range_and_non_finite():
    """A query or vertex outside the proof's range (|p|^2 > kFilterMax) or
    not finite passes for every partner: the exact re-check decides."""
    q = torch.tensor([[3e19, 3e19, 3e19], [float("nan"), 0, 0], [0.1, 0.2, 0.3]])
    v = torch.tensor([[3e19, 3e19, 3e19], [float("inf"), 0, 0], [1e30, 0, 0],
                      [0.1, 0.2, 0.3]])
    ok = kf.passes(q[:, None], v[None], torch.zeros(3, 4), K)
    assert ok[:2].all() and ok[:, :3].all()
    assert ok[2, 3]                      # an exact hit at d4 = 0


def _reference(q, v, k=4):
    """The kernels' selection from every exact distance: the k smallest
    (d^2, index) pairs whose d^2 < FAR_INIT, ascending; (FAR_INIT, 0)
    beyond."""
    e = kf.exact_d2(q[:, None], v[None])
    e = torch.where(torch.isnan(e) | (e >= kf.FAR_INIT), torch.inf, e)
    d, i = torch.sort(e, dim=1, stable=True)
    d, i = d[:, :k], i[:, :k]
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.cat([d, torch.full((len(q), pad), torch.inf)], 1)
        i = torch.cat([i, torch.zeros((len(q), pad), dtype=i.dtype)], 1)
    unfilled = torch.isinf(d)
    return (torch.where(unfilled, torch.tensor(kf.FAR_INIT), d),
            torch.where(unfilled, torch.zeros_like(i), i).int())


@pytest.mark.parametrize("name", ["unit", "offset-2m", "offset-1e4", "tiny"])
@pytest.mark.parametrize("n", [3, 37, 300])
def test_scan_selects_the_plain_neighbours(name, n):
    """The emulated pass 1 (coarse-to-fine order, groups of 32 against the
    group's threshold, lexicographic insertion) selects the (d^2, index)
    pairs of the exact scan bit for bit, and its distances equal
    ``knn_topk_plain``'s."""
    q, v = _adversarial(1, *CASES[name], n=max(n, 3))
    v = v[:n]
    d, i, counts = kf.scan(q, v, K)
    rd, ri = _reference(q, v)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    pd, _ = knn.knn_topk_plain(q, v[None], torch.tensor([n], dtype=torch.int32))
    assert torch.equal(d, torch.sort(pd[0], dim=1).values)
    assert counts.shape == (len(q), math.ceil(n / kf.GROUP))
    # index order selects the same
    d2, i2, _ = kf.scan(q, v, K, index_order=True)
    assert torch.equal(d2, rd) and torch.equal(i2, ri)


def test_scan_with_non_finite_vertices():
    """NaN and infinite vertices are never selected; every real one is
    where the exact scan would take it."""
    q, v = _adversarial(2, 0.0, 0.3, n=100, C=64)
    v = v.clone()
    v[5] = float("nan")
    v[17, 1] = float("inf")
    v[40] = 1e30
    d, i, _ = kf.scan(q, v, K)
    rd, ri = _reference(q, v)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    assert not torch.isin(i, torch.tensor([5, 17, 40])).any()


def test_scan_margin_costs_little_and_order_helps():
    """On the render chunk's kind of queries (near a sphere of SMPL's 6,890
    vertices split into 5 bands), the margin lets no more vertices through
    than the bare comparison, and the coarse-to-fine order re-checks fewer
    than the index order."""
    from instant_nvr_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(n_verts=6890, grid=32)
    rng = np.random.default_rng(0)
    verts = scene["verts"]
    q = verts[rng.integers(0, len(verts), 128)] + rng.normal(scale=0.03, size=(128, 3))
    q = torch.from_numpy(q.astype(np.float32))
    v = torch.from_numpy(scene["part_pts"][2, :int(scene["lengths2"][2])])
    passed = {}
    for label, kw in {"margin": {}, "bare": {"margin": False},
                      "index": {"index_order": True}}.items():
        d, i, counts = kf.scan(q, v, K, **kw)
        rd, ri = _reference(q, v)
        assert torch.equal(d, rd) and torch.equal(i, ri)
        passed[label] = int(counts.sum())
    assert passed["margin"] <= 1.01 * passed["bare"]
    assert passed["margin"] < passed["index"]


@pytest.mark.parametrize("n", list(range(1, 70)) + [1378, 2297, 4593, 6890, 10000])
def test_stride_is_a_bijection(n):
    s = kf.stride(n)
    assert math.gcd(s, n) == 1
    assert sorted((k * s) % n for k in range(n)) == list(range(n))


def test_sass_loops_finds_backward_branches():
    """tools/sass_loops reads cuobjdump's listing: a branch to a lower
    address (hex or label) is a loop, the innermost one holds no other."""
    from instant_nvr_tpu_torch.tools import sass_loops
    sass = """
        Function : _Z3fooPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R6, R4, R5, R6 ;
        /*0030*/              @!P0 BRA 0x10 ;
        /*0040*/                   IADD3 R2, R2, 0x1, RZ ;
.L_x_3:
        /*0050*/                   ISETP.GE.AND P1, PT, R2, R3, PT ;
        /*0060*/               @P1 BRA `(.L_x_3) ;
        /*0070*/                   BRA 0x0 ;
        /*0080*/                   EXIT ;
    """
    funcs, labels = sass_loops.parse(sass)
    assert list(funcs) == ["_Z3fooPf"] and labels["_Z3fooPf"] == {".L_x_3": 0x50}
    found = {(s, e): [sass_loops.opcode(t) for _, t in body]
             for s, e, body in sass_loops.loops(funcs["_Z3fooPf"], labels["_Z3fooPf"])}
    assert found[(0x10, 0x30)] == ["LDS.128", "FFMA", "BRA"]
    assert found[(0x50, 0x60)] == ["ISETP.GE.AND", "BRA"]
    assert len(found[(0x0, 0x70)]) == 8


def test_chip_smoke_knn_cases():
    """chip_smoke.py's KNN cases have the shapes the main paths give the
    kernels, and its adversarial case holds what it is for: coordinates
    near +2 m, exact duplicate vertices, queries on vertices; the emulated
    scan selects the exact scan's neighbours on it."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    cases = cs.knn_inputs(torch.device("cpu"), np.random.default_rng(0))
    assert {n: c[0].shape[0] for n, c in cases.items()} == {
        "inb_377-chunk": 65536, "ragged": 65499, "train-shape": 16384,
        "adversarial": 16379}
    for query, pts, pbw, lengths in cases.values():
        assert query.dtype == pts.dtype == pbw.dtype == torch.float32
        assert lengths.dtype == torch.int32 and pbw.shape[:2] == pts.shape[:2]
    q, pts, _, lengths = cases["adversarial"]
    v = pts[0, :int(lengths[0])]
    assert v.min() > 1.5 and torch.equal(v[1::3], v[0:-1:3][:len(v[1::3])])
    on_vertex = (q[:2000, None] == pts.reshape(1, -1, 3)).all(-1).any(-1)
    assert 0.4 < on_vertex.float().mean() < 0.6
    d, i, _ = kf.scan(q[:64], v, K)
    rd, ri = _reference(q[:64], v)
    assert torch.equal(d, rd) and torch.equal(i, ri)
