"""Plain PyTorch emulation of the KNN kernels' distance filter and scan
(``csrc/knn_select.cuh``), and the counts it gives.

    python -m instant_nvr_tpu_torch.tools.knn_filter [--queries N]

The margin's constants are read from the header's text, so the emulation
and the kernels cannot drift apart.  An FMA is emulated as the float64
product of two float32 operands (exact) plus the addend, rounded to
float32.  ``scan`` replays the kernels' pass 1 for one part: positions in
the order ``(k * stride) mod len``, groups of 32 tested against the
threshold of the group's start, the passing vertices re-checked with the
exact ``(dx^2 + dy^2) + dz^2`` and inserted by (d^2, index).

Run as a script (on the CPU; counts only, no time), it builds
chip_smoke.py's render-chunk and adversarial queries (the first N of each)
and prints, per query summed over the parts, the vertices that pass the
filter and re-check, and for the warps of the kernel's layout the sum over
groups of the largest count of any lane (what the warp pays for its
re-checks), for: the header's margin, no margin (the lag of the groups
alone), coordinates centred on each part's first vertex for the filter,
and the scan in index order.
"""
from __future__ import annotations

import argparse
import re
from pathlib import Path

import torch

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "knn_select.cuh"
GROUP = 32
FAR_INIT = 1.5e9


def constants(text: str = None) -> dict:
    """Every ``constexpr int|float kName = <literal>;`` of the header."""
    text = HEADER.read_text() if text is None else text
    out = {}
    for kind, name, value in re.findall(
            r"constexpr\s+(int|float)\s+(k\w+)\s*=\s*([-+0-9.a-fA-FxXpP]+)\s*;", text):
        if kind == "int":
            out[name] = int(value)
        elif value.startswith("0x"):
            out[name] = float.fromhex(value.rstrip("f"))
        else:
            out[name] = float(value.rstrip("f"))
    return out


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding of the float64 sum."""
    a = torch.as_tensor(a, dtype=torch.float32).double()
    b = torch.as_tensor(b, dtype=torch.float32).double()
    c = torch.as_tensor(c, dtype=torch.float32).double()
    return (a * b + c).float()


def norm2(p: torch.Tensor) -> torch.Tensor:
    """fma(x, x, fma(y, y, z * z)) of (..., 3) float32 points."""
    x, y, z = p.unbind(-1)
    return fma(x, x, fma(y, y, z * z))


def query_terms(q: torch.Tensor, k: dict) -> torch.Tensor:
    """nq of each (..., 3) query: (kMarginQ u qq - qq) + kMarginAbs, or NaN
    when |q|^2 > kFilterMax or is not finite."""
    qq = norm2(q)
    nq = fma(qq, k["kMarginQ"] * k["kUlp"], -qq) + torch.tensor(k["kMarginAbs"])
    return torch.where(qq <= k["kFilterMax"], nq, torch.full_like(nq, float("nan")))


def vertex_w(v: torch.Tensor, k: dict) -> torch.Tensor:
    """The tile's w of each (..., 3) vertex: |v|^2 (1 - kMarginV u), or NaN
    when |v|^2 > kFilterMax or is not finite."""
    vv = norm2(v)
    w = fma(vv, -k["kMarginV"] * k["kUlp"], vv)
    return torch.where(vv <= k["kFilterMax"], w, torch.full_like(w, float("nan")))


def filter_s(q: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s = fma(-2qx, x, fma(-2qy, y, fma(-2qz, z, w))), broadcasting q
    (..., 3) against v (..., 3) and w."""
    a = -2.0 * q
    return fma(a[..., 0], v[..., 0], fma(a[..., 1], v[..., 1],
                                         fma(a[..., 2], v[..., 2], w)))


def threshold(d4: torch.Tensor, nq: torch.Tensor, k: dict) -> torch.Tensor:
    return fma(d4, 1.0 + k["kMarginB"] * k["kUlp"], nq)


def passes(q: torch.Tensor, v: torch.Tensor, d4: torch.Tensor, k: dict) -> torch.Tensor:
    """Whether vertex v passes query q's filter when its current 4th
    distance is d4 (NaN passes, as ``!(s >= thr)``)."""
    s = filter_s(q, v, vertex_w(v, k))
    return ~(s >= threshold(d4, query_terms(q, k), k))


def exact_d2(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(dx^2 + dy^2) + dz^2 in float32, the kernels' exact form."""
    d = q - v
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def stride(n: int) -> int:
    """The scan stride of a part of n vertices: the first integer from
    floor(0.618 n) up that is coprime with n."""
    import math
    s = max(1, int(0.6180339887 * n))
    while math.gcd(s, max(n, 1)) != 1:
        s += 1
    return s


def scan(q: torch.Tensor, verts: torch.Tensor, k: dict, margin: bool = True,
         centre: bool = False, index_order: bool = False):
    """The kernels' pass 1 for queries q (C, 3) and one part's real
    vertices (n, 3): returns d2 (C, 4), idx (C, 4) (unfilled: FAR_INIT, 0)
    and the (C, groups) counts of vertices that passed the filter.
    ``margin=False`` compares s with d4 - qq unwidened; ``centre`` moves
    both to the part's first vertex for the filter (the exact re-check keeps
    the coordinates); ``index_order`` scans 0, 1, 2, ...."""
    C, n = q.shape[0], verts.shape[0]
    key_d = torch.full((C, 4), FAR_INIT)
    key_i = torch.zeros((C, 4), dtype=torch.int64)
    counts = []
    if n == 0:
        return key_d, key_i.int(), torch.zeros((C, 0), dtype=torch.int64)
    order = torch.arange(n) if index_order else (torch.arange(n) * stride(n)) % n
    fq, fv = q, verts[order]
    if centre:
        fq, fv = q - verts[0], verts[order] - verts[0]
    nq = query_terms(fq, k)
    w = vertex_w(fv, k)
    if not margin:
        nq = -norm2(fq)
        w = norm2(fv)
    for g in range(0, n, GROUP):
        thr = (threshold(key_d[:, 3], nq, k) if margin else key_d[:, 3] + nq)
        sl = slice(g, min(g + GROUP, n))
        s = filter_s(fq[:, None], fv[None, sl], w[None, sl])
        mask = ~(s >= thr[:, None])                           # (C, group)
        counts.append(mask.sum(1))
        for jj in range(mask.shape[1]):
            rows = mask[:, jj].nonzero()[:, 0]
            if not len(rows):
                continue
            j = int(order[g + jj])
            e = exact_d2(q[rows], verts[j])
            d, i = key_d[rows], key_i[rows]
            ins = (e[:, None] < d) | ((e[:, None] == d) & (j < i))   # (r, 4)
            nd = torch.cat([d, e[:, None]], 1)
            ni = torch.cat([i, torch.full_like(i[:, :1], j)], 1)
            # the lexicographic sorted insertion: c enters before the first
            # larger key
            pos = (~ins).sum(1)                                # slots before c
            slot = torch.arange(5)[None, :]
            src = torch.where(slot < pos[:, None], slot,
                              torch.where(slot == pos[:, None], 4, slot - 1))
            key_d[rows] = nd.gather(1, src)[:, :4]
            key_i[rows] = ni.gather(1, src)[:, :4]
    return key_d, key_i.int(), torch.stack(counts, 1)


def warp_cost(counts: torch.Tensor, threads: int, queries: int) -> float:
    """Sum over groups of the largest count of any lane, per query, for the
    kernel's layout: query i of thread t of a block is block * threads *
    queries + i * threads + t, a warp is 32 threads."""
    C = counts.shape[0]
    per_block = threads * queries
    nb = C // per_block
    c = counts[:nb * per_block].reshape(nb, queries, threads // 32, 32, -1)
    return float(c.amax(3).sum(-1).double().mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=2048,
                    help="queries of each case (the first N)")
    args = ap.parse_args(argv)
    import os
    import sys
    import numpy as np
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    k = constants()
    cases = cs.knn_inputs(torch.device("cpu"), np.random.default_rng(0))
    variants = {"margin": {}, "no-margin": {"margin": False},
                "centred": {"centre": True}, "index-order": {"index_order": True}}
    for name in ("inb_377-chunk", "adversarial"):
        query, part_pts, _, lengths = cases[name]
        q = query[:args.queries]
        for label, kw in variants.items():
            passed, cost = 0.0, 0.0
            for p in range(part_pts.shape[0]):
                verts = part_pts[p, :int(lengths[p])]
                _, _, counts = scan(q, verts, k, **kw)
                passed += float(counts.sum(1).double().mean())
                cost += warp_cost(counts, k["kThreads"], k["kQ"])
            print(f"[knn_filter] case={name} queries={len(q)} variant={label} "
                  f"passed_per_query={passed:.1f} warp_recheck_per_query={cost:.1f} "
                  f"vertices_per_query={int(lengths.clamp(0, part_pts.shape[1]).sum())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
