"""Multiresolution hash-grid encoding, forward (port of
``instant_nvr_tpu/ops/hashgrid.py``).

Levels whose dense size fits the table stay dense (flat x*n^2 + y*n + z
rows, all dense levels in one table); finer levels are hashed with the
uint32 prime-xor spatial hash into ``nextprime(2^log2)`` rows per level.
8-corner gather (corner bit order: z fastest) + trilinear lerp in float32,
then feature aggregation: scalar tables (``F * q``, one value per row, the
part grids), sum over features, sum over levels, or concat (the deformer).

The index must equal JAX's bit for bit: the uint32 products wrap, so each
is computed in int64 and masked to 32 bits before the XOR and the modulus.
``fd.to(int32)`` truncates toward zero like ``astype(int32)``; the corner
is clipped after truncating and the lerp offset is measured from the
*clipped* corner.

Storage is the logical rows only: ``dense`` (max(dense_total, 1), F) and
``hash`` (max(H, 1) * T, F), or 1-D for scalar grids.  The JAX package's
TPU tile padding and packed (rows / (128/F), 128) layout do not exist here
(``bridge.py`` strips or refuses them).  The JAX forward is an XLA gather,
so this forward is a plain gather too.

Backward.  Every table read goes through :func:`scalar_table_gather` (one
value per row: scalar grids, and one feature column of a small table) or
:func:`table_gather` (whole rows of a big non-scalar table, where the JAX
package stores the table packed), autograd Functions whose backward is a
scatter-add of the gather's cotangent, routed by :func:`grad_route`:

* a bf16 table, or an f32 table whose gather allows rounding (the
  deformer's columns unless ``exact_grads``), takes the bf16 kernels of
  ``ops/scatter.py``: ``segmented_scatter_add`` from ``KERNEL_MIN_ROWS``
  rows up, ``onehot_scatter_add`` below, when its widest level window fits
  a block's shared memory (otherwise ``segmented_scatter_add``);
* any other f32 table (``grid_compute_dtype: float32`` sets
  ``exact_grads``) gets the exact f32 ``index_add_``, as the JAX package
  gives it XLA's f32 scatter;
* under ``fix_random`` (the spec's ``sorted_grads``) every table of the
  first kind takes ``sorted_scatter_add`` instead: the records sorted by
  key, each row's sum in a fixed order, bit for bit the same from run to
  run.  An exact table keeps ``index_add_``, which is deterministic under
  ``torch.use_deterministic_algorithms``.

The index streams are (n_lev, 8, N) arrays, level-major when flattened,
which the kernels require.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from sympy import nextprime
from torch import nn

from ..utils.constants import device_constant
from . import scatter

_U32 = 0xFFFFFFFF
# the corner lerp's dtype (gathered values, weights, level sums): float32 as
# the configuration states; the benchmark's ``bfloat16_encoding`` control
# sets bfloat16 (:func:`lerp_dtype`)
LERP_DTYPE = torch.float32


class lerp_dtype:
    """Context in which the encoders' corner lerp runs in ``dtype``."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def __enter__(self):
        global LERP_DTYPE
        self.saved, LERP_DTYPE = LERP_DTYPE, self.dtype

    def __exit__(self, *exc):
        global LERP_DTYPE
        LERP_DTYPE = self.saved


# the encodings' record while :class:`observe_encodes` is on, else None
_OBSERVED = None


class observe_encodes:
    """Context in which each encoding appends (encoder, points, boxes,
    output width, bytes of the distinct table rows its gathers read, each
    row once at the table's row width) to the list it yields; the encoder
    is ``"hashgrid_encode"`` or ``"multi_hashgrid_encode"``.  The
    benchmark's count of the fused kernel's bound reads it
    (``counts.encode_bounds``)."""

    def __enter__(self):
        global _OBSERVED
        self.saved, _OBSERVED = _OBSERVED, SimpleNamespace(calls=[], row_bytes=0)
        return _OBSERVED.calls

    def __exit__(self, *exc):
        global _OBSERVED
        _OBSERVED = self.saved


def _observe_rows(table: torch.Tensor, ind: torch.Tensor) -> None:
    if _OBSERVED is not None:
        row = table.element_size() * (1 if table.ndim == 1 else table.shape[1])
        _OBSERVED.row_bytes += int(torch.unique(ind).numel()) * row


def _observe_call(encoder: str, points: int, boxes: int, out_dim: int) -> None:
    if _OBSERVED is not None:
        _OBSERVED.calls.append((encoder, points, boxes, out_dim, _OBSERVED.row_bytes))
        _OBSERVED.row_bytes = 0


# The JAX package's routing threshold (kernel_min_rows,
# instant_nvr_tpu/ops/device_rates.py:43), kept as the reference's rule: it
# was measured on a TPU, not on the H100, and re-tuning it on the card is
# later work.  It also decides which non-scalar tables gather whole rows.
KERNEL_MIN_ROWS = 190_000


class HashGridSpec(NamedTuple):
    """Static description of one hash-grid embedder."""
    n_levels: int
    n_features: int
    table_size: int               # nextprime(2**log2_hashmap_size)
    entries_num: Tuple[int, ...]  # per-level entries per side
    start_hash: int               # first hashed level
    dense_offsets: Tuple[int, ...]
    dense_total: int
    sum: bool
    sum_over_features: bool
    include_input: bool
    primes: Tuple[int, int, int]
    scalar: bool = False          # one value per row; forward uses F * q
    # f32 tables keep exact f32 gradients (no bf16 rounding in the backward)
    exact_grads: bool = False
    # every gradient through the deterministic sorted-segment kernel
    sorted_grads: bool = False

    @property
    def out_dim(self) -> int:
        if self.sum:
            d = self.n_levels if self.sum_over_features else self.n_features
        else:
            d = self.n_levels * self.n_features
        return d + (3 if self.include_input else 0)

    @property
    def n_hash_levels(self) -> int:
        return self.n_levels - self.start_hash

    @property
    def dense_rows(self) -> int:
        return max(self.dense_total, 1)

    @property
    def hash_rows(self) -> int:
        return max(self.n_hash_levels, 1) * self.table_size

    def tables(self) -> List[Tuple[str, int, Tuple[int, ...]]]:
        """(name, rows, level_offsets) of each table the encoding reads."""
        out = []
        if self.start_hash > 0:
            out.append(("dense", self.dense_rows,
                        self.dense_offsets + (self.dense_total,)))
        if self.n_hash_levels > 0:
            out.append(("hash", self.hash_rows,
                        tuple(l * self.table_size
                              for l in range(self.n_hash_levels + 1))))
        return out


def make_hashgrid_spec(n_levels: int = 16, n_features_per_level: int = 16,
                       log2_hashmap_size: int = 18, base_resolution: int = 2,
                       b: float = 1.38, sum: bool = True,
                       sum_over_features: bool = True,
                       include_input: bool = True,
                       separate_dense: bool = True,
                       primes=(1, 19349663, 83492791),
                       scalar_tables: bool = True,
                       exact_grads: bool = False,
                       sorted_grads: bool = False,
                       **_unused) -> HashGridSpec:
    table_size = int(nextprime(2 ** log2_hashmap_size))
    entries_num = tuple(int(base_resolution * b ** i) for i in range(n_levels))
    entries_cnt = [n ** 3 for n in entries_num]
    start_hash = n_levels
    for i in range(n_levels):
        if entries_cnt[i] > table_size:
            start_hash = i
            break
    if not separate_dense:
        start_hash = 0
    offsets, total = [], 0
    for i in range(start_hash):
        offsets.append(total)
        total += entries_cnt[i]
    return HashGridSpec(
        n_levels=n_levels, n_features=n_features_per_level,
        table_size=table_size, entries_num=entries_num, start_hash=start_hash,
        dense_offsets=tuple(offsets), dense_total=total, sum=sum,
        sum_over_features=sum_over_features, include_input=include_input,
        primes=tuple(int(p) for p in primes),
        scalar=bool(scalar_tables and sum and sum_over_features),
        exact_grads=bool(exact_grads), sorted_grads=bool(sorted_grads))


def hashgrid_init(spec: HashGridSpec, generator: torch.Generator,
                  device) -> dict:
    """{'dense', 'hash'} tables drawn like the JAX init: N(0, std^2) with
    std = sqrt(2 / (T * F)); scalar grids N(0, std^2 / F), the distribution
    of the mean of F such draws."""
    std = math.sqrt(2.0 / (spec.table_size * spec.n_features))
    F = spec.n_features

    def make(rows):
        if spec.scalar:
            shape, s = (rows,), std / math.sqrt(F)
        else:
            shape, s = (rows, F), std
        return s * torch.randn(shape, generator=generator, device=device)

    return {"dense": make(spec.dense_rows), "hash": make(spec.hash_rows)}


class HashTables(nn.Module):
    """The ``dense`` and ``hash`` tables of one hash grid (logical rows)."""

    def __init__(self, spec: HashGridSpec, device=None):
        super().__init__()
        self.spec = spec
        cols = () if spec.scalar else (spec.n_features,)
        self.dense = nn.Parameter(torch.empty((spec.dense_rows,) + cols,
                                              device=device))
        self.hash = nn.Parameter(torch.empty((spec.hash_rows,) + cols,
                                             device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init = hashgrid_init(self.spec, generator, self.dense.device)
        with torch.no_grad():
            self.dense.copy_(init["dense"])
            self.hash.copy_(init["hash"])

    def tables(self, dtype=None) -> dict:
        """{'dense', 'hash'}, cast to ``dtype`` when given."""
        if dtype is None:
            return {"dense": self.dense, "hash": self.hash}
        return {"dense": self.dense.to(dtype), "hash": self.hash.to(dtype)}


def _corner_bits() -> np.ndarray:
    """8 corner offsets, rows 000, 001, 010, ... (z fastest)."""
    return np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                    axis=-1).reshape(8, 3)


def _corners(x01: torch.Tensor, res: torch.Tensor):
    """Per-(level, corner, point) integer corners and trilinear weights.

    x01 (N, 3) normalized points; res (L, 1) or (L, N) int32 entries per
    side.  Returns idx3: three (L, 8, N) int64 index arrays and w (L, 8, N).
    """
    cbits = device_constant("corner_bits", x01.device, _corner_bits, torch.int64)
    res_f = res.to(x01.dtype)
    nmax = res.long()
    idx3, w = [], None
    for d in range(3):
        fd = x01[:, d][None, :] * (res_f - 1.0)                 # (L, N)
        bd = fd.to(torch.int32).long()                          # trunc to 0
        cd = cbits[:, d].long()[None, :, None]                  # (1, 8, 1)
        hi = (nmax - 1)[:, None, :]
        idx3.append(torch.minimum(torch.clamp(bd[:, None, :] + cd, min=0), hi))
        off = fd - torch.minimum(torch.clamp(bd, min=0), nmax - 1).to(fd.dtype)
        cf = cbits[:, d].to(x01.dtype)[None, :, None]
        wd = (1.0 - cf) + (2.0 * cf - 1.0) * off[:, None, :]
        w = wd if w is None else w * wd
    return idx3, w


def _hash_index(idx3, primes, table_size: int) -> torch.Tensor:
    """uint32 prime-xor hash mod table_size, bit-exact with the JAX version."""
    p0, p1, p2 = primes
    h = (((idx3[0] * p0) & _U32) ^ ((idx3[1] * p1) & _U32)
         ^ ((idx3[2] * p2) & _U32))
    return h % table_size


# --------------------------------------------------------------------------
# gathers with a scatter-add backward
# --------------------------------------------------------------------------

def grad_route(n_rows: int, F: int, level_offsets: Sequence[int],
               table_dtype: torch.dtype, allow_rounded: bool,
               sorted_grads: bool = False) -> str:
    """Where the gradient of a gather from an (n_rows, F) table goes:
    'segmented' | 'onehot' (the kernels of ops/scatter.py, bf16 payload),
    'exact' (f32 index_add_) or, under ``sorted_grads``, 'sorted' (the
    deterministic kernel) in place of the first two.  Mirrors the JAX
    package's ``_table_gather_bwd`` / ``_scalar_gather_bwd`` (see module
    doc)."""
    if table_dtype != torch.bfloat16 and not allow_rounded:
        return "exact"
    if sorted_grads:
        return "sorted"
    if n_rows < KERNEL_MIN_ROWS and scatter.onehot_fits(level_offsets, F):
        return "onehot"
    return "segmented"


_SCATTER = {"segmented": scatter.segmented_scatter_add,
            "onehot": scatter.onehot_scatter_add,
            "sorted": scatter.sorted_scatter_add}


def _table_grad(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                level_offsets: Tuple[int, ...], table_dtype: torch.dtype,
                allow_rounded: bool, sorted_grads: bool) -> torch.Tensor:
    """idx (n_lev, ...) level-major rows, g (R, F) cotangent -> (n_rows, F)
    gradient in the table's dtype."""
    route = grad_route(n_rows, g.shape[1], level_offsets, table_dtype,
                       allow_rounded, sorted_grads)
    if route == "exact":
        return scatter.exact_scatter_add(idx, g.to(table_dtype), n_rows)
    # the payload is rounded to bf16 once (a bf16 cotangent is unchanged);
    # the bf16 result converts to an f32 table's dtype exactly
    grad = _SCATTER[route](idx.reshape(-1).to(torch.int32),
                           g.to(torch.bfloat16).contiguous(), n_rows,
                           level_offsets)
    return grad.to(table_dtype)


class _TableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, level_offsets, allow_rounded, sorted_grads):
        ctx.save_for_backward(idx)
        ctx.meta = (table.shape, table.dtype, level_offsets, allow_rounded,
                    sorted_grads)
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        (idx,) = ctx.saved_tensors
        shape, dtype, level_offsets, allow_rounded, sorted_grads = ctx.meta
        grad = _table_grad(idx, g.reshape(idx.numel(), -1), shape[0],
                           level_offsets, dtype, allow_rounded, sorted_grads)
        return grad.reshape(shape), None, None, None, None


def table_gather(table: torch.Tensor, idx: torch.Tensor,
                 level_offsets: Tuple[int, ...],
                 allow_rounded: bool = False,
                 sorted_grads: bool = False) -> torch.Tensor:
    """``table[idx]`` for an (n_rows,) or (n_rows, F) table; idx (n_lev, ...)
    with level l's rows inside ``level_offsets[l]:level_offsets[l + 1]``.
    ``allow_rounded`` lets an f32 table's gradient take the bf16 kernels;
    ``sorted_grads`` sends it to the deterministic one."""
    return _TableGather.apply(table, idx, level_offsets, allow_rounded,
                              sorted_grads)


# the JAX package's name for the gather from a 1-D (scalar) table
scalar_table_gather = table_gather


def gather_plan(spec: HashGridSpec, n_rows: int) -> str:
    """How the encoders read a table: 'scalar' (one value per row), 'rows'
    (whole rows: the non-scalar tables the JAX package stores packed) or
    'columns' (one gather per feature column, as the JAX package reads
    its small tables)."""
    F = spec.n_features
    if spec.scalar:
        return "scalar"
    if n_rows >= KERNEL_MIN_ROWS and F < 128 and 128 % F == 0:
        return "rows"
    return "columns"


def _gather(spec: HashGridSpec, table: torch.Tensor, ind: torch.Tensor,
            level_offsets: Tuple[int, ...]) -> torch.Tensor:
    """ind (n_lev, 8, N) -> (n_lev, 8, N, F') in the table's dtype: F' = 1
    for scalar grids (the value q), else the F features."""
    _observe_rows(table, ind)
    plan = gather_plan(spec, table.shape[0])
    rounded = not spec.exact_grads
    det = spec.sorted_grads
    if plan == "scalar":
        return scalar_table_gather(table, ind, level_offsets, False, det)[..., None]
    if plan == "rows":
        return table_gather(table, ind, level_offsets, rounded, det)
    return torch.stack([scalar_table_gather(table[:, f], ind, level_offsets,
                                            rounded, det)
                        for f in range(spec.n_features)], dim=-1)


def encode_grad_routes(spec: HashGridSpec, table_dtype: torch.dtype) -> List[str]:
    """The :func:`grad_route` of every table gradient one backward of an
    encoding through ``spec`` computes, in order (one per gather call)."""
    routes = []
    for _, rows, level_offsets in spec.tables():
        plan = gather_plan(spec, rows)
        rounded = plan != "scalar" and not spec.exact_grads
        F = spec.n_features if plan == "rows" else 1
        n_calls = spec.n_features if plan == "columns" else 1
        routes += [grad_route(rows, F, level_offsets, table_dtype, rounded,
                              spec.sorted_grads)] * n_calls
    return routes


def _level_block(table: torch.Tensor, ind: torch.Tensor, ws: torch.Tensor,
                 spec: HashGridSpec, level_offsets) -> torch.Tensor:
    """Gather + corner lerp for one table.  ind/ws (n_lev, 8, N) ->
    (n_lev, F', N) with F' = 1 for scalar grids (the contribution F * q)."""
    v = _gather(spec, table, ind, level_offsets)                # (n_lev, 8, N, F')
    if LERP_DTYPE != torch.float32:
        v, ws = v.to(LERP_DTYPE), ws.to(LERP_DTYPE)
    if spec.scalar:
        return (torch.sum(ws * v[..., 0], dim=1) * spec.n_features)[:, None, :]
    return torch.sum(ws[..., None] * v, dim=1).movedim(-1, 1)  # (n_lev, F, N)


def _dense_offsets(spec: HashGridSpec, device) -> torch.Tensor:
    """(S, 1, 1) int64: each dense level's first row."""
    return device_constant(("dense_offsets", spec.dense_offsets), device,
                           lambda: np.asarray(spec.dense_offsets)[:, None, None],
                           torch.int64)


def _hash_offsets(spec: HashGridSpec, device) -> torch.Tensor:
    """(H, 1, 1) int64: each hashed level's first row."""
    H, T = spec.n_hash_levels, spec.table_size
    return device_constant(("hash_offsets", H, T), device,
                           lambda: (np.arange(H) * T)[:, None, None], torch.int64)


def hashgrid_encode(spec: HashGridSpec, params: dict, xyz: torch.Tensor,
                    bounds: torch.Tensor) -> torch.Tensor:
    """Encode points.  xyz (N, 3); bounds (2, 3) -> (N, out_dim)."""
    N = xyz.shape[0]
    L, F = spec.n_levels, spec.n_features
    S, H = spec.start_hash, spec.n_hash_levels
    x01 = (xyz - bounds[0]) / (bounds[1] - bounds[0])
    dev = xyz.device
    res = device_constant(("entries_num", spec.entries_num), dev,
                          lambda: np.asarray(spec.entries_num)[:, None],
                          torch.int32)                          # (L, 1)
    idx3, w = _corners(x01, res)

    vals = []
    for name, _, level_offsets in spec.tables():
        if name == "dense":
            nd = res[:S].long()[:, :, None]                     # (S, 1, 1)
            ind = (idx3[0][:S] * (nd * nd) + idx3[1][:S] * nd + idx3[2][:S])
            ind = ind + _dense_offsets(spec, dev)
            ws = w[:S]
        else:
            ind = _hash_index([i[S:] for i in idx3], spec.primes, spec.table_size)
            ind = ind + _hash_offsets(spec, dev)
            ws = w[S:]
        vals.append(_level_block(params[name], ind, ws, spec, level_offsets))
    val = torch.cat(vals, dim=0).to(x01.dtype)                  # (L, F', N)

    if spec.scalar:
        out = val[:, 0, :].T                                    # (N, L)
    elif spec.sum:
        out = (torch.sum(val, dim=1).T if spec.sum_over_features
               else torch.sum(val, dim=0).T)                    # (N, L) / (N, F)
    else:
        out = val.reshape(L * F, N).T                           # (N, L*F)
    if spec.include_input:
        out = torch.cat([x01, out], dim=-1)
    _observe_call("hashgrid_encode", N, 1, out.shape[1])
    return out


def multi_hashgrid_encode(specs: Sequence[HashGridSpec], params_list,
                          pts: torch.Tensor, bounds: torch.Tensor,
                          seg_sizes: Sequence[int]) -> torch.Tensor:
    """Encode a part-major concatenation of points through P part grids.

    Equal to :func:`hashgrid_encode` per part on ``pts[off_p: off_p + n_p]``
    with ``bounds[p]``, concatenated; the index and weight math runs once
    over all M points.  pts (M, 3), M == sum(seg_sizes); bounds (P, 2, 3).
    Every spec shares n_levels / n_features / primes and the part-grid mode
    (sum over features).  Returns (M, out_dim).
    """
    P = len(specs)
    s0 = specs[0]
    L, F = s0.n_levels, s0.n_features
    if not all(s.n_levels == L and s.n_features == F and s.sum
               and s.sum_over_features and s.include_input == s0.include_input
               and s.primes == s0.primes and s.scalar == s0.scalar
               for s in specs):
        raise ValueError("multi_hashgrid_encode requires uniform part-grid specs")
    M = int(sum(seg_sizes))
    if pts.shape[0] != M:
        raise ValueError(f"pts has {pts.shape[0]} rows, seg_sizes sum to {M}")
    dev = pts.device
    offs = np.cumsum([0] + list(seg_sizes))
    seg = tuple(int(n) for n in seg_sizes)
    pid = device_constant(("part_ids", seg), dev,
                          lambda: np.repeat(np.arange(P), seg), torch.int64)
    b = bounds[pid]                                             # (M, 2, 3)
    x01 = (pts - b[:, 0]) / (b[:, 1] - b[:, 0])
    entries = tuple(s.entries_num for s in specs)
    res = device_constant(
        ("part_entries_num", entries, seg), dev,
        lambda: np.asarray(entries, np.int32)[np.repeat(np.arange(P), seg)].T,
        torch.int32)                                            # (L, M)
    idx3, w = _corners(x01, res)

    n_lm = res.long()[:, None, :]                               # (L, 1, M)
    ind_dense = idx3[0] * (n_lm * n_lm) + idx3[1] * n_lm + idx3[2]

    def block_feat(s, tab, ind, ws, level_offsets):
        """(n_lev, 8, Kp) -> (n_lev, Kp): feature sum first, f32 lerp."""
        v = _gather(s, tab, ind, level_offsets).to(LERP_DTYPE)
        vsum = v[..., 0] * F if s0.scalar else torch.sum(v, dim=-1)
        return torch.sum(ws.to(LERP_DTYPE) * vsum, dim=1)

    outs = []
    for p in range(P):
        s = specs[p]
        o, e = int(offs[p]), int(offs[p + 1])
        S, H = s.start_hash, s.n_hash_levels
        blocks = []
        for name, _, level_offsets in s.tables():
            if name == "dense":
                ind = ind_dense[:S, :, o:e] + _dense_offsets(s, dev)
                ws = w[:S, :, o:e]
            else:
                ind = _hash_index([i[S:, :, o:e] for i in idx3], s.primes,
                                  s.table_size)
                ind = ind + _hash_offsets(s, dev)
                ws = w[S:, :, o:e]
            blocks.append(block_feat(s, params_list[p][name], ind, ws,
                                     level_offsets))
        outs.append(torch.cat(blocks, dim=0).T)                 # (Kp, L)
    val = torch.cat(outs, dim=0).to(x01.dtype)                  # (M, L)
    if s0.include_input:
        val = torch.cat([x01, val], dim=-1)
    _observe_call("multi_hashgrid_encode", M, P, val.shape[1])
    return val
