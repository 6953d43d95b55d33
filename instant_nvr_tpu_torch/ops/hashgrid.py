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

Routes (:func:`encode_route`).  Points on a CUDA device take the kernels
of ``csrc/hashgrid_encode.cu``, one launch an encoder call, all part grids
of :func:`multi_hashgrid_encode` in one: where no gradient is asked of the
encoding (``torch.no_grad``, ``inference_mode``, or no input that requires
one: the render, the evaluator, the occupancy cube) the forward alone
(:func:`fused_encode`); where one is (every training path) the autograd
Function :func:`fused_autograd_encode`, that forward and one backward
launch (:func:`fused_encode_backward`) that writes the table-gradient
records the scatter kernels above sum, bit-equal to those the plain
chain's autograd hands them, and the points' gradient.  The forward gives
the plain chain's numbers (module doc of the kernel).  A CUDA call the
kernels cannot take raises ValueError with the reason
(:func:`fused_refusal`).  The CPU takes the plain chain
(:func:`hashgrid_encode_plain`, :func:`multi_hashgrid_encode_plain`), the
reference the tests hold; :func:`encode_backward_plain` is the backward
kernel's contract in plain PyTorch, which the Function runs on CPU
tensors.  ``fused_encode.launches`` and ``fused_encode_backward.launches``
count the kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from sympy import nextprime
from torch import nn

from ..utils.constants import device_constant
from . import scatter

_U32 = 0xFFFFFFFF

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


def hashgrid_encode_plain(spec: HashGridSpec, params: dict, xyz: torch.Tensor,
                          bounds: torch.Tensor) -> torch.Tensor:
    """:func:`hashgrid_encode` as the plain chain of PyTorch ops."""
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
    return out


def _check_parts(specs: Sequence[HashGridSpec], pts: torch.Tensor,
                 seg_sizes: Sequence[int]) -> None:
    """Raise unless the part grids share n_levels / n_features / primes and
    the part-grid mode (sum over features), and ``seg_sizes`` covers pts."""
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


def multi_hashgrid_encode_plain(specs: Sequence[HashGridSpec], params_list,
                                pts: torch.Tensor, bounds: torch.Tensor,
                                seg_sizes: Sequence[int]) -> torch.Tensor:
    """:func:`multi_hashgrid_encode` as the plain chain of PyTorch ops: the
    index and weight math runs once over all M points."""
    _check_parts(specs, pts, seg_sizes)
    P = len(specs)
    s0 = specs[0]
    F = s0.n_features
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
        v = _gather(s, tab, ind, level_offsets).to(torch.float32)
        vsum = v[..., 0] * F if s0.scalar else torch.sum(v, dim=-1)
        return torch.sum(ws * vsum, dim=1)

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
    return val


def hashgrid_encode(spec: HashGridSpec, params: dict, xyz: torch.Tensor,
                    bounds: torch.Tensor) -> torch.Tensor:
    """Encode points.  xyz (N, 3); bounds (2, 3) -> (N, out_dim).  The
    fused kernels on CUDA (:func:`encode_route`), else
    :func:`hashgrid_encode_plain`."""
    n = (xyz.shape[0],)
    refusal = functools.partial(fused_refusal, (spec,), (params,), xyz, bounds, n)
    route = _route(xyz.device.type, [xyz, bounds, *params.values()], refusal)
    if route == "fused":
        return fused_encode((spec,), (params,), xyz, bounds.reshape(1, 2, 3), n,
                            multi=False)
    if route == "grad":
        return fused_autograd_encode((spec,), (params,), xyz, bounds, n, multi=False)
    return hashgrid_encode_plain(spec, params, xyz, bounds)


def multi_hashgrid_encode(specs: Sequence[HashGridSpec], params_list,
                          pts: torch.Tensor, bounds: torch.Tensor,
                          seg_sizes: Sequence[int]) -> torch.Tensor:
    """Encode a part-major concatenation of points through P part grids.

    Equal to :func:`hashgrid_encode` per part on ``pts[off_p: off_p + n_p]``
    with ``bounds[p]``, concatenated.  pts (M, 3), M == sum(seg_sizes);
    bounds (P, 2, 3).  Every spec shares n_levels / n_features / primes and
    the part-grid mode (sum over features).  Returns (M, out_dim): from one
    launch of the fused kernel on CUDA (:func:`encode_route`; its backward
    one more), else from :func:`multi_hashgrid_encode_plain`.
    """
    _check_parts(specs, pts, seg_sizes)
    tensors = [pts, bounds] + [t for tabs in params_list for t in tabs.values()]
    refusal = functools.partial(fused_refusal, specs, params_list, pts, bounds, seg_sizes)
    route = _route(pts.device.type, tensors, refusal)
    if route == "fused":
        return fused_encode(specs, params_list, pts, bounds, seg_sizes, multi=True)
    if route == "grad":
        return fused_autograd_encode(specs, params_list, pts, bounds, seg_sizes, multi=True)
    return multi_hashgrid_encode_plain(specs, params_list, pts, bounds, seg_sizes)


# --------------------------------------------------------------------------
# the fused forward (csrc/hashgrid_encode.cu)
# --------------------------------------------------------------------------

# what the kernel takes (its kMaxParts, kMaxLevels, kMaxStaged)
FUSED_FEATURES = (1, 2, 4, 8, 16)
FUSED_MAX_PARTS = 8
FUSED_MAX_LEVELS = 32
FUSED_MAX_STAGED = 256
# the kernel's modes (its enum Mode)
_SCALAR, _LEVEL_SUM, _FEATURE_SUM, _CONCAT = range(4)


def encode_route(device_type: str, needs_grad: bool, refusal: Optional[str] = None) -> str:
    """Where an encoder call goes: for points on a CUDA device 'fused'
    (:func:`fused_encode`) when no gradient is asked of the encoding, else
    'grad' (:func:`fused_autograd_encode`); off CUDA 'plain' (the chain of
    PyTorch ops, whose table gathers carry the scatter-kernel backward).
    Raises ValueError on CUDA when the kernels cannot take the call:
    ``refusal`` (:func:`fused_refusal`) says why."""
    if device_type != "cuda":
        return "plain"
    if refusal is not None:
        raise ValueError(f"the fused hash-grid encoding cannot take this CUDA call: "
                         f"{refusal}")
    return "grad" if needs_grad else "fused"


def _fused_mode(spec: HashGridSpec) -> int:
    """The kernel's mode for ``spec``: one value a row times F, the sum over
    features (a column a level), the sum over levels, or the concat."""
    if spec.scalar:
        return _SCALAR
    if spec.sum:
        return _LEVEL_SUM if spec.sum_over_features else _FEATURE_SUM
    return _CONCAT


def fused_refusal(specs: Sequence[HashGridSpec], params_list, pts: torch.Tensor,
                  bounds: torch.Tensor, seg_sizes: Sequence[int]) -> Optional[str]:
    """Why the kernels cannot take this call, or None where they can: they
    take uniform specs within their limits, float32 points (M, 3) and
    bounds (P, 2, 3) (or (2, 3) for one part) that ask for no gradient, and
    tables of one dtype (float32 or bfloat16), contiguous, 16-byte aligned,
    of the specs' shapes, on the points' device."""
    s0 = specs[0]
    L, F = s0.n_levels, s0.n_features
    staged = L * F if _fused_mode(s0) in (_FEATURE_SUM, _CONCAT) else L
    if len(specs) > FUSED_MAX_PARTS:
        return f"{len(specs)} part grids, more than {FUSED_MAX_PARTS}"
    if F not in FUSED_FEATURES:
        return f"{F} features a level, not one of {FUSED_FEATURES}"
    if L > FUSED_MAX_LEVELS:
        return f"{L} levels, more than {FUSED_MAX_LEVELS}"
    if staged > FUSED_MAX_STAGED:
        return f"{staged} output values a point, more than {FUSED_MAX_STAGED}"
    if any(s.n_levels != L or s.n_features != F or s.primes != s0.primes
           or s.scalar != s0.scalar or s.sum != s0.sum
           or s.sum_over_features != s0.sum_over_features
           or s.include_input != s0.include_input for s in specs):
        return "part grids of different levels, features, primes or modes"
    M = int(sum(seg_sizes))
    if pts.dtype != torch.float32 or tuple(pts.shape) != (M, 3) or 3 * M >= 2 ** 31:
        return f"points {pts.dtype} {tuple(pts.shape)}, not float32 ({M}, 3) under 2**31 values"
    if (bounds.dtype != torch.float32 or bounds.device != pts.device
            or bounds.numel() != 6 * len(specs)):
        return (f"bounds {bounds.dtype} {tuple(bounds.shape)} on {bounds.device}, not "
                f"float32 ({len(specs)}, 2, 3) on {pts.device}")
    if torch.is_grad_enabled() and bounds.requires_grad:
        return "bounds that require a gradient: the backward kernel gives the points' alone"
    dtype = params_list[0]["dense"].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        return f"{dtype} tables, not float32 or bfloat16"
    for p, (s, tabs) in enumerate(zip(specs, params_list)):
        cols = () if s.scalar else (F,)
        for name, rows in (("dense", s.dense_rows), ("hash", s.hash_rows)):
            t = tabs[name]
            if t.dtype != dtype:
                return f"part {p}'s {name} table is {t.dtype}, part 0's dense one {dtype}"
            if tuple(t.shape) != (rows,) + cols or t.device != pts.device:
                return (f"part {p}'s {name} table {tuple(t.shape)} on {t.device}, "
                        f"not {(rows,) + cols} on {pts.device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                return f"part {p}'s {name} table is not contiguous and 16-byte aligned"
    return None


def _route(device_type: str, tensors, refusal) -> str:
    """:func:`encode_route` of a call on ``tensors`` (points, bounds,
    tables); ``refusal()`` is asked only of CUDA calls."""
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return encode_route(device_type, needs_grad,
                        refusal() if device_type == "cuda" else None)


@functools.lru_cache(maxsize=64)
def _part_ints(specs: Tuple[HashGridSpec, ...]) -> np.ndarray:
    """(P, 2 + 2 L) int32: each part's first hashed level, table size,
    entries a side and dense level offsets (the kernel's Part)."""
    L = specs[0].n_levels
    rows = []
    for s in specs:
        offs = list(s.dense_offsets) + [0] * (L - len(s.dense_offsets))
        rows.append([s.start_hash, s.table_size, *s.entries_num, *offs])
    return np.ascontiguousarray(rows, dtype=np.int32)


def load_fused_kernel():
    """Build (if needed) and load ``csrc/hashgrid_encode.cu`` -> its launch
    function.  Raises if the build fails."""
    from ..cuda_build import load_library
    fn = load_library("hashgrid_encode").hashgrid_encode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def fused_encode(specs: Sequence[HashGridSpec], params_list, pts: torch.Tensor,
                 bounds: torch.Tensor, seg_sizes: Sequence[int],
                 multi: bool = True) -> torch.Tensor:
    """One launch of ``csrc/hashgrid_encode.cu`` on the current stream:
    the part-major points ``pts`` (M, 3) through the part grids ``specs``
    with ``bounds`` (P, 2, 3) -> (M, out_dim) float32, the same floats as
    :func:`multi_hashgrid_encode_plain` (``multi``) or, for one part,
    :func:`hashgrid_encode_plain` computes on the card (the two sum in
    different orders: module doc of the kernel).  The caller has checked
    :func:`fused_refusal`.  No host sync and no allocation but the output,
    so it runs inside a CUDA graph capture."""
    s0 = specs[0]
    M = int(sum(seg_sizes))
    out = torch.empty((M, s0.out_dim), dtype=torch.float32, device=pts.device)
    if M == 0:
        return out
    pts, bounds = pts.contiguous(), bounds.contiguous()
    seg, ptrs, ints, primes = _launch_arrays(specs, params_list, bounds, seg_sizes)
    launch = load_fused_kernel()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = launch(pts.data_ptr(), out.data_ptr(), M, len(specs), seg.ctypes.data,
                     ptrs.ctypes.data, ints.ctypes.data, s0.n_levels, s0.n_features,
                     1 if s0.scalar else s0.n_features,
                     int(params_list[0]["dense"].dtype == torch.bfloat16),
                     _fused_mode(s0), int(multi), int(s0.include_input), s0.out_dim,
                     primes.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"hashgrid_encode kernel launch failed: cudaError {err}")
    fused_encode.launches += 1
    return out


fused_encode.launches = 0


def _launch_arrays(specs: Sequence[HashGridSpec], params_list, bounds: torch.Tensor,
                   seg_sizes: Sequence[int]):
    """The host arrays both launch functions read: the part-major segment
    starts, each part's (dense, hash, bounds row) pointers, its level
    constants (:func:`_part_ints`) and the primes."""
    seg = np.cumsum([0] + [int(n) for n in seg_sizes], dtype=np.int64).astype(np.int32)
    ptrs = np.asarray([[t["dense"].data_ptr(), t["hash"].data_ptr(),
                        bounds.data_ptr() + 24 * p] for p, t in enumerate(params_list)],
                      dtype=np.uint64)
    primes = np.asarray([p & 0xFFFFFFFF for p in specs[0].primes], dtype=np.uint32)
    return seg, ptrs, _part_ints(tuple(specs)), primes


# --------------------------------------------------------------------------
# the fused backward (csrc/hashgrid_encode.cu: hashgrid_backward_kernel)
# --------------------------------------------------------------------------

class RecordTable(NamedTuple):
    """Where one table's gradient records lie in a backward's flat buffers:
    part ``part``'s ``name`` table, its levels ``levels`` of the encoding,
    records [first, first + rows) (``(n_lev, 8, kp)`` level-major), the
    payload ``V`` values a record from ``first * V``, feature-major (one
    column a scatter call, the 'columns' plan) or record-major."""
    part: int
    name: str
    levels: Tuple[int, int]
    kp: int
    first: int
    rows: int
    n_rows: int
    level_offsets: Tuple[int, ...]
    plan: str


def record_tables(specs: Sequence[HashGridSpec], seg_sizes: Sequence[int]) -> List[RecordTable]:
    """Each table's place in the records of one backward, in the order the
    kernel writes them: part by part, the dense levels then the hashed."""
    L = specs[0].n_levels
    out, start = [], 0
    for p, (s, kp) in enumerate(zip(specs, (int(n) for n in seg_sizes))):
        lo = 0
        for name, n_rows, level_offsets in s.tables():
            hi = s.start_hash if name == "dense" else L
            out.append(RecordTable(p, name, (lo, hi), kp, start + lo * 8 * kp,
                                   (hi - lo) * 8 * kp, n_rows, level_offsets,
                                   gather_plan(s, n_rows)))
            lo = hi
        start += L * 8 * kp
    return out


def payload_dtype(spec: HashGridSpec, table_dtype: torch.dtype) -> torch.dtype:
    """The records' payload dtype: float32 where the tables' gradient is
    exact (:func:`grad_route`: float32 tables read whole, or under
    ``exact_grads``), else bfloat16, the scatter kernels'."""
    exact = table_dtype != torch.bfloat16 and (spec.scalar or spec.exact_grads)
    return torch.float32 if exact else torch.bfloat16


def _backward_buffers(specs, seg_sizes, device, dtype, need_pts):
    L, M = specs[0].n_levels, int(sum(seg_sizes))
    V = 1 if specs[0].scalar else specs[0].n_features
    idx = torch.empty(L * 8 * M, dtype=torch.int32, device=device)
    payload = torch.empty(L * 8 * M * V, dtype=dtype, device=device)
    pts_grad = torch.empty((M, 3), dtype=torch.float32, device=device) if need_pts else None
    return idx, payload, pts_grad


def load_backward_kernel():
    """Build (if needed) and load ``csrc/hashgrid_encode.cu`` -> its
    backward launch function.  Raises if the build fails."""
    from ..cuda_build import load_library
    fn = load_library("hashgrid_encode").hashgrid_backward_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_encode_backward(specs: Sequence[HashGridSpec], params_list, pts: torch.Tensor,
                          bounds: torch.Tensor, seg_sizes: Sequence[int], g: torch.Tensor,
                          multi: bool, need_pts: bool, dtype: torch.dtype):
    """One launch of the backward kernel on the current stream: for the
    forward :func:`fused_encode` ran (the same arguments) and ``g``, the
    (M, out_dim) cotangent of its output -> (idx, payload, pts_grad): the
    table-gradient records, laid out as :func:`record_tables` says, with
    ``dtype`` payloads, and with ``need_pts`` the (M, 3) float32 gradient
    of the points (else None).  :func:`encode_backward_plain` states the
    numbers.  No host sync and no allocation but the outputs, so it runs
    inside a CUDA graph capture."""
    s0 = specs[0]
    M = int(sum(seg_sizes))
    idx, payload, pts_grad = _backward_buffers(specs, seg_sizes, pts.device, dtype, need_pts)
    if M == 0:
        return idx, payload, pts_grad
    pts, bounds, g = pts.contiguous(), bounds.contiguous(), g.contiguous()
    seg, ptrs, ints, primes = _launch_arrays(specs, params_list, bounds, seg_sizes)
    fmajor = np.zeros((len(specs), 2), dtype=np.int32)
    for t in record_tables(specs, seg_sizes):
        fmajor[t.part, int(t.name == "hash")] = t.plan == "columns"
    launch = load_backward_kernel()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = launch(pts.data_ptr(), g.data_ptr(), idx.data_ptr(), payload.data_ptr(),
                     pts_grad.data_ptr() if need_pts else 0, M, len(specs),
                     seg.ctypes.data, ptrs.ctypes.data, ints.ctypes.data, fmajor.ctypes.data,
                     s0.n_levels, s0.n_features, 1 if s0.scalar else s0.n_features,
                     int(params_list[0]["dense"].dtype == torch.bfloat16),
                     _fused_mode(s0), int(multi), int(s0.include_input), s0.out_dim,
                     primes.ctypes.data, int(dtype == torch.bfloat16), int(need_pts), stream)
    if err != 0:
        raise RuntimeError(f"hashgrid_backward kernel launch failed: cudaError {err}")
    fused_encode_backward.launches += 1
    return idx, payload, pts_grad


fused_encode_backward.launches = 0


def _level_cotangent(spec: HashGridSpec, g: torch.Tensor) -> torch.Tensor:
    """(kp, out_dim) cotangent -> (L, V, kp): each level's V values'."""
    L, F = spec.n_levels, spec.n_features
    V = 1 if spec.scalar else F
    gl = g[:, 3:] if spec.include_input else g
    mode = _fused_mode(spec)
    if mode == _CONCAT:
        return gl.reshape(-1, L, V).permute(1, 2, 0)
    if mode == _FEATURE_SUM:
        return gl[:, :V].T[None].expand(L, V, -1)
    return gl[:, :L].T[:, None].expand(L, V, -1)


def encode_backward_plain(specs: Sequence[HashGridSpec], params_list, pts: torch.Tensor,
                          bounds: torch.Tensor, seg_sizes: Sequence[int], g: torch.Tensor,
                          multi: bool, need_pts: bool, dtype: torch.dtype):
    """:func:`fused_encode_backward`'s contract in plain PyTorch, float op
    for float op (the twin the tests hold against autograd through the
    plain chain).

    Records: each (level, corner, point)'s row, as the plain chain indexes
    the table, and payload ``ge * w`` in ``dtype`` for the level's
    cotangent ``ge`` and the corner's weight ``w``, but for scalar grids
    ``(ge * F) * w`` (``multi`` False: :func:`hashgrid_encode_plain`'s
    product order) or ``(ge * w) * F`` (``multi``: the order of
    :func:`multi_hashgrid_encode_plain`).

    Points (``need_pts``): for each level, ``u_c`` = the sum over the
    corner's row values of cotangent x value (scalar grids: ``(ge * v) *
    F``), then for each dimension d the sum over the corners in order of
    ``u_c * (+-)`` the product of the other two dimensions' weights (the
    sign of the corner's bit), times ``res - 1``; the levels summed in
    order from 0, then the normalised point's own cotangent (with
    ``include_input``), over the box's extent."""
    s0 = specs[0]
    L, V = s0.n_levels, 1 if s0.scalar else s0.n_features
    nf = float(s0.n_features)
    dev = pts.device
    idx, payload, pts_grad = _backward_buffers(specs, seg_sizes, dev, dtype, need_pts)
    b = bounds.reshape(-1, 2, 3)
    offs = np.cumsum([0] + [int(n) for n in seg_sizes])
    tabs = record_tables(specs, seg_sizes)
    cbits = torch.from_numpy(_corner_bits()).to(dev)                 # (8, 3)
    for p, s in enumerate(specs):
        o, e = int(offs[p]), int(offs[p + 1])
        if e == o:
            continue
        x01 = (pts[o:e] - b[p, 0]) / (b[p, 1] - b[p, 0])
        res = torch.tensor(s.entries_num, dtype=torch.int32, device=dev)[:, None]
        idx3, w = _corners(x01, res)                                  # (L, 8, kp)
        S = s.start_hash
        ind = torch.empty_like(idx3[0])
        if S:
            n = res[:S].long()[:, :, None]
            ind[:S] = (idx3[0][:S] * (n * n) + idx3[1][:S] * n + idx3[2][:S]
                       + _dense_offsets(s, dev))
        if S < L:
            ind[S:] = (_hash_index([i[S:] for i in idx3], s.primes, s.table_size)
                       + _hash_offsets(s, dev))
        ge = _level_cotangent(s, g[o:e])                             # (L, V, kp)
        if s.scalar:
            g0 = ge[:, 0][:, None, :]
            vals = ((g0 * w) * nf if multi else (g0 * nf) * w)[..., None]
        else:
            vals = ge.permute(0, 2, 1)[:, None] * w[..., None]      # (L, 8, kp, V)
        vals = vals.to(dtype)
        for t in (t for t in tabs if t.part == p):
            lo, hi = t.levels
            idx[t.first:t.first + t.rows] = ind[lo:hi].reshape(-1).to(torch.int32)
            v = vals[lo:hi].reshape(t.rows, V)
            payload[t.first * V:(t.first + t.rows) * V] = (
                v.T.reshape(-1) if t.plan == "columns" else v.reshape(-1))
        if not need_pts:
            continue
        # the corners' row values, float32 (L, 8, kp, V)
        val = torch.empty(ind.shape + (V,), dtype=torch.float32, device=dev)
        for t in (t for t in tabs if t.part == p):
            lo, hi = t.levels
            val[lo:hi] = params_list[p][t.name][ind[lo:hi]].reshape(
                (hi - lo, 8, e - o, V)).float()
        if s.scalar:
            u = (ge[:, 0][:, None, :] * val[..., 0]) * nf
        else:
            u = torch.zeros_like(w)
            for f in range(V):
                u = u + ge[:, f][:, None, :] * val[..., f]
        # each dimension's weights of the corners, as the forward takes them
        scale = res.to(torch.float32) - 1.0                          # (L, 1)
        wd = []
        for d in range(3):
            fd = x01[:, d][None, :] * scale                           # (L, kp)
            lo_d = torch.minimum(torch.clamp(fd.to(torch.int32).long(), min=0),
                                 res.long() - 1).to(torch.float32)
            off = fd - lo_d
            bit = cbits[:, d].bool()[None, :, None]
            wd.append(torch.where(bit, off[:, None, :], (1.0 - off)[:, None, :]))
        dw = (wd[1] * wd[2], wd[0] * wd[2], wd[0] * wd[1])
        x_grad = []
        for d in range(3):
            signed = torch.where(cbits[:, d].bool()[None, :, None], dw[d], -dw[d])
            acc = torch.zeros_like(u[:, 0])
            for c in range(8):
                acc = acc + u[:, c] * signed[:, c]
            dxl = acc * scale                                         # (L, kp)
            tot = torch.zeros_like(dxl[0])
            for lev in range(L):
                tot = tot + dxl[lev]
            if s.include_input:
                tot = tot + g[o:e, d]
            x_grad.append(tot / (b[p, 1, d] - b[p, 0, d]))
        pts_grad[o:e] = torch.stack(x_grad, dim=-1)
    return idx, payload, pts_grad


def _table_grads(specs: Sequence[HashGridSpec], tables: Sequence[torch.Tensor],
                 seg_sizes: Sequence[int], idx: torch.Tensor, payload: torch.Tensor,
                 needs: Sequence[bool]) -> List[Optional[torch.Tensor]]:
    """The gradient of each of ``tables`` (part by part, dense then hash),
    or None where ``needs`` says none is asked: the records handed to
    :func:`_table_grad` as the plain chain's gathers hand theirs, one call a
    table, or a column of a table the encoders read by column."""
    V = 1 if specs[0].scalar else specs[0].n_features
    grads: List[Optional[torch.Tensor]] = [None] * len(tables)
    slot = {(p, name): 2 * p + i for p in range(len(specs))
            for i, name in enumerate(("dense", "hash"))}
    for t in record_tables(specs, seg_sizes):
        k = slot[(t.part, t.name)]
        if not needs[k]:
            continue
        s, table = specs[t.part], tables[k]
        ind = idx[t.first:t.first + t.rows].view(t.levels[1] - t.levels[0], 8, t.kp)
        pay = payload[t.first * V:(t.first + t.rows) * V]
        args = (t.n_rows, t.level_offsets, table.dtype)
        if t.plan == "columns":
            cols = pay.view(V, t.rows)
            grads[k] = torch.cat([_table_grad(ind, cols[f].view(t.rows, 1), *args,
                                              not s.exact_grads, s.sorted_grads)
                                  for f in range(V)], dim=1)
        else:
            grads[k] = _table_grad(ind, pay.view(t.rows, V), *args,
                                   t.plan == "rows" and not s.exact_grads, s.sorted_grads)
        grads[k] = grads[k].reshape(table.shape)
    return grads


class _FusedEncode(torch.autograd.Function):
    """The encoding with the kernels' forward and backward: on CUDA
    :func:`fused_encode` and :func:`fused_encode_backward`, on the CPU the
    plain chain and :func:`encode_backward_plain`.  Saves the points, the
    bounds and the tables it read; the records go to the scatter kernels
    through :func:`_table_grad`."""

    @staticmethod
    def forward(ctx, specs, seg_sizes, multi, pts, bounds, *tables):
        params_list = [{"dense": tables[2 * p], "hash": tables[2 * p + 1]}
                       for p in range(len(specs))]
        if pts.device.type == "cuda":
            out = fused_encode(specs, params_list, pts, bounds.reshape(-1, 2, 3), seg_sizes,
                               multi=multi)
        elif multi:
            out = multi_hashgrid_encode_plain(specs, params_list, pts, bounds, seg_sizes)
        else:
            out = hashgrid_encode_plain(specs[0], params_list[0], pts, bounds)
        ctx.save_for_backward(pts, bounds, *tables)
        ctx.meta = (specs, seg_sizes, multi)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pts, bounds, *tables = ctx.saved_tensors
        specs, seg_sizes, multi = ctx.meta
        need_pts = ctx.needs_input_grad[3]
        needs = ctx.needs_input_grad[5:]
        params_list = [{"dense": tables[2 * p], "hash": tables[2 * p + 1]}
                       for p in range(len(specs))]
        dtype = payload_dtype(specs[0], tables[0].dtype)
        fn = fused_encode_backward if pts.device.type == "cuda" else encode_backward_plain
        idx, payload, pts_grad = fn(specs, params_list, pts, bounds.reshape(-1, 2, 3),
                                    seg_sizes, g, multi, need_pts, dtype)
        grads = _table_grads(specs, tables, seg_sizes, idx, payload, needs)
        return (None, None, None, pts_grad, None, *grads)


def fused_autograd_encode(specs: Sequence[HashGridSpec], params_list, pts: torch.Tensor,
                          bounds: torch.Tensor, seg_sizes: Sequence[int],
                          multi: bool = True) -> torch.Tensor:
    """:func:`multi_hashgrid_encode` (``multi``) or :func:`hashgrid_encode`
    (one spec, ``bounds`` (2, 3)) through the autograd Function of the
    kernels: the same forward as :func:`fused_encode`, and a backward of
    one kernel launch plus the table-gradient scatters.  The caller has
    checked :func:`fused_refusal` on CUDA."""
    tables = [t[name] for t in params_list for name in ("dense", "hash")]
    return _FusedEncode.apply(tuple(specs), tuple(int(n) for n in seg_sizes), bool(multi),
                              pts, bounds, *tables)
