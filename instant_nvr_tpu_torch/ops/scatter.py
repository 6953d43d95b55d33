"""Hash-table gradient scatter-adds (port of the Pallas kernels
``instant_nvr_tpu/ops/pallas/segmented_scatter.py:segmented_scatter_add``
and ``instant_nvr_tpu/ops/pallas/onehot_scatter.py:onehot_scatter_add``).

Both compute the dense gradient of a table from R scatter records:

    grad[keys[r], f] += payload[r, f]      keys (R,) int32, payload (R, F) bf16

summed in float32, rounded to bf16 once and returned as (n_rows, F) bf16;
keys outside [0, n_rows) are dropped.  Records are level-major:
``level_offsets`` (n_levels + 1 ascending row starts, the last one the
level end) give each level's row window, and level l's R / n_levels records
fall inside window l.  F is a power of two <= 128.

* ``segmented_scatter_add`` (any table size) launches ``csrc/segmented_scatter.cu``:
  one pass zeroes the output and adds every record into the float32
  workspace with atomics, a second swaps each touched workspace entry for
  0 and writes it to the output as bf16.  It needs no level windows; it
  takes them so both kernels share one signature.
* ``onehot_scatter_add`` (small tables) launches ``csrc/onehot_scatter.cu``:
  a thread block cluster per level (several when the level has many
  records; :func:`onehot_plan`) sums the level's row window in shared
  memory and reduces it across the cluster's blocks through distributed
  shared memory; several clusters of a level meet in the workspace.  The widest window must fit a block's shared memory
  (:func:`onehot_fits`).  A record whose key lies inside the table but
  outside its level's window is outside the contract: the kernel drops it,
  as the TPU kernel does, where the plain version adds it.
* ``sorted_scatter_add`` (``fix_random``: every table) is the deterministic
  form, as the TPU kernel is, and launches ``csrc/sorted_scatter.cu``: the
  records are grouped by output tile in a stable bucket pass that carries
  the payload (no sort of indices, no gather), and one block per tile
  orders its records by row in shared memory, sums each row in a fixed
  order with no atomics and writes the tile once; a table that fits a
  block's shared memory is one tile, cut into splits whose partial tables
  meet in split order (:func:`sorted_plan`).  Two runs give the same bits.
  An exact float32 table keeps ``exact_scatter_add`` under ``fix_random``:
  ``index_add_`` is deterministic under ``torch.use_deterministic_algorithms``.

Each wrapper call is one call into its library, which enqueues all of its
work: no zero fill of a workspace and no cast pass over the table.  The
two atomic kernels share one persistent float32 workspace per (device, stream)
(:func:`workspace`), all zero between calls: the segmented kernel's
accumulator and, with several clusters per level, the one-hot kernel's
(its window sums, then one ticket word per level behind the table).
It is as large as the largest table x F the stream has seen (42 MB for the
flagship's body hash table) and never shrinks.  The sorted kernel has a
byte workspace of its own per (device, stream) (:func:`sorted_workspace`),
whose content between calls is of no meaning.

On a CPU tensor each wrapper runs its ``*_plain`` version (a float32
``index_add_`` into zeros, cast to bf16: the contract of
``segmented_scatter_add_ref``); on a CUDA tensor it launches its kernel or
raises, and adds one to its ``.launches``.  The results differ only in
the order of the float32 sums.  ``exact_scatter_add`` is the float32
gradient of an f32 table that may not be rounded (``grid_compute_dtype:
float32``); it counts its calls in ``.calls``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.utils.deterministic

# shared memory a block may opt into on Hopper (sm_90: 227 KB); the one-hot
# kernel's accumulator holds the widest level window x F in float32
ONEHOT_SMEM_BYTES = 232448
_MAX_LEVELS = 64          # kMaxLevels in onehot_scatter.cu
CLUSTER_MAX = 8           # the portable thread block cluster size (kMaxCluster)
# (record, feature) elements a one-hot block aims for: its float32 shared
# atomics are compare-and-swap loops on sm_90, so records are spread over
# as many SMs as the card has before a block takes more
BLOCK_ELEMS = 4096
_TICKETS = _MAX_LEVELS    # the one-hot kernel's ticket words behind the table


def _scatter_plain(keys: torch.Tensor, payload: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    acc = torch.zeros((n_rows, payload.shape[1]), dtype=torch.float32,
                      device=payload.device)
    acc.index_add_(0, keys.long(), payload.float())
    return acc.to(torch.bfloat16)


def segmented_scatter_add_plain(keys: torch.Tensor, payload: torch.Tensor,
                                n_rows: int,
                                level_offsets: Sequence[int] = ()) -> torch.Tensor:
    """Plain PyTorch version of :func:`segmented_scatter_add`."""
    return _scatter_plain(keys, payload, n_rows)


def onehot_scatter_add_plain(keys: torch.Tensor, payload: torch.Tensor,
                             n_rows: int,
                             level_offsets: Sequence[int] = ()) -> torch.Tensor:
    """Plain PyTorch version of :func:`onehot_scatter_add`."""
    return _scatter_plain(keys, payload, n_rows)


def sorted_scatter_add_plain(keys: torch.Tensor, payload: torch.Tensor,
                             n_rows: int,
                             level_offsets: Sequence[int] = ()) -> torch.Tensor:
    """Plain PyTorch version of :func:`sorted_scatter_add`: the stable sort,
    then each row's records added in order in float32 (``index_add_`` on
    the CPU adds in index order), keys outside the table dropped; bf16."""
    skeys, order = torch.sort(keys, stable=True)
    keep = (skeys >= 0) & (skeys < n_rows)
    acc = torch.zeros((n_rows, payload.shape[1]), dtype=torch.float32,
                      device=payload.device)
    acc.index_add_(0, skeys[keep].long(), payload[order[keep]].float())
    return acc.to(payload.dtype)


def sorted_scatter_add_ordered(keys: torch.Tensor, payload: torch.Tensor,
                               n_rows: int,
                               level_offsets: Sequence[int] = ()) -> torch.Tensor:
    """The sorted kernel's own summation order in plain PyTorch, on the CPU
    (whose ``index_add_`` adds in index order): the records in bucket order
    (by tile, then record order; the small regime keeps every record in
    place), cut into splits and chunks as :func:`sorted_plan` says; each
    (chunk, row) summed from +0 in record order, each (split, row) from +0
    in chunk order, each row from +0 in split order.  The kernel's result
    bit for bit; against :func:`sorted_scatter_add_plain` it differs only on
    rows whose records span chunks."""
    R, F = payload.shape
    plan = sorted_plan(R, F, n_rows)
    k, x = keys.long().cpu(), payload.cpu().float()
    if plan.tiled:
        keep = (k >= 0) & (k < n_rows)
        k, x = k[keep], x[keep]
        t = k // plan.tile_rows
        order = torch.sort(t, stable=True).indices
        k, x, t = k[order], x[order], t[order]
        n_t = torch.bincount(t, minlength=plan.tiles)
        rank = torch.arange(len(k)) - (torch.cumsum(n_t, 0) - n_t)[t]
        n_t = n_t[t]
    else:
        t, rank, n_t = torch.zeros_like(k), torch.arange(R), torch.full_like(k, R)
    splits = torch.clamp(-(-n_t // plan.split), 1, plan.max_split)
    length = -(-n_t // splits)
    split = rank // length
    chunk = (rank - split * length) // plan.chunk
    keep = (k >= 0) & (k < n_rows)
    k, x, t, split, chunk = k[keep], x[keep], t[keep], split[keep], chunk[keep]
    def number(*ids):
        """Consecutive ids of the groups of equal ``ids`` in bucket order."""
        new = torch.ones(len(k), dtype=torch.bool)
        for v in ids:
            new[1:] |= v[1:] != v[:-1]
        return torch.cumsum(new.long(), 0) - 1
    cid, sid = number(t, split, chunk), number(t, split)
    split_of = torch.zeros(len(k), dtype=torch.long).scatter_(0, cid, sid)
    pair, inv = torch.unique(cid * n_rows + k, return_inverse=True)
    acc = torch.zeros((len(pair), F)).index_add_(0, inv, x)          # (chunk, row)
    pair, inv = torch.unique(split_of[pair // n_rows] * n_rows + pair % n_rows,
                             return_inverse=True)
    acc = torch.zeros((len(pair), F)).index_add_(0, inv, acc)        # (split, row)
    out = torch.zeros((n_rows, F)).index_add_(0, pair % n_rows, acc)
    return out.to(payload.dtype)


def exact_scatter_add(keys: torch.Tensor, g: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """(n_rows, F) gradient in g's dtype, summed in that dtype (index_add_)."""
    exact_scatter_add.calls += 1
    acc = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return acc.index_add_(0, keys.reshape(-1).long(), g)


exact_scatter_add.calls = 0


def _window_rows(level_offsets: Sequence[int]) -> int:
    return max(b - a for a, b in zip(level_offsets[:-1], level_offsets[1:]))


def onehot_fits(level_offsets: Sequence[int], F: int) -> bool:
    """Whether the widest level window x F float32 fits one block's shared
    memory (and the level count the kernel's window table)."""
    n_levels = len(level_offsets) - 1
    return (0 < n_levels <= _MAX_LEVELS
            and _window_rows(level_offsets) * F * 4 <= ONEHOT_SMEM_BYTES)


def _check_onehot(level_offsets: Sequence[int], F: int) -> None:
    if not onehot_fits(level_offsets, F):
        raise ValueError(
            f"onehot_scatter_add: widest level window {_window_rows(level_offsets)} "
            f"rows x F={F} x 4 B exceeds {ONEHOT_SMEM_BYTES} B of shared memory, "
            f"or {len(level_offsets) - 1} levels exceed {_MAX_LEVELS}")


def _check_args(name: str, keys, payload, n_rows: int, level_offsets=None):
    if keys.device != payload.device:
        raise ValueError(f"{name}: keys on {keys.device}, payload on {payload.device}")
    if keys.dtype != torch.int32 or keys.ndim != 1 or not keys.is_contiguous():
        raise TypeError(f"{name}: keys must be contiguous (R,) int32, got "
                        f"{keys.dtype} {tuple(keys.shape)}")
    if (payload.dtype != torch.bfloat16 or payload.ndim != 2
            or not payload.is_contiguous()):
        raise TypeError(f"{name}: payload must be contiguous (R, F) bfloat16, "
                        f"got {payload.dtype} {tuple(payload.shape)}")
    R, F = payload.shape
    if keys.shape[0] != R:
        raise ValueError(f"{name}: {keys.shape[0]} keys for {R} payload rows")
    if F < 1 or F > 128 or F & (F - 1):
        raise ValueError(f"{name}: F={F} is not a power of two <= 128")
    if not 0 < n_rows or n_rows * F >= 2 ** 31:
        raise ValueError(f"{name}: n_rows={n_rows} x F={F} outside the kernel's "
                         f"int32 row index")
    if level_offsets is not None:
        L = len(level_offsets) - 1
        if L < 1 or R % L or list(level_offsets) != sorted(level_offsets) \
                or level_offsets[0] < 0 or level_offsets[-1] > n_rows:
            raise ValueError(f"{name}: bad level_offsets {tuple(level_offsets)} "
                             f"for R={R}, n_rows={n_rows}")


def _stream(t: torch.Tensor) -> int:
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # several microseconds per call
    return torch._C._cuda_getCurrentRawStream(t.device.index)


_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _refuse_under_capture(what: str, device: torch.device) -> None:
    """A workspace made inside a CUDA graph capture would come from the
    graph's pool and be zeroed by a node of the graph: the eager warm-up on
    the capturing stream must size it first."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} would be allocated under CUDA graph capture; "
                           f"warm up on the capturing stream first")


# workspaces a larger one replaced: a CUDA graph captured with one holds its
# address, so none is ever freed
_retired = []


def workspace(device: torch.device, n: int, stream: int = 0) -> torch.Tensor:
    """The float32 workspace of (device, stream), at least ``n`` floats.
    Allocated with ``torch.zeros`` at first use and replaced by a larger
    zeroed one only when a call needs more; it never shrinks, and one it
    replaces is kept.  The kernels leave it all zero when their work ends,
    and so does every replay of a CUDA graph that captured them.  A capture
    finds the workspace its warm-up made on the same stream, and raises if
    it would need a new one."""
    key = (torch.device(device), stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < n:
        _refuse_under_capture("the scatter workspace", key[0])
        if ws is not None:
            _retired.append(ws)
        ws = torch.zeros(n, dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws


def workspace_nonzero() -> int:
    """Nonzero words over every workspace (0 between calls); synchronises."""
    return sum(int(torch.count_nonzero(ws.view(torch.int32)))
               for ws in [*_workspaces.values(), *_retired] if ws.dtype == torch.float32)


_launch = {}


def load_segmented_kernel():
    """Build (if needed) and load ``csrc/segmented_scatter.cu`` -> its launch
    function.  Raises if the build fails."""
    fn = _launch.get("segmented")
    if fn is None:
        from ..cuda_build import load_library
        fn = load_library("segmented_scatter").segmented_scatter_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch["segmented"] = fn
    return fn


def load_onehot_kernel():
    """Build (if needed) and load ``csrc/onehot_scatter.cu`` -> its launch
    function.  Raises if the build fails."""
    fn = _launch.get("onehot")
    if fn is None:
        from ..cuda_build import load_library
        fn = load_library("onehot_scatter").onehot_scatter_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch["onehot"] = fn
    return fn


def segmented_scatter_add(keys: torch.Tensor, payload: torch.Tensor,
                          n_rows: int,
                          level_offsets: Sequence[int] = ()) -> torch.Tensor:
    """(n_rows, F) bf16 table gradient, summed in float32; see module doc."""
    if keys.device.type == "cpu":
        return segmented_scatter_add_plain(keys, payload, n_rows, level_offsets)
    if keys.device.type != "cuda":
        raise ValueError(f"segmented_scatter_add runs on cpu or cuda, not {keys.device}")
    _check_args("segmented_scatter_add", keys, payload, n_rows)
    R, F = payload.shape
    stream = _stream(keys)
    ws = workspace(keys.device, n_rows * F, stream)
    out = torch.empty((n_rows, F), dtype=torch.bfloat16, device=keys.device)
    err = load_segmented_kernel()(keys.data_ptr(), payload.data_ptr(), ws.data_ptr(),
                                  out.data_ptr(), R, F.bit_length() - 1, n_rows,
                                  keys.device.index, stream)
    if err != 0:
        raise RuntimeError(f"segmented_scatter_add launch failed: cudaError {err}")
    segmented_scatter_add.launches += 1
    return out


segmented_scatter_add.launches = 0


# the sorted kernel's sizes (csrc/sorted_scatter.cu's source note gives
# the reasons); the plan's numbers follow from them and the call's shape
SORTED_THREADS = 256
SORTED_CHUNK_ELEMS = 4096       # (record, feature) elements a tile-pass chunk sorts ...
SORTED_TILED_CHUNK_ELEMS = 2048  # ... in the tiled regime (four blocks an SM)
SORTED_TILE_ELEMS = 8192        # rows x F of a tile: 32 KB of float32 sums
SORTED_SMALL_ELEMS = 36864      # the largest table summed as one tile (144 KB)
SORTED_MAX_SPLIT = 256          # splits of one tile at most
SORTED_MIN_SPLITS = 128         # small regime: splits of one chunk below this many
SORTED_MAX_BINS = 2048          # buckets of one radix pass of the bucket pass
SORTED_BLOCK_RECORDS = (256, 4096)
SORTED_MAX_DIGIT_BITS = 8       # the in-block sort's digits
SORTED_SLICE = 256              # combine_kernel's elements a work item
_SORTED_SCRATCH_WORDS = 36     # the source's kScratchWords
_ALIGN = 256


class SortedPlan(NamedTuple):
    """The launch plan of ``csrc/sorted_scatter.cu`` for (R, F, n_rows), its
    fields in the order of the source's ``PlanField``; ``off_*`` are byte
    offsets into the workspace."""
    R: int
    log2_f: int
    n_rows: int
    tiled: int            # 0: one tile, no bucket pass; 1: tiles and buckets
    tile_rows: int
    log2_tile: int        # tiled: log2(tile_rows)
    tile_elems: int       # tile_rows x F
    chunk: int            # records a tile-pass chunk sorts
    split: int            # a tile takes ceil(records / split) splits ...
    max_split: int        # ... at most this many
    row_bits: int         # the bits of a tile-local row (and the small regime's dropped row)
    passes: int           # radix passes of the bucket pass (0: small regime)
    bins_lo: int          # buckets of the first pass
    bits_lo: int          # two passes: the first pass's digit width
    bins_hi: int          # two passes: buckets of the second
    block_records: int    # bucket pass: records a block
    blocks: int
    tiles: int
    work_max: int         # tile-pass work items at most
    combine_max: int      # tiles of several splits at most
    slots_max: int        # partial tiles at most
    combine_grid: int
    tile_smem: int        # bytes of shared memory of a tile-pass block
    scatter_smem: int     # ... of a bucket-pass block
    small_splits: int     # small regime: the table's splits
    packed: int           # F = 1: a record is one word, tile-local row over payload
    bucket_packed: int    # the buckets hold such words (one radix pass, F = 1)
    off_counts: int
    off_tot: int
    off_bins_lo: int
    off_bins_hi: int
    off_tile_start: int
    off_header: int
    off_work: int
    off_combine: int
    off_slot: int
    off_keys: int
    off_pay: int
    off_tmp_keys: int
    off_tmp_pay: int
    off_partials: int
    workspace_bytes: int


def _sort_digit_bits(row_bits: int) -> int:
    """The in-block sort's digit (``sort_digit_bits`` in the source): one
    pass of up to 8 bits, else two of half the row bits."""
    return row_bits if row_bits <= SORTED_MAX_DIGIT_BITS else (row_bits + 1) // 2


def sorted_splits(n: int, split: int) -> int:
    """The splits of a tile that holds n records (``n_splits`` in the
    source): ceil(n / split), at least 1 and at most SORTED_MAX_SPLIT."""
    return min(max(-(-n // split), 1), SORTED_MAX_SPLIT)


def sorted_plan(R: int, F: int, n_rows: int) -> SortedPlan:
    """How ``csrc/sorted_scatter.cu`` cuts a call of R records into an
    (n_rows, F) table (F a power of two <= 128, R < 2^31).

    * n_rows x F <= SORTED_SMALL_ELEMS: the *small* regime, one tile of the
      whole table and no bucket pass; the records are cut into
      ``small_splits`` splits of consecutive records.
    * Otherwise tiles of SORTED_TILE_ELEMS / F rows, and a bucket pass by
      tile: one radix pass up to SORTED_MAX_BINS tiles, two beyond (low
      digit of ``bits_lo`` bits first), each in ``blocks`` blocks of
      ``block_records`` records (a multiple of 256 in [256, 8192], aiming
      at 256 blocks).

    A tile of n records takes ``sorted_splits(n, split)`` work items;
    ``split`` is a whole number of chunks: tiled, at least 4,096 / F
    records and a quarter of a tile's elements, so a partial tile
    (float32) costs at most about twice the bytes of the records that made
    it; small, one chunk while that gives fewer than SORTED_MIN_SPLITS
    splits (a call of few records spreads over the card), else up to a
    quarter of the table's elements.  The workspace holds, tiled: the (block, bucket)
    counts, bucket totals and starts, the tiles' bucket starts, a header
    (items, tiles of several splits, a ticket), the work list (four ints
    an item) and the combine list, each
    multi-split tile's first partial slot, the bucketed keys and payload
    (twice with two passes) and the partial tiles; small: the partial
    tiles.  Its bounds: the splits of all tiles of several splits number
    at most 2R / split, since each has more than ``split`` records."""
    log2_f = F.bit_length() - 1
    tiled = n_rows * F > SORTED_SMALL_ELEMS
    chunk = (SORTED_TILED_CHUNK_ELEMS if tiled else SORTED_CHUNK_ELEMS) // F
    if tiled:
        tile_rows = SORTED_TILE_ELEMS // F
        log2_tile = tile_rows.bit_length() - 1
        tiles = -(-n_rows // tile_rows)
        row_bits = log2_tile
    else:
        tile_rows, log2_tile, tiles = n_rows, 0, 1
        row_bits = n_rows.bit_length()      # room for the dropped keys' row n_rows
    tile_elems = tile_rows * F
    quarter = -(-tile_elems // (4 * chunk))     # chunks of a quarter tile's elements
    if tiled:
        split = max(SORTED_CHUNK_ELEMS // F, chunk * quarter)
    else:                                       # fewer, while 128 splits would not fill the card
        split = chunk * max(1, min(quarter, R // (SORTED_MIN_SPLITS * chunk)))
    small_splits = 0 if tiled else sorted_splits(R, split)
    passes = bins_lo = bits_lo = bins_hi = 0
    block_records = blocks = scatter_smem = 0
    if tiled:
        if tiles <= SORTED_MAX_BINS:
            passes, bins_lo = 1, tiles
        else:
            bits = (tiles - 1).bit_length()
            passes, bits_lo = 2, (bits + 1) // 2
            bins_lo = 1 << bits_lo
            bins_hi = -(-tiles // bins_lo)
        lo, hi = SORTED_BLOCK_RECORDS
        per_block = -(-R // 256)                  # 256 blocks ...
        block_records = min(max(-(-per_block // 256) * 256, lo), hi)   # ... of whole warps' steps
        blocks = max(1, -(-R // block_records))
        bins = max(bins_lo, bins_hi)
        scatter_smem = (4 * (2 * block_records + 9 * bins + _SORTED_SCRATCH_WORDS)
                        + 2 * block_records)
        slots_max = 0 if R <= split else min(2 * R // split, SORTED_MAX_SPLIT * tiles)
        work_max = tiles + slots_max
        combine_max = min(tiles, slots_max // 2)
    else:
        slots_max = small_splits if small_splits > 1 else 0
        work_max = small_splits
        combine_max = int(small_splits > 1)
    combine_grid = (min(combine_max * -(-tile_elems // SORTED_SLICE), 1024)
                    if combine_max else 0)
    packed = int(F == 1)
    bucket_packed = int(packed and passes == 1)
    bitmap_words = -(-tile_rows // 32) if tiled else 0
    sort_counters = (SORTED_THREADS // 32) << _sort_digit_bits(row_bits)
    # the source's tile_smem_layout and scatter_smem_bytes: its launch
    # refuses (cudaErrorInvalidValue) a plan whose sizes differ from them
    tile_smem = (4 * (-(-tile_elems // 4) * 4) + 8 * chunk
                 + 4 * (sort_counters + 2 * bitmap_words + _SORTED_SCRATCH_WORDS)
                 + (0 if packed else 2 * chunk * F))
    sizes = {}
    if tiled:
        bins = max(bins_lo, bins_hi)
        two = passes == 2
        sizes = {"counts": 4 * blocks * bins, "tot": 4 * bins,
                 "bins_lo": 4 * (bins_lo + 1) if two else 0,
                 "bins_hi": 4 * (bins_hi + 1) if two else 0,
                 "tile_start": 4 * (tiles + 1), "header": 16, "work": 16 * work_max,
                 "combine": 4 * combine_max, "slot": 4 * tiles, "keys": 4 * R,
                 "pay": 0 if bucket_packed else 2 * R * F, "tmp_keys": 4 * R if two else 0,
                 "tmp_pay": 2 * R * F if two else 0}
    sizes["partials"] = 4 * slots_max * tile_elems
    offs, at = {}, 0
    for name in ("counts", "tot", "bins_lo", "bins_hi", "tile_start", "header", "work",
                 "combine", "slot", "keys", "pay", "tmp_keys", "tmp_pay", "partials"):
        offs[f"off_{name}"] = at
        at += -(-sizes.get(name, 0) // _ALIGN) * _ALIGN
    return SortedPlan(R, log2_f, n_rows, int(tiled), tile_rows, log2_tile, tile_elems,
                      chunk, split, SORTED_MAX_SPLIT, row_bits, passes, bins_lo, bits_lo,
                      bins_hi, block_records, blocks, tiles, work_max, combine_max,
                      slots_max, combine_grid, tile_smem, scatter_smem, small_splits,
                      packed, bucket_packed, workspace_bytes=max(at, _ALIGN), **offs)


@functools.lru_cache(maxsize=256)
def _sorted_launch_args(R: int, F: int, n_rows: int):
    """The plan and its C array, once per distinct call shape."""
    plan = sorted_plan(R, F, n_rows)
    return plan, (ctypes.c_longlong * len(plan))(*plan)


def _empty(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.empty``, never filled: under ``use_deterministic_algorithms``
    PyTorch fills every ``torch.empty`` (``fill_uninitialized_memory``),
    a pass over the memory that a tensor the kernel writes whole does not
    need."""
    det = torch.utils.deterministic
    if det.fill_uninitialized_memory and torch.are_deterministic_algorithms_enabled():
        det.fill_uninitialized_memory = False
        try:
            return torch.empty(shape, dtype=dtype, device=device)
        finally:
            det.fill_uninitialized_memory = True
    return torch.empty(shape, dtype=dtype, device=device)


_sorted_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def sorted_workspace(device: torch.device, nbytes: int, stream: int = 0) -> torch.Tensor:
    """The sorted kernel's byte workspace of (device, stream), at least
    ``nbytes``: allocated unfilled (:func:`_empty`), replaced by a larger
    one only when a call needs more; it never shrinks, and one it replaces
    is kept (a graph may hold it).  The kernel writes every byte it reads,
    so its content between calls does not matter."""
    key = (torch.device(device), stream)
    ws = _sorted_workspaces.get(key)
    if ws is None or ws.numel() < nbytes:
        _refuse_under_capture("the sorted kernel's workspace", key[0])
        if ws is not None:
            _retired.append(ws)
        ws = _empty(nbytes, torch.uint8, device)
        _sorted_workspaces[key] = ws
    return ws


def load_sorted_kernel():
    """Build (if needed) and load ``csrc/sorted_scatter.cu`` -> its launch
    function.  Raises if the build fails."""
    fn = _launch.get("sorted")
    if fn is None:
        from ..cuda_build import load_library
        fn = load_library("sorted_scatter").sorted_scatter_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch["sorted"] = fn
    return fn


def sorted_scatter_add(keys: torch.Tensor, payload: torch.Tensor,
                       n_rows: int,
                       level_offsets: Sequence[int] = ()) -> torch.Tensor:
    """(n_rows, F) bf16 table gradient, summed in float32 in an order fixed
    by the inputs alone; see module doc.  The output and the workspace are
    allocated unfilled (:func:`_empty`): the kernel writes every element."""
    if keys.device.type == "cpu":
        return sorted_scatter_add_plain(keys, payload, n_rows, level_offsets)
    if keys.device.type != "cuda":
        raise ValueError(f"sorted_scatter_add runs on cpu or cuda, not {keys.device}")
    _check_args("sorted_scatter_add", keys, payload, n_rows)
    R, F = payload.shape
    if R >= 2 ** 31:
        raise ValueError(f"sorted_scatter_add: R={R} records exceed int32")
    plan, c_plan = _sorted_launch_args(R, F, n_rows)
    stream = _stream(keys)
    ws = sorted_workspace(keys.device, plan.workspace_bytes, stream)
    out = _empty((n_rows, F), torch.bfloat16, keys.device)
    err = load_sorted_kernel()(keys.data_ptr(), payload.data_ptr(), out.data_ptr(),
                               ws.data_ptr(), c_plan, keys.device.index, stream)
    if err != 0:
        raise RuntimeError(f"sorted_scatter_add launch failed: cudaError {err}")
    sorted_scatter_add.launches += 1
    return out


sorted_scatter_add.launches = 0


def onehot_plan(level_offsets: Sequence[int], R: int, F: int,
                n_sm: int) -> Tuple[int, int, int]:
    """(clusters_per_level, cluster_size, smem_bytes) of the one-hot kernel.

    A level's blocks take about BLOCK_ELEMS (record, feature) elements each.
    A level that needs at most CLUSTER_MAX blocks takes one cluster of that
    many, which writes the window's bf16 sums itself; a bigger one takes
    clusters of CLUSTER_MAX, as many as fill the card's ``n_sm`` SMs once
    over all levels (at least one), which meet in the workspace.  Each block
    holds the widest window x F floats.  Raises where :func:`onehot_fits`
    does not hold."""
    _check_onehot(level_offsets, F)
    L = len(level_offsets) - 1
    n = R // L * F
    smem = max(_window_rows(level_offsets) * F * 4, 4)     # >= the flag word
    blocks = max(1, -(-n // BLOCK_ELEMS))
    if blocks <= CLUSTER_MAX:
        return 1, blocks, smem
    return (min(-(-blocks // CLUSTER_MAX), max(1, n_sm // (CLUSTER_MAX * L))),
            CLUSTER_MAX, smem)


_sm_count: Dict[int, int] = {}


def _device_sms(device: torch.device) -> int:
    n = _sm_count.get(device.index)
    if n is None:
        n = _sm_count[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


@functools.lru_cache(maxsize=256)
def _onehot_launch_args(level_offsets: Tuple[int, ...], R: int, F: int,
                        n_sm: int):
    """The plan and the C array of row starts, once per distinct call shape."""
    return (onehot_plan(level_offsets, R, F, n_sm),
            (ctypes.c_int * len(level_offsets))(*level_offsets))


def onehot_scatter_add(keys: torch.Tensor, payload: torch.Tensor,
                       n_rows: int, level_offsets: Sequence[int]) -> torch.Tensor:
    """(n_rows, F) bf16 table gradient, summed in float32; see module doc.
    Raises when the widest level window does not fit a block."""
    if keys.device.type == "cpu":
        return onehot_scatter_add_plain(keys, payload, n_rows, level_offsets)
    if keys.device.type != "cuda":
        raise ValueError(f"onehot_scatter_add runs on cpu or cuda, not {keys.device}")
    level_offsets = tuple(int(o) for o in level_offsets)
    _check_args("onehot_scatter_add", keys, payload, n_rows, level_offsets)
    R, F = payload.shape
    if R >= 2 ** 31:
        raise ValueError(f"onehot_scatter_add: R={R} records exceed int32")
    (clusters, cluster_size, smem), offs = _onehot_launch_args(
        level_offsets, R, F, _device_sms(keys.device))
    stream = _stream(keys)
    ws = (workspace(keys.device, n_rows * F + _TICKETS, stream).data_ptr()
          if clusters > 1 else None)
    out = torch.empty((n_rows, F), dtype=torch.bfloat16, device=keys.device)
    err = load_onehot_kernel()(keys.data_ptr(), payload.data_ptr(), ws, out.data_ptr(),
                               offs, len(level_offsets) - 1, R, F.bit_length() - 1,
                               n_rows, clusters, cluster_size, smem,
                               keys.device.index, stream)
    if err == -1:
        raise RuntimeError(f"onehot_scatter_add: no cluster of {cluster_size} blocks "
                           f"with {smem} B of shared memory each fits the card")
    if err != 0:
        raise RuntimeError(f"onehot_scatter_add launch failed: cudaError {err}")
    onehot_scatter_add.launches += 1
    return out


onehot_scatter_add.launches = 0
