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

Each wrapper call is one call into its library, which enqueues all of its
work: no zero fill of a workspace and no cast pass over the table.  Both
kernels share one persistent float32 workspace per (device, stream)
(:func:`workspace`), all zero between calls: the segmented kernel's
accumulator and, with several clusters per level, the one-hot kernel's
(its window sums, then one ticket word per level behind the table).
It is as large as the largest table x F the stream has seen (42 MB for the
flagship's body hash table) and never shrinks.

On a CPU tensor each wrapper runs its ``*_plain`` version (a float32
``index_add_`` into zeros, cast to bf16: the contract of
``segmented_scatter_add_ref``); on a CUDA tensor it launches its kernel or
raises, and adds one to its ``.launches``.  The two results differ only in
the order of the float32 sums.  ``exact_scatter_add`` is the float32
gradient of an f32 table that may not be rounded (``grid_compute_dtype:
float32``); it counts its calls in ``.calls``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

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


def workspace(device: torch.device, n: int, stream: int = 0) -> torch.Tensor:
    """The float32 workspace of (device, stream), at least ``n`` floats.
    Allocated with ``torch.zeros`` at first use and replaced by a larger
    zeroed one only when a call needs more; it never shrinks.  The kernels
    leave it all zero when their work ends."""
    key = (torch.device(device), stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < n:
        ws = torch.zeros(n, dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws


def workspace_nonzero() -> int:
    """Nonzero words over every workspace (0 between calls); synchronises."""
    return sum(int(torch.count_nonzero(ws.view(torch.int32)))
               for ws in _workspaces.values())


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
