"""Hash-table gradient scatter-adds (port of the Pallas kernels
``instant_nvr_tpu/ops/pallas/segmented_scatter.py:segmented_scatter_add``
and ``instant_nvr_tpu/ops/pallas/onehot_scatter.py:onehot_scatter_add``).

Both compute the dense gradient of a table from R scatter records:

    grad[keys[r], f] += payload[r, f]      keys (R,) int32, payload (R, F) bf16

summed in float32 and returned as (n_rows, F) bf16.  Records are
level-major: ``level_offsets`` (n_levels + 1 ascending row starts, the last
one the level end) give each level's row window, and level l's R / n_levels
records fall inside window l.  F is a power of two <= 128.

* ``segmented_scatter_add`` (any table size) launches ``csrc/segmented_scatter.cu``:
  record-parallel float32 atomics into a zeroed workspace, then a bf16 cast.
  It needs no level windows; it takes them so both kernels share one
  signature.
* ``onehot_scatter_add`` (small tables) launches ``csrc/onehot_scatter.cu``:
  one block per (level, record chunk) accumulates into its level's row
  window in shared memory, then flushes into the workspace.  The widest
  window must fit the block's shared memory (:func:`onehot_fits`).

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
from typing import Sequence

import torch

# shared memory a block may opt into on Hopper (sm_90: 227 KB); the one-hot
# kernel's accumulator holds the widest level window x F in float32
ONEHOT_SMEM_BYTES = 232448
_MAX_LEVELS = 64        # kMaxLevels in onehot_scatter.cu
_TARGET_BLOCKS = 264    # one-hot blocks to aim for: two per SM of an H100


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
    return torch.cuda.current_stream(t.device).cuda_stream


def load_segmented_kernel():
    """Build (if needed) and load ``csrc/segmented_scatter.cu`` -> its launch
    function.  Raises if the build fails."""
    from ..cuda_build import load_library
    fn = load_library("segmented_scatter").segmented_scatter_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def load_onehot_kernel():
    """Build (if needed) and load ``csrc/onehot_scatter.cu`` -> its launch
    function.  Raises if the build fails."""
    from ..cuda_build import load_library
    fn = load_library("onehot_scatter").onehot_scatter_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
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
    acc = torch.zeros((n_rows, F), dtype=torch.float32, device=keys.device)
    out = torch.empty((n_rows, F), dtype=torch.bfloat16, device=keys.device)
    launch = load_segmented_kernel()
    with torch.cuda.device(keys.device):
        err = launch(keys.data_ptr(), payload.data_ptr(), acc.data_ptr(),
                     out.data_ptr(), R, F.bit_length() - 1, n_rows,
                     _stream(keys))
    if err != 0:
        raise RuntimeError(f"segmented_scatter_add launch failed: cudaError {err}")
    segmented_scatter_add.launches += 1
    return out


segmented_scatter_add.launches = 0


def onehot_chunk(level_offsets: Sequence[int], R: int) -> int:
    """Records per block: enough blocks to spread over the card, but never
    fewer records than the window a block zeroes and flushes."""
    L = len(level_offsets) - 1
    per_level = -(-_TARGET_BLOCKS // L)
    return max(_window_rows(level_offsets), -(-(R // L) // per_level), 1)


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
    _check_onehot(level_offsets, F)
    if R >= 2 ** 31:
        raise ValueError(f"onehot_scatter_add: R={R} records exceed int32")
    acc = torch.zeros((n_rows, F), dtype=torch.float32, device=keys.device)
    out = torch.empty((n_rows, F), dtype=torch.bfloat16, device=keys.device)
    offs = (ctypes.c_int * len(level_offsets))(*level_offsets)
    launch = load_onehot_kernel()
    with torch.cuda.device(keys.device):
        err = launch(keys.data_ptr(), payload.data_ptr(), acc.data_ptr(),
                     out.data_ptr(), offs, len(level_offsets) - 1, R,
                     F.bit_length() - 1, n_rows, onehot_chunk(level_offsets, R),
                     _window_rows(level_offsets), _stream(keys))
    if err != 0:
        raise RuntimeError(f"onehot_scatter_add launch failed: cudaError {err}")
    onehot_scatter_add.launches += 1
    return out


onehot_scatter_add.launches = 0
