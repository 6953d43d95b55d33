"""The weight and bias gradients of the MLPs' linear layers.

For x (P, N, Din) and g (P, N, Dout), float32: dw = x^T g (P, Din, Dout)
and db = sum over rows of g (P, Dout), each part on its own, in float32;
for a plain layer x (N, Din) and g (N, Dout), dw (Din, Dout) and db
(Dout,).  ``models/nn.py``'s autograd Function asks them of every linear
layer that asks a gradient (every training path).

Route (:func:`weight_grads`).  CUDA tensors take ``csrc/mlp_wgrad.cu``
(:func:`mlp_wgrad`): one launch a layer, the row axis split into slabs
over enough blocks to fill the card, the slabs' partial sums added in a
fixed order, so the result is the same from run to run and a captured
step replays its eager run bit for bit.  A CUDA call the kernel cannot
take raises ValueError with the reason (:func:`wgrad_refusal`).  CPU
tensors take :func:`wgrad_plain`, the products autograd computes for
``torch.matmul`` / ``torch.bmm`` and the bias's sum, the reference the
tests hold.  ``mlp_wgrad.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

# the kernel's limits: a shared-memory stage holds a few rows of x and g,
# and the grid's second axis the parts
MAX_WIDTH = 1024
MAX_PARTS = 65535


def wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db): ``x^T g`` and ``g``'s sum over the rows by the calls
    autograd makes for ``torch.matmul(x, w) + b`` (x (N, Din)) or
    ``torch.bmm(x, w) + b[:, None, :]`` (x (P, N, Din))."""
    if x.dim() == 2:
        return x.t().mm(g), g.sum(0)
    return torch.bmm(x.transpose(1, 2), g), g.sum(1)


def wgrad_refusal(x: torch.Tensor, g: torch.Tensor) -> Optional[str]:
    """Why the kernel cannot take (x, g), or None where it can: float32
    x (P, N, Din) and g (P, N, Dout) on one CUDA device, contiguous,
    Din + Dout at most :data:`MAX_WIDTH`, P at most :data:`MAX_PARTS`."""
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        return f"operands {x.dtype} and {g.dtype}, not float32"
    if x.device != g.device or x.device.type != "cuda":
        return f"operands on {x.device} and {g.device}, not one CUDA device"
    if x.dim() != 3 or g.dim() != 3 or x.shape[:2] != g.shape[:2]:
        return f"shapes {tuple(x.shape)} and {tuple(g.shape)}, not (P, N, Din) and (P, N, Dout)"
    P, _, din = x.shape
    dout = g.shape[2]
    if not (x.is_contiguous() and g.is_contiguous()):
        return "operands that are not contiguous"
    if din < 1 or dout < 1 or din + dout > MAX_WIDTH:
        return f"widths {din} + {dout}, not 2 to {MAX_WIDTH}"
    if P < 1 or P > MAX_PARTS:
        return f"{P} parts, not 1 to {MAX_PARTS}"
    return None


def load_kernel():
    """Build (if needed) and load ``csrc/mlp_wgrad.cu`` -> (its launch
    function, its slab count).  Raises if the build fails."""
    from ..cuda_build import load_library
    lib = load_library("mlp_wgrad")
    launch, slabs = lib.mlp_wgrad_launch, lib.mlp_wgrad_slabs
    if launch.argtypes is None:
        launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        slabs.argtypes = [ctypes.c_int] * 4
        slabs.restype = ctypes.c_int
    return launch, slabs


@functools.lru_cache(maxsize=256)
def _slabs(device: int, P: int, N: int, din: int, dout: int) -> int:
    with torch.cuda.device(device):
        n = load_kernel()[1](P, N, din, dout)
    if n < 1:
        raise ValueError(f"mlp_wgrad cannot take {P} parts of {N} rows, widths {din}, {dout}")
    return n


def mlp_wgrad(x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) of :func:`wgrad_plain` through one launch of
    ``csrc/mlp_wgrad.cu`` on the current stream.  The caller has checked
    :func:`wgrad_refusal`.  No host sync; it allocates its outputs and a
    scratch buffer of the slabs' partial sums, so it runs inside a CUDA
    graph capture."""
    P, N, din = x.shape
    dout = g.shape[2]
    dw = torch.empty((P, din, dout), dtype=torch.float32, device=x.device)
    db = torch.empty((P, dout), dtype=torch.float32, device=x.device)
    if N == 0:
        return dw.zero_(), db.zero_()
    slabs = _slabs(x.device.index, P, N, din, dout)
    partial = torch.empty(P * slabs * (din + 1) * dout, dtype=torch.float32, device=x.device)
    launch = load_kernel()[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                     db.data_ptr(), P, N, din, dout, slabs, stream)
    if err != 0:
        raise RuntimeError(f"mlp_wgrad kernel launch failed: cudaError {err}")
    mlp_wgrad.launches += 1
    return dw, db


mlp_wgrad.launches = 0


def weight_grads(x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) for x (N, Din) and g (N, Dout), or x (P, N, Din) and g
    (P, N, Dout): the kernel for CUDA tensors (a plain layer as P = 1;
    ValueError with the reason where it cannot take them), the plain
    version for CPU tensors."""
    if x.device.type != "cuda":
        return wgrad_plain(x, g)
    plain = x.dim() == 2
    x3, g3 = (x[None], g[None]) if plain else (x, g)
    reason = wgrad_refusal(x3, g3)
    if reason is not None:
        raise ValueError(f"mlp_wgrad cannot take this CUDA call: {reason}")
    dw, db = mlp_wgrad(x3, g3)
    return (dw[0], db[0]) if plain else (dw, db)
