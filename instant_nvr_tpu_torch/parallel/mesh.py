"""Data parallelism over the ray axis (port of
``instant_nvr_tpu/parallel/mesh.py``).

The JAX package shards the rays of one image over a device mesh and lets
XLA insert the gradient all-reduce.  Here each rank is one process with
one device, in a ``torch.distributed`` process group:

  - every rank walks the same items and builds the same host batch (item
    rngs seeded by (epoch, position), ``train/loop.py``);
  - parameters and per-frame SMPL metadata are replicated;
  - the ray keys (:data:`RAY_KEYS`), padded by :func:`pad_rays_to_multiple`
    with ``ray_mask = 0``, are cut into contiguous per-rank slices
    (:func:`shard_batch`);
  - the step's losses are local sums over a global count, and one SUM
    all-reduce of every gradient (:func:`all_reduce_grads`) gives each rank
    the one-process step's gradient (``train/step.py``).

Every collective here is an ``all_reduce`` or a ``broadcast``, the two
that Gloo also runs on CUDA tensors: gathers are an all-reduce of a
zero-padded buffer in which each rank fills its own rows.  So two ranks
can share one card on Gloo, where NCCL refuses a second rank per device.
In one process (no group) every function here is the identity.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable

import numpy as np
import torch
import torch.distributed as dist

# batch keys whose leading axis is the ray axis
RAY_KEYS = ("ray_o", "ray_d", "near", "far", "rgb", "occupancy", "ray_mask",
            "coord")

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# the device of this process's rank, set by init_distributed: where the
# group's own small buffers (barrier, counts) live
_rank_device = torch.device("cpu")


def pad_rays_to_multiple(batch: Dict, mult: int) -> Dict:
    """Pad the ray axis so it divides ``mult``; pad rays get ray_mask=0."""
    n = batch["ray_o"].shape[0]
    pad = (-n) % mult
    if pad == 0:
        return batch
    out = dict(batch)
    for k in RAY_KEYS:
        if k in out and getattr(out[k], "ndim", 0) >= 1:
            widths = [(0, pad)] + [(0, 0)] * (out[k].ndim - 1)
            out[k] = np.pad(np.asarray(out[k]), widths, mode="edge")
    mask = np.ones(n + pad, np.float32)
    mask[n:] = 0.0
    if "ray_mask" in batch:
        mask[:n] = np.asarray(batch["ray_mask"], np.float32)
    out["ray_mask"] = mask
    return out


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """This rank's contiguous slice of every ray key; the rest whole.
    Raises when a ray axis does not divide ``world`` (pad first with
    :func:`pad_rays_to_multiple`)."""
    if world == 1:
        return batch
    out = dict(batch)
    for k in RAY_KEYS:
        v = batch.get(k)
        if v is None or getattr(v, "ndim", 0) < 1:
            continue
        if v.shape[0] % world:
            raise ValueError(f"ray axis of {k} ({v.shape[0]}) must divide the "
                             f"world size ({world}); pad with "
                             "pad_rays_to_multiple before shard_batch")
        per = v.shape[0] // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out


# -- the process group ---------------------------------------------------------

def init_distributed(device: str | torch.device,
                     backend: str | None = None) -> torch.device:
    """Join the process group that ``torchrun`` (or a launcher setting
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) describes;
    returns this rank's device.  ``cuda`` becomes ``cuda:LOCAL_RANK`` on
    NCCL; ``cpu`` runs on Gloo.  ``backend`` names another one explicitly
    (Gloo on CUDA tensors: two ranks on one card).  A group that already
    exists is kept.  Raises without the environment, without a card for
    ``cuda``, or without NCCL for ``cuda``: nothing falls back to Gloo or
    to the CPU."""
    global _rank_device
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--distributed on cuda: torch.cuda is not available "
                           "(pass --device cpu for Gloo ranks on the CPU)")
    joined = dist.is_initialized()
    if not joined:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"--distributed needs {', '.join(missing)} in the "
                               "environment (torchrun sets them)")
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("--distributed on cuda needs NCCL, which this "
                               "torch build lacks")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _rank_device = device
    if not joined:
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def backend() -> str | None:
    """The process group's backend (``nccl``, ``gloo``), None without one."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_device() -> torch.device:
    """This rank's device (``cpu`` until :func:`init_distributed`)."""
    return _rank_device


def is_rank0() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in one process).  An all-reduce, not
    ``dist.barrier``, which Gloo runs only for CPU tensors and NCCL on the
    current device."""
    if world_size() > 1:
        dist.all_reduce(torch.ones(1, device=_rank_device))


@contextlib.contextmanager
def distributed(device: str | torch.device):
    """:func:`init_distributed` for a ``with`` block, which gets the rank's
    device; the group is destroyed at its end if the block created it."""
    owned = not dist.is_initialized()
    dev = init_distributed(device)
    try:
        yield dev
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


# -- collectives ---------------------------------------------------------------

def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, in place (identity in one process)."""
    if world_size() > 1:
        dist.all_reduce(x)
    return x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each), stacked along a new first
    axis: (world, *x.shape).  No gradient."""
    world = world_size()
    if world == 1:
        return x[None]
    buf = x.new_zeros((world,) + tuple(x.shape))
    buf[rank()] = x
    dist.all_reduce(buf)
    return buf


class _GatherRows(torch.autograd.Function):
    """Concatenate every rank's rows; the backward sums the gradient over
    the ranks (each computed its own copy of what follows) and keeps this
    rank's rows: a reduce-scatter, made of an all-reduce."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return all_gather_rows(x).reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        lo = rank() * ctx.rows
        return g[lo:lo + ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in rank order, with autograd:
    the gradient each rank sends back through it is summed over the ranks
    before this rank takes its rows (identity in one process)."""
    return _GatherRows.apply(x) if world_size() > 1 else x


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> int:
    """SUM every gradient over the ranks in one all-reduce of a flat buffer
    (per dtype); returns the bytes reduced.  Every rank must hold the same
    set of gradients (they run the same graph); parameters without one
    stay without one."""
    if world_size() == 1:
        return 0
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    nbytes = 0
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        nbytes += flat.numel() * flat.element_size()
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
    return nbytes


def global_positions(vals: torch.Tensor) -> torch.Tensor:
    """Each entry of this rank's ascending ``vals`` (B,), B the same on
    every rank: its position among every rank's entries in ascending
    order, ties broken by rank, then by position.  This is the slot one
    process's top-k over the union gives it, where that top-k holds it."""
    pos = torch.arange(vals.shape[0], device=vals.device)
    if world_size() == 1:
        return pos
    own = pos - torch.searchsorted(vals, vals)         # ties before, here
    allv = all_gather_rows(vals)                       # (world, B)
    below = (allv[:, :, None] < vals).sum((0, 1))
    tied_before = (allv[:rank(), :, None] == vals).sum((0, 1))
    return below + tied_before + own


def broadcast_(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``x`` replaced in place by rank ``src``'s (identity in one process)."""
    if world_size() > 1:
        dist.broadcast(x, src)
    return x


def replicas_equal(module: torch.nn.Module) -> bool:
    """Whether every rank's parameters are bit-equal to rank 0's: rank 0's
    flat parameter bits are broadcast, each rank compares its own, and the
    mismatch count is summed, so every rank gets the same answer."""
    if world_size() == 1:
        return True
    flat = torch.cat([p.detach().float().reshape(-1) for p in module.parameters()])
    ref = broadcast_(flat.clone())
    bad = (flat.view(torch.int32) != ref.view(torch.int32)).sum()
    bad = bad.to(torch.float64).reshape(1)
    dist.all_reduce(bad)
    return int(bad.item()) == 0
