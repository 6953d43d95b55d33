"""Per-part KNN blend weights (port of ``instant_nvr_tpu/ops/knn.py``).

``knn_blend`` (also exported under the JAX name
``knn_blend_weights_multiassign``) returns, for every query point and body
part, the gaussian-weighted blend of the part's 4 nearest SMPL vertices'
bone weights plus the aggregated distance the model thresholds: (C, P, 25).

``knn_blend_unfused`` computes the same in two steps, as the JAX package's
``knn_blend_weights_multiassign_pallas(fused=False)`` does: ``knn_topk``
finds each (part, query)'s 4 nearest vertices, then ``aggregate`` (plain
PyTorch on every device, as JAX's ``_aggregate`` is jnp) blends them.  The
on-card self-check (``tools/cuda_selfcheck.py``) holds both routes against
the plain version.

On a CUDA tensor ``knn_blend`` launches the hand-written kernel
``csrc/knn_blend.cu`` (the port of the Pallas kernel
``knn_pallas.py:_knn_blend_kernel``) and ``knn_topk`` launches
``csrc/knn_topk.cu`` (the port of ``knn_pallas.py:_knn_kernel``); each
counts its launches in ``.launches``.  On a CPU tensor each runs its
``*_plain`` version, the plain PyTorch version the CPU tests hold against
JAX; on the card only a kernel-vs-plain comparison calls the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_FAR = 1e9            # masked (padded) vertex slots, as in the JAX version
FAR_INIT = 1.5e9      # knn_topk's d2 for a slot no real vertex fills
KERNEL_K = 4          # the kernels' neighbour count (kK in knn_select.cuh)


def _topk_chunk(q: torch.Tensor, part_pts: torch.Tensor, lengths: torch.Tensor,
                K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (c, 3) -> (P, c, K) ascending squared distances and int64 indices
    of each part's K nearest real vertices; unfilled slots (FAR_INIT, 0).
    ``lengths`` (P,) int64 already clipped to [0, M]."""
    M = part_pts.shape[1]
    diff = q[None, :, None, :] - part_pts[:, None]            # (P, c, M, 3)
    dx, dy, dz = diff.unbind(-1)
    d2 = (dx * dx + dy * dy) + dz * dz                        # (P, c, M)
    valid = torch.arange(M, device=q.device)[None, :] < lengths[:, None]
    d2 = torch.where(valid[:, None], d2, torch.full_like(d2, _FAR))
    if M < K:
        d2 = torch.cat([d2, d2.new_full(d2.shape[:2] + (K - M,), _FAR)], -1)
    best, idx = torch.topk(d2, K, dim=-1, largest=False)      # (P, c, K)
    real = idx < lengths[:, None, None]
    return (torch.where(real, best, torch.full_like(best, FAR_INIT)),
            torch.where(real, idx, torch.zeros_like(idx)))


def knn_topk_plain(query: torch.Tensor, part_pts: torch.Tensor,
                   lengths: torch.Tensor, K: int = 4,
                   chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute force in plain PyTorch.  query (C, 3); part_pts (P, M, 3);
    lengths (P,) -> d2 (P, C, K) float32, idx (P, C, K) int32.

    Each (part, query)'s K nearest of the part's real vertices (the first
    ``lengths[p]``) by the exact float32 ``(dx^2 + dy^2) + dz^2`` in
    ascending order (padded vertices masked to ``_FAR``, then
    ``torch.topk``).  A slot no real vertex fills holds d2 = 1.5e9 and
    idx = 0.  ``chunk`` bounds the (P, chunk, M, 3) intermediate.
    """
    C = query.shape[0]
    P, M = part_pts.shape[:2]
    dev = query.device
    lens = lengths.to(dev).long().clamp(0, M)
    d2 = torch.empty((P, C, K), dtype=torch.float32, device=dev)
    idx = torch.empty((P, C, K), dtype=torch.int32, device=dev)
    for s in range(0, C, chunk):
        d2[:, s:s + chunk], idx[:, s:s + chunk] = _topk_chunk(
            query[s:s + chunk], part_pts, lens, K)
    return d2, idx


def aggregate(d: torch.Tensor, idx: torch.Tensor, part_pbw: torch.Tensor,
              radius: float = 0.075, eps: float = 1e-8) -> torch.Tensor:
    """(P, C, K) neighbour distances and vertex indices + (P, M, D) values
    -> (C, P, D + 1); port of ``instant_nvr_tpu/ops/knn.py:_aggregate``.

    Gaussian weights exp(-d^2 / 2r^2) normalised by (sum + eps) blend the
    K value rows; the last channel is the weighted distance, or 1e6 when the
    nearest neighbour lies beyond 8 r.  Indices are clipped to [0, M - 1]:
    JAX's top-k kernel returns padded columns' indices (up to its padded M)
    for the spare slots of a part with fewer than K vertices, and their
    weight is 0.
    """
    d_safe = torch.clamp(d, max=1e10)
    w = torch.exp(-(d_safe * d_safe) / (2.0 * radius * radius))
    w = w / (torch.sum(w, dim=-1, keepdim=True) + eps)
    agg_dist = torch.sum(d_safe * w, dim=-1)                  # (P, C)
    agg_dist = torch.where(torch.amin(d_safe, dim=-1) <= 8.0 * radius,
                           agg_dist, torch.full_like(agg_dist, 1e6))
    P, M = part_pbw.shape[:2]
    pidx = torch.arange(P, device=part_pbw.device)[:, None, None]
    sampled = part_pbw[pidx, idx.long().clamp(0, M - 1)]      # (P, C, K, D)
    agg_val = torch.sum(sampled * w[..., None], dim=-2)       # (P, C, D)
    out = torch.cat([agg_val, agg_dist[..., None]], dim=-1)
    return out.transpose(0, 1).contiguous()                   # (C, P, D + 1)


def knn_blend_plain(query: torch.Tensor, part_pts: torch.Tensor,
                    part_pbw: torch.Tensor, lengths: torch.Tensor,
                    K: int = 4, radius: float = 0.075, eps: float = 1e-8,
                    chunk: int = 1024) -> torch.Tensor:
    """Brute force in plain PyTorch.  query (C, 3); part_pts (P, M, 3);
    part_pbw (P, M, D); lengths (P,) -> (C, P, D + 1).

    :func:`knn_topk_plain`'s neighbours, then :func:`aggregate`, over query
    chunks of ``chunk``.
    """
    C = query.shape[0]
    P, M, D = part_pbw.shape
    dev = query.device
    lens = lengths.to(dev).long().clamp(0, M)
    out = torch.empty((C, P, D + 1), dtype=torch.float32, device=dev)
    for s in range(0, C, chunk):
        d2, idx = _topk_chunk(query[s:s + chunk], part_pts, lens, K)
        out[s:s + chunk] = aggregate(torch.sqrt(torch.clamp(d2, min=0.0)), idx,
                                     part_pbw, radius, eps)
    return out


def _check_kernel_args(query, part_pts, part_pbw, lengths, K):
    """Refuse what the kernels do not take; ``part_pbw`` None for knn_topk."""
    if K != KERNEL_K:
        raise ValueError(f"the KNN kernels are built for K={KERNEL_K}, got {K}")
    dev = query.device
    args = [("query", query, torch.float32), ("part_pts", part_pts, torch.float32),
            ("lengths", lengths, torch.int32)]
    if part_pbw is not None:
        args.append(("part_pbw", part_pbw, torch.float32))
    for name, t, dt in args:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, query on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    C = query.shape[0]
    if query.ndim != 2 or query.shape[1] != 3:
        raise ValueError(f"query must be (C, 3), got {tuple(query.shape)}")
    if part_pts.ndim != 3 or part_pts.shape[2] != 3:
        raise ValueError(f"part_pts must be (P, M, 3), got {tuple(part_pts.shape)}")
    P, M = part_pts.shape[:2]
    if part_pbw is not None and (part_pbw.ndim != 3 or part_pbw.shape[:2] != (P, M)):
        raise ValueError(f"part_pbw must be (P, M, D) with (P, M) = {(P, M)}, "
                         f"got {tuple(part_pbw.shape)}")
    if lengths.shape != (P,):
        raise ValueError(f"lengths must be ({P},), got {tuple(lengths.shape)}")
    if not (0 < P <= 65535) or C >= 2 ** 31:
        raise ValueError(f"unsupported sizes C={C} P={P} (grid limits)")


def _launcher(lib: str, argtypes):
    from ..cuda_build import load_library
    fn = getattr(load_library(lib), f"{lib}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def load_kernel():
    """Build (if needed) and load ``csrc/knn_blend.cu`` -> its launch
    function.  Raises if the build fails."""
    return _launcher("knn_blend", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_float] * 3 + [ctypes.c_void_p])


def load_topk_kernel():
    """Build (if needed) and load ``csrc/knn_topk.cu`` -> its launch
    function.  Raises if the build fails."""
    return _launcher("knn_topk", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])


def _device_route(name: str, query: torch.Tensor) -> bool:
    """True for a CPU tensor (run the plain version), False for CUDA; any
    other device raises."""
    if query.device.type == "cpu":
        return True
    if query.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {query.device}")
    return False


def knn_blend(query: torch.Tensor, part_pts: torch.Tensor,
              part_pbw: torch.Tensor, lengths: torch.Tensor,
              K: int = 4, radius: float = 0.075, eps: float = 1e-8,
              chunk: int = 1024) -> torch.Tensor:
    """(C, P, D + 1) blend weights + aggregated distance; see module doc.

    ``chunk`` bounds the plain version's (P, chunk, M, 3) intermediate.
    """
    if _device_route("knn_blend", query):
        return knn_blend_plain(query, part_pts, part_pbw, lengths, K=K,
                               radius=radius, eps=eps, chunk=chunk)
    _check_kernel_args(query, part_pts, part_pbw, lengths, K)
    C = query.shape[0]
    P, M, D = part_pbw.shape
    out = torch.empty((C, P, D + 1), dtype=torch.float32, device=query.device)
    if C == 0:
        return out
    launch = load_kernel()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = launch(query.data_ptr(), part_pts.data_ptr(), part_pbw.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(), C, P, M, D,
                     2.0 * radius * radius, 8.0 * radius, eps, stream)
    if err != 0:
        raise RuntimeError(f"knn_blend kernel launch failed: cudaError {err}")
    knn_blend.launches += 1
    return out


knn_blend.launches = 0


def knn_topk(query: torch.Tensor, part_pts: torch.Tensor, lengths: torch.Tensor,
             K: int = 4, chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """d2 (P, C, K) float32 and idx (P, C, K) int32: each (part, query)'s K
    nearest real vertices, ascending; see :func:`knn_topk_plain` and the
    module doc."""
    if _device_route("knn_topk", query):
        return knn_topk_plain(query, part_pts, lengths, K=K, chunk=chunk)
    _check_kernel_args(query, part_pts, None, lengths, K)
    C = query.shape[0]
    P, M = part_pts.shape[:2]
    d2 = torch.empty((P, C, K), dtype=torch.float32, device=query.device)
    idx = torch.empty((P, C, K), dtype=torch.int32, device=query.device)
    if C == 0:
        return d2, idx
    launch = load_topk_kernel()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = launch(query.data_ptr(), part_pts.data_ptr(), lengths.data_ptr(),
                     d2.data_ptr(), idx.data_ptr(), C, P, M, stream)
    if err != 0:
        raise RuntimeError(f"knn_topk kernel launch failed: cudaError {err}")
    knn_topk.launches += 1
    return d2, idx


knn_topk.launches = 0


def knn_blend_unfused(query: torch.Tensor, part_pts: torch.Tensor,
                      part_pbw: torch.Tensor, lengths: torch.Tensor,
                      K: int = 4, radius: float = 0.075,
                      eps: float = 1e-8) -> torch.Tensor:
    """(C, P, D + 1), as :func:`knn_blend`, in two steps: :func:`knn_topk`,
    then :func:`aggregate` of the neighbours' distances.  The counterpart of
    the JAX package's ``knn_blend_weights_multiassign_pallas(fused=False)``
    (top-k kernel + jnp ``_aggregate``)."""
    d2, idx = knn_topk(query, part_pts, lengths, K=K)
    return aggregate(torch.sqrt(torch.clamp(d2, min=0.0)), idx, part_pbw,
                     radius, eps)


# the JAX package's name for this function (instant_nvr_tpu/ops/knn.py)
knn_blend_weights_multiassign = knn_blend
