"""Per-part KNN blend weights (port of ``instant_nvr_tpu/ops/knn.py``).

``knn_blend`` (also exported under the JAX name
``knn_blend_weights_multiassign``) returns, for every query point and body
part, the gaussian-weighted blend of the part's 4 nearest SMPL vertices'
bone weights plus the aggregated distance the model thresholds: (C, P, 25).

On a CUDA tensor it launches the hand-written kernel ``csrc/knn_blend.cu``
(the port of the Pallas kernel ``knn_pallas.py:_knn_blend_kernel``) and
counts the launch in ``knn_blend.launches``.  On a CPU tensor it runs
``knn_blend_plain``, the plain PyTorch version the CPU tests hold against
JAX; on the card only a kernel-vs-plain comparison calls the plain version.
"""
from __future__ import annotations

import ctypes

import torch

_FAR = 1e9            # masked (padded) vertex slots, as in the JAX version
KERNEL_K = 4          # the kernel's neighbour count (kK in knn_blend.cu)


def knn_blend_plain(query: torch.Tensor, part_pts: torch.Tensor,
                    part_pbw: torch.Tensor, lengths: torch.Tensor,
                    K: int = 4, radius: float = 0.075, eps: float = 1e-8,
                    chunk: int = 1024) -> torch.Tensor:
    """Brute force in plain PyTorch.  query (C, 3); part_pts (P, M, 3);
    part_pbw (P, M, D); lengths (P,) -> (C, P, D + 1).

    Exact float32 squared distances ``(dx^2 + dy^2) + dz^2`` over query
    chunks, padded vertices masked to ``_FAR``, ``torch.topk``, then the
    aggregation of ``instant_nvr_tpu/ops/knn.py:_aggregate``.
    """
    C = query.shape[0]
    P, M = part_pts.shape[:2]
    D = part_pbw.shape[-1]
    dev = query.device
    valid = (torch.arange(M, device=dev)[None, :]
             < lengths.to(dev).long()[:, None])                  # (P, M)
    out = torch.empty((C, P, D + 1), dtype=torch.float32, device=dev)
    pidx = torch.arange(P, device=dev)[None, :, None]
    for s in range(0, C, chunk):
        q = query[s:s + chunk]
        diff = q[:, None, None, :] - part_pts[None]               # (c, P, M, 3)
        dx, dy, dz = diff.unbind(-1)
        d2 = (dx * dx + dy * dy) + dz * dz                        # (c, P, M)
        d2 = torch.where(valid[None], d2, torch.full_like(d2, _FAR))
        if M < K:
            d2 = torch.cat([d2, d2.new_full(d2.shape[:2] + (K - M,), _FAR)], -1)
        best, idx = torch.topk(d2, K, dim=-1, largest=False)      # (c, P, K)
        idx = idx.clamp(max=M - 1)

        d = torch.sqrt(torch.clamp(best, min=0.0))
        d_safe = torch.clamp(d, max=1e10)
        w = torch.exp(-(d_safe * d_safe) / (2.0 * radius * radius))
        w = w / (torch.sum(w, dim=-1, keepdim=True) + eps)
        agg_dist = torch.sum(d_safe * w, dim=-1)                  # (c, P)
        agg_dist = torch.where(torch.amin(d_safe, dim=-1) <= 8.0 * radius,
                               agg_dist, torch.full_like(agg_dist, 1e6))
        sampled = part_pbw[pidx, idx]                             # (c, P, K, D)
        out[s:s + chunk, :, :D] = torch.sum(sampled * w[..., None], dim=-2)
        out[s:s + chunk, :, D] = agg_dist
    return out


def _check_kernel_args(query, part_pts, part_pbw, lengths, K):
    if K != KERNEL_K:
        raise ValueError(f"the knn_blend kernel is built for K={KERNEL_K}, got {K}")
    dev = query.device
    for name, t, dt in (("query", query, torch.float32),
                        ("part_pts", part_pts, torch.float32),
                        ("part_pbw", part_pbw, torch.float32),
                        ("lengths", lengths, torch.int32)):
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
    if part_pbw.ndim != 3 or part_pbw.shape[:2] != (P, M):
        raise ValueError(f"part_pbw must be (P, M, D) with (P, M) = {(P, M)}, "
                         f"got {tuple(part_pbw.shape)}")
    if lengths.shape != (P,):
        raise ValueError(f"lengths must be ({P},), got {tuple(lengths.shape)}")
    if not (0 < P <= 65535) or C >= 2 ** 31:
        raise ValueError(f"unsupported sizes C={C} P={P} (grid limits)")


def load_kernel():
    """Build (if needed) and load the CUDA library -> its launch function.
    Raises if the build fails."""
    from ..cuda_build import load_library
    lib = load_library("knn_blend")
    fn = lib.knn_blend_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def knn_blend(query: torch.Tensor, part_pts: torch.Tensor,
              part_pbw: torch.Tensor, lengths: torch.Tensor,
              K: int = 4, radius: float = 0.075, eps: float = 1e-8,
              chunk: int = 1024) -> torch.Tensor:
    """(C, P, D + 1) blend weights + aggregated distance; see module doc.

    ``chunk`` bounds the plain version's (chunk, P, M, 3) intermediate.
    """
    if query.device.type == "cpu":
        return knn_blend_plain(query, part_pts, part_pbw, lengths, K=K,
                               radius=radius, eps=eps, chunk=chunk)
    if query.device.type != "cuda":
        raise ValueError(f"knn_blend runs on cpu or cuda, not {query.device}")
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

# the JAX package's name for this function (instant_nvr_tpu/ops/knn.py)
knn_blend_weights_multiassign = knn_blend
