"""Trilinear volume sampling (port of ``instant_nvr_tpu/ops/grid_sample.py``).

Volumes are channels-last ``(X, Y, Z, C)`` and may be padded: ``sizes``
carries the real extent, and only index arithmetic depends on it.  Border
clamp, align_corners=True.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import device_constant


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor,
                   sizes: torch.Tensor | None = None) -> torch.Tensor:
    """vol (X, Y, Z, C); coords (N, 3) in [-1, 1]; sizes (3,) int -> (N, C)."""
    X, Y, Z = vol.shape[:3]
    if sizes is None:
        sizes = device_constant(("volume_sizes", X, Y, Z), vol.device,
                                lambda: np.array([X, Y, Z]), torch.int32)
    sizes = sizes.to(device=vol.device, dtype=torch.int32)
    # align_corners=True: -1 -> 0, +1 -> size-1
    pix = (coords + 1.0) * 0.5 * (sizes.to(coords.dtype) - 1.0)   # (N, 3)
    lo = torch.floor(pix)
    frac = pix - lo
    lo = lo.to(torch.int32)
    hi_idx = sizes - 1
    c000 = torch.clamp(lo, min=torch.zeros_like(hi_idx), max=hi_idx)
    c111 = torch.clamp(lo + 1, min=torch.zeros_like(hi_idx), max=hi_idx)

    vol_flat = vol.reshape(X * Y * Z, vol.shape[-1])

    def gather(ix, iy, iz):
        return vol_flat[((ix * Y + iy) * Z + iz).long()]

    x0, y0, z0 = c000[:, 0], c000[:, 1], c000[:, 2]
    x1, y1, z1 = c111[:, 0], c111[:, 1], c111[:, 2]
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]

    v00 = gather(x0, y0, z0) * (1 - fz) + gather(x0, y0, z1) * fz
    v01 = gather(x0, y1, z0) * (1 - fz) + gather(x0, y1, z1) * fz
    v10 = gather(x1, y0, z0) * (1 - fz) + gather(x1, y0, z1) * fz
    v11 = gather(x1, y1, z0) * (1 - fz) + gather(x1, y1, z1) * fz
    v0 = v00 * (1 - fy) + v01 * fy
    v1 = v10 * (1 - fy) + v11 * fy
    return v0 * (1 - fx) + v1 * fx


def pts_sample_volume(pts: torch.Tensor, vol: torch.Tensor, bounds: torch.Tensor,
                      sizes: torch.Tensor | None = None) -> torch.Tensor:
    """Sample a volume spanning ``bounds`` (2, 3) at points (N, 3) -> (N, C)."""
    extent = bounds[1] - bounds[0]
    coords = (pts - bounds[0]) / extent * 2.0 - 1.0
    return grid_sample_3d(vol, coords, sizes=sizes)
