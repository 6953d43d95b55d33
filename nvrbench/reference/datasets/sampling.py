"""Host-side ray sampling of the frozen reference: the two strategies the
benchmark's items use, each with a fixed output shape:

  - :func:`sample_rays_full`: every pixel whose ray hits the box (eval);
  - :func:`sample_patch`: one ``patch_size`` square crop around a body (or
    focus) pixel, for the image-space patch losses.

Near and far are ``ops.ray.get_near_far_np``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ops.ray import get_near_far_np, get_rays_np

def sample_rays_full(img, K, R, T, bounds) -> Dict[str, np.ndarray]:
    """All pixels whose ray hits the box (a variable count; the caller pads)."""
    H, W = img.shape[:2]
    ray_o, ray_d = get_rays_np(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3).astype(np.float32)
    ray_d = ray_d.reshape(-1, 3).astype(np.float32)
    near, far, hit = get_near_far_np(bounds, ray_o, ray_d)
    coord = np.argwhere(hit.reshape(H, W))
    return {"ray_o": ray_o[hit], "ray_d": ray_d[hit],
            "rgb": img.reshape(-1, 3)[hit].astype(np.float32),
            "near": near.astype(np.float32), "far": far.astype(np.float32),
            "coord": coord, "mask_at_box": hit,
            "ray_mask": np.ones(hit.sum(), np.float32)}


def sample_patch(img, msk, K, R, T, bounds, patch_size: int,
                 focus_msk: Optional[np.ndarray], rng) -> Dict[str, np.ndarray]:
    """A ``patch_size`` square crop centred on a random body (or focus)
    pixel: exactly patch_size^2 ray slots, rays that miss the box masked
    out by ``ray_mask`` with a degenerate [0, 0] depth interval (their
    samples sit at the camera and the SMPL-distance cull drops them), and
    ``patch_hw`` for the image-space losses."""
    H, W = img.shape[:2]
    ref = focus_msk if focus_msk is not None and focus_msk.sum() > 0 else (msk == 1)
    coords = np.argwhere(ref)
    cy, cx = coords[rng.integers(0, len(coords))]
    y0 = int(np.clip(cy - patch_size // 2, 0, max(H - patch_size, 0)))
    x0 = int(np.clip(cx - patch_size // 2, 0, max(W - patch_size, 0)))
    crop = img[y0:y0 + patch_size, x0:x0 + patch_size]
    ph, pw = crop.shape[:2]
    if ph < patch_size or pw < patch_size:        # image smaller than the patch
        crop = np.pad(crop, ((0, patch_size - ph), (0, patch_size - pw), (0, 0)))

    Kc = K.copy()
    Kc[0, 2] -= x0
    Kc[1, 2] -= y0
    ray_o, ray_d = get_rays_np(patch_size, patch_size, Kc, R, T)
    ray_o = ray_o.reshape(-1, 3).astype(np.float32)
    ray_d = ray_d.reshape(-1, 3).astype(np.float32)
    near, far, hit = get_near_far_np(bounds, ray_o, ray_d)

    n = patch_size * patch_size
    near_full = np.zeros(n, np.float32)
    far_full = np.zeros(n, np.float32)
    near_full[hit] = near
    far_full[hit] = far
    ys, xs = np.meshgrid(np.arange(patch_size), np.arange(patch_size), indexing="ij")
    coord = np.stack([ys, xs], -1).reshape(-1, 2)
    return {"ray_o": ray_o, "ray_d": ray_d,
            "rgb": crop.reshape(-1, 3).astype(np.float32),
            "near": near_full, "far": far_full,
            "coord": coord, "mask_at_box": hit,
            "ray_mask": hit.astype(np.float32),
            "patch_hw": np.array([patch_size, patch_size], np.int32)}
