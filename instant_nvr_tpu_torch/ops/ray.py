"""Ray generation and depth sampling (port of ``instant_nvr_tpu/ops/ray.py``).

Ray generation is host-side numpy, copied as is; depth sampling runs on the
tensors' device.  ``jax.random`` keys become a ``torch.Generator`` or a
pre-drawn tensor.
"""
from __future__ import annotations

import numpy as np
import torch


# --------------------------------------------------------------------------
# host-side (numpy)
# --------------------------------------------------------------------------

def get_rays_np(H: int, W: int, K: np.ndarray, R: np.ndarray, T: np.ndarray):
    """Pinhole rays for every pixel -> (H, W, 3) origins + unit directions."""
    rays_o = -np.dot(R.T, T).ravel()
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = np.dot(xy1, np.linalg.inv(K).T)
    pixel_world = np.dot(pixel_camera - T.ravel(), R)
    rays_d = pixel_world - rays_o[None, None]
    rays_d = rays_d / np.linalg.norm(rays_d, axis=2, keepdims=True)
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o, rays_d


def rays_for_coords_np(K: np.ndarray, R: np.ndarray, T: np.ndarray,
                       coords: np.ndarray):
    """Rays for an (n, 2) list of (row, col) pixels only: the math of
    :func:`get_rays_np` on the sampled pixels (the plain version of the
    native ``ray_dirs``)."""
    rays_o = -np.dot(R.T, T).ravel()
    xy1 = np.stack([coords[:, 1], coords[:, 0], np.ones(len(coords))],
                   axis=1).astype(np.float64)
    pixel_world = np.dot(np.dot(xy1, np.linalg.inv(K).T) - T.ravel(), R)
    d = pixel_world - rays_o[None]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(rays_o, d.shape)
    return o.astype(np.float32), d.astype(np.float32)


def get_near_far_np(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """AABB slab test -> (near, far, mask_at_box); near/far for hits only."""
    norm_d = np.linalg.norm(ray_d, axis=-1, keepdims=True)
    viewdir = ray_d / norm_d
    viewdir = viewdir.copy()
    viewdir[(viewdir < 1e-5) & (viewdir > -1e-10)] = 1e-5
    viewdir[(viewdir > -1e-5) & (viewdir < 1e-10)] = -1e-5
    tmin = (bounds[:1] - ray_o) / viewdir
    tmax = (bounds[1:2] - ray_o) / viewdir
    t1 = np.minimum(tmin, tmax)
    t2 = np.maximum(tmin, tmax)
    near = np.max(t1, axis=-1)
    far = np.min(t2, axis=-1)
    mask_at_box = near < far
    near = near[mask_at_box] / norm_d[mask_at_box, 0]
    far = far[mask_at_box] / norm_d[mask_at_box, 0]
    return near, far, mask_at_box


# --------------------------------------------------------------------------
# device-side
# --------------------------------------------------------------------------

def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                      perturb: bool = False,
                      generator: torch.Generator | None = None,
                      t_rand: torch.Tensor | None = None) -> torch.Tensor:
    """Stratified depth samples per ray.  near/far (..., R) -> (..., R, S).

    Evenly spaced unless ``perturb``: then each sample moves uniformly
    within its stratum, by ``t_rand`` (..., R, S) in [0, 1) when given (the
    parity tests pass the JAX package's draws), else by draws from
    ``generator``.
    """
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype,
                            device=near.device)
    z_vals = near[..., None] * (1.0 - t_vals) + far[..., None] * t_vals
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=generator,
                                dtype=z_vals.dtype, device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def z_to_points(ray_o: torch.Tensor, ray_d: torch.Tensor,
                z_vals: torch.Tensor) -> torch.Tensor:
    """(..., R, 3) x (..., R, S) -> (..., R, S, 3)."""
    return ray_o[..., None, :] + ray_d[..., None, :] * z_vals[..., None]
