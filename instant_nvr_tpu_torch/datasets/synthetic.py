"""Procedural synthetic "human" scene for tests and benchmarks.

Generates batches with exactly the tensor layout the real ZJU/MonoCap loader
produces (SMPL metadata, per-part padded vertex sets, pose blend-weight
volume, UV volume, rays + GT pixels) but from an analytic sphere scene, so
the full train/eval path runs without any dataset on disk.  A numpy-only
copy of ``instant_nvr_tpu.datasets.synthetic`` (that package imports jax).

Scene: a lambertian sphere (radius 0.3) at the origin, observed by a pinhole
camera; "SMPL vertices" are fibonacci-sphere samples split into 5 z-bands
(the part structure), blend weights are a smooth 2-bone mix, and the
world==pose transform is identity so LBS is exercised as a pass-through
(non-identity pose variants available via ``pose_angle``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.lbs import NUM_PARTS
from ..ops.ray import get_near_far_np, get_rays_np

NUM_BONES = 24


def _fibonacci_sphere(n: int, radius: float) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - 2 * i / (n - 1)
    r = np.sqrt(np.maximum(0, 1 - y * y))
    pts = np.stack([np.cos(phi * i) * r, y, np.sin(phi * i) * r], axis=-1)
    return (radius * pts).astype(np.float32)


def _sphere_color(pts: np.ndarray) -> np.ndarray:
    """Position-dependent lambertian-ish color in [0,1]."""
    n = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-8)
    return (0.5 + 0.5 * n).astype(np.float32)


def _textured_color(pts: np.ndarray) -> np.ndarray:
    """Smooth color + mid-frequency procedural texture (canonical space).

    The round-2 quality fixture was texture-free: held-out PSNR was rim-
    dominated and interiors carried no reconstruction signal.  Bands in
    spherical coordinates give the radiance field real structure to learn
    while staying band-limited (well under the hash grid's top resolution,
    so the ceiling is the pipeline, not the fixture).
    """
    n = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-8)
    base = 0.5 + 0.5 * n
    u = np.arctan2(n[..., 1], n[..., 0])
    v = np.arccos(np.clip(n[..., 2], -1, 1))
    tex = 0.5 + 0.25 * np.sin(6.0 * u) * np.sin(8.0 * v) \
        + 0.15 * np.cos(11.0 * v + 3.0 * u)
    out = base * np.clip(tex, 0.15, 1.0)[..., None] + 0.1
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def make_scene(n_verts: int = 1200, radius: float = 0.3, grid: int = 32,
               seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    verts = _fibonacci_sphere(n_verts, radius)

    # part assignment by y-band
    band = np.clip(((verts[:, 1] / radius + 1) / 2 * NUM_PARTS).astype(int),
                   0, NUM_PARTS - 1)

    # smooth 2-bone blend weights per vertex
    bw = np.zeros((n_verts, NUM_BONES), np.float32)
    t = (verts[:, 1] / radius + 1) / 2
    bw[np.arange(n_verts), band] = 1 - (t % (1 / NUM_PARTS)) * NUM_PARTS * 0.3
    bw[np.arange(n_verts), (band + 1) % NUM_BONES] = 1 - bw[np.arange(n_verts), band]
    bw /= bw.sum(-1, keepdims=True)

    # padded per-part arrays (tpose_dataset.py:578-600 layout)
    lengths = np.array([(band == p).sum() for p in range(NUM_PARTS)], np.int32)
    M = int(lengths.max())
    part_pts = np.zeros((NUM_PARTS, M, 3), np.float32)
    part_pbw = np.zeros((NUM_PARTS, M, NUM_BONES), np.float32)
    part_bounds = np.zeros((NUM_PARTS, 2, 3), np.float32)
    for p in range(NUM_PARTS):
        sel = verts[band == p]
        part_pts[p, :lengths[p]] = sel
        part_pbw[p, :lengths[p]] = bw[band == p]
        part_bounds[p, 0] = sel.min(0) - 0.2
        part_bounds[p, 1] = sel.max(0) + 0.2

    bounds = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05]).astype(np.float32)

    # pose blend-weight volume: 24 bw channels + distance-to-surface channel
    axes = [np.linspace(bounds[0, d], bounds[1, d], grid) for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    gpts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    dist = np.abs(np.linalg.norm(gpts, axis=-1) - radius)
    pbw = np.zeros((grid, grid, grid, NUM_BONES + 1), np.float32)
    pbw[..., 0] = 1.0
    pbw[..., -1] = dist.reshape(grid, grid, grid)

    # canonical UV volume from spherical angles
    gnorm = gpts / np.maximum(np.linalg.norm(gpts, axis=-1, keepdims=True), 1e-8)
    u = np.arctan2(gnorm[:, 1], gnorm[:, 0]) / (2 * np.pi) + 0.5
    v = np.arccos(np.clip(gnorm[:, 2], -1, 1)) / np.pi
    tuv = np.stack([u, v], -1).reshape(grid, grid, grid, 2).astype(np.float32)

    eye = np.eye(4, dtype=np.float32)
    return {
        "verts": verts, "radius": np.float32(radius),
        "part_pts": part_pts, "part_pbw": part_pbw,
        "lengths2": lengths, "part_bounds": part_bounds,
        "pbw": pbw, "pbw_sizes": np.array([grid] * 3, np.int32),
        "pbounds": bounds, "wbounds": bounds,
        "tbounds": bounds, "tuv": tuv, "tuv_sizes": np.array([grid] * 3, np.int32),
        "A": np.tile(eye, (NUM_BONES, 1, 1)),
        "big_A": np.tile(eye, (NUM_BONES, 1, 1)),
        "R": np.eye(3, dtype=np.float32), "Th": np.zeros((1, 3), np.float32),
    }


def render_gt(scene, H: int = 64, W: int = 64):
    """Analytic GT image + mask from ray/sphere intersection."""
    K = np.array([[2 * W, 0, W / 2], [0, 2 * H, H / 2], [0, 0, 1]], np.float64)
    R = np.eye(3)
    T = np.array([[0.0], [0.0], [1.5]])  # camera at z=-1.5 looking at origin
    ray_o, ray_d = get_rays_np(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3).astype(np.float32)
    ray_d = ray_d.reshape(-1, 3).astype(np.float32)

    r = float(scene["radius"])
    b = np.sum(ray_o * ray_d, -1)
    c = np.sum(ray_o * ray_o, -1) - r * r
    disc = b * b - c
    hit = disc > 0
    t_hit = -b - np.sqrt(np.maximum(disc, 0))
    pts = ray_o + ray_d * t_hit[:, None]
    img = np.zeros((H * W, 3), np.float32)
    img[hit] = _sphere_color(pts[hit])
    return {"K": K, "Rc": R, "Tc": T, "H": H, "W": W,
            "ray_o": ray_o, "ray_d": ray_d,
            "img": img.reshape(H, W, 3), "mask": hit.reshape(H, W)}


def make_batch(scene, view, n_rays: int = 1024, seed: int = 0,
               split: str = "train") -> Dict[str, np.ndarray]:
    """Assemble a device-ready batch dict (numpy; caller moves to device)."""
    rng = np.random.default_rng(seed)
    H, W = view["H"], view["W"]
    ray_o_all = view["ray_o"]
    ray_d_all = view["ray_d"]
    img = view["img"].reshape(-1, 3)
    mask = view["mask"].reshape(-1)

    near_all, far_all, box = get_near_far_np(scene["wbounds"], ray_o_all, ray_d_all)
    idx_box = np.where(box)[0]

    if split == "train":
        # body-weighted sampling: half on the object mask, half anywhere in box
        n_body = n_rays // 2
        body_idx = np.where(mask & box)[0]
        pick_body = body_idx[rng.integers(0, len(body_idx), n_body)]
        pick_rand = idx_box[rng.integers(0, len(idx_box), n_rays - n_body)]
        pick = np.concatenate([pick_body, pick_rand])
    else:
        pick = idx_box[:n_rays] if len(idx_box) >= n_rays else \
            np.pad(idx_box, (0, n_rays - len(idx_box)), mode="edge")

    # map from all-rays index to box-subset index for near/far
    box_pos = np.full(len(box), -1, np.int64)
    box_pos[idx_box] = np.arange(len(idx_box))
    sel_box = box_pos[pick]

    batch = {k: scene[k] for k in
             ("part_pts", "part_pbw", "lengths2", "part_bounds", "pbw",
              "pbw_sizes", "pbounds", "tbounds", "tuv", "tuv_sizes",
              "A", "big_A", "R", "Th")}
    batch.update({
        "ray_o": ray_o_all[pick], "ray_d": ray_d_all[pick],
        "near": near_all[sel_box].astype(np.float32),
        "far": far_all[sel_box].astype(np.float32),
        "rgb": img[pick], "occupancy": mask[pick].astype(np.float32),
        "ray_mask": np.ones(n_rays, np.float32),
        "latent_index": np.int32(0), "frame_dim": np.float32(0.0),
        "reg_dist_weight": np.float32(0.1),
    })
    return batch
