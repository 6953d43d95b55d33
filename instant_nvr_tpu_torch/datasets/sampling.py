"""Host-side ray sampling (port of ``instant_nvr_tpu/datasets/sampling.py``).

The strategies of the reference data layer, each with a fixed output shape:

  - :func:`sample_rays_train`: body- and face-weighted pixel draws from the
    projected box, resampled in bounded rounds and truncated;
  - :func:`sample_rays_mse`: a share of the rays on the top-20% error pixels;
  - :func:`sample_coord`: draws from a precomputed coordinate set;
  - :func:`sample_rays_full`: every pixel whose ray hits the box (eval);
  - :func:`sample_patch`: one ``patch_size`` square crop around a body (or
    focus) pixel, for the image-space patch losses.

The projected-box mask is :func:`image_ops.fill_convex_poly` in place of
``cv2.fillPoly``; rays and pixel draws go through the native library
(``utils/native.py``), whose mt19937 draws are the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ops.ray import get_near_far_np, get_rays_np
from ..utils import native
from .image_ops import fill_convex_poly

# the faces of the box by corner index (bit pattern x, y, z)
_BOX_FACES = ((0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
              (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5))


def _bound_2d_mask(bounds, K, R, T, H, W) -> np.ndarray:
    """Pixels inside the projection of the box ``bounds`` (2, 3)."""
    lo, hi = bounds
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    cam = corners @ R.T + T.ravel()
    uv = cam @ K.T
    uv = np.round(uv[:, :2] / uv[:, 2:]).astype(int)
    mask = np.zeros((H, W), np.uint8)
    for f in _BOX_FACES:
        fill_convex_poly(mask, uv[list(f)], 1)
    return mask


def _weighted_pick(msk, bound_mask, n_body, n_face, n_rand, rng):
    """The plain (numpy) weighted pixel draw: same classes as
    :func:`native.sample_pixels`, another random stream."""
    picks = []
    body = np.argwhere(msk == 1)
    if n_body and len(body):
        picks.append(body[rng.integers(0, len(body), n_body)])
    face = np.argwhere(msk == 13)
    if n_face and len(face):
        picks.append(face[rng.integers(0, len(face), n_face)])
    box = np.argwhere(bound_mask == 1)
    n_rand = n_rand + (n_face if not len(face) else 0) + (n_body if not len(body) else 0)
    if n_rand and len(box):
        picks.append(box[rng.integers(0, len(box), n_rand)])
    return np.concatenate(picks, axis=0)


def weighted_pick(msk, bound_mask, n_body, n_face, n_rand, rng):
    """Weighted pixel draw through the native library, seeded from ``rng``."""
    seed = int(rng.integers(0, 2 ** 63 - 1))
    return native.sample_pixels(msk, bound_mask, n_body, n_face, n_rand, seed)


def _finalize(img, K, R, T, coords, bounds, nrays, rng, bound_mask):
    """Resample until ``nrays`` box-hitting rays are collected (at most 8
    rounds), then truncate; degenerate masks pad by repetition with the
    pads masked out of ``ray_mask``."""
    out_o, out_d, out_rgb, out_near, out_far, out_coord = [], [], [], [], [], []
    total = 0
    for _round in range(8):
        o, d = native.ray_dirs(K, R, T, coords)
        rgb = img[coords[:, 0], coords[:, 1]]
        near, far, hit = native.near_far(bounds, o, d)
        out_o.append(o[hit]); out_d.append(d[hit]); out_rgb.append(rgb[hit])
        out_near.append(near); out_far.append(far); out_coord.append(coords[hit])
        total += hit.sum()
        if total >= nrays:
            break
        box = np.argwhere(bound_mask == 1)
        coords = box[rng.integers(0, len(box), nrays - total)]
    cat = lambda xs: np.concatenate(xs, axis=0)[:nrays]
    o, d, rgb = cat(out_o), cat(out_d), cat(out_rgb)
    near, far, coord = cat(out_near), cat(out_far), cat(out_coord)
    n = len(o)
    if n < nrays:
        reps = np.resize(np.arange(n), nrays - n)
        pad = lambda x: np.concatenate([x, x[reps]], axis=0)
        mask = np.concatenate([np.ones(n, np.float32), np.zeros(nrays - n, np.float32)])
        o, d, rgb, near, far, coord = map(pad, (o, d, rgb, near, far, coord))
    else:
        mask = np.ones(nrays, np.float32)
    return {"ray_o": o.astype(np.float32), "ray_d": d.astype(np.float32),
            "rgb": rgb.astype(np.float32), "near": near.astype(np.float32),
            "far": far.astype(np.float32), "coord": coord,
            "mask_at_box": np.ones(nrays, bool), "ray_mask": mask}


def _apply_restrict(msk, bound_mask, restrict_mask):
    """Intersect a geometry-pruning pixel mask into the sampling pools (the
    consumption side of ``prune_using_geo``); a restrict mask overlapping
    the box pool by fewer than 64 pixels is ignored."""
    if restrict_mask is None:
        return msk, bound_mask
    inside = (bound_mask == 1) & (restrict_mask > 0)
    if inside.sum() < 64:
        return msk, bound_mask
    bound_mask = np.where(inside, bound_mask, 0)
    msk = np.where(restrict_mask > 0, msk, 0)
    return msk, bound_mask


def _pools(img, msk, K, R, T, bounds, restrict_mask):
    """(image zeroed outside the box, class mask, box pool without the
    eroded edge band (label 100))."""
    H, W = img.shape[:2]
    bound_mask = _bound_2d_mask(bounds, K, R, T, H, W)
    img = img.copy()
    img[bound_mask != 1] = 0
    msk = msk * bound_mask
    bound_mask = bound_mask.copy()
    bound_mask[msk == 100] = 0
    msk, bound_mask = _apply_restrict(msk, bound_mask, restrict_mask)
    return img, msk, bound_mask


def sample_rays_train(img, msk, K, R, T, bounds, nrays, body_ratio, face_ratio,
                      rng, restrict_mask=None) -> Dict[str, np.ndarray]:
    img, msk, bound_mask = _pools(img, msk, K, R, T, bounds, restrict_mask)
    n_body = int(nrays * body_ratio)
    n_face = int(nrays * face_ratio)
    n_rand = nrays - n_body - n_face
    coords = weighted_pick(msk, bound_mask, n_body, n_face, n_rand, rng)
    return _finalize(img, K, R, T, coords, bounds, nrays, rng, bound_mask)


def sample_rays_mse(img, msk, error_map, K, R, T, bounds, nrays, mse_portion,
                    body_ratio, face_ratio, rng,
                    restrict_mask=None) -> Dict[str, np.ndarray]:
    """Error-guided: the top-20% error pixels get ``mse_portion`` of the rays."""
    img, msk, bound_mask = _pools(img, msk, K, R, T, bounds, restrict_mask)
    nz = error_map[(error_map > 0) & (msk == 1)]
    if len(nz):
        k = max(int(len(nz) * 0.2), 1)
        thresh = np.partition(nz, -k)[-k]
        err_msk = (error_map >= thresh) & (msk == 1)
    else:
        err_msk = np.zeros_like(msk, bool)

    n_err = int(nrays * mse_portion)
    n_body = int(nrays * (1 - mse_portion) * body_ratio)
    n_face = int(nrays * (1 - mse_portion) * face_ratio)
    n_rand = nrays - n_err - n_body - n_face
    picks = []
    err_coords = np.argwhere(err_msk)
    if n_err and len(err_coords):
        picks.append(err_coords[rng.integers(0, len(err_coords), n_err)])
    else:
        n_rand += n_err
    picks.append(weighted_pick(msk, bound_mask, n_body, n_face, n_rand, rng))
    coords = np.concatenate(picks, axis=0)
    return _finalize(img, K, R, T, coords, bounds, nrays, rng, bound_mask)


def sample_coord(img, msk, train_coord, K, R, T, bounds, nrays,
                 rng) -> Dict[str, np.ndarray]:
    """Draw from ``train_coord`` = {'coord': (M, 2), 'near': (M,), 'far':
    (M,)} until ``nrays`` coords survive the edge-band filter, truncated."""
    H, W = img.shape[:2]
    bound_mask = _bound_2d_mask(bounds, K, R, T, H, W)
    img = img.copy()
    img[bound_mask != 1] = 0
    msk = msk * bound_mask

    M = len(train_coord["coord"])
    picks, nears, fars = [], [], []
    total = 0
    for _ in range(8):
        want = nrays - total
        if want <= 0:
            break
        inds = rng.integers(0, M, want)
        coord = train_coord["coord"][inds]
        keep = msk[coord[:, 0], coord[:, 1]] != 100
        picks.append(coord[keep])
        nears.append(train_coord["near"][inds][keep])
        fars.append(train_coord["far"][inds][keep])
        total += keep.sum()
    coord = np.concatenate(picks)[:nrays]
    near = np.concatenate(nears)[:nrays].astype(np.float32)
    far = np.concatenate(fars)[:nrays].astype(np.float32)
    n = len(coord)
    mask = np.ones(nrays, np.float32)
    if n < nrays:
        reps = np.resize(np.arange(max(n, 1)), nrays - n)
        coord = np.concatenate([coord, coord[reps]])
        near = np.concatenate([near, near[reps]])
        far = np.concatenate([far, far[reps]])
        mask[n:] = 0.0
    o, d = native.ray_dirs(K, R, T, coord)
    return {"ray_o": o, "ray_d": d,
            "rgb": img[coord[:, 0], coord[:, 1]].astype(np.float32),
            "near": near, "far": far, "coord": coord,
            "mask_at_box": np.ones(nrays, bool), "ray_mask": mask}


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


def pick_nonzero(ref: np.ndarray, rng):
    """``np.argwhere(ref)[rng.integers(0, n)]`` for the n nonzero pixels of
    the 2-D ``ref``, the same draw and the same pixel, from the rows'
    counts and one row's nonzeros instead of every pixel's coordinates
    (six times faster at 1024^2)."""
    rows = np.cumsum(np.count_nonzero(ref, axis=1))
    k = int(rng.integers(0, int(rows[-1]) if len(rows) else 0))
    r = int(np.searchsorted(rows, k, side="right"))
    return r, int(np.flatnonzero(ref[r])[k - (int(rows[r - 1]) if r else 0)])


def sample_patch(img, msk, K, R, T, bounds, patch_size: int,
                 focus_msk: Optional[np.ndarray], rng) -> Dict[str, np.ndarray]:
    """A ``patch_size`` square crop centred on a random body (or focus)
    pixel: exactly patch_size^2 ray slots, rays that miss the box masked
    out by ``ray_mask`` with a degenerate [0, 0] depth interval (their
    samples sit at the camera and the SMPL-distance cull drops them), and
    ``patch_hw`` for the image-space losses."""
    H, W = img.shape[:2]
    ref = focus_msk if focus_msk is not None and focus_msk.sum() > 0 else (msk == 1)
    cy, cx = pick_nonzero(ref, rng)
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
    near, far, hit = native.near_far(bounds, ray_o, ray_d)

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
