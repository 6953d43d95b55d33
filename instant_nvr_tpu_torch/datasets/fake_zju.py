"""Write a miniature ZJU-MoCap-format subject to disk (port of
``instant_nvr_tpu/datasets/fake_zju.py``).

The exact on-disk contract of ``TPoseDataset`` (annots.npy, PNG images and
SCHP masks, per-frame SMPL vertices and parameters, the lbs tree, the SMPL
meta) around an analytic sphere, so the data layer and the training loop
run without the real dataset.  Images are written with
``image_ops.write_png``; the pixels equal the JAX package's writer's.

    python -m instant_nvr_tpu_torch.datasets.fake_zju data/fake_zju

writes ``tools/make_fixtures.py``'s ``data/fake_zju`` recipe (3 views x 4
frames at 512^2, 2,000 vertices).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..ops.ray import get_rays_np
from .image_ops import rodrigues, write_png
from .synthetic import _fibonacci_sphere, _sphere_color, _textured_color
from .tpose_dataset import schp_palette

NUM_BONES = 24


def write_fake_dataset(root: str, n_frames: int = 2, n_views: int = 2,
                       n_verts: int = 2000, H: int = 128, W: int = 128,
                       radius: float = 0.3, seed: int = 0,
                       supersample: int = 4, texture: bool = True,
                       grid: int = 16) -> dict:
    """A miniature ZJU-layout subject: a sphere of ``n_verts`` vertices
    (spacing well under ``smpl_thresh``) that turns and drifts per frame,
    seen by ``n_views`` cameras on a ring.  Ground truth is rendered at
    ``supersample``^2 rays a pixel and box-filtered (anti-aliased rims);
    the masks threshold that coverage at 0.5.  ``texture`` paints a
    procedural texture in canonical space; ``grid`` is the resolution of
    the blend-weight and UV volumes per axis."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    smpl_meta = os.path.join(root, "smpl-meta")
    lbs = os.path.join(root, "smpl_lbs")
    for d in ("images", "schp", "smpl_vertices", "smpl_params",
              os.path.join("smpl_lbs", "bweights")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    os.makedirs(smpl_meta, exist_ok=True)

    verts0 = _fibonacci_sphere(n_verts, radius)

    # SMPL meta: weights, parents, faces, joints
    t = (verts0[:, 1] / radius + 1) / 2
    weights = np.zeros((n_verts, NUM_BONES), np.float32)
    bone = np.clip((t * 6).astype(int), 0, 5)
    weights[np.arange(n_verts), bone] = 0.7
    weights[np.arange(n_verts), (bone + 1) % NUM_BONES] = 0.3
    np.save(os.path.join(smpl_meta, "weights.npy"), weights)
    parents = np.concatenate([[0], np.arange(NUM_BONES - 1)]).astype(np.int64)
    np.save(os.path.join(smpl_meta, "parents.npy"), parents)
    np.save(os.path.join(smpl_meta, "faces.npy"),
            rng.integers(0, n_verts, (2 * n_verts, 3)).astype(np.int64))
    joints = rng.normal(size=(NUM_BONES, 3)).astype(np.float32) * 0.1
    np.save(os.path.join(lbs, "joints.npy"), joints)
    np.save(os.path.join(lbs, "parents.npy"), parents)

    # canonical (bigpose) data: the blend-weight volume holds 24 bone
    # weights and a distance-to-surface channel
    np.save(os.path.join(lbs, "bigpose_vertices.npy"), verts0)
    g = int(grid)
    bounds = np.stack([verts0.min(0) - 0.05, verts0.max(0) + 0.05])
    axes0 = [np.linspace(bounds[0, d], bounds[1, d], g) for d in range(3)]
    gpts0 = np.stack(np.meshgrid(*axes0, indexing="ij"), -1).reshape(-1, 3)
    tvol = np.zeros((g, g, g, NUM_BONES + 1), np.float32)
    tvol[..., 0] = 1.0
    tvol[..., -1] = np.abs(np.linalg.norm(gpts0, axis=-1) - radius) \
        .reshape(g, g, g)
    np.save(os.path.join(lbs, "bigpose_bw.npy"), tvol)
    uvvol = rng.uniform(0, 1, (g, g, g, 2)).astype(np.float32)
    np.save(os.path.join(root, "bigpose_uv.npy"), uvvol)

    # cameras on a ring at distance 1.5, looking at the origin
    cams = {"K": [], "D": [], "R": [], "T": []}
    for v in range(n_views):
        Rc = rodrigues(np.array([0.0, 2 * np.pi * v / n_views, 0.0]))
        C = Rc.T @ np.array([0, 0, -1.5])
        T = -Rc @ C
        cams["K"].append(np.array([[2 * W, 0, W / 2], [0, 2 * H, H / 2], [0, 0, 1]],
                                  np.float64))
        cams["D"].append(np.zeros((5, 1)))
        cams["R"].append(Rc)
        cams["T"].append(T.reshape(3, 1) * 1000.0)  # annots store mm

    pal = schp_palette(20)
    color_fn = _textured_color if texture else _sphere_color
    ss = max(1, int(supersample))
    ims = []
    for f in range(n_frames):
        # the body turns per frame (canonical geometry and colours stay
        # fixed while the world pose changes) on a bounded orbit
        Th = np.array([0.15 * np.sin(0.4 * f),
                       0.05 * np.sin(0.23 * f),
                       0.15 * np.cos(0.4 * f) - 0.15],
                      np.float32).reshape(1, 3)
        Rh = np.array([[0.0, 0.9 * f, 0.0]], np.float32)
        Rw = rodrigues(Rh.astype(np.float64))
        wxyz = (verts0 @ Rw.T.astype(np.float32)) + Th
        np.save(os.path.join(root, "smpl_vertices", f"{f}.npy"), wxyz)
        np.save(os.path.join(root, "smpl_params", f"{f}.npy"),
                {"Rh": Rh.ravel(), "Th": Th.astype(np.float32),
                 "poses": np.zeros((1, NUM_BONES * 3), np.float32)})

        # per-frame blend-weight volume with the distance channel
        pb = np.stack([wxyz.min(0) - Th[0] - 0.05, wxyz.max(0) - Th[0] + 0.05])
        axes = [np.linspace(pb[0, d], pb[1, d], g) for d in range(3)]
        gpts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        dist = np.abs(np.linalg.norm(gpts, axis=-1) - radius)
        vol = np.zeros((g, g, g, NUM_BONES + 1), np.float32)
        vol[..., 0] = 1.0
        vol[..., -1] = dist.reshape(g, g, g)
        np.save(os.path.join(lbs, "bweights", f"{f}.npy"), vol)

        frame_ims = []
        for v in range(n_views):
            K, Rc, Tc = cams["K"][v], cams["R"][v], cams["T"][v] / 1000.0
            Khi = K.copy()
            Khi[:2] *= ss
            # low-res pixel J box-filters high-res pixels ss*J .. ss*J+ss-1,
            # whose mean lands on ray J once the principal point moves by
            # (ss - 1) / 2
            Khi[:2, 2] += (ss - 1) / 2.0
            ro, rd = get_rays_np(H * ss, W * ss, Khi, Rc, Tc)
            ro = ro.reshape(-1, 3) - Th
            rd = rd.reshape(-1, 3)
            b = np.sum(ro * rd, -1)
            c = np.sum(ro * ro, -1) - radius * radius
            disc = b * b - c
            hit = disc > 0
            t_hit = -b - np.sqrt(np.maximum(disc, 0))
            pts = ro + rd * t_hit[:, None]
            img = np.zeros((H * ss * W * ss, 3), np.float32)
            img[hit] = color_fn(pts[hit] @ Rw.astype(np.float32))
            img = img.reshape(H, ss, W, ss, 3).mean((1, 3))
            cover = hit.reshape(H, ss, W, ss).mean((1, 3))
            img = (img * 255).round().astype(np.uint8)

            rel = f"images/Cam{v}/{f:04d}.png"
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
            write_png(os.path.join(root, rel), img)
            # SCHP mask: the body label (5) where coverage exceeds half
            sem = np.zeros((H, W), np.uint8)
            sem[cover > 0.5] = 5
            mrel = rel.replace("images", "schp")[:-4] + ".png"
            os.makedirs(os.path.dirname(os.path.join(root, mrel)), exist_ok=True)
            write_png(os.path.join(root, mrel), pal[sem])
            frame_ims.append(rel)
        ims.append({"ims": frame_ims})

    np.save(os.path.join(root, "annots.npy"), {"cams": cams, "ims": ims})
    return {"root": root, "n_frames": n_frames, "n_views": n_views}


def fake_cfg_overrides(root: str, n_frames: int = 2) -> dict:
    """Config entries that point a config at a subject written here."""
    return {
        "train_dataset": {"data_root": root, "human": "fake",
                          "ann_file": os.path.join(root, "annots.npy"),
                          "split": "train"},
        "test_dataset": {"data_root": root, "human": "fake",
                         "ann_file": os.path.join(root, "annots.npy"),
                         "split": "test"},
        "val_dataset": {"data_root": root, "human": "fake",
                        "ann_file": os.path.join(root, "annots.npy"),
                        "split": "val"},
        "smpl_meta": os.path.join(root, "smpl-meta"),
        "num_train_frame": n_frames,
        "frame_interval": 1,
        "training_view": [0],
        "test_view": [1],
        "ratio": 0.5,
        "eval_ratio": 0.5,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.datasets.fake_zju")
    p.add_argument("root", nargs="?", default="data/fake_zju")
    root = p.parse_args(argv).root
    write_fake_dataset(root, n_frames=4, n_views=3, H=512, W=512)
    print(f"wrote {root}: 3 views x 4 frames, 512^2")


if __name__ == "__main__":
    main()
