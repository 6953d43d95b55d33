"""The benchmark's subject: a ZJU-MoCap-layout capture of an analytic sphere,
written once per checkout from fixed parameters and read by the program and
the reference alike.

The writer follows the port's ``datasets/fake_zju.py:write_fake_dataset``
(the on-disk contract of ``TPoseDataset``: ``annots.npy``, PNG images and
SCHP masks, per-frame SMPL vertices and parameters, the lbs tree, the SMPL
meta), with two changes for a cell at SMPL's scale: the sphere's vertices
are split into SMPL's five parts in about equal shares (a top cap for the
head, a bottom cap for the legs, the middle band in three wedges for the
body and the arms), each vertex weighted 0.7 / 0.3 over two bones of its
part, and the images are PNGs of unfiltered rows, which the reference reads
with ``zlib`` alone.

:func:`ensure_subject` writes into ``<cache>/subject-<key>``, the key a hash
of the parameters and of this file, through a fixed staging directory that
is renamed into place when complete; a later run finds it and reads only.
"""
from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
from pathlib import Path
from typing import Dict

import numpy as np

from .reference.datasets.image_ops import rodrigues, write_png
from .reference.datasets.tpose_dataset import schp_palette
from .reference.ops.lbs import PART_BW_MAP, PARTNAMES
from .reference.ops.ray import get_rays_np

NUM_BONES = 24


def fibonacci_sphere(n: int, radius: float) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - 2 * i / (n - 1)
    r = np.sqrt(np.maximum(0, 1 - y * y))
    pts = np.stack([np.cos(phi * i) * r, y, np.sin(phi * i) * r], axis=-1)
    return (radius * pts).astype(np.float32)


def textured_color(pts: np.ndarray) -> np.ndarray:
    """Smooth colour with a band-limited procedural texture (canonical space)."""
    n = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-8)
    base = 0.5 + 0.5 * n
    u = np.arctan2(n[..., 1], n[..., 0])
    v = np.arccos(np.clip(n[..., 2], -1, 1))
    tex = 0.5 + 0.25 * np.sin(6.0 * u) * np.sin(8.0 * v) \
        + 0.15 * np.cos(11.0 * v + 3.0 * u)
    out = base * np.clip(tex, 0.15, 1.0)[..., None] + 0.1
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def part_of_vertex(verts: np.ndarray, radius: float) -> np.ndarray:
    """Each vertex's part index into ``PARTNAMES``: head above 0.6 r, legs
    below -0.6 r, the band between split by azimuth into the left arm
    (cos > 0.5), the right arm (cos < -0.5) and the body."""
    y = verts[:, 1] / radius
    c = verts[:, 0] / np.maximum(np.hypot(verts[:, 0], verts[:, 2]), 1e-8)
    part = np.full(len(verts), PARTNAMES.index("body"))
    part[c > 0.5] = PARTNAMES.index("larm")
    part[c < -0.5] = PARTNAMES.index("rarm")
    part[y > 0.6] = PARTNAMES.index("head")
    part[y < -0.6] = PARTNAMES.index("leg")
    return part


def bone_weights(verts: np.ndarray, radius: float) -> np.ndarray:
    """(n, 24) blend weights: 0.7 on a bone of the vertex's part and 0.3 on
    the next bone of that part, the bone chosen by height."""
    part = part_of_vertex(verts, radius)
    t = (verts[:, 1] / radius + 1) / 2
    w = np.zeros((len(verts), NUM_BONES), np.float32)
    for p, name in enumerate(PARTNAMES):
        bones = PART_BW_MAP[name]
        sel = np.nonzero(part == p)[0]
        k = np.clip((t[sel] * len(bones)).astype(int), 0, len(bones) - 1)
        w[sel, np.asarray(bones)[k]] = 0.7
        w[sel, np.asarray(bones)[(k + 1) % len(bones)]] += 0.3
    return w


def write_subject(root: str, n_frames: int, n_views: int, n_verts: int,
                  H: int, W: int, radius: float = 0.3, seed: int = 0,
                  supersample: int = 1, grid: int = 16,
                  workers: int = 1) -> None:
    """The subject's files under ``root`` (see the module doc): ``n_views``
    cameras on a ring at 1.5 m, ``n_frames`` frames in which the sphere
    turns and drifts, ground truth rendered at ``supersample``^2 rays a
    pixel and box-filtered, masks at half coverage; ``grid`` is the
    resolution of the blend-weight and UV volumes per axis; ``workers``
    processes write the frames."""
    rng = np.random.default_rng(seed)
    smpl_meta = os.path.join(root, "smpl-meta")
    lbs = os.path.join(root, "smpl_lbs")
    for d in ("images", "schp", "smpl_vertices", "smpl_params",
              os.path.join("smpl_lbs", "bweights"), "smpl-meta"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    verts0 = fibonacci_sphere(n_verts, radius)
    np.save(os.path.join(smpl_meta, "weights.npy"), bone_weights(verts0, radius))
    parents = np.concatenate([[0], np.arange(NUM_BONES - 1)]).astype(np.int64)
    np.save(os.path.join(smpl_meta, "parents.npy"), parents)
    np.save(os.path.join(smpl_meta, "faces.npy"),
            rng.integers(0, n_verts, (2 * n_verts, 3)).astype(np.int64))
    joints = rng.normal(size=(NUM_BONES, 3)).astype(np.float32) * 0.1
    np.save(os.path.join(lbs, "joints.npy"), joints)
    np.save(os.path.join(lbs, "parents.npy"), parents)

    # canonical (bigpose) data: 24 bone weights and a distance channel
    np.save(os.path.join(lbs, "bigpose_vertices.npy"), verts0)
    g = int(grid)
    bounds = np.stack([verts0.min(0) - 0.05, verts0.max(0) + 0.05])
    axes0 = [np.linspace(bounds[0, d], bounds[1, d], g) for d in range(3)]
    gpts0 = np.stack(np.meshgrid(*axes0, indexing="ij"), -1).reshape(-1, 3)
    tvol = np.zeros((g, g, g, NUM_BONES + 1), np.float32)
    tvol[..., 0] = 1.0
    tvol[..., -1] = np.abs(np.linalg.norm(gpts0, axis=-1) - radius).reshape(g, g, g)
    np.save(os.path.join(lbs, "bigpose_bw.npy"), tvol)
    np.save(os.path.join(root, "bigpose_uv.npy"),
            rng.uniform(0, 1, (g, g, g, 2)).astype(np.float32))

    cams = {"K": [], "D": [], "R": [], "T": []}
    for v in range(n_views):
        Rc = rodrigues(np.array([0.0, 2 * np.pi * v / n_views, 0.0]))
        C = Rc.T @ np.array([0, 0, -1.5])
        cams["K"].append(np.array([[2 * W, 0, W / 2], [0, 2 * H, H / 2], [0, 0, 1]],
                                  np.float64))
        cams["D"].append(np.zeros((5, 1)))
        cams["R"].append(Rc)
        cams["T"].append((-Rc @ C).reshape(3, 1) * 1000.0)   # annots store mm

    jobs = [(root, f, cams, n_views, H, W, radius, supersample, g)
            for f in range(n_frames)]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, n_frames)) as pool:
            ims = pool.map(_write_frame, jobs)
            pool.close()
            pool.join()
    else:
        ims = [_write_frame(j) for j in jobs]
    np.save(os.path.join(root, "annots.npy"), {"cams": cams, "ims": ims})


def _write_frame(job) -> Dict:
    """One frame's SMPL files, blend-weight volume, images and masks."""
    root, f, cams, n_views, H, W, radius, supersample, g = job
    lbs = os.path.join(root, "smpl_lbs")
    verts0 = np.load(os.path.join(lbs, "bigpose_vertices.npy"))
    pal = schp_palette(20)
    ss = max(1, int(supersample))
    Th = np.array([0.15 * np.sin(0.4 * f), 0.05 * np.sin(0.23 * f),
                   0.15 * np.cos(0.4 * f) - 0.15], np.float32).reshape(1, 3)
    Rh = np.array([[0.0, 0.9 * f, 0.0]], np.float32)
    Rw = rodrigues(Rh.astype(np.float64))
    wxyz = (verts0 @ Rw.T.astype(np.float32)) + Th
    np.save(os.path.join(root, "smpl_vertices", f"{f}.npy"), wxyz)
    np.save(os.path.join(root, "smpl_params", f"{f}.npy"),
            {"Rh": Rh.ravel(), "Th": Th.astype(np.float32),
             "poses": np.zeros((1, NUM_BONES * 3), np.float32)})

    pb = np.stack([wxyz.min(0) - Th[0] - 0.05, wxyz.max(0) - Th[0] + 0.05])
    axes = [np.linspace(pb[0, d], pb[1, d], g) for d in range(3)]
    gpts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    vol = np.zeros((g, g, g, NUM_BONES + 1), np.float32)
    vol[..., 0] = 1.0
    vol[..., -1] = np.abs(np.linalg.norm(gpts, axis=-1) - radius).reshape(g, g, g)
    np.save(os.path.join(lbs, "bweights", f"{f}.npy"), vol)

    frame_ims = []
    for v in range(n_views):
        K, Rc, Tc = cams["K"][v], cams["R"][v], cams["T"][v] / 1000.0
        Khi = K.copy()
        Khi[:2] *= ss
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
        img[hit] = textured_color(pts[hit] @ Rw.astype(np.float32))
        img = img.reshape(H, ss, W, ss, 3).mean((1, 3))
        cover = hit.reshape(H, ss, W, ss).mean((1, 3))
        rel = f"images/Cam{v}/{f:04d}.png"
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        write_png(os.path.join(root, rel), (img * 255).round().astype(np.uint8))
        sem = np.zeros((H, W), np.uint8)
        sem[cover > 0.5] = 5                       # SCHP's body label
        mrel = rel.replace("images", "schp")
        os.makedirs(os.path.dirname(os.path.join(root, mrel)), exist_ok=True)
        write_png(os.path.join(root, mrel), pal[sem])
        frame_ims.append(rel)
    return {"ims": frame_ims}


def subject_key(params: Dict) -> str:
    h = hashlib.sha256(json.dumps(params, sort_keys=True).encode())
    h.update(Path(__file__).read_bytes())
    return h.hexdigest()[:16]


def ensure_subject(cache: str, params: Dict, workers: int = 1) -> str:
    """The subject of ``params`` under ``cache``, written unless it is
    there; returns its directory."""
    root = os.path.join(cache, f"subject-{subject_key(params)}")
    if os.path.exists(os.path.join(root, "annots.npy")):
        return root
    staging = root + ".partial"
    shutil.rmtree(staging, ignore_errors=True)
    write_subject(staging, **params, workers=workers)
    os.replace(staging, root)
    return root


def subject_overrides(root: str, params: Dict) -> Dict:
    """Config entries that point a configuration at the subject."""
    node = {"data_root": root, "human": "nvrbench",
            "ann_file": os.path.join(root, "annots.npy")}
    return {"train_dataset": dict(node, split="train"),
            "test_dataset": dict(node, split="test"),
            "val_dataset": dict(node, split="val"),
            "smpl_meta": os.path.join(root, "smpl-meta"),
            "lbs": "smpl_lbs", "params": "smpl_params",
            "vertices": "smpl_vertices"}
