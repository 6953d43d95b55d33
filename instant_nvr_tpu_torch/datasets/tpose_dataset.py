"""ZJU-MoCap / MonoCap dataset: the host pipeline that builds a training or
eval item (port of ``instant_nvr_tpu/datasets/tpose_dataset.py``).

The on-disk contract is the reference loader's:

  data_root/
    annots.npy                       # {'cams': {K,D,R,T}, 'ims': [{'ims': []}]}
    images..., schp/ or mask_cihp/   # per-view frames + semantic masks (PNG)
    <vertices>/<i>.npy               # posed SMPL vertices (world)
    <params>/<i>.npy                 # {'Rh','Th','poses'}
    <lbs>/joints.npy, parents.npy, bweights/<i>.npy,
          bigpose_vertices.npy, bigpose_bw.npy
    bigpose_uv.npy
  smpl_meta/: faces.npy, parents.npy, weights.npy

Image decoding, undistortion, resizing, the box mask and the mask
morphology go through ``image_ops`` (numpy, scipy and the host decoder
``csrc/imgdecode.cpp``) in place of OpenCV and imageio, with the same
pixels.  Images are JPEG (real captures) or PNG, told apart by their bytes;
masks are PNG, as in the JAX package.  The items are numpy, as the JAX
package's are; the train loop moves them to the device.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from ..ops.lbs import NUM_PARTS, PART_BW_MAP, PARTNAMES
from . import image_ops, sampling

NUM_BONES = 24


def schp_palette(num_cls: int = 20) -> np.ndarray:
    """VOC-style colour palette of the SCHP semantic masks."""
    pal = np.zeros((num_cls, 3), np.uint8)
    for j in range(num_cls):
        lab, i = j, 0
        while lab:
            pal[j, 0] |= ((lab >> 0) & 1) << (7 - i)
            pal[j, 1] |= ((lab >> 1) & 1) << (7 - i)
            pal[j, 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return pal


def rodrigues_np(r: np.ndarray) -> np.ndarray:
    return image_ops.rodrigues(r).astype(np.float32)


def get_rigid_transformation_np(poses, joints, parents):
    """(J, 4, 4) float32 joint transforms of the kinematic chain for axis-angle
    ``poses`` (J, 3) about ``joints`` (J, 3)."""
    J = joints.shape[0]
    rots = np.stack([image_ops.rodrigues(p) for p in poses])
    rel = joints.copy()
    rel[1:] -= joints[parents[1:]]
    T = np.zeros((J, 4, 4))
    T[:, :3, :3] = rots
    T[:, :3, 3] = rel
    T[:, 3, 3] = 1
    chain = [T[0]]
    for i in range(1, J):
        chain.append(chain[parents[i]] @ T[i])
    A = np.stack(chain)
    jh = np.concatenate([joints, np.zeros((J, 1))], axis=1)
    A[:, :, 3] -= np.einsum("jab,jb->ja", A, jh)
    return A.astype(np.float32)


def get_bounds(xyz: np.ndarray, padding: float = 0.05) -> np.ndarray:
    lo = xyz.min(0) - padding
    hi = xyz.max(0) + padding
    return np.stack([lo, hi]).astype(np.float32)


def erode_edge_mask(msk: np.ndarray, border: int) -> np.ndarray:
    """The mask with its boundary band (dilated minus eroded by a
    ``border``-pixel square) set to label 100, which no ray is drawn from."""
    msk = msk.copy()
    er = image_ops.erode(msk, border)
    di = image_ops.dilate(msk, border)
    msk[(di - er) == 1] = 100
    return msk


# SCHP label -> part semantic masks
_SEM_GROUPS = {
    "head": (2, 10, 13),
    "larm": (14,),
    "rarm": (15,),
    "lleg": (9, 16),
    "rleg": (9, 17),
    "leg": (9, 16, 17),
    "body": (5,),
    "arm": (14, 15),
}


class TPoseDataset:
    """Index-addressable dataset of per-(frame, view) samples."""

    _schp_lut = None           # (24-bit colour -> label table, palette size)

    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = split
        node = cfg[f"{split}_dataset"] if f"{split}_dataset" in cfg else cfg.train_dataset
        self.data_root = node.data_root
        self.human = node.human

        annots = np.load(node.ann_file, allow_pickle=True).item()
        self.cams = annots["cams"]
        num_cams = len(self.cams["K"])

        test_view = list(cfg.test_view) or \
            [i for i in range(num_cams) if i not in cfg.training_view] or [0]
        if split in ("train", "prune"):
            self.view = list(cfg.training_view)
        elif split == "test":
            self.view = test_view
        else:  # val
            self.view = test_view[::4]

        i0 = cfg.begin_ith_frame
        i_intv = cfg.frame_interval
        ni = cfg.num_train_frame
        if cfg.get("test_novel_pose", False):
            i0 = cfg.begin_ith_frame + cfg.num_train_frame * i_intv
            ni = cfg.num_eval_frame
        self.f_intv = i_intv

        frames = annots["ims"][i0:i0 + ni * i_intv][::i_intv]
        self.ims = np.array([np.array(d["ims"])[self.view] for d in frames]).ravel()
        self.cam_inds = np.array(
            [np.arange(len(d["ims"]))[self.view] for d in frames]).ravel()
        self.num_cams = len(self.view)
        self.nrays = cfg.N_rand

        self.lbs_root = os.path.join(self.data_root, cfg.lbs)
        self.joints = np.load(os.path.join(self.lbs_root, "joints.npy")).astype(np.float32)
        self.parents = np.load(os.path.join(self.lbs_root, "parents.npy"))

        # SMPL meta and each vertex's part (by its largest blend weight)
        meta_root = cfg.smpl_meta
        self.faces = np.load(os.path.join(meta_root, "faces.npy")).astype(np.int64)
        self.weights = np.load(os.path.join(meta_root, "weights.npy")).astype(np.float32)
        wmax = self.weights.argmax(-1)
        parts = np.zeros(self.weights.shape[0], np.int64)
        for pid, pname in enumerate(PARTNAMES):
            for bwid in PART_BW_MAP[pname]:
                parts[wmax == bwid] = pid
        self.parts = parts
        self.part_counts = np.array([(parts == p).sum() for p in range(NUM_PARTS)])
        self.max_part = int(self.part_counts.max())

        # canonical (bigpose) data
        vfile = "bigpose_vertices.npy" if cfg.bigpose else "tvertices.npy"
        self.tpose = np.load(os.path.join(self.lbs_root, vfile)).astype(np.float32)
        bwfile = "bigpose_bw.npy" if cfg.bigpose else "tbw.npy"
        self.tbw = np.load(os.path.join(self.lbs_root, bwfile)).astype(np.float32)
        self.tuv = np.load(os.path.join(self.data_root, "bigpose_uv.npy")).astype(np.float32)
        self.tbounds = get_bounds(self.tpose, cfg.box_padding)

        # static per-part canonical bounds (+ overlap)
        self.part_bounds = np.zeros((NUM_PARTS, 2, 3), np.float32)
        for p in range(NUM_PARTS):
            sel = self.tpose[parts == p]
            if len(sel) == 0:  # a part without vertices: the whole body's box
                sel = self.tpose
            self.part_bounds[p, 0] = sel.min(0) - cfg.bbox_overlap
            self.part_bounds[p, 1] = sel.max(0) + cfg.bbox_overlap

        # the largest blend-weight volume over the frames (items pad to it)
        self.pbw_max_shape = self._scan_pbw_max()

        # MSE-guided sampling state
        self.error_map: Optional[np.ndarray] = None

        # geometry-pruned sampling state
        self._prune_cache = None        # (mtime, canonical pts, weights, res)
        self._prune_world: Dict = {}    # frame id -> warped world points
        self._smpl_cache: Dict = {}

        # decoded images, an LRU bounded in bytes: each item is revisited
        # ~ep_iter / len(ds) times an epoch and decoding and undistorting
        # dominate an item's time; producer threads share it under the lock
        self._img_cache: "OrderedDict" = OrderedDict()
        self._img_cache_bytes = 0
        self._img_lock = threading.Lock()
        self.cache_bytes = int(cfg.get("dataset_cache_bytes", 8 << 30))
        self.cache_items = int(cfg.get("dataset_cache_items", 200))

    # -- per-frame SMPL ----------------------------------------------------

    def _frame_id(self, index: int) -> int:
        base = os.path.basename(self.ims[index])
        if self.human in ("CoreView_313", "CoreView_315"):
            return int(base.split("_")[4]) - 1
        return int(os.path.splitext(base)[0])

    def _scan_pbw_max(self):
        shapes = []
        bdir = os.path.join(self.lbs_root, "bweights")
        if not os.path.isdir(bdir):
            return None
        for f in sorted(os.listdir(bdir))[:500]:
            if f.endswith(".npy"):
                arr = np.load(os.path.join(bdir, f), mmap_mode="r")
                shapes.append(arr.shape[:3])
        return tuple(np.max(np.array(shapes), axis=0)) if shapes else None

    # -- geometry-pruned sampling (cfg.prune_using_geo): the consumption side

    def _prune_points(self):
        """Occupied canonical points from ``result_dir/latest.npy`` (or an
        in-memory cube from :meth:`set_prune_geometry`): (points (M, 3),
        blend weights (M, 24), cube resolution), or None when pruning is
        off or no cube exists.  A file is re-read when its mtime changes."""
        cfg = self.cfg
        if not cfg.get("prune_using_geo", False):
            return None
        if self._prune_cache is not None and self._prune_cache[0] == -1.0:
            return self._prune_cache[1:]
        path = os.path.join(cfg.result_dir, "latest.npy")
        if not os.path.exists(path):
            return None
        mtime = os.path.getmtime(path)
        if self._prune_cache is not None and self._prune_cache[0] == mtime:
            return self._prune_cache[1:]
        self._ingest_prune_cube(np.load(path), mtime)
        return self._prune_cache[1:]

    def set_prune_geometry(self, cube: np.ndarray):
        """Install an occupancy cube in memory (outranks the file)."""
        self._ingest_prune_cube(cube, mtime=-1.0)

    def _ingest_prune_cube(self, cube: np.ndarray, mtime: float):
        """The top-10% density voxels as canonical points (at most 16,384)
        with the nearest blend weights."""
        flat = cube.reshape(-1)
        n_top = max(int((flat > -1).sum() * 0.1), 1)
        thresh = np.partition(flat, -n_top)[-n_top]
        idx = np.argwhere(cube >= thresh).astype(np.float32)
        res = np.array(cube.shape, np.float32)
        tb = self.tbounds
        pts = tb[0] + idx / np.maximum(res - 1, 1) * (tb[1] - tb[0])
        if len(pts) > 16384:
            pick = np.random.default_rng(0).choice(len(pts), 16384, replace=False)
            pts = pts[pick]
        if self.tbw.ndim == 4:        # nearest voxel of the canonical volume
            S = np.array(self.tbw.shape[:3], np.float32)
            vi = np.clip(np.round((pts - tb[0]) / (tb[1] - tb[0]) * (S - 1)),
                         0, S - 1).astype(int)
            w = self.tbw[vi[:, 0], vi[:, 1], vi[:, 2], :NUM_BONES]
        else:                         # the nearest canonical vertex's weights
            from scipy.spatial import cKDTree
            nn = cKDTree(self.tpose).query(pts)[1]
            w = self.weights[nn]
        w = w / np.maximum(w.sum(-1, keepdims=True), 1e-8)
        self._prune_cache = (mtime, pts.astype(np.float32),
                             w.astype(np.float32), int(max(cube.shape)))
        self._prune_world.clear()

    def _prune_mask(self, i: int, A, big_A, R, Th, K, Rc, Tc, H, W):
        """Pixels of frame ``i`` covered by the occupied geometry: the points
        warped canonical -> posed -> world, projected, and dilated by ~3
        voxel footprints so the splat closes into a region."""
        geo = self._prune_points()
        if geo is None:
            return None
        pts, w, cube_res = geo
        xw = self._prune_world.get(i)
        if xw is None:
            A_bw = (w @ A.reshape(NUM_BONES, 16)).reshape(-1, 4, 4)
            bigA_bw = (w @ big_A.reshape(NUM_BONES, 16)).reshape(-1, 4, 4)
            xt = np.einsum("nij,nj->ni", np.linalg.inv(bigA_bw[:, :3, :3]),
                           pts - bigA_bw[:, :3, 3])
            xp = np.einsum("nij,nj->ni", A_bw[:, :3, :3], xt) + A_bw[:, :3, 3]
            xw = (xp @ R.T + Th.reshape(1, 3)).astype(np.float32)
            if len(self._prune_world) < self.cache_items:
                self._prune_world[i] = xw
        cam = xw @ np.asarray(Rc).T + np.asarray(Tc).reshape(1, 3)
        z = cam[:, 2]
        pix = cam @ np.asarray(K).T
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.round(pix[:, 0] / pix[:, 2]).astype(np.int64)
            v = np.round(pix[:, 1] / pix[:, 2]).astype(np.int64)
        keep = (z > 1e-6) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        mask = np.zeros((H, W), np.uint8)
        mask[v[keep], u[keep]] = 1
        vox = float((self.tbounds[1] - self.tbounds[0]).max()) \
            / max(cube_res - 1, 1)
        zmed = float(np.median(z[keep])) if keep.any() else 1.0
        k = int(np.clip(3.0 * vox * float(K[0, 0]) / max(zmed, 1e-3), 3, 31))
        return image_ops.dilate(mask, k)

    def prepare_input(self, i: int):
        """Frame ``i``'s SMPL: world/pose vertices, A, big_A, the blend-weight
        volume, R and Th (cached per frame)."""
        cached = self._smpl_cache
        if i in cached:
            return cached[i]
        cfg = self.cfg
        wxyz = np.load(os.path.join(self.data_root, cfg.vertices, f"{i}.npy")).astype(np.float32)
        params = np.load(os.path.join(self.data_root, cfg.params, f"{i}.npy"),
                         allow_pickle=True).item()
        Rh = params["Rh"].astype(np.float32)
        Th = params["Th"].astype(np.float32)
        R = rodrigues_np(Rh)

        if cfg.get("mono_bullet", False):
            # monocular bullet time: spin the body by the frame index
            Rrel = rodrigues_np(np.array([0.0, float(i), 0.0], np.float32))
            wxyz = (wxyz - Th) @ Rrel.T + Th
            R = (Rrel @ R).astype(np.float32)

        pxyz = np.dot(wxyz - Th, R).astype(np.float32)

        poses = params["poses"].reshape(-1, 3)
        A = get_rigid_transformation_np(poses, self.joints, self.parents)

        big_poses = np.zeros_like(poses).ravel()
        angle = 30.0  # the legs-apart "bigpose"
        big_poses[5] = np.deg2rad(angle)
        big_poses[8] = np.deg2rad(-angle)
        big_A = get_rigid_transformation_np(big_poses.reshape(-1, 3),
                                            self.joints, self.parents)
        pbw = np.load(os.path.join(self.lbs_root, f"bweights/{i}.npy")).astype(np.float32)
        out = (wxyz, pxyz, A, big_A, pbw, R, Th)
        if len(cached) < self.cache_items:
            cached[i] = out
        return out

    def _pad_volume(self, vol: np.ndarray, max_shape):
        if max_shape is None:
            return vol, np.array(vol.shape[:3], np.int32)
        pad = [(0, m - s) for m, s in zip(max_shape, vol.shape[:3])] + [(0, 0)]
        return np.pad(vol, pad), np.array(vol.shape[:3], np.int32)

    # -- masks -------------------------------------------------------------

    def get_mask(self, index: int):
        """(mask, unmodified mask, part semantic masks) of item ``index``
        from its SCHP colour mask (or a ``mask_cihp`` label image)."""
        cfg = self.cfg
        im = self.ims[index]
        msk_path = os.path.join(self.data_root, im.replace("images", "schp"))[:-4] + ".png"
        if not os.path.exists(msk_path):
            msk_path = os.path.join(self.data_root, "mask_cihp", im)[:-4] + ".png"
            sem = image_ops.read_png(msk_path)
            if sem.ndim == 3:
                sem = sem[..., 0]
        else:
            rgb = image_ops.read_png(msk_path)[..., :3]
            # exact-colour lookup through a 24-bit table; colours off the
            # palette decode to label 0
            pal = schp_palette(cfg.get("semantic_dim", 20)).astype(np.uint32)
            lut = TPoseDataset._schp_lut
            if lut is None or lut[1] != len(pal):
                table = np.zeros(1 << 24, np.uint8)
                keys = (pal[:, 0] << 16) | (pal[:, 1] << 8) | pal[:, 2]
                table[keys] = np.arange(len(pal), dtype=np.uint8)
                lut = TPoseDataset._schp_lut = (table, len(pal))
            r = rgb.astype(np.uint32)
            sem = lut[0][(r[..., 0] << 16) | (r[..., 1] << 8) | r[..., 2]]

        sem_masks = {k: np.isin(sem, v).astype(np.uint8)
                     for k, v in _SEM_GROUPS.items()}
        msk = (sem != 0).astype(np.uint8)
        if "deepcap" in self.data_root:
            msk = (sem > 125).astype(np.uint8)
        orig_msk = msk.copy()
        if not cfg.get("eval", False) and cfg.erode_edge:
            msk = erode_edge_mask(msk, border=5)
        return msk, orig_msk, sem_masks

    # -- item --------------------------------------------------------------

    def __len__(self):
        return len(self.ims)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get_item(index)

    def _load_image(self, index: int, ratio: float):
        """(image, mask, unmodified mask, semantic masks, K, H, W) of item
        ``index`` at ``ratio``: decoded, undistorted and resized once, then
        served from the byte-bounded cache.  The arrays are the cached ones,
        read-only: the samplers copy what they change (a copy of a 1024^2
        image an item was a fifth of MonoCap's item build), and a write to
        one raises."""
        cache_key = (index, ratio)
        with self._img_lock:
            cached = self._img_cache.get(cache_key)
            if cached is not None:
                self._img_cache.move_to_end(cache_key)
        if cached is not None:
            img, msk, orig_msk, sem_masks, K, H, W = cached
            return img, msk, orig_msk, sem_masks, K.copy(), H, W

        cfg = self.cfg
        cam_ind = self.cam_inds[index]
        img = image_ops.read_image(
            os.path.join(self.data_root, self.ims[index])).astype(np.float32) / 255.0
        msk, orig_msk, sem_masks = self.get_mask(index)
        H0, W0 = img.shape[:2]
        msk = image_ops.resize_nearest(msk, W0, H0)
        orig_msk = image_ops.resize_nearest(orig_msk, W0, H0)

        K = np.array(self.cams["K"][cam_ind]).astype(np.float64)
        D = np.array(self.cams["D"][cam_ind])
        img = image_ops.undistort(img, K, D)
        msk = image_ops.undistort(msk, K, D)
        orig_msk = image_ops.undistort(orig_msk, K, D)
        sem_masks = {k: image_ops.undistort(v, K, D) for k, v in sem_masks.items()}

        H, W = int(H0 * ratio), int(W0 * ratio)
        img = image_ops.resize_area(img, W, H)
        msk = image_ops.resize_nearest(msk, W, H)
        orig_msk = image_ops.resize_nearest(orig_msk, W, H)
        sem_masks = {k: image_ops.resize_nearest(v, W, H) for k, v in sem_masks.items()}
        if cfg.mask_bkgd:
            img[msk == 0] = 0
        K = K.copy()
        K[:2] *= ratio
        for a in (img, msk, orig_msk, *sem_masks.values()):
            a.flags.writeable = False
        entry = (img, msk, orig_msk, sem_masks, K, H, W)
        nbytes = _entry_bytes(entry)
        with self._img_lock:
            if nbytes <= self.cache_bytes and cache_key not in self._img_cache:
                self._img_cache[cache_key] = entry
                self._img_cache_bytes += nbytes
                while self._img_cache_bytes > self.cache_bytes:
                    _, old = self._img_cache.popitem(last=False)
                    self._img_cache_bytes -= _entry_bytes(old)
        return img, msk, orig_msk, sem_masks, K.copy(), H, W

    def get_item(self, index: int, ratio: Optional[float] = None,
                 sample_focus: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = rng or np.random.default_rng()
        if ratio is None:
            ratio = cfg.ratio if self.split == "train" else cfg.eval_ratio
        if sample_focus is None:
            sample_focus = cfg.get("sample_focus", "")

        cam_ind = self.cam_inds[index]
        img, msk, orig_msk, sem_masks, K, H, W = self._load_image(index, ratio)
        Rc = np.array(self.cams["R"][cam_ind])
        Tc = np.array(self.cams["T"][cam_ind]) / 1000.0

        i = self._frame_id(index)
        wpts, ppts, A, big_A, pbw, R, Th = self.prepare_input(i)
        pbounds = get_bounds(ppts, cfg.box_padding)
        wbounds = get_bounds(wpts, cfg.box_padding)
        pbw_pad, pbw_sizes = self._pad_volume(pbw, self.pbw_max_shape)

        # ray sampling
        frame_index = i
        latent_index = index // self.num_cams
        patch_mode = self.split == "train" and any(
            cfg.get(f"use_{k}", False) for k in ("lpips", "ssim", "fourier", "tv_image"))
        if self.split == "train" and cfg.get("train_with_coord", False):
            coord_path = os.path.join(
                self.data_root,
                f"train_coord/frame_{frame_index:04d}_view_{cam_ind:04d}.npy")
            train_coord = np.load(coord_path, allow_pickle=True).item()
            sample = sampling.sample_coord(img, msk, train_coord, K, Rc, Tc,
                                           wbounds, self.nrays, rng)
            if cfg.erode_edge:
                orig_msk = erode_edge_mask(orig_msk, border=10)
        elif patch_mode:
            sample = sampling.sample_patch(
                img, msk, K, Rc, Tc, wbounds, cfg.patch_size,
                sem_masks.get(sample_focus) if sample_focus else None, rng)
        elif self.split == "train" and cfg.get("sample_using_mse", False) \
                and self.error_map is not None:
            emap = self.error_map[frame_index // self.f_intv,
                                  self.view.index(cam_ind)]
            sample = sampling.sample_rays_mse(
                img, msk, emap, K, Rc, Tc, wbounds, self.nrays,
                cfg.sample_mse_portion, cfg.body_sample_ratio,
                cfg.face_sample_ratio, rng,
                restrict_mask=self._prune_mask(i, A, big_A, R, Th,
                                               K, Rc, Tc, H, W))
            if cfg.erode_edge:
                orig_msk = erode_edge_mask(orig_msk, border=10)
        elif self.split == "train":
            sample = sampling.sample_rays_train(
                img, msk, K, Rc, Tc, wbounds, self.nrays,
                cfg.body_sample_ratio, cfg.face_sample_ratio, rng,
                restrict_mask=self._prune_mask(i, A, big_A, R, Th,
                                               K, Rc, Tc, H, W))
            if cfg.erode_edge:
                orig_msk = erode_edge_mask(orig_msk, border=10)
        else:
            sample = sampling.sample_rays_full(img, K, Rc, Tc, wbounds)

        occupancy = orig_msk[sample["coord"][:, 0], sample["coord"][:, 1]]

        # per-part padded KNN inputs
        M = self.max_part
        part_pts = np.zeros((NUM_PARTS, M, 3), np.float32)
        part_pbw = np.zeros((NUM_PARTS, M, NUM_BONES), np.float32)
        for p in range(NUM_PARTS):
            sel = self.parts == p
            n = int(self.part_counts[p])
            part_pts[p, :n] = ppts[sel]
            part_pbw[p, :n] = self.weights[sel]

        # novel-pose eval reuses the last trained latent code
        if cfg.get("test_novel_pose", False):
            latent_index = cfg.num_train_frame - 1
        latent_index = min(latent_index, cfg.num_train_frame - 1)

        ret = {
            "rgb": sample["rgb"], "ray_o": sample["ray_o"], "ray_d": sample["ray_d"],
            "near": sample["near"], "far": sample["far"],
            "coord": sample["coord"], "mask_at_box": sample["mask_at_box"],
            "ray_mask": sample.get("ray_mask",
                                   np.ones(len(sample["rgb"]), np.float32)),
            "occupancy": (occupancy == 1).astype(np.float32),
            "A": A, "big_A": big_A,
            "pbw": pbw_pad, "pbw_sizes": pbw_sizes,
            "pbounds": pbounds, "wbounds": wbounds, "tbounds": self.tbounds,
            "tuv": self.tuv, "tuv_sizes": np.array(self.tuv.shape[:3], np.int32),
            "tbw": self.tbw,
            "tbw_sizes": np.array(self.tbw.shape[:3], np.int32)
            if self.tbw.ndim == 4 else np.zeros(3, np.int32),
            "part_pts": part_pts, "part_pbw": part_pbw,
            "lengths2": self.part_counts.astype(np.int32),
            "part_bounds": self.part_bounds,
            "R": R, "Th": Th, "H": np.int32(H), "W": np.int32(W),
            "latent_index": np.int32(latent_index),
            "frame_dim": np.float32(latent_index / max(cfg.num_train_frame, 1)),
            "frame_index": np.int32(frame_index),
            "cam_ind": np.int32(cam_ind),
            "sem_mask": np.stack([sem_masks[k] for k in PARTNAMES]),
        }
        if "patch_hw" in sample:
            ret["patch_hw"] = sample["patch_hw"]
        return ret

    # -- MSE-guided sampling state -----------------------------------------

    def init_error_map(self, H: int, W: int):
        self.error_map = np.full(
            (self.cfg.num_train_frame, len(self.view), H, W), 1000.0, np.float32)

    def update_error_map(self, coord, err, frame_index, cam_ind):
        if self.error_map is None:
            return
        cind = self.view.index(int(cam_ind))
        self.error_map[int(frame_index) // self.f_intv, cind,
                       coord[:, 0], coord[:, 1]] = err

    def save_error_map(self, result_dir: str):
        if self.error_map is not None:
            np.save(os.path.join(result_dir, "latest_error.npy"), self.error_map)

    def load_error_map(self, result_dir: str):
        p = os.path.join(result_dir, "latest_error.npy")
        if os.path.exists(p):
            self.error_map = np.load(p)


def _entry_bytes(entry) -> int:
    img, msk, orig_msk, sem_masks, K = entry[:5]
    return (img.nbytes + msk.nbytes + orig_msk.nbytes + K.nbytes
            + sum(v.nbytes for v in sem_masks.values()))
