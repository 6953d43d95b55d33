"""Dataset preprocessing: generate the lbs/ tree + smpl-meta from raw
captures (port of ``tools/prepare_dataset.py``, with the same command line
and outputs; ``cv2.Rodrigues`` is ``datasets/image_ops.rodrigues``, which
gives its matrices bit for bit, so nothing here needs OpenCV).  Host
numpy + scipy only: it runs no device code.

From-scratch rebuild of the reference's offline preparation
(``tools/prepare_zjumocap.py``, 573 LoC, psbody.mesh/trimesh-based) using
only numpy + scipy:

  inputs:  <data_root>/{<params>/, <vertices>/}  per-frame SMPL params/verts,
           an SMPL model pickle (basicModel_*.pkl), optionally an SMPL UV
           .obj (for bigpose_uv).
  outputs: <data_root>/<lbs>/{joints,parents,faces,bigpose_vertices,
           bigpose_bw}.npy + bweights/<i>.npy, <data_root>/bigpose_uv.npy,
           <smpl_meta>/{faces,parents,weights}.npy.

Closest-point queries use a cKDTree over face centroids + exact
point-to-triangle projection on the K nearest candidate faces (replaces
psbody ``closest_faces_and_points``).

Usage:
  python -m instant_nvr_tpu_torch.tools.prepare_dataset --data_root data/zju-mocap/my_377 \
      --smpl_pkl data/smpl-meta/SMPL_NEUTRAL.pkl \
      [--uv_obj data/smpl-meta/smpl_uv.obj] \
      [--params smpl_params --vertices smpl_vertices --lbs smpl_lbs] \
      [--frames 0:500:5] [--voxel 0.005]
"""
import argparse
import os
import pickle

import numpy as np

from ..datasets.image_ops import rodrigues


def read_smpl_pkl(path):
    with open(path, "rb") as f:
        smpl = pickle.load(f, encoding="latin1")
    out = {}
    for k in ("v_template", "shapedirs", "J_regressor", "weights",
              "kintree_table", "f", "posedirs"):
        if k in smpl:
            v = smpl[k]
            if hasattr(v, "toarray"):      # scipy sparse (J_regressor)
                v = v.toarray()
            out[k] = np.array(v)
    return out


def rigid_transform_chain(rot_mats, joints, parents):
    J = joints.shape[0]
    rel = joints.copy()
    rel[1:] -= joints[parents[1:]]
    T = np.zeros((J, 4, 4))
    T[:, :3, :3] = rot_mats
    T[:, :3, 3] = rel
    T[:, 3, 3] = 1
    chain = [T[0]]
    for i in range(1, J):
        chain.append(chain[parents[i]] @ T[i])
    A = np.stack(chain)
    jh = np.concatenate([joints, np.zeros((J, 1))], axis=1)
    A[:, :, 3] -= np.einsum("jab,jb->ja", A, jh)
    return A.astype(np.float32)


def smpl_transform_params(smpl, params):
    """A (24,4,4), R (3,3), Th, joints — reference get_transform_params."""
    v = smpl["v_template"]
    shapedirs = smpl["shapedirs"]
    if "shapes" in params:
        betas = np.asarray(params["shapes"]).ravel()[:shapedirs.shape[-1]]
        v = v + shapedirs[..., :len(betas)] @ betas
    joints = smpl["J_regressor"] @ v
    parents = smpl["kintree_table"][0].astype(np.int64)
    parents[0] = 0

    poses = np.asarray(params["poses"]).reshape(-1, 3)
    rot_mats = np.stack([rodrigues(p) for p in poses])
    A = rigid_transform_chain(rot_mats, joints, parents)
    R = rodrigues(np.asarray(params["Rh"]).ravel())
    Th = np.asarray(params["Th"]).reshape(1, 3)
    return A, R.astype(np.float32), Th.astype(np.float32), \
        joints.astype(np.float32), parents


# --------------------------------------------------------------------------
# closest point on a triangle mesh (numpy, KDTree candidates)
# --------------------------------------------------------------------------

def closest_points_on_mesh(pts, verts, faces, k_candidates=24):
    """For each query point: closest surface point, face id, barycentrics."""
    from scipy.spatial import cKDTree
    tri = verts[faces]                       # (F, 3, 3)
    centroids = tri.mean(axis=1)
    tree = cKDTree(centroids)
    _, cand = tree.query(pts, k=k_candidates)          # (N, K)

    a = tri[cand, 0]                        # (N, K, 3)
    b = tri[cand, 1]
    c = tri[cand, 2]
    p = pts[:, None, :]

    # point-to-triangle projection (Ericson, Real-Time Collision Detection)
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.einsum("nkd,nkd->nk", ab, ap)
    d2 = np.einsum("nkd,nkd->nk", ac, ap)
    bp = p - b
    d3 = np.einsum("nkd,nkd->nk", ab, bp)
    d4 = np.einsum("nkd,nkd->nk", ac, bp)
    cp = p - c
    d5 = np.einsum("nkd,nkd->nk", ab, cp)
    d6 = np.einsum("nkd,nkd->nk", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    v = np.where(np.abs(denom) > 1e-20, vb / np.where(denom == 0, 1, denom), 0)
    w = np.where(np.abs(denom) > 1e-20, vc / np.where(denom == 0, 1, denom), 0)

    # interior case
    u_int, v_int, w_int = 1 - v - w, v, w
    # vertex/edge regions (clamped barycentrics)
    bar = np.stack([u_int, v_int, w_int], axis=-1)
    # vertex A
    bar = np.where((d1 <= 0)[..., None] & (d2 <= 0)[..., None],
                   np.broadcast_to([1.0, 0, 0], bar.shape), bar)
    # vertex B
    bar = np.where((d3 >= 0)[..., None] & (d4 <= d3)[..., None],
                   np.broadcast_to([0, 1.0, 0], bar.shape), bar)
    # vertex C
    bar = np.where((d6 >= 0)[..., None] & (d5 <= d6)[..., None],
                   np.broadcast_to([0, 0, 1.0], bar.shape), bar)
    # edge AB
    t_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1, d1 - d3), 0, 1)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    bar = np.where(on_ab[..., None],
                   np.stack([1 - t_ab, t_ab, np.zeros_like(t_ab)], -1), bar)
    # edge AC
    t_ac = np.clip(d2 / np.where(d2 - d6 == 0, 1, d2 - d6), 0, 1)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    bar = np.where(on_ac[..., None],
                   np.stack([1 - t_ac, np.zeros_like(t_ac), t_ac], -1), bar)
    # edge BC
    t_bc = np.clip((d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1,
                                        (d4 - d3) + (d5 - d6)), 0, 1)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    bar = np.where(on_bc[..., None],
                   np.stack([np.zeros_like(t_bc), 1 - t_bc, t_bc], -1), bar)

    bar = np.clip(bar, 0, 1)
    bar = bar / np.maximum(bar.sum(-1, keepdims=True), 1e-12)
    proj = bar[..., 0:1] * a + bar[..., 1:2] * b + bar[..., 2:3] * c  # (N,K,3)
    d2s = np.sum((p - proj) ** 2, axis=-1)             # (N, K)
    best = np.argmin(d2s, axis=-1)
    rows = np.arange(len(pts))
    return (proj[rows, best], cand[rows, best], bar[rows, best])


def grid_points(bounds, voxel):
    lo, hi = np.asarray(bounds, np.float64)
    # deterministic voxel counts (arange float endpoints are flaky)
    ns = [int(np.round((hi[d] - lo[d]) / voxel[d])) + 1 for d in range(3)]
    axes = [lo[d] + np.arange(ns[d]) * voxel[d] for d in range(3)]
    g = np.meshgrid(*axes, indexing="ij")
    return np.stack(g, -1).astype(np.float32)


def blend_weight_volume(verts, faces, weights, voxel, padding=0.05):
    bounds = np.stack([verts.min(0) - padding, verts.max(0) + padding])
    pts = grid_points(bounds, voxel)
    sh = pts.shape
    flat = pts.reshape(-1, 3)
    out = np.empty((len(flat), 25), np.float32)
    chunk = 200000
    for i in range(0, len(flat), chunk):
        p = flat[i:i + chunk]
        proj, fid, bar = closest_points_on_mesh(p, verts, faces)
        bw = np.einsum("nv,nvk->nk", bar, weights[faces[fid]])
        out[i:i + chunk, :24] = bw
        out[i:i + chunk, 24] = np.linalg.norm(p - proj, axis=-1)
    return out.reshape(*sh[:3], 25)


def load_uv_obj(path):
    """Parse v/vt/f from an SMPL UV obj -> per-face-corner UVs."""
    vts, faces_v, faces_vt = [], [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "vt":
                vts.append([float(t[1]), float(t[2])])
            elif t[0] == "f":
                idx = [p.split("/") for p in t[1:4]]
                faces_v.append([int(p[0]) - 1 for p in idx])
                faces_vt.append([int(p[1]) - 1 for p in idx])
    return np.array(vts, np.float32), np.array(faces_v), np.array(faces_vt)


def uv_volume(verts, faces, uv_obj_path, voxel, padding=0.05):
    vts, faces_v, faces_vt = load_uv_obj(uv_obj_path)
    bounds = np.stack([verts.min(0) - padding, verts.max(0) + padding])
    pts = grid_points(bounds, voxel)
    sh = pts.shape
    flat = pts.reshape(-1, 3)
    out = np.empty((len(flat), 2), np.float32)
    chunk = 200000
    for i in range(0, len(flat), chunk):
        p = flat[i:i + chunk]
        _, fid, bar = closest_points_on_mesh(p, verts, faces_v)
        out[i:i + chunk] = np.einsum("nv,nvk->nk", bar, vts[faces_vt[fid]])
    return out.reshape(*sh[:3], 2)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.tools.prepare_dataset")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--smpl_pkl", required=True)
    ap.add_argument("--uv_obj", default="")
    ap.add_argument("--params", default="smpl_params")
    ap.add_argument("--vertices", default="smpl_vertices")
    ap.add_argument("--lbs", default="smpl_lbs")
    ap.add_argument("--smpl_meta", default="")
    ap.add_argument("--frames", default="0:100:1", help="begin:end:interval")
    ap.add_argument("--voxel", type=float, default=0.005)
    args = ap.parse_args(argv)

    smpl = read_smpl_pkl(args.smpl_pkl)
    faces = smpl["f"].astype(np.int64)
    weights = smpl["weights"].astype(np.float32)
    lbs_root = os.path.join(args.data_root, args.lbs)
    os.makedirs(os.path.join(lbs_root, "bweights"), exist_ok=True)
    meta = args.smpl_meta or os.path.join(args.data_root, "smpl-meta")
    os.makedirs(meta, exist_ok=True)
    voxel = np.array([args.voxel] * 3)

    b, e, intv = (int(x) for x in args.frames.split(":"))
    frames = list(range(b, e, intv))

    # smpl-meta + lbs static data
    np.save(os.path.join(meta, "faces.npy"), faces)
    np.save(os.path.join(meta, "weights.npy"), weights)

    for n, i in enumerate(frames):
        params = np.load(os.path.join(args.data_root, args.params, f"{i}.npy"),
                         allow_pickle=True).item()
        wverts = np.load(os.path.join(args.data_root, args.vertices, f"{i}.npy"))
        A, R, Th, joints, parents = smpl_transform_params(smpl, params)
        if n == 0:
            np.save(os.path.join(meta, "parents.npy"), parents)
            np.save(os.path.join(lbs_root, "parents.npy"), parents)
            np.save(os.path.join(lbs_root, "joints.npy"), joints)
            np.save(os.path.join(lbs_root, "faces.npy"), faces)

            # bigpose canonical vertices (reference get_bigpose_blend_weights)
            pxyz = (wverts - Th) @ R
            A_bw = (weights @ A.reshape(24, -1)).reshape(-1, 4, 4)
            tpose = np.einsum(
                "nij,nj->ni", np.linalg.inv(A_bw[:, :3, :3]),
                pxyz - A_bw[:, :3, 3])
            big_poses = np.zeros((24, 3))
            big_poses.ravel()[5] = np.deg2rad(30)
            big_poses.ravel()[8] = np.deg2rad(-30)
            big_rot = np.stack([rodrigues(p) for p in big_poses])
            big_A = rigid_transform_chain(big_rot, joints, parents)
            big_A_bw = (weights @ big_A.reshape(24, -1)).reshape(-1, 4, 4)
            bigpose = np.einsum("nij,nj->ni", big_A_bw[:, :3, :3], tpose) \
                + big_A_bw[:, :3, 3]
            np.save(os.path.join(lbs_root, "bigpose_vertices.npy"),
                    bigpose.astype(np.float32))
            print("bigpose_bw volume...")
            np.save(os.path.join(lbs_root, "bigpose_bw.npy"),
                    blend_weight_volume(bigpose.astype(np.float32), faces,
                                        weights, voxel))
            if args.uv_obj:
                print("bigpose_uv volume...")
                np.save(os.path.join(args.data_root, "bigpose_uv.npy"),
                        uv_volume(bigpose.astype(np.float32), faces,
                                  args.uv_obj, voxel))

        pxyz = ((wverts - Th) @ R).astype(np.float32)
        vol = blend_weight_volume(pxyz, faces, weights, voxel)
        np.save(os.path.join(lbs_root, "bweights", f"{i}.npy"), vol)
        print(f"frame {i} ({n + 1}/{len(frames)}): bw volume {vol.shape}")


if __name__ == "__main__":
    main()
