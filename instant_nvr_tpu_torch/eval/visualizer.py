"""Novel-view ("bullet-time") rendering and video assembly (port of
``instant_nvr_tpu/eval/visualizer.py``).

An elliptical camera orbit fitted through the dataset's cameras, one
full-image render per orbit camera through :class:`AutoBudgetRenderer`,
PNG frames, and an ffmpeg merge into an mp4 where ffmpeg is on the path.
Without ffmpeg the frames go into an MPEG-4 Part 2 (mp4v) file written by
the port itself (``eval/video.py``), as the JAX version falls back to
cv2's mp4v writer.
"""
from __future__ import annotations

import os
import subprocess
from typing import Dict, List

import numpy as np

from ..datasets.image_ops import read_png, write_png
from ..datasets.tpose_dataset import TPoseDataset
from ..ops.ray import get_near_far_np, get_rays_np
from ..renderer.inb_renderer import make_render_spec
from .runner import (META_KEYS, AutoBudgetRenderer, budgets_path, eval_chunk,
                     frame_route)
from .video import write_mp4

# frames per second of the bullet-time video
FPS = 24


def normalize(v):
    return v / np.linalg.norm(v)


def look_at_pose(eye: np.ndarray, center: np.ndarray, up: np.ndarray):
    """World->camera R, T with z forward (OpenCV convention)."""
    z = normalize(center - eye)
    x = normalize(np.cross(up, z))
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    T = (-R @ eye)[:, None]
    return R, T


def gen_path_from_cams(Rs: np.ndarray, Ts: np.ndarray, center: np.ndarray,
                       n_views: int) -> List[Dict[str, np.ndarray]]:
    """Elliptical orbit fitted through the input camera poses: their mean up
    vector, per-axis radii from the 80th-percentile camera offsets (x1.3),
    the mean camera height, ``n_views`` look-at poses around ``center``.
    Rs: (V, 3, 3) world->cam; Ts: (V, 3, 1).
    """
    Rs = np.asarray(Rs, np.float64)
    Ts = np.asarray(Ts, np.float64).reshape(-1, 3, 1)
    pos = np.einsum("vji,vjk->vik", Rs, -Ts)[..., 0]      # camera centers -R^T T
    # OpenCV w2c: row 1 of R is the camera's (image-down) y axis in world
    up = normalize(-Rs[:, 1, :].sum(0))

    rel = pos - center
    h = rel @ up                                          # height above center
    planar = rel - np.outer(h, up)
    e1 = normalize(planar[0]) if np.linalg.norm(planar[0]) > 1e-8 else \
        normalize(np.cross(up, [1.0, 0.0, 0.0]))
    e2 = np.cross(up, e1)
    r1 = max(np.percentile(np.abs(planar @ e1), 80) * 1.3, 1e-3)
    r2 = max(np.percentile(np.abs(planar @ e2), 80) * 1.3, 1e-3)
    r2 = max(r2, 0.25 * r1)  # few-camera rigs: avoid a degenerate ellipse
    height = float(h.mean())

    cams = []
    for theta in np.linspace(0.0, 2 * np.pi, n_views, endpoint=False):
        eye = center + e1 * (r1 * np.cos(theta)) + e2 * (r2 * np.sin(theta)) \
            + up * height
        R, T = look_at_pose(eye, center, up)
        cams.append({"R": R, "T": T})
    return cams


def render_novel_views(cfg, mspec, model, eager: bool = False) -> List[str]:
    """Bullet-time demo on the model's device: ``render_views`` cameras on
    an orbit; the body animates across the test frames (``render_frame ==
    -1``, the default: frame ``view % frames``) or stays at frame
    ``render_frame``.  Writes ``result_dir/novel_views/frame_%04d.png`` and
    tries the mp4; returns the frame paths.  Each view renders on
    ``frame_route``'s route (``eager`` forces the eager one)."""
    ds = TPoseDataset(cfg, "test")
    n_frames = max(len(ds) // ds.num_cams, 1)
    render_frame = int(cfg.get("render_frame", -1))
    n_views = cfg.get("render_views", 50)

    items: Dict[int, Dict] = {}
    keep = set(META_KEYS) | {"wbounds", "H", "W", "cam_ind"}

    def frame_item(fi: int) -> Dict:
        if fi not in items:
            full = ds.get_item(fi * ds.num_cams)
            # the per-frame metadata only: the item's own rays are replaced
            # by the orbit cameras' (~1M rays at ZJU resolution)
            items[fi] = {k: v for k, v in full.items() if k in keep}
        return items[fi]

    item0 = frame_item(render_frame if render_frame >= 0 else 0)
    H, W = int(item0["H"]), int(item0["W"])
    K = np.array(ds.cams["K"][int(item0["cam_ind"])]).astype(np.float64).copy()
    K[:2] *= cfg.eval_ratio

    Rs = np.array(ds.cams["R"], np.float64)
    Ts = np.array(ds.cams["T"], np.float64) / 1000.0
    center = np.asarray(item0["wbounds"]).mean(0)
    cams = gen_path_from_cams(Rs, Ts, center, n_views)

    route = frame_route(next(model.parameters()).device, eager)
    renderer = AutoBudgetRenderer(mspec, make_render_spec(cfg), eval_chunk(cfg),
                                  persist_path=budgets_path(cfg),
                                  captured=route.name == "captured")
    out_dir = os.path.join(cfg.result_dir, "novel_views")
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for vi, cam in enumerate(cams):
        fi = render_frame if render_frame >= 0 else (vi % n_frames)
        item = frame_item(fi)
        wb = np.asarray(item["wbounds"])
        ro, rd = get_rays_np(H, W, K, cam["R"], cam["T"])
        ro = ro.reshape(-1, 3).astype(np.float32)
        rd = rd.reshape(-1, 3).astype(np.float32)
        near, far, hit = get_near_far_np(wb, ro, rd)
        sub = {"ray_o": ro[hit], "ray_d": rd[hit],
               "near": near.astype(np.float32), "far": far.astype(np.float32)}
        sub.update({k: item[k] for k in META_KEYS if k in item})
        out = renderer(model, sub)
        img = np.zeros((H * W, 3), np.float32)
        img[hit] = out["rgb_map"]
        img = (img.reshape(H, W, 3) * 255).clip(0, 255).astype(np.uint8)
        path = os.path.join(out_dir, f"frame_{vi:04d}.png")
        write_png(path, img)
        frames.append(path)
        print(f"novel view {vi + 1}/{n_views} (body frame {fi})")

    merge_into_video(out_dir, os.path.join(cfg.result_dir, "novel_view.mp4"))
    return frames


def merge_into_video(frame_dir: str, out_path: str, fps: int = FPS) -> bool:
    """Merge ``frame_dir/frame_%04d.png`` into ``out_path`` at ``fps``:
    ffmpeg (libx264) where it runs, else the port's mp4v writer
    (``eval/video.py``), as the JAX version falls back to cv2's.  Returns
    True when a video was written, False when there are no frames."""
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i",
             os.path.join(frame_dir, "frame_%04d.png"),
             "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path],
            check=True, capture_output=True)
        print(f"wrote {out_path}")
        return True
    except (FileNotFoundError, subprocess.CalledProcessError) as e:
        print(f"ffmpeg unavailable/failed ({e}); writing mp4v")
    names = sorted(f for f in os.listdir(frame_dir)
                   if f.startswith("frame_") and f.endswith(".png"))
    if not names:
        print(f"no frames in {frame_dir}; skipping video")
        return False
    frames = (read_png(os.path.join(frame_dir, f))[..., :3] for f in names)
    write_mp4(out_path, frames, fps)
    print(f"wrote {out_path} (mp4v)")
    return True
