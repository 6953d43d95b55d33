"""PSNR / SSIM / LPIPS on reassembled full images (port of
``instant_nvr_tpu/eval/evaluator.py``).

Per view the rendered rays are scattered back into an (H, W) canvas via
``mask_at_box``, optionally restricted to a semantic part
(``cfg.eval_part``); the prediction, ground truth and error images are
written as PNGs and the metrics accumulated.  ``summarize`` writes
``metrics.npy`` (``metrics_epoch{n}.npy`` during training) with the JAX
package's dict layout ({'mse', 'psnr', 'ssim', 'lpips'}).

LPIPS is :func:`~instant_nvr_tpu_torch.models.lpips.lpips_distance` on the
evaluator's device, on :func:`lpips_route`'s route: on the card a CUDA
graph per image size (:class:`CapturedLpips`, the JAX package's
``_lpips_jit``); SSIM is the numpy/scipy ``ssim_skimage`` on the host, as
in JAX.  The PNGs are
written by ``datasets/image_ops.write_png`` in RGB order: the pixels cv2
writes from the JAX package's BGR-flipped arrays.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..datasets.image_ops import write_png
from ..models.lpips import lpips_distance
from ..ops.ssim import ssim_skimage
from ..train import compiled


def psnr_metric(img_pred: np.ndarray, img_gt: np.ndarray) -> float:
    mse = np.mean((img_pred - img_gt) ** 2)
    return float(-10.0 * np.log(mse) / np.log(10.0))


def fill_image(rgb: np.ndarray, mask_at_box: np.ndarray, H: int, W: int) -> np.ndarray:
    img = np.zeros((H, W, 3), rgb.dtype)
    img[mask_at_box.reshape(H, W)] = rgb
    return img


def bounding_rect(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(x, y, w, h) of the nonzero pixels of a 2-D mask, as
    ``cv2.boundingRect``; (0, 0, 0, 0) for an empty mask."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, 0, 0
    x, y = int(xs.min()), int(ys.min())
    return x, y, int(xs.max()) - x + 1, int(ys.max()) - y + 1


def lpips_route(device, eager: bool = False) -> compiled.Route:
    """The eval LPIPS's route: ``captured`` (:class:`CapturedLpips`) on a
    CUDA device unless ``eager``; ``eager`` with its reason otherwise."""
    return compiled.program_route(device, eager)


class CapturedLpips(compiled.CapturedProgram):
    """:func:`lpips_distance` as CUDA graphs, one per static key (the image
    size, the weights file, the device), the two images its static inputs;
    the JAX package's ``_lpips_jit`` compiles once per image size as well.
    A call copies the two host images into the inputs; the first call of a
    key runs eagerly on the side stream (the warm-up: the VGG weights and
    constants, cuDNN's handles and workspace), the second captures, and
    each call replays (:class:`~..train.compiled.CapturedProgram`).  Returns
    the graph's 0-d output: read it before the next call.  Refuses a
    device other than CUDA."""

    name = "lpips"

    def __call__(self, img_pred: torch.Tensor, img_gt: torch.Tensor,
                 weights_path: str, device) -> torch.Tensor:
        device = torch.device(device)
        if device.type != "cuda":
            raise RuntimeError(f"a captured LPIPS runs on a CUDA device, not {device}; "
                               f"eager=True runs it on the CPU")
        if device.index is None:        # one key for "cuda" and "cuda:<current>"
            device = torch.device("cuda", torch.cuda.current_device())

        def fn(st):
            with torch.no_grad():
                return {"lpips": lpips_distance(st["images"]["pred"], st["images"]["gt"],
                                                weights_path)}
        return self.run((tuple(img_pred.shape), weights_path, device),
                        {"images": {"pred": img_pred, "gt": img_gt}}, device, fn)["lpips"]


# the eval LPIPS graphs of this process: one per image size, as the JAX
# package keeps its jitted programs
LPIPS = CapturedLpips()


class Evaluator:
    def __init__(self, result_dir: str = "", lpips_weights: str = "",
                 save_images: bool = True, eval_part: str = "",
                 partnames=None, test_full: bool = True,
                 device: torch.device = torch.device("cpu"),
                 captured: bool = False):
        self.result_dir = result_dir
        self.lpips_weights = lpips_weights
        self.save_images = save_images and bool(result_dir)
        self.eval_part = eval_part
        self.partnames = partnames or []
        self.test_full = test_full
        self.device = device
        self.captured = captured        # LPIPS through CapturedLpips (LPIPS)
        self.mse, self.psnr, self.ssim, self.lpips = [], [], [], []

    def _lpips(self, img_pred: np.ndarray, img_gt: np.ndarray) -> float:
        """LPIPS of two host images: one read of the scalar on the host."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        if self.captured:
            return float(LPIPS(t(img_pred), t(img_gt), self.lpips_weights, self.device))
        with torch.no_grad():
            return float(lpips_distance(t(img_pred).to(self.device),
                                        t(img_gt).to(self.device), self.lpips_weights))

    def evaluate(self, rgb_pred: np.ndarray, rgb_gt: np.ndarray,
                 mask_at_box: np.ndarray, H: int, W: int,
                 frame_index: int = 0, view_index: int = 0,
                 sem_mask: Optional[np.ndarray] = None, epoch: int = -1):
        if not self.test_full:
            # masked pixels only: PSNR on the rays, SSIM on the bounding box
            # of the reassembled image, LPIPS on the full canvas
            if rgb_gt.sum() == 0:
                return
            self.mse.append(float(np.mean((rgb_pred - rgb_gt) ** 2)))
            self.psnr.append(psnr_metric(rgb_pred, rgb_gt))
            ip = fill_image(rgb_pred, mask_at_box, H, W)
            ig = fill_image(rgb_gt, mask_at_box, H, W)
            x, y, w, h = bounding_rect(mask_at_box.reshape(H, W))
            self.ssim.append(ssim_skimage(ip[y:y + h, x:x + w],
                                          ig[y:y + h, x:x + w]))
            self.lpips.append(self._lpips(ip, ig))
            return

        img_pred = fill_image(rgb_pred, mask_at_box, H, W)
        img_gt = fill_image(rgb_gt, mask_at_box, H, W)

        if self.eval_part and sem_mask is not None:
            pm = sem_mask[self.partnames.index(self.eval_part)].astype(bool)
            img_pred[~pm] = 0
            img_gt[~pm] = 0

        if self.save_images:
            sub = "comparison" if epoch == -1 else f"comparison_epoch{epoch}"
            d = os.path.join(self.result_dir, sub)
            os.makedirs(d, exist_ok=True)
            name = f"{d}/frame{frame_index:04d}_view{view_index:04d}"
            write_png(f"{name}.png", (img_pred * 255).clip(0, 255).astype(np.uint8))
            write_png(f"{name}_gt.png", (img_gt * 255).clip(0, 255).astype(np.uint8))
            err = np.abs(img_pred - img_gt).sum(-1)
            write_png(f"{name}_error.png",
                      (err / max(err.max(), 1e-8) * 255).astype(np.uint8))

        self.mse.append(float(np.mean((img_pred - img_gt) ** 2)))
        self.psnr.append(psnr_metric(img_pred.reshape(-1, 3), img_gt.reshape(-1, 3)))
        self.ssim.append(ssim_skimage(img_pred, img_gt))
        self.lpips.append(self._lpips(img_pred, img_gt))

    def summarize(self, epoch: int = -1) -> Dict[str, float]:
        if self.result_dir:
            name = "metrics.npy" if epoch == -1 else f"metrics_epoch{epoch}.npy"
            os.makedirs(self.result_dir, exist_ok=True)
            np.save(os.path.join(self.result_dir, name),
                    {"mse": self.mse, "psnr": self.psnr,
                     "ssim": self.ssim, "lpips": self.lpips})
        ret = {"mse": float(np.mean(self.mse)) if self.mse else float("nan"),
               "psnr": float(np.mean(self.psnr)) if self.psnr else float("nan"),
               "ssim": float(np.mean(self.ssim)) if self.ssim else float("nan"),
               "lpips": float(np.mean(self.lpips)) if self.lpips else float("nan")}
        print(" ".join(f"{k}: {v:.4f}" for k, v in ret.items()))
        self.mse, self.psnr, self.ssim, self.lpips = [], [], [], []
        return ret
