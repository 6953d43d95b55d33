"""SSIM: the training loss (torch) and the eval metric (numpy/scipy) (port
of ``instant_nvr_tpu/ops/ssim.py``).

  - :func:`ssim_loss`: the pytorch-ssim formulation (11x11 gaussian window,
    sigma 1.5, zero padding), differentiable;
  - :func:`ssim_skimage`: skimage ``structural_similarity`` semantics (7x7
    uniform window, sample covariance, edge crop, channel mean), a copy;
    ``data_range`` defaults to 1.0 for [0, 1] float images.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import uniform_filter


def _gaussian_window(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _filter2d(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' convolution: img (H, W, C), win (k, k) -> (H, W, C)."""
    C = img.shape[-1]
    x = img.permute(2, 0, 1)[:, None]                       # (C, 1, H, W)
    out = F.conv2d(x, win[None, None], padding=win.shape[0] // 2)
    return out[:, 0].permute(1, 2, 0).reshape(img.shape[:2] + (C,))


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images in [0, 1]."""
    win = _gaussian_window(window_size, device=img1.device)
    mu1 = _filter2d(img1, win)
    mu2 = _filter2d(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d(img1 * img1, win) - mu1_sq
    s2 = _filter2d(img2 * img2, win) - mu2_sq
    s12 = _filter2d(img1 * img2, win) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / \
               ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map)


def ssim_skimage(img1: np.ndarray, img2: np.ndarray, win_size: int = 7,
                 data_range: float = 1.0) -> float:
    """skimage.structural_similarity for (H, W[, C]) numpy images."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    if img1.ndim == 3:
        return float(np.mean([
            ssim_skimage(img1[..., c], img2[..., c], win_size, data_range)
            for c in range(img1.shape[-1])]))

    NP = win_size ** 2
    cov_norm = NP / (NP - 1)  # sample covariance, as skimage

    def f(x):
        return uniform_filter(x, size=win_size)

    ux, uy = f(img1), f(img2)
    uxx, uyy, uxy = f(img1 * img1), f(img2 * img2), f(img1 * img2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return float(S[pad:S.shape[0] - pad, pad:S.shape[1] - pad].mean())
