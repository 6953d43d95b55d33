"""VGG-feature perceptual loss and LPIPS distance (port of
``instant_nvr_tpu/models/lpips.py``).

  - :func:`perceptual_loss`, the training patch loss: VGG19 relu1_2 +
    relu2_2 feature L1 (averaged) + image L1 + image MSE on raw [0, 1]
    images;
  - :func:`lpips_distance`, the eval metric: VGG16 features at the five
    relu stages, channel-unit-normalised, squared differences, spatial
    mean, summed over stages.

Pretrained weights cannot be had offline: weights load from an ``.npz``
(``cfg.lpips_weights``, HWIO as ``tools/export_vgg_weights.py`` writes
them, transposed to OIHW here) or are drawn by :func:`vgg_init`, which
draws with numpy exactly as the JAX package does (seed 1234 for training,
4321 for eval), so both packages use the same weights bit for bit.  The
convolutions and pools are ``torch.nn.functional`` calls in float32: the
JAX package computes them with XLA outside any Pallas kernel.  On the card
they need TF32 off (``run.resolve_device`` turns it off for cuDNN).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.constants import device_constant

# VGG16/VGG19 conv plans: (out_channels, n_convs per stage)
_VGG16_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_VGG19_PLAN = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]


def vgg_init(seed: int, plan: Sequence[Tuple[int, int]],
             n_stages: int) -> List[List[Dict]]:
    """He-init HWIO conv weights (numpy) for the first ``n_stages`` stages."""
    rng = np.random.default_rng(seed)
    params = []
    c_in = 3
    for s, (c_out, n_convs) in enumerate(plan[:n_stages]):
        stage = []
        for i in range(n_convs):
            fan_in = 3 * 3 * c_in
            w = (rng.standard_normal((3, 3, c_in, c_out)).astype(np.float32)
                 * (2.0 / fan_in) ** 0.5)
            stage.append({"w": w, "b": np.zeros((c_out,), np.float32)})
            c_in = c_out
        params.append(stage)
    return params


def vgg_load_npz(path: str, plan: Sequence[Tuple[int, int]],
                 n_stages: int) -> List[List[Dict]]:
    """HWIO conv weights from an npz with keys 'w_<s>_<i>' / 'b_<s>_<i>'."""
    z = np.load(path)
    return [[{"w": np.asarray(z[f"w_{s}_{i}"]), "b": np.asarray(z[f"b_{s}_{i}"])}
             for i in range(n_convs)]
            for s, (_, n_convs) in enumerate(plan[:n_stages])]


def to_torch(params: List[List[Dict]], device) -> List[List[Dict]]:
    """HWIO numpy weights -> OIHW float32 tensors on ``device``."""
    return [[{"w": torch.from_numpy(np.ascontiguousarray(
                  np.transpose(layer["w"], (3, 2, 0, 1)))).to(device),
              "b": torch.from_numpy(layer["b"]).to(device)}
             for layer in stage] for stage in params]


def vgg_features(params: List[List[Dict]], img: torch.Tensor) -> List[torch.Tensor]:
    """img (N, 3, H, W) -> each stage's last relu output; a 2x2 max-pool
    between stages."""
    feats = []
    x = img
    for s, stage in enumerate(params):
        for layer in stage:
            x = F.relu(F.conv2d(x, layer["w"], layer["b"], padding=1))
        feats.append(x)
        if s < len(params) - 1:
            x = F.max_pool2d(x, 2)
    return feats


def _nchw(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (1, 3, H, W)."""
    return img.permute(2, 0, 1)[None]


# --------------------------------------------------------------------------
# training patch loss (VGG19 relu1_2 + relu2_2)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _train_vgg_params(weights_path: str, device: torch.device):
    params = (vgg_load_npz(weights_path, _VGG19_PLAN, 2) if weights_path
              else vgg_init(1234, _VGG19_PLAN, 2))
    return to_torch(params, device)


def perceptual_loss(img_pred: torch.Tensor, img_gt: torch.Tensor,
                    weights_path: str = "") -> torch.Tensor:
    """(H, W, 3) x2 in [0, 1] -> scalar: feature L1 mean + image L1 + MSE."""
    params = _train_vgg_params(weights_path, img_pred.device)
    fp = vgg_features(params, _nchw(img_pred))
    fg = vgg_features(params, _nchw(img_gt))
    feat = (torch.mean(torch.abs(fp[0] - fg[0]))
            + torch.mean(torch.abs(fp[1] - fg[1]))) / 2.0
    l1 = torch.mean(torch.abs(img_pred - img_gt))
    l2 = torch.mean((img_pred - img_gt) ** 2)
    return feat + l1 + l2


# --------------------------------------------------------------------------
# eval LPIPS metric (VGG16, 5 stages, unit-normalised, lpips convention)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _eval_vgg_params(weights_path: str, device: torch.device):
    params = (vgg_load_npz(weights_path, _VGG16_PLAN, 5) if weights_path
              else vgg_init(4321, _VGG16_PLAN, 5))
    return to_torch(params, device)


@functools.lru_cache(maxsize=4)
def _eval_lin_weights(weights_path: str, device: torch.device):
    if weights_path:
        z = np.load(weights_path)
        if "lin_0" in z:
            return [torch.from_numpy(np.asarray(z[f"lin_{s}"])).to(device)
                    for s in range(5)]
    return None


_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_distance(img_pred: torch.Tensor, img_gt: torch.Tensor,
                   weights_path: str = "") -> torch.Tensor:
    """(H, W, 3) x2 in [0, 1] -> scalar LPIPS-style distance: inputs scaled
    to [-1, 1] and normalised with lpips' shift and scale; per stage the
    channel-unit-normalised features' squared difference, averaged over
    space and channels (or weighted by the npz's 'lin_<s>'), summed."""
    dev = img_pred.device
    params = _eval_vgg_params(weights_path, dev)
    lin = _eval_lin_weights(weights_path, dev)
    shift = device_constant("lpips_shift", dev, lambda: np.asarray(_SHIFT),
                            torch.float32)
    scale = device_constant("lpips_scale", dev, lambda: np.asarray(_SCALE),
                            torch.float32)
    prep = lambda im: _nchw((im * 2.0 - 1.0 - shift) / scale)
    fp = vgg_features(params, prep(img_pred))
    fg = vgg_features(params, prep(img_gt))
    total = torch.zeros((), device=dev)
    for s in range(len(fp)):
        a = fp[s] / torch.clamp(torch.linalg.norm(fp[s], dim=1, keepdim=True), min=1e-10)
        b = fg[s] / torch.clamp(torch.linalg.norm(fg[s], dim=1, keepdim=True), min=1e-10)
        d2 = (a - b) ** 2                      # (1, C, H, W)
        if lin is not None:
            total = total + torch.mean(torch.sum(d2 * lin[s][None, :, None, None], dim=1))
        else:
            total = total + torch.mean(torch.sum(d2, dim=1) / d2.shape[1])
    return total
