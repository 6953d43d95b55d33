"""VGG-feature perceptual loss (port of ``instant_nvr_tpu/models/lpips.py``).

:func:`perceptual_loss`, the training patch loss: VGG19 relu1_2 + relu2_2
feature L1 (averaged) + image L1 + image MSE on raw [0, 1] images.  The
eval LPIPS distance of the program is not in this copy.

Pretrained weights cannot be had offline: weights load from an ``.npz``
(``cfg.lpips_weights``, HWIO as ``tools/export_vgg_weights.py`` writes
them, transposed to OIHW here) or are drawn by :func:`vgg_init`, which
draws with numpy exactly as the JAX package does (seed 1234 for training), so both packages use the same weights bit for bit.  The
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


# the VGG19 conv plan: (out_channels, n_convs per stage)
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



