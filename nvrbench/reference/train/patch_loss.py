"""The patch-mode image loss of the frozen reference: the LPIPS branch of
the port's ``train/loop.py:make_patch_loss_fn``, the one the benchmark's
configurations train with (``use_lpips``)."""
from __future__ import annotations

from ..models.lpips import perceptual_loss


def make_patch_loss_fn(cfg):
    """``fn(ret, batch)``: the VGG perceptual loss on the ``patch_size``
    square, masked by ``ray_mask``."""
    size = cfg.patch_size
    weights_path = cfg.get("lpips_weights", "")

    def fn(ret, batch):
        mask = batch["ray_mask"][:, None]
        img_pred = (ret["rgb_map"] * mask).reshape(size, size, 3)
        img_gt = (batch["rgb"] * mask).reshape(size, size, 3)
        return perceptual_loss(img_pred, img_gt, weights_path)

    return fn
