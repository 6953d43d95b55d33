"""Blend-skinning space transforms (port of ``instant_nvr_tpu/ops/lbs.py``).

The JAX version runs every matmul at ``Precision.HIGHEST``.  Here a float32
``torch.matmul`` is full float32 as long as TF32 is off
(``torch.backends.cuda.matmul.allow_tf32``, False by default); entry points
that run on the card set it False explicitly.
"""
from __future__ import annotations

import torch

from .math import inverse_3x3

NUM_BONES = 24

# 5-part scheme (reference blend_utils.py:9-38): SMPL joint -> part id
PARTNAMES = ["body", "leg", "head", "larm", "rarm"]
NUM_PARTS = len(PARTNAMES)
PART_BW_MAP = {
    "body": [14, 13, 9, 6, 3, 0],
    "leg": [1, 2, 4, 5, 7, 8, 10, 11],
    "head": [12, 15],
    "larm": [16, 18, 20, 22],
    "rarm": [17, 19, 21, 23],
}


def world_points_to_pose_points(wpts: torch.Tensor, Rh: torch.Tensor,
                                Th: torch.Tensor) -> torch.Tensor:
    """``(wpts - Th) @ Rh``."""
    return torch.matmul(wpts - Th, Rh)


def world_dirs_to_pose_dirs(wdirs: torch.Tensor, Rh: torch.Tensor) -> torch.Tensor:
    return torch.matmul(wdirs, Rh)


def pose_points_to_world_points(ppts: torch.Tensor, Rh: torch.Tensor,
                                Th: torch.Tensor) -> torch.Tensor:
    return torch.matmul(ppts, Rh.transpose(-1, -2)) + Th


def blend_transforms(bw: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """bw (B, N, 24), A (B, 24, 4, 4) -> blended transforms (B, N, 4, 4)."""
    B, K = A.shape[0], A.shape[1]
    A_bw = torch.matmul(bw, A.reshape(B, K, 16))     # (B, N, 16)
    return A_bw.reshape(B, -1, 4, 4)


def inverse_blend_params(bw: torch.Tensor, A: torch.Tensor):
    """(A_bw, R_inv) for the pose->tpose inverse LBS."""
    A_bw = blend_transforms(bw, A)
    R_inv = inverse_3x3(A_bw[..., :3, :3])
    return A_bw, R_inv


def pose_points_to_tpose_points(ppts: torch.Tensor, A_bw: torch.Tensor,
                                R_inv: torch.Tensor) -> torch.Tensor:
    """Inverse-LBS points: R_inv @ (p - t)."""
    pts = ppts - A_bw[..., :3, 3]
    return torch.sum(R_inv * pts[..., None, :], dim=-1)


def pose_dirs_to_tpose_dirs(pdirs: torch.Tensor, R_inv: torch.Tensor) -> torch.Tensor:
    return torch.sum(R_inv * pdirs[..., None, :], dim=-1)


def tpose_points_to_pose_points(pts: torch.Tensor, A_bw: torch.Tensor) -> torch.Tensor:
    """Forward-LBS points: R @ p + t."""
    R = A_bw[..., :3, :3]
    out = torch.sum(R * pts[..., None, :], dim=-1)
    return out + A_bw[..., :3, 3]


def tpose_dirs_to_pose_dirs(ddirs: torch.Tensor, A_bw: torch.Tensor) -> torch.Tensor:
    R = A_bw[..., :3, :3]
    return torch.sum(R * ddirs[..., None, :], dim=-1)
