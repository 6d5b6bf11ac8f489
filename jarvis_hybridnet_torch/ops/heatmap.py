"""Heatmap decoding and 3D training targets (port of
``jarvis_hybridnet_tpu/ops/heatmap.py``)."""

from __future__ import annotations

import numpy as np
import torch

SIGMA_EXP_3D = 1.7  # the 3D target's exponent (heatmap.py:127)


def argmax_2d(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel spatial argmax of (..., H, W, C) NHWC heatmaps.

    Returns (xy (..., C, 2) int32, maxvals (..., C)): the first maximal
    index m in row-major order, x = m % W, y = m // W.
    """
    h, w, c = heatmaps.shape[-3:]
    flat = torch.movedim(heatmaps, -1, -3).reshape(*heatmaps.shape[:-3], c, h * w)
    maxvals, m = flat.max(dim=-1)
    xy = torch.stack([m % w, torch.div(m, w, rounding_mode="floor")], dim=-1)
    return xy.to(torch.int32), maxvals


def gaussian_heatmaps_3d_on_device(kps_vox: torch.Tensor, kps_world: torch.Tensor,
                                   size: int) -> torch.Tensor:
    """3D Gaussian targets (B, size, size, size, J) float32: 255 * exp(-0.5 *
    d^2), d = (kps_vox - r) / 1.7 per axis, summed (x + y) + z as the JAX
    package sums them; zero for a joint whose ``kps_world`` row is all zero
    (unlabeled). The training step builds it inside K7 instead
    (``kernels/hybridnet_loss.py``); this is K7's plain version's target."""
    r = torch.arange(size, dtype=torch.float32, device=kps_vox.device)
    d = (kps_vox.float()[..., None] - r) / SIGMA_EXP_3D  # (B, J, 3, S)
    d2 = ((d[..., 0, :] ** 2)[..., :, None, None] + (d[..., 1, :] ** 2)[..., None, :, None]
          + (d[..., 2, :] ** 2)[..., None, None, :])
    g = 255.0 * torch.exp(-0.5 * d2)
    labeled = (kps_world != 0).any(dim=-1)
    g = torch.where(labeled[..., None, None, None], g, torch.zeros_like(g))
    return torch.movedim(g, 1, -1)


def gaussian_heatmaps_3d(keypoints_vox: np.ndarray, keypoints_world: np.ndarray,
                         size: int) -> np.ndarray:
    """3D Gaussian GT volumes (J, size, size, size) float32 on the host, as
    the JAX package's ``gaussian_heatmaps_3d`` (the reference's
    Dataset3D.__getitem__, jarvis/dataset/dataset3D.py:233-248): peak 255,
    sigma-exponent 1.7, joints with all-zero world coordinates left empty."""
    r = np.arange(size)
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    J = keypoints_vox.shape[0]
    out = np.zeros((J, size, size, size), dtype=np.float32)
    for i in range(J):
        if not np.any(keypoints_world[i] != 0):
            continue
        kx, ky, kz = keypoints_vox[i]
        out[i] = 255.0 * np.exp(
            -0.5 * (((kx - xx) / SIGMA_EXP_3D) ** 2
                    + ((ky - yy) / SIGMA_EXP_3D) ** 2
                    + ((kz - zz) / SIGMA_EXP_3D) ** 2)
        )
    return out
