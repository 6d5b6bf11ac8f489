"""Voxel reprojection layer (port of ``jarvis_hybridnet_tpu/models/repro.py``),
quarter_fused mode only.

The voxel cube around each frameset's center is sampled on the (G/4)^3
quarter grid: every quarter voxel is projected into every camera (k1/k2
distortion, clamped to the crop window), the padded stride-2 heatmap row
at that pixel is gathered, the cameras are averaged, and the values are
interpolated to the (G/2)^3 half grid that V2V's fused front conv consumes.
All of it runs in K2. The exact, half and half_fused modes are not ported.
"""

from __future__ import annotations

import torch

from ..kernels import repro_quarter_gather


def reproject_rows(rows, center3d, center_hm, P, K, D, grid_size: int,
                   grid_spacing: float, return_indices: bool = False):
    """quarter_fused reprojection of heatmap rows (B, C, hs*hs, J) into the
    half-grid volume (B, G/2, G/2, G/2, J) float32."""
    # (grid_size // 2, 2 * spacing) in reproject_indices: g4 points per axis
    # at 4 * spacing, centered at index g4 // 2
    return repro_quarter_gather(
        rows, center3d.to(torch.int32).contiguous(),
        center_hm.to(torch.int32).contiguous(),
        P.float().contiguous(), K.float().contiguous(), D.float().contiguous(),
        grid_size // 4, float(grid_spacing) * 4.0, return_indices)


def reprojection_layer(heatmaps, center3d, center_hm, camera_matrices,
                       intrinsics, distortions, grid_size: int,
                       grid_spacing: float, mode: str = "quarter_fused") -> torch.Tensor:
    """Batched voxel reprojection in the JAX layout, (B, G/2, G/2, G/2, J)
    float32.

    heatmaps (B, C, J, hs, hs) padded stride-2 heatmaps, gathered in their
    own dtype; center3d (B, 3); center_hm (B, C, 2); cameras (B, C, 4, 3),
    (B, C, 3, 3), (B, C, 1, 5).
    """
    if mode != "quarter_fused":
        raise NotImplementedError(
            f"repro mode {mode!r} is not ported; only 'quarter_fused' is")
    B, C, J, hs, _ = heatmaps.shape
    rows = heatmaps.permute(0, 1, 3, 4, 2).reshape(B, C, hs * hs, J).contiguous()
    return reproject_rows(rows, center3d, center_hm, camera_matrices, intrinsics,
                          distortions, grid_size, grid_spacing)
