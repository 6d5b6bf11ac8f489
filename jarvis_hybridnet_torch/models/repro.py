"""Voxel reprojection layer (port of ``jarvis_hybridnet_tpu/models/repro.py``),
all four modes.

Every voxel of a cube around each frameset's center is projected into every
camera (k1/k2 distortion, clamped to the crop window), the padded stride-2
heatmap row at that pixel is gathered, and the cameras are averaged. The
modes differ in where the gather happens and what is interpolated:

- ``exact``: the pixel-index maps of the (G/2)^3 half grid are upsampled to
  G^3 (0.25/0.75 stencil) and every G^3 voxel gathers its own row, as the
  reference does; indices bit-identical to JAX's. Output (B, G, G, G, J).
- ``half``: gather at the half grid, then upsample the values to G^3.
- ``half_fused``: the half-grid gather alone, (B, G/2, G/2, G/2, J), for
  V2V's fused up-front conv.
- ``quarter_fused``: gather at the (G/4)^3 quarter grid and interpolate the
  values to the half grid (center-aligned), (B, G/2, G/2, G/2, J).

quarter_fused runs in K2, the other three in K5.
"""

from __future__ import annotations

import torch

from ..kernels import repro_grid_gather, repro_quarter_gather
from ..kernels.repro_gather import pad_rows

REPRO_MODES = ("exact", "half", "half_fused", "quarter_fused")


def reproject_rows(rows, center3d, center_hm, P, K, D, grid_size: int,
                   grid_spacing: float, mode: str = "quarter_fused",
                   return_indices: bool = False):
    """Reprojection of heatmap rows (B, C, hs*hs, J), padded as
    ``repro_gather.pad_rows`` makes them and gathered in their own dtype, into the ``mode``'s volume in float32: (B, G, G, G, J) for exact
    and half, (B, G/2, G/2, G/2, J) for half_fused and quarter_fused. With
    ``return_indices`` the gather indices come back too."""
    if mode not in REPRO_MODES:
        raise ValueError(f"unknown repro mode {mode!r}; one of {REPRO_MODES}")
    args = (rows, center3d.to(torch.int32).contiguous(),
            center_hm.to(torch.int32).contiguous(),
            P.float().contiguous(), K.float().contiguous(), D.float().contiguous())
    if mode == "quarter_fused":
        # (grid_size // 2, 2 * spacing) in reproject_indices: g4 points per
        # axis at 4 * spacing, centered at index g4 // 2
        return repro_quarter_gather(*args, grid_size // 4, float(grid_spacing) * 4.0,
                                    return_indices)
    return repro_grid_gather(*args, grid_size, float(grid_spacing), mode, return_indices)


def reprojection_layer(heatmaps, center3d, center_hm, camera_matrices,
                       intrinsics, distortions, grid_size: int,
                       grid_spacing: float, mode: str = "quarter_fused") -> torch.Tensor:
    """Batched voxel reprojection in the JAX layout and output shapes.

    heatmaps (B, C, J, hs, hs) padded stride-2 heatmaps, gathered in their
    own dtype; center3d (B, 3); center_hm (B, C, 2); cameras (B, C, 4, 3),
    (B, C, 3, 3), (B, C, 1, 5).
    """
    B, C, J, hs, _ = heatmaps.shape
    rows = pad_rows(heatmaps.permute(0, 1, 3, 4, 2).reshape(B, C, hs * hs, J))
    return reproject_rows(rows, center3d, center_hm, camera_matrices, intrinsics,
                          distortions, grid_size, grid_spacing, mode)
