"""HybridNet 3D backbone (port of ``jarvis_hybridnet_tpu/models/hybridnet.py``).

KeypointDetect runs on all camera crops as one batch; its stride-2 heatmaps
are zero-padded by 1 px, reprojected into the voxel grid (``repro_mode``:
quarter_fused through K2, exact / half / half_fused through K5), divided by
255, refined by V2V (with the fused up-front conv for the modes that give
the half grid, half_fused and quarter_fused), and decoded by softplus +
soft-argmax (K3) into world mm and confidences.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import soft_argmax
from ..kernels.repro_gather import padded_width
from .efficienttrack import EfficientTrackBackbone
from .repro import REPRO_MODES, reproject_rows
from .v2v import V2VNet


class HybridNetBackbone(nn.Module):
    def __init__(self, num_joints: int, model_size: str, roi_cube_size: int,
                 grid_spacing: int, repro_mode: str = "quarter_fused"):
        super().__init__()
        if repro_mode not in REPRO_MODES:
            raise ValueError(f"unknown repro mode {repro_mode!r}; one of {REPRO_MODES}")
        self.repro_mode = repro_mode
        self.num_joints = num_joints
        self.roi_cube_size = roi_cube_size
        self.grid_spacing = grid_spacing
        self.grid_size = int(roi_cube_size / grid_spacing)
        self.effTrack = EfficientTrackBackbone(model_size, num_joints)
        self.v2vNet = V2VNet(num_joints, fused_upsample_front=repro_mode in (
            "half_fused", "quarter_fused"))

    @property
    def dtype(self) -> torch.dtype:
        return self.v2vNet.output_layer.weight.dtype

    def heatmap_rows(self, imgs: torch.Tensor) -> torch.Tensor:
        """Normalized crops (B, C, S, S, 3) -> padded KeypointDetect heatmaps
        as rows (B, C, hs*hs, J) in the compute dtype, hs = S/2 + 2: the
        J-view of a zero-filled buffer whose rows are whole 16-byte loads
        (``repro_gather.pad_rows``)."""
        B, C, S = imgs.shape[0], imgs.shape[1], imgs.shape[2]
        flat = imgs.reshape(B * C, S, S, imgs.shape[-1]).permute(0, 3, 1, 2)
        hm = self.effTrack.heatmap2(flat)  # (B*C, J, h, h), channels last
        h, J = hm.shape[-1], self.num_joints
        width = padded_width(J, hm.element_size())
        rows = torch.zeros((B, C, h + 2, h + 2, width), dtype=hm.dtype, device=hm.device)
        rows[:, :, 1:-1, 1:-1, :J] = hm.permute(0, 2, 3, 1).reshape(B, C, h, h, J)
        return rows.reshape(B, C, (h + 2) ** 2, width)[..., :J]

    def v2v_output(self, rows, center_hm, center3d, P, K, D) -> torch.Tensor:
        """Heatmap rows -> V2V output (B, g, g, g, J) in the compute dtype."""
        voxels = reproject_rows(rows, center3d, center_hm, P, K, D, self.grid_size,
                                float(self.grid_spacing), self.repro_mode)
        vol = (voxels / 255.0).to(self.dtype).permute(0, 4, 1, 2, 3)
        return self.v2vNet(vol).permute(0, 2, 3, 4, 1)

    def points(self, imgs, center_hm, center3d, P, K, D):
        """(points3D (B, J, 3) mm, confidences (B, J)); no voxel volume."""
        center3d = center3d.to(torch.int32).contiguous()
        out = self.v2v_output(self.heatmap_rows(imgs), center_hm, center3d, P, K, D)
        return soft_argmax(out.contiguous(), center3d, float(self.grid_spacing),
                           float(self.roi_cube_size))

    def forward(self, imgs, center_hm, center3d, P, K, D):
        """As the JAX module: (double-softplus volume (B, g, g, g, J),
        padded heatmaps (B, C, J, hs, hs) float32, points3D, confidences)."""
        center3d = center3d.to(torch.int32).contiguous()
        rows = self.heatmap_rows(imgs)
        out = self.v2v_output(rows, center_hm, center3d, P, K, D)
        points, conf, volume = soft_argmax(out.contiguous(), center3d,
                                           float(self.grid_spacing),
                                           float(self.roi_cube_size), return_volume=True)
        B, C, hs2, J = rows.shape
        hs = int(round(hs2 ** 0.5))
        heatmaps = rows.reshape(B, C, hs, hs, J).permute(0, 1, 4, 2, 3).float()
        return volume, heatmaps, points, conf
