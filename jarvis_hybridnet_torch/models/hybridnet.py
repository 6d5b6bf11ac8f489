"""HybridNet 3D backbone (port of ``jarvis_hybridnet_tpu/models/hybridnet.py``).

KeypointDetect runs on all camera crops as one batch; its stride-2 heatmaps
are zero-padded by 1 px, reprojected into the voxel grid (``repro_mode``:
quarter_fused through K2, exact / half / half_fused through K5), divided by
255, refined by V2V (with the fused up-front conv for the modes that give
the half grid, half_fused and quarter_fused), and decoded by softplus +
soft-argmax (K3) into world mm and confidences.

:meth:`HybridNetBackbone.train_outputs` is the training forward of every
freeze mode. In ``3D_only`` the frozen 2D net and the gather run without a
graph, V2V with one; in ``all``, ``bifpn`` and ``last_layers`` the 2D net
and the gather run with one too, and the gradient reaches KeypointDetect
through the gather's backward (K11 for quarter_fused, K12 for the other
modes). The loss (K7, ``kernels/hybridnet_loss``) takes V2V's output.

Under camera sharding (:meth:`HybridNetBackbone.set_mesh`) the module runs
on this rank's cameras: the gather divides by the rig's camera count and
the camera group sums the partial volumes before V2V, which runs on every
camera rank; the dropout and drop-connect sites keep their part of the
global batch's draws (``layers.DrawShard``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import soft_argmax
from ..kernels.hybridnet_loss import hybridnet_mse_loss  # noqa: F401  (the JAX module's name)
from ..kernels.repro_gather import padded_width
from .efficienttrack import EfficientTrackBackbone
from ..parallel.collectives import camera_sum
from .layers import DrawShard, compute_dtype, set_draw_shard
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
        self.mesh = None  # set_mesh
        self.c_total = None

    def set_mesh(self, mesh, num_cameras: int) -> "HybridNetBackbone":
        """Run on ``mesh``'s part of each batch: this rank's samples and,
        with more than one camera rank, its cameras of the ``num_cameras``
        of the rig (module docstring). None: one process, the whole batch."""
        if mesh is None:
            self.mesh = self.c_total = None
            set_draw_shard(self, None)
            return self
        cams = mesh.cameras(num_cameras)
        self.mesh, self.c_total = mesh, int(num_cameras)
        set_draw_shard(self.effTrack, DrawShard(mesh.n_data, mesh.data_index, mesh.n_cameras,
                                                mesh.camera_index, cams.stop - cams.start))
        set_draw_shard(self.v2vNet, DrawShard(mesh.n_data, mesh.data_index))
        return self

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the parameters may be float32 masters)."""
        return compute_dtype(self.v2vNet.output_layer)

    def heatmap_rows(self, imgs: torch.Tensor) -> torch.Tensor:
        """Normalized crops (B, C, S, S, 3) -> padded KeypointDetect heatmaps
        as rows (B, C, hs*hs, J) in the compute dtype, hs = S/2 + 2: the
        J-view of a zero-filled buffer whose rows are whole 16-byte loads
        (``repro_gather.pad_rows``). JAX's exact mode gathers the float32
        cast of its bf16 heatmaps (``gather_dtype`` None): the same values,
        and its VJP sums in float32 and rounds once to bf16 at the cast's
        transpose, as K12 does at bf16 rows (``repro_gather.round_rows``)."""
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
                                float(self.grid_spacing), self.repro_mode, c_total=self.c_total)
        voxels = camera_sum(voxels, self.mesh)
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

    def train_outputs(self, imgs, center_hm, center3d, P, K, D):
        """Training forward: (V2V output (B, g, g, g, J) float32, with its
        graph when grad is enabled; points3D (B, J, 3) mm by K3 from its
        detached copy, for the mm-accuracy). The 2D net runs in the module's
        mode (drop-connect in ``train()``, as JAX's ``deterministic=False``);
        with a graph only when grad is enabled and one of its parameters
        requires grad (the modes other than 3D_only), and the gather then
        saves its indices for its backward."""
        center3d = center3d.to(torch.int32).contiguous()
        with torch.set_grad_enabled(torch.is_grad_enabled() and any(
                p.requires_grad for p in self.effTrack.parameters())):
            rows = self.heatmap_rows(imgs)
        out = self.v2v_output(rows, center_hm, center3d, P, K, D).float().contiguous()
        points, _ = soft_argmax(out.detach(), center3d, float(self.grid_spacing),
                                float(self.roi_cube_size))
        return out, points
