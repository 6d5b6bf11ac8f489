"""Fused 2D prediction cascade (port of
``jarvis_hybridnet_tpu/prediction/predictor2d.py::build_predict2d``).

Per batch of T frames of one camera, uint8 or float32 RGB in [0, 1]:
resize + normalize (K4), CenterDetect, first-index argmax, the maxval > 40
gate (the 3D cascade's gate is >= 2 cameras above 50; the two are kept
apart), the crop center in full-resolution pixels by truncation, clamped to
[bbox/2, W - bbox/2 - 1] (one less than the 3D clamp), the bbox^2 crop
normalized in float32 and cast to the inference dtype, KeypointDetect (K1 in
both EfficientTracks), its argmax, and the decode
``points = 2 * xy + crop corner``, ``confidences = min(max, 255) / 255``.
Everything stays on the predictor's device; nothing synchronizes with the
host.
"""

from __future__ import annotations

import torch

from ..kernels import resize_normalize
from ..kernels.resize_normalize import value_scale
from ..models.efficienttrack import EfficientTrackBackbone
from ..ops.heatmap import argmax_2d
from .predictor3d import FRAME_DTYPES


class Predict2D:
    """``predictor(imgs) -> (points2D (T, J, 2) full-resolution pixels,
    confidences (T, J), valid (T,) bool)`` for imgs (T, H, W, 3), uint8 or
    float32 RGB in [0, 1], on the predictor's device."""

    def __init__(self, cfg, center_model: EfficientTrackBackbone,
                 keypoint_model: EfficientTrackBackbone, device):
        self.device = torch.device(device)
        self.center_size = int(cfg.CENTERDETECT.IMAGE_SIZE)
        self.bbox = int(cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE)
        self.mean = [float(v) for v in cfg.DATASET.MEAN]
        self.std = [float(v) for v in cfg.DATASET.STD]
        self.center_model = center_model
        self.keypoint_model = keypoint_model
        self.mean_t = torch.tensor(self.mean, dtype=torch.float32, device=self.device)
        self.std_t = torch.tensor(self.std, dtype=torch.float32, device=self.device)

    @property
    def dtype(self) -> torch.dtype:
        return self.keypoint_model.deconv1.weight.dtype

    @torch.no_grad()
    def detect(self, imgs: torch.Tensor):
        """K4, CenterDetect, argmax and gate: (cx, cy (T,) int32 crop centers
        in full-resolution pixels, valid (T,), the CenterDetect heatmap
        (T, 1, h, w) float32)."""
        T, H, W = imgs.shape[:3]
        cs, hw = self.center_size, self.bbox // 2
        inp = resize_normalize(imgs, cs, cs, self.mean, self.std, self.dtype)
        hm = self.center_model.heatmap2(inp.permute(0, 3, 1, 2)).float()
        xy, maxval = argmax_2d(hm.permute(0, 2, 3, 1))  # (T, 1, 2), (T, 1)
        valid = maxval[:, 0] > 40.0
        # stride-2 heatmap -> full-res pixels in float32, truncated
        # (predictor2d.py:101-102)
        cx = (xy[:, 0, 0].float() * (W / float(cs)) * 2.0).to(torch.int32)
        cy = (xy[:, 0, 1].float() * (H / float(cs)) * 2.0).to(torch.int32)
        return cx.clamp(hw, W - hw - 1), cy.clamp(hw, H - hw - 1), valid, hm

    @torch.no_grad()
    def keypoints(self, imgs: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor):
        """bbox^2 crops at (cx, cy), KeypointDetect and the decode:
        (points2D, confidences, the KeypointDetect heatmaps (T, J, h, w)
        float32)."""
        T = imgs.shape[0]
        bbox, hw = self.bbox, self.bbox // 2
        r = torch.arange(bbox, device=imgs.device)
        rows = (cy[:, None] - hw + r)[:, :, None]  # (T, bbox, 1)
        cols = (cx[:, None] - hw + r)[:, None, :]  # (T, 1, bbox)
        t = torch.arange(T, device=imgs.device)[:, None, None]
        crops = imgs[t, rows, cols]  # (T, bbox, bbox, 3)
        crops = ((crops.float() / value_scale(imgs) - self.mean_t) / self.std_t).to(self.dtype)
        khm = self.keypoint_model.heatmap2(crops.permute(0, 3, 1, 2)).float()
        kxy, kmax = argmax_2d(khm.permute(0, 2, 3, 1))  # (T, J, 2), (T, J)
        offset = torch.stack([cx - hw, cy - hw], dim=-1)
        points = kxy.float() * 2.0 + offset[:, None, :]
        return points, kmax.clamp(max=255.0) / 255.0, khm

    @torch.no_grad()
    def __call__(self, imgs):
        imgs = torch.as_tensor(imgs, device=self.device)
        if imgs.dtype not in FRAME_DTYPES or imgs.dim() != 4 or imgs.shape[-1] != 3:
            raise ValueError("expected uint8 or float32 frames (T, H, W, 3), got "
                             f"{imgs.dtype} {tuple(imgs.shape)}")
        cx, cy, valid, _ = self.detect(imgs)
        points, conf, _ = self.keypoints(imgs, cx, cy)
        return points, conf, valid
