"""Fused 3D prediction cascade (port of
``jarvis_hybridnet_tpu/prediction/predictor3d.py::build_predict3d``).

Per batch of T framesets of C uint8 frames: resize + normalize (K4),
CenterDetect, first-index argmax, the >= 2-camera maxval > 50 gate, the
confidence-weighted DLT of the subject center, its reprojection into every
camera for the crop centers (truncated, clamped to [bbox/2, W - bbox/2]),
the bbox^2 crops normalized in float32, then HybridNet (K1 throughout the
2D and 3D nets, K2 or K5 reprojection by the configured mode, K3
soft-argmax). Everything stays on the
predictor's device; nothing synchronizes with the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import resize_normalize
from ..models.efficienttrack import EfficientTrackBackbone
from ..models.hybridnet import HybridNetBackbone
from ..ops.heatmap import argmax_2d
from ..utils.reprojection import project_points, triangulate


class Predict3D:
    """``predictor(imgs) -> (points3D (T, J, 3) mm, confidences (T, J),
    valid (T,) bool)`` for uint8 imgs (T, C, H, W, 3) on the predictor's
    device."""

    def __init__(self, cfg, center_model: EfficientTrackBackbone,
                 hybrid_model: HybridNetBackbone, camera_matrices, intrinsics,
                 distortions, device):
        self.device = torch.device(device)
        self.center_size = int(cfg.CENTERDETECT.IMAGE_SIZE)
        self.bbox = int(cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE)
        self.mean = [float(v) for v in cfg.DATASET.MEAN]
        self.std = [float(v) for v in cfg.DATASET.STD]
        self.center_model = center_model
        self.hybrid_model = hybrid_model

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self.P, self.K, self.D = dev(camera_matrices), dev(intrinsics), dev(distortions)
        self.mean_t, self.std_t = dev(self.mean), dev(self.std)

    @property
    def dtype(self) -> torch.dtype:
        return self.hybrid_model.dtype

    @torch.no_grad()
    def detect(self, imgs: torch.Tensor):
        """Resize + normalize (K4), CenterDetect and argmax: the detected
        centers (T, C, 2) in CenterDetect heatmap pixels, float32, and
        their heatmap maxima (T, C)."""
        T, C, H, W = imgs.shape[:4]
        cs = self.center_size
        inp = resize_normalize(imgs.reshape(T * C, H, W, 3), cs, cs, self.mean,
                               self.std, self.dtype)
        hm = self.center_model.heatmap2(inp.permute(0, 3, 1, 2)).float()
        xy, maxval = argmax_2d(hm.permute(0, 2, 3, 1))  # (T*C, 1, 2), (T*C, 1)
        return xy[:, 0].reshape(T, C, 2).float(), maxval[:, 0].reshape(T, C)

    @torch.no_grad()
    def place(self, preds: torch.Tensor, maxvals: torch.Tensor, height: int,
              width: int):
        """Gate -> weighted DLT -> crop centers for frames of height x width.

        Returns (center_hm (T, C, 2) int32 crop centers in full-res pixels,
        center3d (T, 3) mm, float32, zero where invalid, valid (T,))."""
        cs, hw = self.center_size, self.bbox // 2
        valid = (maxvals > 50.0).sum(dim=1) >= 2
        # heatmap (stride 2) -> full-res pixels, per axis (Python scalars: no
        # host-to-device copy)
        full = torch.stack([preds[..., 0] * (width / float(cs) * 2.0),
                            preds[..., 1] * (height / float(cs) * 2.0)], dim=-1)
        center3d = triangulate(full, maxvals / 255.0, self.P, self.K, self.D)
        center3d = torch.where(valid[:, None], center3d, torch.zeros_like(center3d))

        centers = project_points(center3d, self.P, self.K, self.D).to(torch.int32)
        cx = centers[..., 0].clamp(hw, width - hw)
        cy = centers[..., 1].clamp(hw, height - hw)
        return torch.stack([cx, cy], dim=-1), center3d, valid

    def centers(self, imgs: torch.Tensor):
        """:meth:`detect` then :meth:`place`."""
        return self.place(*self.detect(imgs), imgs.shape[2], imgs.shape[3])

    def crops(self, imgs: torch.Tensor, center_hm: torch.Tensor) -> torch.Tensor:
        """The bbox^2 windows at the crop centers, normalized in float32:
        (T, C, bbox, bbox, 3)."""
        T, C = imgs.shape[:2]
        bbox, hw = self.bbox, self.bbox // 2
        r = torch.arange(bbox, device=imgs.device)
        rows = (center_hm[..., 1, None] - hw + r)[..., :, None]  # (T, C, bbox, 1)
        cols = (center_hm[..., 0, None] - hw + r)[..., None, :]  # (T, C, 1, bbox)
        t = torch.arange(T, device=imgs.device)[:, None, None, None]
        c = torch.arange(C, device=imgs.device)[None, :, None, None]
        crops = imgs[t, c, rows, cols]  # (T, C, bbox, bbox, 3)
        return (crops.float() / 255.0 - self.mean_t) / self.std_t

    @torch.no_grad()
    def __call__(self, imgs):
        imgs = torch.as_tensor(imgs, device=self.device)
        if imgs.dtype != torch.uint8 or imgs.dim() != 5 or imgs.shape[-1] != 3:
            raise ValueError("expected uint8 frames (T, C, H, W, 3), got "
                             f"{imgs.dtype} {tuple(imgs.shape)}")
        center_hm, center3d, valid = self.centers(imgs)
        T = imgs.shape[0]

        def per_frameset(a):
            return a.expand(T, *a.shape)

        points, conf = self.hybrid_model.points(
            self.crops(imgs, center_hm), center_hm, center3d.to(torch.int32),
            per_frameset(self.P), per_frameset(self.K), per_frameset(self.D))
        return points, conf, valid
