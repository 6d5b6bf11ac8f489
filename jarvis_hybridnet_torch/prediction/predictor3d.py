"""Fused and two-phase 3D prediction cascades (port of
``jarvis_hybridnet_tpu/prediction/predictor3d.py``: ``build_predict3d`` and
``build_predict3d_twophase``).

Per batch of T framesets of C uint8 or float32 [0, 1] frames: resize +
normalize (K4),
CenterDetect, first-index argmax, the >= 2-camera maxval > 50 gate, the
confidence-weighted DLT of the subject center, its reprojection into every
camera for the crop centers (truncated, clamped to [bbox/2, W - bbox/2]),
the bbox^2 crops normalized in float32 and rounded to the compute dtype
(K16), then HybridNet (K15 its 2D net's heads, K1 throughout the
2D and 3D nets, K2 or K5 reprojection by the configured mode, K3
soft-argmax). Everything stays on the
predictor's device; nothing synchronizes with the host.

Camera sharding (:meth:`Predict3D.set_mesh`, ``parallel/predict_step``):
each rank of a camera group takes its own cameras' frames, runs K4,
CenterDetect and the argmax on them, and the centers and maxima are
gathered over the group in camera order (``collectives.camera_gather``),
so every rank computes the same gate, DLT and crop centers; then each rank
crops its cameras, runs KeypointDetect on them and gathers their rows
divided by the rig's camera count, the group sums the partial volumes
(``collectives.camera_sum``), and V2V and K3 run on every rank.

The two-phase cascade splits that step for streaming: phase A runs the
center stage on low-resolution frames and returns crop centers in
full-resolution pixels, the host cuts the crops out of its full-resolution
frames, and phase B runs HybridNet on them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import crop_normalize, resize_normalize
from ..models.efficienttrack import EfficientTrackBackbone
from ..models.hybridnet import HybridNetBackbone
from ..ops.heatmap import argmax_2d
from ..parallel.collectives import camera_gather
from ..utils.reprojection import project_points, triangulate


class Predict3D:
    """``predictor(imgs) -> (points3D (T, J, 3) mm, confidences (T, J),
    valid (T,) bool)`` for imgs (T, C, H, W, 3), uint8 or float32 RGB in
    [0, 1], on the predictor's device.

    A call checks the frames, moves them to the device and runs ``step``
    on them: :meth:`eager_step`, or its replays from a CUDA graph captured
    per input shape once the loaders wrap it (``export.wrap_predictor``)."""

    def __init__(self, cfg, center_model: EfficientTrackBackbone,
                 hybrid_model: HybridNetBackbone, camera_matrices, intrinsics,
                 distortions, device):
        self.device = torch.device(device)
        self.step = self.eager_step
        self.center_size = int(cfg.CENTERDETECT.IMAGE_SIZE)
        self.bbox = int(cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE)
        self.mean = [float(v) for v in cfg.DATASET.MEAN]
        self.std = [float(v) for v in cfg.DATASET.STD]
        self.center_model = center_model
        self.hybrid_model = hybrid_model

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self.P, self.K, self.D = dev(camera_matrices), dev(intrinsics), dev(distortions)
        self.set_mesh(None)

    def set_mesh(self, mesh) -> "Predict3D":
        """Shard the cameras over ``mesh``'s camera group (module
        docstring): a call then takes this rank's cameras' frames (T,
        C / n_cameras, H, W, 3). None, or one camera rank: every camera."""
        C = self.P.shape[0]
        self.mesh = mesh if mesh is not None and mesh.n_cameras > 1 else None
        self.cams = slice(0, C) if self.mesh is None else self.mesh.cameras(C)
        self.local_P, self.local_K, self.local_D = (a[self.cams] for a in (self.P, self.K,
                                                                             self.D))
        self.hybrid_model.set_mesh(self.mesh, C)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.hybrid_model.dtype

    @torch.no_grad()
    def detect(self, imgs: torch.Tensor):
        """Resize + normalize (K4), CenterDetect and argmax: the detected
        centers (T, C, 2) in CenterDetect heatmap pixels, float32, and
        their heatmap maxima (T, C), of every camera of the rig (gathered
        over the camera group where the frames are this rank's cameras)."""
        T, C, H, W = imgs.shape[:4]
        cs = self.center_size
        inp = resize_normalize(imgs.reshape(T * C, H, W, 3), cs, cs, self.mean,
                               self.std, self.dtype)
        hm = self.center_model.heatmap2(inp.permute(0, 3, 1, 2))
        xy, maxval = argmax_2d(hm.permute(0, 2, 3, 1))  # (T*C, 1, 2), (T*C, 1) float32
        return (camera_gather(xy[:, 0].reshape(T, C, 2).float(), self.mesh),
                camera_gather(maxval[:, 0].reshape(T, C).float(), self.mesh))

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

    def normalize(self, crops: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """uint8 or float [0, 1] crops (T, C, bbox, bbox, 3) ->
        ImageNet-normalized in float32, rounded to ``dtype``: K16 with each
        whole crop as its window."""
        T, C, bbox = crops.shape[:3]
        out = crop_normalize(crops.reshape(T * C, bbox, bbox, 3), None, bbox, self.mean,
                             self.std, dtype)
        return out.reshape(crops.shape)

    def crops(self, imgs: torch.Tensor, center_hm: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
        """The bbox^2 windows at the crop centers (T, C, 2) int32, normalized
        in float32 and rounded to ``dtype``: (T, C, bbox, bbox, 3), by K16."""
        T, C, H, W = imgs.shape[:4]
        out = crop_normalize(imgs.reshape(T * C, H, W, 3), center_hm.reshape(T * C, 2),
                             self.bbox, self.mean, self.std, dtype)
        return out.reshape(T, C, self.bbox, self.bbox, 3)

    def frames(self, imgs) -> torch.Tensor:
        """``imgs`` on the predictor's device, checked: (T, C, H, W, 3) uint8
        or float32."""
        imgs = torch.as_tensor(imgs, device=self.device)
        if imgs.dtype not in FRAME_DTYPES or imgs.dim() != 5 or imgs.shape[-1] != 3:
            raise ValueError("expected uint8 or float32 frames (T, C, H, W, 3), got "
                             f"{imgs.dtype} {tuple(imgs.shape)}")
        return imgs

    @torch.no_grad()
    def hybrid_points(self, crops, center_hm, center3d):
        """HybridNet on normalized crops of this rank's cameras, at their
        crop centers: (points3D, confidences)."""
        T = crops.shape[0]

        def per_frameset(a):
            return a.expand(T, *a.shape)

        return self.hybrid_model.points(
            crops, center_hm, center3d.to(torch.int32), per_frameset(self.local_P),
            per_frameset(self.local_K), per_frameset(self.local_D))

    @torch.no_grad()
    def eager_step(self, imgs: torch.Tensor):
        """One step on checked frames on the device, launched op by op."""
        center_hm, center3d, valid = self.centers(imgs)
        local = center_hm[:, self.cams]
        points, conf = self.hybrid_points(self.crops(imgs, local, self.dtype), local, center3d)
        return points, conf, valid

    def __call__(self, imgs):
        return self.step(self.frames(imgs))


FRAME_DTYPES = (torch.uint8, torch.float32)


def build_predict3d_twophase(predictor: Predict3D, full_size):
    """Split cascade for streaming (``predictor3d.py:165-306``), on the
    models and rig of ``predictor``. ``full_size`` is (W, H) of the
    full-resolution recording.

    Returns ``(phase_a, phase_b, crop_fn)``:

    - ``phase_a(lowres (T, C, H/f, W/f, 3) uint8 or float32) -> (cx, cy
      (T, C) int32, center3d (T, 3) int32, valid (T,))``: K4 to the
      CenterDetect input, CenterDetect, argmax, gate and DLT, with the crop
      centers in full-resolution pixels clamped to [bbox/2, W - bbox/2];
    - ``phase_b(crops (T, C, bbox, bbox, 3) uint8 or float32, cx, cy,
      center3d) -> (points3D (T, J, 3), confidences (T, J))``;
    - ``crop_fn(frames (T, C, H, W, 3) numpy, cx, cy) -> crops``: the
      windows cut on the host, as numpy.

    Inputs may be numpy arrays or tensors; they are moved to the predictor's
    device. Nothing synchronizes with the host, so the caller's copy of
    ``cx, cy`` to the host for ``crop_fn`` is the one synchronization of a
    step. Each phase runs its ``step`` on device tensors, which the loaders
    may replace by its CUDA graph replays (``export.wrap_predictor``); the
    moves to the device stay outside.
    """
    W_full, H_full = int(full_size[0]), int(full_size[1])
    bbox, hw = predictor.bbox, predictor.bbox // 2

    @torch.no_grad()
    def step_a(lowres):
        center_hm, center3d, valid = predictor.place(*predictor.detect(lowres), H_full,
                                                     W_full)
        return center_hm[..., 0], center_hm[..., 1], center3d.to(torch.int32), valid

    @torch.no_grad()
    def step_b(crops, cx, cy, center3d):
        center_hm = torch.stack([cx, cy], dim=-1)
        return predictor.hybrid_points(predictor.normalize(crops, predictor.dtype), center_hm,
                                       center3d)

    def phase_a(lowres):
        return phase_a.step(predictor.frames(lowres))

    def phase_b(crops, cx, cy, center3d):
        return phase_b.step(predictor.frames(crops),
                            *(torch.as_tensor(a, device=predictor.device)
                              for a in (cx, cy, center3d)))

    phase_a.step, phase_b.step = step_a, step_b

    def crop_fn(frames: np.ndarray, cx: np.ndarray, cy: np.ndarray) -> np.ndarray:
        """Host-side window slicing from the full-resolution frames."""
        T, C = frames.shape[0], frames.shape[1]
        out = np.empty((T, C, bbox, bbox, 3), frames.dtype)
        for t in range(T):
            for c in range(C):
                x0, y0 = int(cx[t, c]) - hw, int(cy[t, c]) - hw
                out[t, c] = frames[t, c, y0:y0 + bbox, x0:x0 + bbox]
        return out

    return phase_a, phase_b, crop_fn
