"""Training-time image augmentation, numpy/cv2 on the host (a copy of
``jarvis_hybridnet_tpu/dataset/augmentation.py``).

Replaces the reference's imgaug pipeline
(jarvis/dataset/dataset2D.py:84-126, dataset3D.py:143-166) with equivalent
cv2/numpy transforms driven by the same AUGMENTATION config section: Gaussian
blur / additive noise / linear contrast / multiply / per-channel multiply,
horizontal flip (keypoint-aware), and affine rotate+scale about the image
center. Images are float32 RGB in [0, 1].
"""

from __future__ import annotations

import numpy as np

from ..utils.rng import ThreadLocalGenerator

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class AugmentationPipeline:
    def __init__(self, aug_cfg, mirror: bool = False, affine: bool = True,
                 seed: int | None = None):
        self.cfg = aug_cfg
        self.mirror = mirror
        self.affine = affine
        # per-thread streams: thread-pool loader workers draw concurrently
        self.rng = ThreadLocalGenerator(seed)

    def _color(self, img: np.ndarray) -> np.ndarray:
        cm = self.cfg.COLOR_MANIPULATION
        if not cm.ENABLED:
            return img
        rng = self.rng
        if rng.random() < cm.GAUSSIAN_BLUR.PROBABILITY:
            sigma = rng.uniform(*cm.GAUSSIAN_BLUR.SIGMA)
            if sigma > 1e-3:
                img = cv2.GaussianBlur(img, (0, 0), sigma)
        scale = rng.uniform(*cm.GAUSSIAN_NOISE.SCALE)
        if scale > 0:
            per_channel = rng.random() < cm.GAUSSIAN_NOISE.PER_CHANNEL_PROBABILITY
            shape = img.shape if per_channel else img.shape[:2] + (1,)
            img = img + rng.normal(0.0, scale, size=shape).astype(np.float32)
        if rng.random() < cm.LINEAR_CONTRAST.PROBABILITY:
            alpha = rng.uniform(*cm.LINEAR_CONTRAST.SCALE)
            img = (img - 0.5) * alpha + 0.5
        if rng.random() < cm.MULTIPLY.PROBABILITY:
            img = img * rng.uniform(*cm.MULTIPLY.SCALE)
        if rng.random() < cm.PER_CHANNEL_MULTIPLY.PROBABILITY:
            pcm = cm.PER_CHANNEL_MULTIPLY
            if rng.random() < pcm.PER_CHANNEL_PROBABILITY:
                factors = rng.uniform(*pcm.SCALE, size=(1, 1, 3))
            else:
                factors = rng.uniform(*pcm.SCALE, size=(1,))
            img = img * factors.astype(np.float32)
        return np.clip(img, 0.0, 1.0).astype(np.float32)

    def geometric(
        self, img: np.ndarray, keypoints: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
        """Mirror + affine only (the keypoint-moving half of the
        pipeline). Returns ``(img, kps, minv)`` where ``minv`` is the
        float32 (2, 3) *inverse* map of the applied affine (dst px →
        src px; identity when the affine did not trigger) — the record
        the on-device color path (``ops/augment.py``) needs to re-zero
        the warp's out-of-frame border after device-side color ops."""
        kps = None if keypoints is None else keypoints.astype(np.float32).copy()
        h, w = img.shape[:2]
        minv = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)

        if self.mirror and self.rng.random() < self.cfg.MIRROR.PROBABILITY:
            img = img[:, ::-1].copy()
            if kps is not None:
                labeled = np.any(kps != 0, axis=1)
                kps[labeled, 0] = (w - 1) - kps[labeled, 0]

        at = self.cfg.AFFINE_TRANSFORM
        if self.affine and self.rng.random() < at.PROBABILITY:
            angle = self.rng.uniform(*at.ROTATION_RANGE)
            scale = self.rng.uniform(*at.SCALE_RANGE)
            M = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), -angle, scale)
            img = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR)
            minv = cv2.invertAffineTransform(M).astype(np.float32)
            if kps is not None:
                labeled = np.any(kps != 0, axis=1)
                hom = np.concatenate(
                    [kps, np.ones((kps.shape[0], 1), np.float32)], axis=1
                )
                moved = hom @ M.T
                kps[labeled] = moved[labeled].astype(np.float32)
        return img, kps, minv

    def __call__(
        self, img: np.ndarray, keypoints: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """keypoints: (J, 2) or None; returns transformed copies.

        Full host pipeline in the reference's op order (color first, then
        mirror, then affine — reference dataset2D.py:97-126,
        ``random_order=False``). The RNG draw sequence is unchanged by
        the ``geometric`` split above."""
        img = self._color(img)
        img, kps, _ = self.geometric(img, keypoints)
        return img, kps
