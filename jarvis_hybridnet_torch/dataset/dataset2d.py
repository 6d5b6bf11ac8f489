"""2D training datasets, CenterDetect and KeypointDetect (a copy of
``jarvis_hybridnet_tpu/dataset/dataset2d.py``).

Re-implements the reference Dataset2D (jarvis/dataset/dataset2D.py:28-269):
CenterDetect mode resizes the full frame to CENTERDETECT.IMAGE_SIZE and
renders a single bbox-center Gaussian at output/4 and output/2
(sigma = output/64); KeypointDetect mode crops BOUNDING_BOX_SIZE around the
bbox center (clamped inside the frame), shifts keypoints, zeroes the ones
falling outside the crop, and renders per-joint Gaussians
(sigma = 1.5*output/64). Augmentation applies on the train split only.

Samples are (image float32 HWC normalized, [targets/4, targets/2], keypoints).

With ``device_targets=True`` (the trainers' mode) samples are
``(image uint8 HWC raw RGB, keypoints (1, J * 3))``: normalization and the
Gaussian targets run in the train step on the device (K9 and K8). With
``device_aug`` on a train split whose color manipulation is enabled, the
host does only the mirror / affine half of the augmentation and the sample
carries a third item, the per-sample color parameters of
``ops/augment.sample_color_params`` plus ``minv``, the affine's inverse map
(``AugmentationPipeline.geometric``) for the border re-zero.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..ops.heatmap import gaussian_heatmaps
from .augmentation import AugmentationPipeline
from .base import BaseDataset


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """0..1 float RGB -> uint8 for the thin host-to-device path; the train
    step divides by 255 and normalizes on the device (K9). For unaugmented JPEG
    sources this round-trips exactly; after bilinear resize or train
    augmentation (blur/contrast/affine interpolation) values are no
    longer 1/255 multiples, so quantization adds up to 1/510 per pixel
    — accepted by design (≪ the augmentation noise itself)."""
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


class Dataset2D(BaseDataset):
    def __init__(self, cfg, set="train", mode="CenterDetect",
                 skip_assert=False, device_targets=False, device_aug=False,
                 **kwargs):
        super().__init__(cfg, cfg.DATASET.DATASET_2D, set, **kwargs)
        self.mode = mode
        self.device_targets = device_targets
        # the trainer sets this (TPU.DEVICE_AUG, like dataset3d): train
        # samples then skip the host color pass and carry a per-sample
        # parameter record + the affine's inverse map; the pixel work runs
        # in the train step (K9). The mirror/affine half stays on the host.
        self.device_aug = device_aug
        if not skip_assert:
            assert cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE % 64 == 0, (
                "Bounding Box size has to be divisible by 64!"
            )

        img = self._load_image(0)
        self.width, self.height = img.shape[1], img.shape[0]
        cfg.DATASET.IMAGE_SIZE = [self.width, self.height]
        if mode == "CenterDetect":
            cfg.CENTERDETECT.NUM_JOINTS = 1

        self.mean = np.asarray(cfg.DATASET.MEAN, np.float32)
        self.std = np.asarray(cfg.DATASET.STD, np.float32)
        self.augpipe = AugmentationPipeline(
            cfg.AUGMENTATION, mirror=(mode == "KeypointDetect")
        )

    def __getitem__(self, idx):
        if self.mode == "CenterDetect":
            return self._get_item_center(idx)
        return self._get_item_keypoints(idx)

    def _use_device_aug(self) -> bool:
        """The color pipeline runs in the train step for this sample."""
        return (self.device_targets and self.device_aug
                and self.set_name == "train"
                and bool(self.cfg.AUGMENTATION.COLOR_MANIPULATION.ENABLED))

    def _sample_aug_record(self) -> dict:
        """Per-sample device-aug parameters (squeezed to scalar leaves so
        the collated batch has plain (B, ...) leading shapes). Drawn from
        ``augpipe.rng`` — the loader's absolute-epoch stream — so
        preemption-replay determinism matches the host pipeline's."""
        from ..ops.augment import sample_color_params

        p = sample_color_params(
            self.cfg.AUGMENTATION.COLOR_MANIPULATION, self.augpipe.rng, 1)
        return {k: v[0] for k, v in p.items()}

    # -- in-memory decoded-sample cache ----------------------------------
    #
    # The pre-augmentation part of every sample (JPEG decode + resize/crop
    # + keypoint shift) is deterministic, so epochs 2..N re-do identical
    # work; on a host whose cores are the training bottleneck that decode
    # is the dominant per-sample cost. preload() materializes the pre-aug
    # state once as packed uint8 (256^2 crops: ~200 KB/sample, ~620 MB for
    # the full Example_Dataset) — the loader's worker threads share it,
    # and every epoch pays only augmentation + collate.

    def preload_nbytes(self) -> int:
        """Estimated cache size (for the trainers' RAM guard)."""
        size = int(self.cfg.CENTERDETECT.IMAGE_SIZE
                   if self.mode == "CenterDetect"
                   else self.cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE)
        return len(self) * size * size * 3

    def preload(self, log=True) -> None:
        from concurrent.futures import ThreadPoolExecutor

        if getattr(self, "_cache_imgs", None) is not None:
            return
        base = (self._base_center if self.mode == "CenterDetect"
                else self._base_keypoints)
        n = len(self)
        img0, kps0 = base(0)
        imgs = np.zeros((n,) + img0.shape, np.uint8)
        kps = np.zeros((n,) + np.shape(kps0), np.float32)

        def fill(i):
            img, kp = base(i)
            imgs[i] = _to_uint8(img)
            kps[i] = kp

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) \
                as ex:  # cv2 decode releases the GIL
            list(ex.map(fill, range(n)))
        self._cache_imgs, self._cache_kps = imgs, kps
        if log:
            from ..utils import clp

            clp.info(f"Preloaded {n} decoded samples "
                     f"({imgs.nbytes / 1e6:.0f} MB in RAM)")

    def _base_center(self, idx):
        """Pre-augmentation state: (resized f32 0..1 image, center px)."""
        cfg = self.cfg
        size = int(cfg.CENTERDETECT.IMAGE_SIZE)
        img = self._load_image(idx)
        bboxs, _ = self._load_annotations(idx)
        has_subject = bboxs[0][4] != -1
        # (-1, -1) is the explicit "no subject" sentinel (cache-safe: a
        # genuine bbox center is always >= 0, unlike the old (0, 0)
        # overload where an annotation truncating to the origin would be
        # silently treated as a negative sample)
        center = np.array(
            [(bboxs[0][0] + bboxs[0][2]) / 2, (bboxs[0][1] + bboxs[0][3]) / 2],
            np.float32,
        ) if has_subject else np.full(2, -1.0, np.float32)

        # resize to the CenterDetect input size, rescaling the target
        sx = size / img.shape[1]
        sy = size / img.shape[0]
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        if has_subject:
            center = center * np.array([sx, sy], np.float32)
        return img, center

    def _get_item_center(self, idx):
        cfg = self.cfg
        size = int(cfg.CENTERDETECT.IMAGE_SIZE)
        if getattr(self, "_cache_imgs", None) is not None:
            img = self._cache_imgs[idx].astype(np.float32) / 255.0
            center = self._cache_kps[idx].copy()
        else:
            img, center = self._base_center(idx)
        # pre-aug (-1, -1) encodes "no subject in frame" (negative sample)
        has_subject = bool(center[0] >= 0)

        aug_rec = None
        if self.set_name == "train":
            if self._use_device_aug():
                aug_rec = self._sample_aug_record()
                img, kps, aug_rec["minv"] = self.augpipe.geometric(
                    img, center[None])
            else:
                img, kps = self.augpipe(img, center[None])
            center = kps[0]
        if not has_subject:
            # downstream contract stays (0, 0): target rendering and the
            # px-accuracy mask skip zero keypoints; augmentation must not
            # turn an empty frame into a bogus target/GT point
            center = np.zeros(2, np.float32)

        keypoints = np.concatenate([center, [1.0]])[None].astype(np.float32)
        if self.device_targets:
            if aug_rec is not None:
                return _to_uint8(img), keypoints, aug_rec
            return _to_uint8(img), keypoints

        targets = []
        for scale in (4, 2):
            out = size // scale
            sigma = 1.0 * out / 64  # CenterDetect sigma (dataset2D.py:292-294)
            targets.append(
                gaussian_heatmaps(center[None], size, out, sigma).astype(
                    np.float32)
            )
        img = (img - self.mean) / self.std
        return img, targets, keypoints

    def _base_keypoints(self, idx):
        """Pre-augmentation state: (f32 0..1 crop, shifted (J, 3) kps)."""
        bbox_size = int(self.cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE)
        bbox_hw = bbox_size // 2
        img = self._load_image(idx)
        bboxs, keypoints = self._load_annotations(idx)
        center_y = min(
            max(bbox_hw, int((bboxs[0, 1] + int(bboxs[0, 3])) / 2)),
            img.shape[0] - bbox_hw,
        )
        center_x = min(
            max(bbox_hw, int((bboxs[0, 0] + int(bboxs[0, 2])) / 2)),
            img.shape[1] - bbox_hw,
        )
        img = img[center_y - bbox_hw: center_y + bbox_hw,
                  center_x - bbox_hw: center_x + bbox_hw]
        kps = keypoints[0].reshape(-1, 3).astype(np.float32)
        kps[:, 0] += bbox_hw - center_x
        kps[:, 1] += bbox_hw - center_y
        return img, kps

    def _get_item_keypoints(self, idx):
        cfg = self.cfg
        bbox_size = int(cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE)
        if getattr(self, "_cache_imgs", None) is not None:
            img = self._cache_imgs[idx].astype(np.float32) / 255.0
            kps = self._cache_kps[idx].copy()
        else:
            img, kps = self._base_keypoints(idx)

        aug_rec = None
        if self.set_name == "train":
            if self._use_device_aug():
                aug_rec = self._sample_aug_record()
                img, moved, aug_rec["minv"] = self.augpipe.geometric(
                    img, kps[:, :2])
            else:
                img, moved = self.augpipe(img, kps[:, :2])
            kps[:, :2] = moved

        # zero out keypoints outside the crop (dataset2D.py:199-207)
        outside = (
            (kps[:, 0] < 0) | (kps[:, 1] < 0)
            | (kps[:, 0] >= bbox_size) | (kps[:, 1] >= bbox_size)
        )
        kps[outside, :2] = 0

        if self.device_targets:
            if aug_rec is not None:
                return _to_uint8(img), kps.reshape(1, -1), aug_rec
            return _to_uint8(img), kps.reshape(1, -1)

        targets = []
        for scale in (4, 2):
            out = bbox_size // scale
            sigma = 1.5 * out / 64  # KeypointDetect sigma (dataset2D.py:290)
            targets.append(
                gaussian_heatmaps(kps[:, :2], bbox_size, out, sigma).astype(
                    np.float32
                )
            )
        img = (img - self.mean) / self.std
        return img.astype(np.float32), targets, kps.reshape(1, -1)

    def visualize_sample(self, idx):
        """Heatmap-overlay viewer for one sample
        (reference: jarvis/dataset/dataset2D.py:254-269). Returns the
        rendered BGR image (shown interactively when a display exists)."""
        img, heatmaps, _ = self[idx]
        img = img * self.std + self.mean
        img = cv2.cvtColor(img.astype(np.float32), cv2.COLOR_RGB2BGR)
        hm = heatmaps[1]
        img = cv2.resize(img * 255, (hm.shape[2], hm.shape[1])).astype(
            np.uint8)
        colored = cv2.applyColorMap(hm[0].astype(np.uint8), cv2.COLORMAP_JET)
        for i in range(1, hm.shape[0]):
            colored = colored + cv2.applyColorMap(
                hm[i].astype(np.uint8), cv2.COLORMAP_JET)
        img = cv2.addWeighted(img, 1.0, colored, 0.4, 0)
        img = cv2.resize(img, (640, 512))
        import os

        if os.environ.get("DISPLAY"):  # interactive only; headless returns
            cv2.imshow("frame", img)
            cv2.waitKey(0)
        return img

    def get_dataset_config(self) -> int:
        """Suggested BOUNDING_BOX_SIZE = ceil(1.2 * p98(bbox)/64)*64
        (dataset2D.py:226-251)."""
        bboxs = []
        for i in range(len(self.image_ids)):
            bbox, _ = self._load_annotations(i)
            if len(bbox) != 0 and bbox[0][4] != -1:
                bboxs.append(bbox)
        bboxs = np.array(bboxs)
        x_sizes = bboxs[:, 0, 2] - bboxs[:, 0, 0]
        y_sizes = bboxs[:, 0, 3] - bboxs[:, 0, 1]
        bbox_min = max(np.percentile(x_sizes, 98), np.percentile(y_sizes, 98))
        return int(np.ceil((bbox_min * 1.20) / 64) * 64)
