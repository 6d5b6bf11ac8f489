"""3D training dataset (a copy of ``jarvis_hybridnet_tpu/dataset/dataset3d.py``).

Re-implements the reference Dataset3D (jarvis/dataset/dataset3D.py:27-309):
at init, triangulates GT 3D keypoints for every frameset from >=2-camera 2D
annotations (cv2-exact DLT) and drops framesets whose 3D extent exceeds
ROI_CUBE_SIZE; per item, crops BOUNDING_BOX_SIZE windows around bbox centers
(±30% random translation on the train split), computes a grid-snapped cube
center (±40% margin jitter on train), and renders 3D Gaussian GT volumes at
(cube/spacing/2)^3.

Samples are dicts of numpy arrays ready for the batched HybridNet forward.
The port's trainer asks for raw uint8 crops and voxel keypoints
(``device_targets``). With ``device_aug`` on a train split whose color
manipulation is enabled, the crops ship untouched and the sample carries
``aug``, the per-camera color parameters of
``ops/augment.sample_color_params`` drawn from ``augpipe.rng``; the train
step applies them on the device (K9).
"""

from __future__ import annotations

import numpy as np

from ..ops.heatmap import gaussian_heatmaps_3d
from ..utils.calibration import CameraRig
from ..utils.reprojection import triangulate_dlt_numpy
from ..utils.rng import ThreadLocalGenerator
from .augmentation import AugmentationPipeline
from .base import BaseDataset


class Dataset3D(BaseDataset):
    def __init__(self, cfg, set="train", analysisMode=False,
                 device_targets=False, device_aug=False, **kwargs):
        self.analysisMode = analysisMode
        # trainers set this: samples then carry raw uint8 crops + voxel
        # keypoints instead of normalized f32 crops + rendered (J, g2^3)
        # volumes — normalization and Gaussian rendering move into the
        # jitted step (ops/heatmap.gaussian_heatmaps_3d_on_device), which
        # cuts both host time (the 3D stamp was ~20% of __getitem__,
        # BASELINE.md) and per-step H2D bytes by ~5x.
        self.device_targets = device_targets
        # trainers set this too (TPU.DEVICE_AUG): train samples then skip
        # the host color pipeline — the largest GIL-held sample-build
        # cost (34.2 ms = 33%, BASELINE.md host split) — and instead
        # carry a per-camera parameter record (ops/augment.
        # sample_color_params); the pixel work runs in the train step (K9).
        self.device_aug = device_aug
        super().__init__(cfg, cfg.DATASET.DATASET_3D, set, **kwargs)

        img = self._load_image(0)
        width, height = img.shape[1], img.shape[0]
        cfg.DATASET.IMAGE_SIZE = [width, height]

        # one rig per calibration session (dataset3D.py:50-62)
        self.rigs: dict[str, CameraRig] = {}
        for session, cams in self.dataset["calibrations"].items():
            calib_paths = {
                cam: rel for cam, rel in cams.items()
                if self.cameras_to_use is None or cam in self.cameras_to_use
            }
            self.rigs[session] = CameraRig.from_calib_paths(
                self.root_dir, calib_paths
            )
            self.num_cameras = self.rigs[session].num_cameras
        cfg.HYBRIDNET.NUM_CAMERAS = self.num_cameras
        cfg.KEYPOINTDETECT.NUM_JOINTS = self.num_keypoints[0]

        if self.cameras_to_use is not None:
            all_names = list(
                next(iter(self.dataset["calibrations"].values())).keys()
            )
            # NB: the builtin `set` is shadowed by the split-name parameter
            # (kept as `set` for reference API parity) in this scope
            keep = frozenset(next(iter(self.rigs.values())).camera_names)
            self.use_idxs = [i for i, c in enumerate(all_names) if c in keep]
        else:
            self.use_idxs = None

        # triangulate GT 3D keypoints per frameset (dataset3D.py:79-134)
        J = self.num_keypoints[0]
        self.frameset_keys = []
        self.keypoints3D = []
        roi = cfg.HYBRIDNET.ROI_CUBE_SIZE
        for key, fs in self.dataset["framesets"].items():
            frame_ids = fs["frames"]
            if self.use_idxs is not None:
                frame_ids = [frame_ids[i] for i in self.use_idxs]
            rig = self.rigs[fs["datasetName"]]
            kp2d = []
            for img_id in frame_ids:
                _, kps = self._load_annotations(img_id, is_id=True)
                kp2d.append(kps.reshape(-1, 3))
            kp3d = np.zeros((J, 3))
            labeled = []
            for j in range(J):
                pts = np.zeros((2, self.num_cameras))
                cams = []
                for c in range(self.num_cameras):
                    if kp2d[c][j][0] != 0 or kp2d[c][j][1] != 0:
                        pts[:, c] = kp2d[c][j][:2]
                        cams.append(c)
                kp3d[j] = triangulate_dlt_numpy(pts, cams, rig.camera_list)
                if len(cams) > 1:
                    labeled.append(kp3d[j])
            if not labeled:
                continue
            labeled = np.array(labeled)
            extent = (labeled.max(axis=0) - labeled.min(axis=0)).max()
            if (roi is None or extent <= roi) and len(labeled) > 1:
                self.frameset_keys.append(key)
                self.keypoints3D.append(kp3d)

        self.mean = np.asarray(cfg.DATASET.MEAN, np.float32)
        self.std = np.asarray(cfg.DATASET.STD, np.float32)
        self.augpipe = AugmentationPipeline(
            cfg.AUGMENTATION, mirror=False, affine=False
        )
        self.rng = ThreadLocalGenerator()

    def __len__(self):
        return len(self.frameset_keys)

    # -- in-memory decoded-frame cache -----------------------------------
    #
    # Unlike Dataset2D, the 3D crop windows are NOT deterministic (±30%
    # center jitter per epoch on the train split), so the cache holds the
    # full decoded frames of every frameset (~4 MB per 1280x1024 camera
    # frame, ~11 GB for Example_Dataset's train split) and __getitem__
    # becomes a pure memcpy crop — JPEG decode, 51% of the per-sample host
    # cost (BASELINE.md), drops out of every epoch. Guarded by
    # loader.maybe_preload's RAM check.

    def preload_nbytes(self) -> int:
        n_frames = len(self) * self.num_cameras
        w, h = self.cfg.DATASET.IMAGE_SIZE
        return n_frames * int(w) * int(h) * 3

    def preload(self, log=True) -> None:
        from concurrent.futures import ThreadPoolExecutor

        if getattr(self, "_frame_cache", None) is not None:
            return
        import os

        ids = []
        for key in self.frameset_keys:
            frame_ids = self.dataset["framesets"][key]["frames"]
            if self.use_idxs is not None:
                frame_ids = [frame_ids[i] for i in self.use_idxs]
            ids.extend(frame_ids)
        ids = sorted(set(ids))
        cache = {}

        def fill(img_id):
            cache[img_id] = self._load_image_u8(img_id, is_id=True)

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) \
                as ex:  # cv2 decode releases the GIL
            list(ex.map(fill, ids))
        self._frame_cache = cache
        if log:
            from ..utils import clp

            total = sum(v.nbytes for v in cache.values())
            clp.info(f"Preloaded {len(ids)} decoded frames "
                     f"({total / 1e9:.1f} GB in RAM)")

    def __getitem__(self, idx):
        cfg = self.cfg
        spacing = float(cfg.HYBRIDNET.GRID_SPACING)
        cube = float(cfg.HYBRIDNET.ROI_CUBE_SIZE)
        bbox_size = int(cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE)
        bbox_hw = bbox_size // 2
        key = self.frameset_keys[idx]
        fs = self.dataset["framesets"][key]
        frame_ids = fs["frames"]
        if self.use_idxs is not None:
            frame_ids = [frame_ids[i] for i in self.use_idxs]
        rig = self.rigs[fs["datasetName"]]

        C = self.num_cameras
        # raw-uint8 fast path: when nothing touches the pixels on the
        # host (val split, or train with on-device augmentation), the
        # native/cached uint8 crops ship as-is — no f32 round trip, no
        # re-quantization (pixels reach the device bit-identical to the
        # JPEG source)
        use_dev_aug = (self.device_targets and self.device_aug
                       and self.set_name == "train" and not self.analysisMode
                       and bool(cfg.AUGMENTATION.COLOR_MANIPULATION.ENABLED))
        raw_u8 = (self.device_targets and not self.analysisMode
                  and (use_dev_aug or self.set_name != "train"))
        if self.analysisMode:
            img0 = self._load_image(frame_ids[0], is_id=True)
            imgs = np.zeros((C,) + img0.shape, np.float32)
        else:
            imgs = np.zeros((C, bbox_size, bbox_size, 3),
                            np.uint8 if raw_u8 else np.float32)
        center_hm = np.full((C, 2), 128, int)

        sizes = []
        for ci, img_id in enumerate(frame_ids):
            # clamp against each camera's own frame size (mixed-resolution
            # rigs; dataset JSON records width/height per image)
            width = int(self.imgs[img_id].get(
                "width", cfg.DATASET.IMAGE_SIZE[0]))
            height = int(self.imgs[img_id].get(
                "height", cfg.DATASET.IMAGE_SIZE[1]))
            sizes.append((width, height))
            bboxs, _ = self._load_annotations(img_id, is_id=True)
            cx = int((bboxs[0, 0] + int(bboxs[0, 2])) / 2)
            cy = int((bboxs[0, 1] + int(bboxs[0, 3])) / 2)
            if self.set_name == "train":
                t = self.rng.uniform(-1.0, 1.0, 2)
                cx += int(t[0] * bbox_hw * 0.3)
                cy += int(t[1] * bbox_hw * 0.3)
            cy = min(max(bbox_hw, cy), height - bbox_hw)
            cx = min(max(bbox_hw, cx), width - bbox_hw)
            center_hm[ci] = (cx, cy)

        cache = getattr(self, "_frame_cache", None)
        crops = None
        if cache is None and not self.analysisMode and len(set(sizes)) == 1:
            # native path: one threaded C++ decode+crop call for the whole
            # frameset (falls back to the cv2 loop below)
            crops = self._native_crops(frame_ids, center_hm, bbox_size,
                                       sizes[0][0], sizes[0][1])
        for ci, img_id in enumerate(frame_ids):
            if cache is not None and not self.analysisMode:
                cx, cy = center_hm[ci]
                img = cache[img_id][cy - bbox_hw: cy + bbox_hw,
                                    cx - bbox_hw: cx + bbox_hw]
                if not raw_u8:
                    img = img.astype(np.float32) / 255.0
            elif crops is not None:
                img = crops[ci] if raw_u8 \
                    else crops[ci].astype(np.float32) / 255.0
            else:
                img = self._load_image(img_id, is_id=True)
                if not self.analysisMode:
                    cx, cy = center_hm[ci]
                    img = img[cy - bbox_hw: cy + bbox_hw,
                              cx - bbox_hw: cx + bbox_hw]
                if raw_u8:
                    img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
            if self.set_name == "train" and not use_dev_aug:
                img, _ = self.augpipe(img)
            imgs[ci] = img

        kp3d = self.keypoints3D[idx]
        labeled = kp3d[np.any(kp3d != 0, axis=1)]
        lo = labeled.min(axis=0)
        hi = labeled.max(axis=0)
        # grid-snapped cube center (dataset3D.py:217-220)
        center3d = (
            ((hi + lo) / spacing / 2.0).astype(int) * int(spacing)
        ).astype(np.float64)
        if self.set_name == "train":
            margins = cube - (hi - lo)
            t = self.rng.uniform(-0.4, 0.4, 3)
            center3d += (
                (margins * t / spacing / 2.0).astype(int) * int(spacing)
            )

        kp_vox = (kp3d + cube / 2.0 - center3d) / spacing / 2.0
        sample = {
            "keypoints3D": kp3d.astype(np.float32),
            "center_hm": center_hm.astype(np.int32),
            "center3d": center3d.astype(np.int32),
            "camera_matrices": rig.camera_matrices,
            "intrinsics": rig.intrinsics,
            "distortions": rig.distortions,
            "dataset_name": fs["datasetName"],
        }
        if self.device_targets and not self.analysisMode:
            sample["imgs"] = imgs if raw_u8 else np.clip(
                imgs * 255.0 + 0.5, 0, 255).astype(np.uint8)
            sample["kp_vox"] = kp_vox.astype(np.float32)
            if use_dev_aug:
                from ..ops.augment import sample_color_params

                sample["aug"] = sample_color_params(
                    cfg.AUGMENTATION.COLOR_MANIPULATION, self.augpipe.rng, C)
        else:
            g2 = int(cube / spacing / 2.0)
            sample["heatmap3d"] = gaussian_heatmaps_3d(kp_vox, kp3d, g2)
            sample["imgs"] = (
                ((imgs - self.mean) / self.std).astype(np.float32)
                if not self.analysisMode else imgs)
        if self.analysisMode:
            sample["file_name"] = self.imgs[fs["frames"][0]]["file_name"]
        return sample

    def _native_crops(self, frame_ids, center_hm, bbox_size, width, height):
        """Threaded C++ decode+crop of a whole frameset; None on fallback."""
        import os

        from .. import native

        if not native.available():
            return None
        paths = []
        for img_id in frame_ids:
            name = self.imgs[img_id]["file_name"]
            if not name.lower().endswith((".jpg", ".jpeg")):
                return None
            paths.append(os.path.join(self.root_dir, self.set_name, name))
        return native.decode_crop_batch(
            paths, center_hm.astype(np.int32), bbox_size, width, height
        )

    def get_dataset_config(self) -> dict:
        """Suggest cube size / grid spacing from p95 GT extents
        (dataset3D.py:265-309)."""
        extents = []
        for kp in self.keypoints3D:
            labeled = kp[np.any(kp != 0, axis=1)]
            extents.append(labeled.max(axis=0) - labeled.min(axis=0))
        extents = np.array(extents)
        min_cube = max(
            np.percentile(extents[:, 0], 95),
            np.percentile(extents[:, 1], 95),
            np.percentile(extents[:, 2], 95),
        )
        rough = min_cube * 1.25
        resolution = max(1, int(np.round(rough / 85.0)))
        bbox = int(np.ceil((min_cube * 1.25) / (resolution * 4)) * resolution * 4)
        return {"bbox": bbox, "resolution": resolution}
