"""COCO-style dataset index (a copy of ``jarvis_hybridnet_tpu/dataset/base.py``).

Re-implements the reference BaseDataset (jarvis/dataset/datasetBase.py:28-143)
minus the torch dependency: loads ``annotations/instances_{split}.json``,
indexes images/annotations/categories, and provides per-image bbox
([x,y,w,h] -> [x1,y1,x2,y2]) and flat keypoint arrays. Images load as RGB
float32 in [0, 1].

Dataset JSON schema (verified on Example_Dataset): keys = annotations,
calibrations, categories, framesets, images, info, keypoint_names, licenses,
skeleton; ``framesets["<path>/Frame_N"] = {datasetName, frames: [img ids]}``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

try:
    import cv2

    cv2.setNumThreads(0)  # avoid oversubscription in loader threads
except ImportError:  # pragma: no cover
    cv2 = None


class BaseDataset:
    def __init__(self, cfg, dataset_name: str, set: str = "train", **kwargs):
        self.cameras_to_use = kwargs.get("cameras_to_use")
        self.cfg = cfg
        if os.path.isabs(dataset_name):
            self.root_dir = dataset_name
        else:
            self.root_dir = os.path.join(
                cfg.PARENT_DIR, cfg.DATASET.DATASET_ROOT_DIR, dataset_name
            )
        self.set_name = set

        with open(
            os.path.join(self.root_dir, "annotations",
                         f"instances_{set}.json")
        ) as f:
            self.dataset = json.load(f)

        self.num_keypoints = [
            cat["num_keypoints"] for cat in self.dataset["categories"]
        ]
        if self.cameras_to_use is not None:
            self.image_ids = [
                img["id"] for img in self.dataset["images"]
                if img["file_name"].split("/")[-2] in self.cameras_to_use
            ]
        else:
            self.image_ids = [img["id"] for img in self.dataset["images"]]

        self.annotations: dict = {}
        self.categories: dict = {}
        self.imgs: dict = {}
        self.imgToAnns = defaultdict(list)
        self._create_index()

    def _create_index(self):
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)
            self.annotations[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.categories[cat["id"]] = cat

    def __len__(self):
        return len(self.image_ids)

    def _load_image_u8(self, image_index, is_id: bool = False) -> np.ndarray:
        img_id = image_index if is_id else self.image_ids[image_index]
        file_name = self.imgs[img_id]["file_name"]
        path = os.path.join(self.root_dir, self.set_name, file_name)
        img = cv2.imread(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def _load_image(self, image_index, is_id: bool = False) -> np.ndarray:
        return self._load_image_u8(image_index, is_id).astype(
            np.float32) / 255.0

    def _load_annotations(self, image_index, is_id: bool = False):
        img_id = image_index if is_id else self.image_ids[image_index]
        anns = self.imgToAnns[img_id]
        J = self.num_keypoints[0]
        if len(anns) == 0:
            annotations = np.zeros((1, 5))
            annotations[0][4] = -1
            return annotations, np.zeros((1, J * 3))
        annotations = np.zeros((len(anns), 5))
        keypoints = np.zeros((len(anns), J * 3))
        for i, a in enumerate(anns):
            annotations[i, :4] = a["bbox"]
            annotations[i, 4] = a["category_id"] - 1
            keypoints[i] = np.array(a["keypoints"]).reshape(-1)[: J * 3]
        annotations[:, 2] = annotations[:, 0] + annotations[:, 2]
        annotations[:, 3] = annotations[:, 1] + annotations[:, 3]
        return annotations, keypoints
