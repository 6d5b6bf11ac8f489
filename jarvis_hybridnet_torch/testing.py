"""Synthetic camera rig and configurations for the tests and ``chip_smoke.py``.

The Example_Dataset calibration is not in the repository, so parity tests
and the on-card smoke run use a seeded synthetic rig: cameras on a ring
about 1 m around the origin, looking inward with jittered aim points so the
subject lands off the principal axis, fx ~ fy ~ 1500 px at 1280x1024,
principal points near the image center and nonzero k1/k2. Matrices follow
the repository's conventions: row-vector projection ``[X, Y, Z, 1] @ P``
with P (4, 3), and transposed intrinsics with ``K[2,0] = cx``,
``K[2,1] = cy``.

:func:`write_calibration` writes a rig camera as an OpenCV-YAML calibration
and :func:`write_dataset3d` a COCO-style 3D dataset on it (JPEG frames,
seeded 3D keypoints projected into every camera, bounding boxes), the
training fixture of the tests and of ``chip_smoke.py``; cv2 (and PyYAML for
:func:`write_project`) are imported where a file is written.
"""

from __future__ import annotations

from dataclasses import dataclass

import json
import os

import numpy as np

from .config import get_default_cfg


@dataclass
class CameraRig:
    """The fields of ``utils/calibration.py``'s rig that the predictor reads."""

    camera_matrices: np.ndarray  # (C, 4, 3)
    intrinsics: np.ndarray  # (C, 3, 3), transposed K
    distortions: np.ndarray  # (C, 1, 5), k1, k2 radial


FOCAL_PX = 1500.0  # at 1280 px wide; scales with the width
RING_RADIUS_MM = 1000.0


def synthetic_rig(num_cameras: int = 12, width: int = 1280, height: int = 1024,
                  seed: int = 0) -> CameraRig:
    """A ring of inward-looking cameras around the origin."""
    rng = np.random.default_rng(seed)
    scale = width / 1280.0
    P = np.zeros((num_cameras, 4, 3), np.float64)
    K = np.zeros((num_cameras, 3, 3), np.float64)
    D = np.zeros((num_cameras, 1, 5), np.float64)
    for i in range(num_cameras):
        theta = 2.0 * np.pi * i / num_cameras
        pos = np.array([RING_RADIUS_MM * np.cos(theta), RING_RADIUS_MM * np.sin(theta),
                        250.0 * (1 if i % 2 else -1) + rng.uniform(-50, 50)])
        aim = rng.uniform(-120.0, 120.0, size=3)
        z = aim - pos
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])  # world -> camera rows
        t = -R @ pos
        fx = FOCAL_PX * scale * rng.uniform(0.97, 1.03)
        fy = fx * rng.uniform(0.99, 1.01)
        cx = width / 2.0 + rng.uniform(-20, 20) * scale
        cy = height / 2.0 + rng.uniform(-20, 20) * scale
        Kstd = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        P[i] = (Kstd @ np.concatenate([R, t[:, None]], axis=1)).T
        K[i] = Kstd.T
        D[i, 0, :2] = [rng.uniform(-0.3, -0.15), rng.uniform(0.05, 0.15)]
    return CameraRig(P.astype(np.float32), K.astype(np.float32),
                     D.astype(np.float32))


def monkeyhand_cfg(center_size: int = 256, bbox: int = 256, cube: int = 144,
                   spacing: int = 2, num_cameras: int = 12):
    """The Example_Project configuration that the committed MonkeyHand
    checkpoints were trained for: small EfficientTracks, 23 joints; the
    defaults are the production sizes (G = cube / spacing = 72)."""
    cfg = get_default_cfg()
    cfg.CENTERDETECT.MODEL_SIZE = "small"
    cfg.CENTERDETECT.IMAGE_SIZE = center_size
    cfg.KEYPOINTDETECT.MODEL_SIZE = "small"
    cfg.KEYPOINTDETECT.NUM_JOINTS = 23
    cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE = bbox
    cfg.HYBRIDNET.NUM_CAMERAS = num_cameras
    cfg.HYBRIDNET.ROI_CUBE_SIZE = cube
    cfg.HYBRIDNET.GRID_SPACING = spacing
    return cfg


def write_calibration(path, P, K, D) -> None:
    """An OpenCV FileStorage calibration: the transposed intrinsics, the
    distortion, and R, T recovered from P = [R; T] @ K_t."""
    import cv2

    rt = P.astype(np.float64) @ np.linalg.inv(K.astype(np.float64))
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_WRITE)
    fs.write("intrinsicMatrix", K.astype(np.float64))
    fs.write("distortionCoefficients", D.reshape(1, 5).astype(np.float64))
    fs.write("R", rt[:3])
    fs.write("T", rt[3].reshape(3, 1))
    fs.release()


def project_numpy(points: np.ndarray, rig: CameraRig) -> np.ndarray:
    """World points (J, 3) mm -> distorted pixels (C, J, 2), the model of
    ``utils/reprojection.project_points`` in float64."""
    hom = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    out = []
    for P, K, D in zip(rig.camera_matrices.astype(np.float64), rig.intrinsics.astype(np.float64),
                       rig.distortions.astype(np.float64)):
        proj = hom @ P
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[2, 0], K[2, 1]
        u, v = proj[:, 0] / proj[:, 2] - cx, proj[:, 1] / proj[:, 2] - cy
        r2 = (u / fx) ** 2 + (v / fy) ** 2
        d = 1.0 + (D[0, 0] + D[0, 1] * r2) * r2
        out.append(np.stack([u * d + cx, v * d + cy], axis=-1))
    return np.stack(out)


def write_dataset3d(root, rig: CameraRig, width: int, height: int, joints: int,
                    splits=(("train", 4), ("val", 2)), extent_mm: float = 100.0,
                    seed: int = 0, unlabeled=()) -> str:
    """A COCO-style 3D dataset under ``root`` (the layout ``dataset/base.py``
    and ``dataset/dataset3d.py`` read): one calibration session of the rig's
    cameras (``Cam0``...), and per split ``n`` framesets of ``width`` x
    ``height`` JPEG frames with ``joints`` seeded 3D keypoints spanning under
    ``extent_mm`` around a seeded center, projected into every camera, and a
    bounding box around them. Joints listed in ``unlabeled`` have no
    annotation in any camera. The frames are seeded color fields: a coarse
    random grid resized to the frame, plus pixel noise. Returns ``root``."""
    import cv2

    rng = np.random.default_rng(seed)
    names = [f"Cam{c}" for c in range(len(rig.camera_matrices))]
    calib = os.path.join(root, "calib_params", "Session")
    os.makedirs(calib, exist_ok=True)
    for c, name in enumerate(names):
        write_calibration(os.path.join(calib, f"{name}.yaml"), rig.camera_matrices[c],
                          rig.intrinsics[c], rig.distortions[c])
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split, n in splits:
        images, anns, framesets = [], [], {}
        for f in range(n):
            center = rng.uniform(-40.0, 40.0, 3)
            kps = center + rng.uniform(-extent_mm / 2, extent_mm / 2, (joints, 3)) * 0.95
            pix = project_numpy(kps, rig)  # (C, J, 2)
            key = f"Session/Frame_{f}"
            frame_ids = []
            for c, name in enumerate(names):
                img_id = len(images) + 1
                file_name = f"Session/Frame_{f}/{name}.jpg"
                path = os.path.join(root, split, file_name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                coarse = rng.integers(20, 236, (height // 32 + 1, width // 32 + 1, 3),
                                      dtype=np.uint8)
                img = cv2.resize(coarse, (width, height), interpolation=cv2.INTER_LINEAR)
                img = img.astype(np.int16) + rng.integers(-8, 9, img.shape, dtype=np.int16)
                cv2.imwrite(path, np.clip(img, 0, 255).astype(np.uint8))
                images.append({"id": img_id, "file_name": file_name, "width": width,
                               "height": height})
                pts = pix[c]
                lo, hi = pts.min(axis=0) - 10, pts.max(axis=0) + 10
                flat = []
                for j in range(joints):
                    flat += [0.0, 0.0, 0] if j in unlabeled else [float(pts[j, 0]),
                                                                  float(pts[j, 1]), 2]
                anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": 1,
                             "bbox": [float(lo[0]), float(lo[1]), float(hi[0] - lo[0]),
                                      float(hi[1] - lo[1])],
                             "keypoints": flat, "num_keypoints": joints})
                frame_ids.append(img_id)
            framesets[key] = {"datasetName": "Session", "frames": frame_ids}
        doc = {"images": images, "annotations": anns, "framesets": framesets,
               "categories": [{"id": 1, "name": "Subject", "num_keypoints": joints}],
               "calibrations": {"Session": {n_: f"calib_params/Session/{n_}.yaml"
                                            for n_ in names}},
               "keypoint_names": [f"Joint_{j}" for j in range(joints)], "skeleton": [],
               "info": {}, "licenses": []}
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as fh:
            json.dump(doc, fh)
    return root


def write_project(parent, name: str, config: dict) -> str:
    """``projects/<name>/config.yaml`` under ``parent`` with ``config``
    merged on the defaults when the project loads. Returns its path."""
    import yaml

    path = os.path.join(parent, "projects", name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.yaml"), "w") as fh:
        yaml.safe_dump(config, fh)
    return path
