"""Synthetic camera rig and configurations for the tests and ``chip_smoke.py``.

The Example_Dataset calibration is not in the repository, so parity tests
and the on-card smoke run use a seeded synthetic rig: cameras on a ring
about 1 m around the origin, looking inward with jittered aim points so the
subject lands off the principal axis, fx ~ fy ~ 1500 px at 1280x1024,
principal points near the image center and nonzero k1/k2. Matrices follow
the repository's conventions: row-vector projection ``[X, Y, Z, 1] @ P``
with P (4, 3), and transposed intrinsics with ``K[2,0] = cx``,
``K[2,1] = cy``.
"""

from __future__ import annotations

from dataclasses import dataclass

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
