"""Camera calibration loading.

Reads per-camera OpenCV ``FileStorage`` YAML calibration files
(``intrinsicMatrix``, ``distortionCoefficients``, ``R``, ``T``) and builds the
4x3 camera matrices used throughout the pipeline, matching the reference's
TorchCamera (jarvis/utils/reprojection.py:93-111) and numpy Camera
(jarvis/dataset/utils.py:102-117).

Conventions (identical to the reference):
  * ``intrinsicMatrix`` as stored in the YAML is the *transposed* K, i.e.
    ``K_t[0,0]=fx, K_t[1,1]=fy, K_t[2,0]=cx, K_t[2,1]=cy``.
  * ``cameraMatrix`` (3x4, numpy layout) = ``([R; T] . K_t)^T``.
  * The stacked per-camera matrices handed to jitted code are the 4x3
    transposes, so projection is ``[x y z 1] @ P`` (reference:
    jarvis/utils/reprojection.py:27-35).
  * Only radial distortion k1, k2 is applied (reference:
    jarvis/hybridnet/repro_layer.py:60-63).

A copy of ``jarvis_hybridnet_tpu/utils/calibration.py``. cv2 and yaml are
imported where a calibration file is read, not with the module: the port's
predictors run on machines that have neither.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


def load_opencv_yaml(path: str) -> dict[str, np.ndarray]:
    """Load all matrices from an OpenCV FileStorage YAML file.

    Uses cv2.FileStorage when cv2 imports; otherwise a small parser for the
    ``%YAML:1.0`` / ``!!opencv-matrix`` dialect.
    """
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        out = {}
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        root = fs.root()
        for key in root.keys():
            node = fs.getNode(key)
            mat = node.mat()
            if mat is not None:
                out[key] = mat
        fs.release()
        return out
    return _parse_opencv_yaml_text(path)


def _parse_opencv_yaml_text(path: str) -> dict[str, np.ndarray]:
    import yaml

    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    text = "\n".join(lines).replace("!!opencv-matrix", "")
    if text.startswith("---"):
        text = text[3:]
    data = yaml.safe_load(text)
    out = {}
    for key, val in data.items():
        if isinstance(val, dict) and {"rows", "cols", "data"} <= set(val):
            out[key] = np.array(val["data"], dtype=np.float64).reshape(
                val["rows"], val["cols"]
            )
    return out


@dataclass
class Camera:
    """A single calibrated camera (reference: jarvis/dataset/utils.py:102)."""

    name: str
    intrinsic: np.ndarray  # 3x3 transposed K (fx at [0,0], cx at [2,0])
    distortion: np.ndarray  # 1x5, only k1/k2 used
    rotation: np.ndarray  # 3x3 R
    position: np.ndarray  # 3 T
    camera_matrix: np.ndarray = field(init=False)  # 3x4 = ([R;T].K_t)^T

    def __post_init__(self):
        rt = np.concatenate(
            [self.rotation, self.position.reshape(1, 3)], axis=0
        )  # 4x3
        self.camera_matrix = (rt @ self.intrinsic).T  # 3x4

    @classmethod
    def from_calib_file(cls, name: str, path: str) -> "Camera":
        mats = load_opencv_yaml(path)
        return cls(
            name=name,
            intrinsic=mats["intrinsicMatrix"].astype(np.float64),
            distortion=mats["distortionCoefficients"].reshape(1, -1).astype(
                np.float64
            ),
            rotation=mats["R"].astype(np.float64),
            position=mats["T"].reshape(3).astype(np.float64),
        )

    @property
    def opencv_K(self) -> np.ndarray:
        """Standard (row-major) OpenCV intrinsic matrix."""
        return self.intrinsic.T


@dataclass
class CameraRig:
    """A set of calibrated cameras with stacked parameter arrays.

    Mirrors the data layout of the reference ReprojectionTool
    (jarvis/utils/reprojection.py:16-46): ``camera_matrices`` is (C, 4, 3)
    so that projection is ``point_h @ P``; ``intrinsics`` is (C, 3, 3)
    transposed-K; ``distortions`` is (C, 1, 5).
    """

    cameras: dict[str, Camera]

    def __post_init__(self):
        cams = list(self.cameras.values())
        self.camera_list = cams
        self.num_cameras = len(cams)
        self.camera_matrices = np.stack(
            [c.camera_matrix.T for c in cams]
        ).astype(np.float32)  # (C, 4, 3)
        self.intrinsics = np.stack([c.intrinsic for c in cams]).astype(
            np.float32
        )  # (C, 3, 3)
        self.distortions = np.stack([c.distortion for c in cams]).astype(
            np.float32
        )  # (C, 1, 5)

    @classmethod
    def from_calib_paths(
        cls, root_dir: str, calib_paths: dict[str, str]
    ) -> "CameraRig":
        cameras = {
            name: Camera.from_calib_file(name, os.path.join(root_dir, rel))
            for name, rel in calib_paths.items()
        }
        return cls(cameras)

    @property
    def camera_names(self) -> list[str]:
        return [c.name for c in self.camera_list]


def discover_camera_names(cfg) -> list[str]:
    """Camera names found in the 3D dataset's calibration tree.

    Lists ``<dataset>/calib_params/<first session>/`` and strips the
    calibration-file extensions (reference:
    jarvis/ui/gui/analyze_gui.py:35-47 and
    jarvis/ui/interactive_cli/analyze_cli.py:71-88, which each re-derive
    this). Returns ``[]`` when no 3D dataset is configured or the tree
    is missing/empty.
    """
    dataset_name = cfg.DATASET.DATASET_3D
    if not dataset_name:
        return []
    if os.path.isabs(dataset_name):
        root = dataset_name
    else:
        root = os.path.join(cfg.PARENT_DIR, cfg.DATASET.DATASET_ROOT_DIR,
                            dataset_name)
    calib_root = os.path.join(root, "calib_params")
    try:
        session = sorted(os.listdir(calib_root))[0]
        return sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(os.path.join(calib_root, session))
        )
    except (OSError, IndexError):
        return []


def load_camera_rigs(
    dataset_dir: str,
    cameras_to_use: list[str] | None = None,
    split: str = "val",
) -> dict[str, CameraRig]:
    """Build one CameraRig per calibration session from the dataset JSON.

    Reference: load_reprojection_tools (jarvis/utils/reprojection.py:149-166).
    """
    import json

    with open(
        os.path.join(dataset_dir, "annotations", f"instances_{split}.json")
    ) as f:
        data = json.load(f)
    rigs = {}
    for session, cams in data["calibrations"].items():
        calib_paths = {
            cam: rel
            for cam, rel in cams.items()
            if cameras_to_use is None or cam in cameras_to_use
        }
        rigs[session] = CameraRig.from_calib_paths(dataset_dir, calib_paths)
    return rigs
