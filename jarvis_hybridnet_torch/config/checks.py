"""Config sanity checks (a copy of ``jarvis_hybridnet_tpu/config/checks.py``).

Equivalent of the reference GUI's check_config_* functions
(jarvis/ui/gui/train_gui.py:273-388), reusable from any frontend: each
check returns a list of human-readable problems (empty = valid). The
training entry points (``training/train_interface.py``) stop on any.
"""

from __future__ import annotations

import os


def _dataset_path(cfg, name):
    if name is None:
        return None
    if os.path.isabs(name):
        return name
    return os.path.join(cfg.PARENT_DIR, cfg.DATASET.DATASET_ROOT_DIR, name)


def check_dataset2d(cfg) -> list[str]:
    path = _dataset_path(cfg, cfg.DATASET.DATASET_2D)
    if path is None or not os.path.isdir(path):
        return ["Dataset2D does not exist, please check path!"]
    return []


def check_dataset3d(cfg) -> list[str]:
    path = _dataset_path(cfg, cfg.DATASET.DATASET_3D)
    if path is None or not os.path.isdir(path):
        return ["Dataset3D does not exist, please check path!"]
    return []


def _check_common(section, name) -> list[str]:
    problems = []
    if section.BATCH_SIZE <= 0:
        problems.append(f"{name} batch size has to be bigger than 0!")
    if section.MAX_LEARNING_RATE <= 0:
        problems.append(f"{name} learning rate has to be bigger than 0!")
    if section.NUM_EPOCHS <= 0:
        problems.append(f"{name} number of epochs has to be bigger than 0!")
    if section.CHECKPOINT_SAVE_INTERVAL <= 0:
        problems.append(
            f"{name} checkpoint save interval has to be bigger than 0!")
    return problems


def check_center_detect(cfg) -> list[str]:
    problems = _check_common(cfg.CENTERDETECT, "CenterDetect")
    size = cfg.CENTERDETECT.IMAGE_SIZE
    if size <= 0 or size % 64 != 0:
        problems.append("CenterDetect image size has to be bigger than 0 "
                        "and divisible by 64!")
    return problems


def check_keypoint_detect(cfg) -> list[str]:
    problems = _check_common(cfg.KEYPOINTDETECT, "KeypointDetect")
    bbox = cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE
    if bbox <= 0 or bbox % 64 != 0:
        problems.append("KeypointDetect bounding box size has to be bigger "
                        "than 0 and divisible by 64!")
    if cfg.KEYPOINTDETECT.NUM_JOINTS <= 0:
        problems.append(
            "KeypointDetect number of joints has to be bigger than 0!")
    return problems


def check_hybridnet(cfg) -> list[str]:
    problems = _check_common(cfg.HYBRIDNET, "HybridNet")
    cube = cfg.HYBRIDNET.ROI_CUBE_SIZE
    spacing = cfg.HYBRIDNET.GRID_SPACING
    if cube is None or spacing is None:
        problems.append("HybridNet ROI_CUBE_SIZE / GRID_SPACING not set!")
    elif cube % (spacing * 4) != 0:
        problems.append("HybridNet ROI_CUBE_SIZE has to be divisible by "
                        "4 * GRID_SPACING!")
    if cfg.HYBRIDNET.NUM_CAMERAS <= 0:
        problems.append("HybridNet number of cameras has to be bigger than 0!")
    return problems


def check_config(cfg, mode: str = "all") -> list[str]:
    """mode in {'all', 'CenterDetect', 'KeypointDetect', 'HybridNet'}."""
    problems: list[str] = []
    if mode in ("all", "CenterDetect", "KeypointDetect"):
        problems += check_dataset2d(cfg)
    if mode in ("all", "HybridNet"):
        problems += check_dataset3d(cfg)
    if mode in ("all", "CenterDetect"):
        problems += check_center_detect(cfg)
    if mode in ("all", "KeypointDetect"):
        problems += check_keypoint_detect(cfg)
    if mode in ("all", "HybridNet"):
        problems += check_hybridnet(cfg)
    return problems
