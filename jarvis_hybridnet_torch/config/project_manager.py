"""Project lifecycle management (port of
``jarvis_hybridnet_tpu/config/project_manager.py``; reference
ProjectManager, jarvis/config/project_manager.py:25-348).

Load a project's ``config.yaml`` on top of the defaults and attach its
model and log paths; create a project: its directory tree
(``models/{CenterDetect,KeypointDetect,HybridNet}``, ``logs/...``), the
network parameters suggested by the dataset's statistics, and a
``config.yaml`` written from the commented template beside this file (a
byte-for-byte copy of the JAX package's), patched as the JAX package
patches it, so that both packages write the same text for one dataset.

Unlike the reference (which anchors everything at the installed repo root),
the parent directory is configurable: pass ``parent_dir`` or set
``JARVIS_PARENT_DIR``; defaults to the current working directory.
"""

from __future__ import annotations

import json
import os
import re

from . import defaults
from .cfg_node import CfgNode
from ..utils import clp

_TEMPLATE = os.path.join(os.path.dirname(__file__), "config_template.yaml")
_MODULES = ("CenterDetect", "KeypointDetect", "HybridNet")


class ProjectManager:
    def __init__(self, parent_dir: str | None = None):
        self.cfg = None
        self.parent_dir = os.path.abspath(
            parent_dir
            or os.environ.get("JARVIS_PARENT_DIR")
            or os.getcwd()
        )

    # -- loading -------------------------------------------------------------
    def load(self, project_name: str) -> bool:
        cfg = defaults.get_default_cfg()
        cfg.PROJECT_NAME = project_name
        config_path = os.path.join(
            self.parent_dir, cfg.PROJECTS_ROOT_PATH, project_name, "config.yaml"
        )
        if not os.path.isfile(config_path):
            clp.error(
                "Project does not exist, change name or create new "
                "project by calling create_new(...)."
            )
            return False
        cfg.merge_from_file(config_path)
        self._attach_runtime_paths(cfg, project_name)
        self.cfg = cfg
        clp.success(f"Successfully loaded project {project_name}.")
        return True

    def _attach_runtime_paths(self, cfg: CfgNode, project_name: str) -> None:
        cfg.logPaths = CfgNode()
        cfg.savePaths = CfgNode()
        for module in _MODULES:
            base = os.path.join(
                self.parent_dir, cfg.PROJECTS_ROOT_PATH, project_name
            )
            cfg.savePaths[module] = os.path.join(base, "models", module)
            cfg.logPaths[module] = os.path.join(base, "logs", module)
        cfg.PARENT_DIR = self.parent_dir

    # -- creation ------------------------------------------------------------
    def create_new(
        self,
        name: str,
        dataset2D_path: str,
        dataset3D_path: str | None = None,
        interactive: bool = False,
    ) -> bool:
        """Create a new project directory and its auto-configured
        config.yaml.

        With ``interactive=False`` the suggested dataset-derived parameters
        are taken as they are (the reference asks on the console,
        project_manager.py:220-261).
        """
        cfg = defaults.get_default_cfg()
        project_dir = os.path.join(self.parent_dir, cfg.PROJECTS_ROOT_PATH, name)
        if os.path.isfile(os.path.join(project_dir, "config.yaml")):
            clp.error("Project already exists, change name or delete old project.")
            return False
        if not os.path.isdir(
            os.path.join(self.parent_dir, cfg.DATASET.DATASET_ROOT_DIR, dataset2D_path)
        ) and not os.path.isdir(dataset2D_path):
            clp.error("Dataset2D directory does not exist. Aborting...")
            return False

        cfg.PROJECT_NAME = name
        cfg.DATASET.DATASET_2D = dataset2D_path
        cfg.DATASET.DATASET_3D = dataset3D_path
        cfg.PARENT_DIR = self.parent_dir
        os.makedirs(project_dir, exist_ok=True)
        self._attach_runtime_paths(cfg, name)
        for module in _MODULES:
            os.makedirs(cfg.savePaths[module], exist_ok=True)
            os.makedirs(cfg.logPaths[module], exist_ok=True)

        self.cfg = cfg
        self._init_dataset2D(interactive)
        if dataset3D_path is not None:
            self._init_dataset3D(interactive)
        self._init_config(name)
        clp.success(f"Project {name} created successfully.")
        return True

    def get_cfg(self):
        if self.cfg is None:
            print(
                "No project loaded yet! Call either load(...) or create_new(...)."
            )
        return self.cfg

    def get_projects(self):
        root = os.path.join(self.parent_dir, "projects")
        if not os.path.isdir(root):
            return []
        return sorted(
            d for d in os.listdir(root)
            if os.path.isfile(os.path.join(root, d, "config.yaml"))
        )

    # -- dataset-derived configuration ----------------------------------------
    def _init_dataset2D(self, interactive: bool) -> None:
        from ..dataset.dataset2d import Dataset2D

        dataset2D = Dataset2D(self.cfg, set="train", mode="KeypointDetect",
                              skip_assert=True)
        suggested = dataset2D.get_dataset_config()
        bbox_size = suggested
        if interactive:
            bbox_size = _ask_number(
                f"Use suggested bounding box size of {suggested} px?",
                suggested, div=64,
            )
        self.cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE = int(bbox_size)
        self.cfg.KEYPOINTDETECT.NUM_JOINTS = int(dataset2D.num_keypoints[0])

    def _init_dataset3D(self, interactive: bool) -> None:
        from ..dataset.dataset3d import Dataset3D

        dataset3D = Dataset3D(self.cfg, set="train")
        suggestions = dataset3D.get_dataset_config()
        resolution = suggestions["resolution"]
        bbox = suggestions["bbox"]
        if interactive:
            resolution = _ask_number(
                f"Use suggested grid spacing of {resolution} mm?", resolution
            )
            bbox = int(bbox / (resolution * 4)) * resolution * 4
            bbox = _ask_number(
                f"Use suggested 3D bounding box size of {bbox} mm?",
                bbox, div=resolution * 4,
            )
        self.cfg.HYBRIDNET.ROI_CUBE_SIZE = int(bbox)
        self.cfg.HYBRIDNET.GRID_SPACING = int(resolution)
        self.cfg.HYBRIDNET.NUM_CAMERAS = int(dataset3D.num_cameras)

    # -- template write --------------------------------------------------------
    def _init_config(self, name: str) -> None:
        """Write config.yaml from the commented template, its values patched
        by regular expressions (which keeps the comments verbatim; the
        reference round-trips the template with ruamel,
        project_manager.py:302-336), then the dataset's keypoint names and
        skeleton appended."""
        config_path = os.path.join(
            self.parent_dir, self.cfg.PROJECTS_ROOT_PATH, name, "config.yaml"
        )
        with open(_TEMPLATE) as f:
            text = f.read()

        values = {
            "DATASET_2D": self.cfg.DATASET.DATASET_2D,
            "DATASET_3D": self.cfg.DATASET.DATASET_3D,
            "BOUNDING_BOX_SIZE": self.cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE,
            "NUM_JOINTS": self.cfg.KEYPOINTDETECT.NUM_JOINTS,
            "NUM_CAMERAS": self.cfg.HYBRIDNET.NUM_CAMERAS,
            "ROI_CUBE_SIZE": self.cfg.HYBRIDNET.ROI_CUBE_SIZE,
            "GRID_SPACING": self.cfg.HYBRIDNET.GRID_SPACING,
        }
        for key, value in values.items():
            if value is None:
                continue
            text = re.sub(
                rf"^(\s*{key}:)\s*\S+",
                lambda m, v=value: f"{m.group(1)} {v}",
                text,
                flags=re.MULTILINE,
            )

        # keypoint names and skeleton from the dataset's JSON
        # (reference: project_manager.py:320-332)
        dataset_name = self.cfg.DATASET.DATASET_3D or self.cfg.DATASET.DATASET_2D
        dataset_dir = dataset_name if os.path.isabs(dataset_name) else \
            os.path.join(self.parent_dir, self.cfg.DATASET.DATASET_ROOT_DIR, dataset_name)
        try:
            with open(os.path.join(dataset_dir, "annotations", "instances_val.json")) as f:
                data = json.load(f)
            names = data["keypoint_names"]
            skeleton = [[c["keypointA"], c["keypointB"]] for c in data["skeleton"]]
            self.cfg.KEYPOINT_NAMES = names
            self.cfg.SKELETON = skeleton
            text += "\nKEYPOINT_NAMES:   #List of all keypoint names\n"
            for n in names:
                text += f"- {n}\n"
            text += "\nSKELETON:         #List of all joints (visualization)\n"
            for a, b in skeleton:
                text += f"- - {a}\n  - {b}\n"
        except (OSError, KeyError):
            print("No keypoint names or skeleton defined in this dataset!")

        with open(config_path, "w") as f:
            f.write(text)


def _ask_number(question, default, div=1, bounds=None):
    """Console confirm / override loop (reference: project_manager.py:220-261)."""
    print(question + " (yes/no)")
    while True:
        ans = input()
        if ans in ("yes", "Yes", "y", "Y"):
            return default
        if ans in ("no", "No", "n", "N"):
            break
        print("Please enter either yes or no!")
    while True:
        ans = input("Enter custom value: ")
        if ans.isdigit() and int(ans) % div == 0:
            v = int(ans)
            if bounds is None or (bounds[0] <= v <= bounds[1]):
                return v
            print(f"Please enter a number between {bounds[0]} and {bounds[1]}!")
        else:
            print(f"Please enter a number divisible by {div}!")
