"""Project loading (the part of the reference ProjectManager,
jarvis/config/project_manager.py:25-348, that the prediction drivers need).

A copy of ``load``, ``_attach_runtime_paths`` and ``get_cfg`` from
``jarvis_hybridnet_tpu/config/project_manager.py``: load a project's
``config.yaml`` on top of the defaults and attach its model and log paths.
Creating a project is a surface of the JAX package that the port does not
have yet.

Unlike the reference (which anchors everything at the installed repo root),
the parent directory is configurable: pass ``parent_dir`` or set
``JARVIS_PARENT_DIR``; defaults to the current working directory.
"""

from __future__ import annotations

import os

from . import defaults
from .cfg_node import CfgNode
from ..utils import clp

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
                "project with the JAX package's ProjectManager.create_new(...)."
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

    def get_cfg(self):
        if self.cfg is None:
            print(
                "No project loaded yet! Call load(...) first."
            )
        return self.cfg
