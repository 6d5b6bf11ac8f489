"""The port's project checks (``config/checks.py``) against the JAX package's,
on the CPU.

A synthetic project (``testing.write_dataset3d``: 4 cameras, one dataset
serving as Dataset2D and Dataset3D) loaded by each package's
``ProjectManager``: ``check_config`` gives the same problems in every mode
with good settings (none) and with each broken one; ``train_hybridnet`` and
``train_efficienttrack`` stop on a broken project before any dataset or
trainer is built, as the JAX package's do
(``jarvis_hybridnet_tpu/training/train_interface.py:70-76,114-120``).
"""

import pytest

from jarvis_hybridnet_torch.config.checks import check_config
from jarvis_hybridnet_torch.config.project_manager import ProjectManager
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.training import train_interface
from jarvis_hybridnet_tpu.config.checks import check_config as jax_check_config
from jarvis_hybridnet_tpu.config.project_manager import ProjectManager as JaxProjectManager

pytest.importorskip("cv2")

CONFIG = {
    "DATASET": {"DATASET_2D": "Synth", "DATASET_3D": "Synth"},
    "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": 64},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": 23, "BOUNDING_BOX_SIZE": 128},
    "HYBRIDNET": {"ROI_CUBE_SIZE": 48, "GRID_SPACING": 4, "NUM_CAMERAS": 4},
}
MODES = ("all", "CenterDetect", "KeypointDetect", "HybridNet")
# (section, key, value) of each broken setting
BROKEN = (("DATASET", "DATASET_2D", "Missing"), ("DATASET", "DATASET_3D", "Missing"),
          ("CENTERDETECT", "IMAGE_SIZE", 100), ("CENTERDETECT", "BATCH_SIZE", 0),
          ("KEYPOINTDETECT", "BOUNDING_BOX_SIZE", 96), ("KEYPOINTDETECT", "NUM_JOINTS", 0),
          ("KEYPOINTDETECT", "MAX_LEARNING_RATE", 0.0), ("HYBRIDNET", "ROI_CUBE_SIZE", 40),
          ("HYBRIDNET", "NUM_CAMERAS", 0), ("HYBRIDNET", "NUM_EPOCHS", 0),
          ("HYBRIDNET", "CHECKPOINT_SAVE_INTERVAL", 0))


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, 23,
                    splits=(("train", 1), ("val", 1)), extent_mm=40.0, seed=4)
    write_project(str(root), "P", CONFIG)
    return str(root)


def _cfgs(parent, broken=None):
    cfgs = []
    for pm in (ProjectManager(parent), JaxProjectManager(parent)):
        assert pm.load("P")
        cfg = pm.get_cfg()
        if broken is not None:
            section, key, value = broken
            cfg[section][key] = value
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("broken", (None,) + BROKEN,
                         ids=["good"] + [f"{s}.{k}" for s, k, _ in BROKEN])
def test_check_config_matches_jax(parent, broken):
    port_cfg, jax_cfg = _cfgs(parent, broken)
    found = False
    for mode in MODES:
        got, want = check_config(port_cfg, mode), jax_check_config(jax_cfg, mode)
        assert got == want, (mode, got, want)
        found = found or bool(got)
    assert found == (broken is not None)


def test_training_stops_on_a_broken_project(parent, tmp_path, monkeypatch):
    """``train_hybridnet`` / ``train_efficienttrack`` return False on a
    project whose checks fail, before building a dataset."""
    write_project(str(tmp_path), "P", {**CONFIG, "HYBRIDNET": {**CONFIG["HYBRIDNET"],
                                                               "NUM_CAMERAS": 0},
                                       "CENTERDETECT": {**CONFIG["CENTERDETECT"],
                                                        "IMAGE_SIZE": 100}})
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(tmp_path))

    def built(*args, **kwargs):
        raise AssertionError("a dataset was built for a broken project")

    monkeypatch.setattr(train_interface, "Dataset3D", built)
    monkeypatch.setattr(train_interface, "Dataset2D", built)
    assert train_interface.train_hybridnet("P", 1, None, None, device="cpu") is False
    assert train_interface.train_efficienttrack("CenterDetect", "P", 1, None,
                                                device="cpu") is False
