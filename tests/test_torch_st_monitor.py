"""The trainers' Streamlit monitor (``utils/st_monitor``) against the JAX
package's, on the CPU, with recording widgets in place of Streamlit's.

- The port's ``StreamlitTrainingMonitor`` and JAX's, driven by the same
  calls with the same history on every prefix of the five-widget protocol:
  identical call logs.
- A tiny CPU run of each port trainer (HybridNet in 3D_only, KeypointDetect;
  2 epochs of the val split, no host augmentation) with five recording
  widgets: the calls JAX's trainer makes, in its order and number (one
  ``markdown`` at the start, one ``step`` a step with the epoch's fraction,
  one ``epoch`` an epoch with the fractions, the markdown and the curves of
  the run's history so far), as JAX's monitor makes them when driven by
  JAX's trainer loop (``trainer2d.py:279-403``, ``trainer3d.py:263-380``),
  and as ``chip_smoke.monitor_expected`` computes them for the card's check.
"""

import numpy as np
import pytest

import chip_smoke
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.utils.st_monitor import StreamlitTrainingMonitor
from jarvis_hybridnet_tpu.utils.st_monitor import StreamlitTrainingMonitor as JaxMonitor
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _widgets(n: int = 5):
    """``n`` recording widgets (``chip_smoke.RecordingWidget``, the card's
    monitor check) sharing one call log."""
    from chip_smoke import RecordingWidget

    log: list = []
    return [RecordingWidget(i, log) for i in range(n)], log


HISTORY = {"train_loss": [3.0, 2.5, 2.25], "train_acc": [9.0, 8.0, 7.5],
           "val_loss": [2.8, 2.6, 2.4], "val_acc": [8.5, 8.1, 7.7]}


def _drive(monitor, epochs: int, steps: int, history: dict) -> None:
    """The trainers' protocol: ``start``, a ``step`` a step, an ``epoch`` an
    epoch with the history so far."""
    monitor.start(epochs)
    for epoch in range(epochs):
        for count in range(steps):
            monitor.step(count, steps)
        monitor.epoch(epoch, epochs, {k: v[:epoch + 1] for k, v in history.items()})


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("mode,unit", [("HybridNet", "mm"), ("KeypointDetect", "px")])
def test_monitor_matches_jax(n, mode, unit):
    port, port_log = _widgets(n)
    ref, ref_log = _widgets(n)
    _drive(StreamlitTrainingMonitor(port, mode, acc_unit=unit), 3, 4, HISTORY)
    _drive(JaxMonitor(ref, mode, acc_unit=unit), 3, 4, HISTORY)
    assert port_log == ref_log
    assert len(port_log) == {0: 0, 1: 3, 2: 15, 3: 19, 5: 25}[n]
    # no widgets at all (the trainers' default) drives nothing
    _drive(StreamlitTrainingMonitor(None, mode), 2, 2, HISTORY)


def _expected(mode: str, unit: str, epochs: int, steps: int, history: dict) -> list:
    widgets, log = _widgets()
    _drive(JaxMonitor(widgets, mode, acc_unit=unit), epochs, steps, history)
    return log


def test_hybridnet_trainer_drives_the_monitor_as_jax(parent3d, monkeypatch):
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer
    from tests.test_torch_training import HYBRID, _cfg

    root = parent3d
    monkeypatch.setenv("JARVIS_PARENT_DIR", root)
    cfg = _cfg(root, VAL_INTERVAL=1)
    ds, val = Dataset3D(cfg, set="val"), Dataset3D(cfg, set="val")
    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name="Monitor",
                               training_mode="3D_only")
    widgets, log = _widgets()
    history = trainer.train(ds, val, 2, streamlitWidgets=widgets)["history"]
    assert len(history["train_loss"]) == len(history["val_loss"]) == 2
    assert np.isfinite(history["train_loss"]).all()
    assert log == _expected("HybridNet", "mm", 2, len(ds), history)
    assert log == chip_smoke.monitor_expected("HybridNet", "mm", 2, len(ds), history)


def test_efficienttrack_trainer_drives_the_monitor_as_jax(parent2d, monkeypatch):
    from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
    from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer
    from tests.test_torch_training2d import _cfg

    root = parent2d
    monkeypatch.setenv("JARVIS_PARENT_DIR", root)
    cfg = _cfg(root)
    cfg.KEYPOINTDETECT.VAL_INTERVAL = 1
    ds = Dataset2D(cfg, set="val", mode="KeypointDetect")
    val = Dataset2D(cfg, set="val", mode="KeypointDetect")
    trainer = EfficientTrackTrainer("KeypointDetect", cfg, weights=None, device="cpu",
                                    run_name="Monitor")
    widgets, log = _widgets()
    history = trainer.train(ds, val, 2, streamlitWidgets=widgets)["history"]
    steps = len(ds) // int(cfg.KEYPOINTDETECT.BATCH_SIZE)
    assert steps >= 2 and len(history["val_acc"]) == 2
    assert log == _expected("KeypointDetect", "px", 2, steps, history)
    assert log == chip_smoke.monitor_expected("KeypointDetect", "px", 2, steps, history)


@pytest.fixture(scope="module")
def parent3d(tmp_path_factory):
    """The synthetic project of ``test_torch_training.py`` (4 cameras, 128^2
    crops, 23 joints) with a val split of two framesets."""
    pytest.importorskip("cv2")
    from tests.test_torch_training import CONFIG

    root = tmp_path_factory.mktemp("monitor3d")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, 23,
                    splits=(("train", 1), ("val", 2)), extent_mm=40.0, seed=4, unlabeled=(7,))
    write_project(str(root), "P", CONFIG)
    return str(root)


@pytest.fixture(scope="module")
def parent2d(tmp_path_factory):
    """The synthetic project of ``test_torch_training2d.py`` (64^2 inputs,
    batch 2, 3 joints)."""
    pytest.importorskip("cv2")
    from tests.test_torch_training2d import CONFIG, J

    root = tmp_path_factory.mktemp("monitor2d")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, J,
                    splits=(("train", 1), ("val", 1)), extent_mm=40.0, seed=8)
    write_project(str(root), "P", CONFIG)
    return str(root)
