"""Training orchestration (port of
``jarvis_hybridnet_tpu/training/train_interface.py``).

``train_efficienttrack`` loads a project, builds the 2D datasets of a
CenterDetect or KeypointDetect run, resolves the weight spec ('latest' /
None / 'ecoset' / a pretrain name / a path), supports resuming a train
state, and runs :class:`~jarvis_hybridnet_torch.training.trainer2d.
EfficientTrackTrainer`. ``train_hybridnet`` builds the 3D datasets, seeds
the embedded 2D net from a KeypointDetect checkpoint, supports finetune (LR
/ 10, reference train_interface.py:201-203) and resuming, and runs
:class:`~jarvis_hybridnet_torch.training.trainer3d.HybridNetTrainer`. Both
run on ``device``, the card unless the caller asks for the CPU. HybridNet
trains in every freeze mode (``all``, ``bifpn``, ``last_layers``,
``3D_only``); the project's configuration checks (``config/checks.py``) are
not ported yet (ROADMAP.md A.13).
"""

from __future__ import annotations

from ..config.project_manager import ProjectManager
from ..dataset.dataset2d import Dataset2D
from ..dataset.dataset3d import Dataset3D
from ..utils import clp
from .trainer2d import EfficientTrackTrainer
from .trainer3d import HybridNetTrainer


def _resolve_resume(resume, cfg, module):
    """'latest' -> newest run's train_state.ckpt; else a path (or None)."""
    if resume is None or resume == "None":
        return None
    if resume == "latest":
        from .checkpoints import get_latest_train_state

        path = get_latest_train_state(cfg, module)
        if path is None:
            clp.error(f"No resumable train_state.ckpt found for {module}.")
        return path
    return resume


def _report_final(results, acc_unit):
    """False when the run was preempted, so callers stop instead of starting
    the next stage inside the eviction grace window."""
    if results.get("preempted"):
        clp.warning("Training was preempted; a resumable train state was "
                    "saved. Continue with --resume latest.")
        return False
    if results.get("already_complete"):
        clp.info("Nothing to train: the resumed state had already "
                 "completed all epochs.")
        return True
    clp.success("Successfully finished training!")
    print("Final Stats:")
    print(f'Training Loss: {results["train_loss"]}')
    print(f'Training Accuracy [{acc_unit}]: {results["train_acc"]}')
    print(f'Validation Loss: {results["val_loss"]}')
    print(f'Validation Accuracy [{acc_unit}]: {results["val_acc"]}')
    return True


def train_efficienttrack(mode, project_name, num_epochs, weights, run_name=None,
                         streamlit_widgets=None, cameras_to_use=None, resume=None,
                         device="cuda", results=None):
    """mode in {'CenterDetect', 'KeypointDetect'}; True on success
    (reference: jarvis/train_interface.py:52-121). ``resume`` is a
    train_state.ckpt path or 'latest'. ``results``, a dict when given,
    receives the trainer's results (with ``history``) and the trainer
    (``"trainer"``)."""
    project = ProjectManager()
    if not project.load(project_name):
        return False
    cfg = project.get_cfg()
    if num_epochs is None:
        num_epochs = int(cfg[mode.upper()].NUM_EPOCHS)
    clp.info(f"Training {mode} on project {project_name} for {num_epochs} epochs!")

    train_set = Dataset2D(cfg, set="train", mode=mode, cameras_to_use=cameras_to_use)
    val_set = Dataset2D(cfg, set="val", mode=mode, cameras_to_use=cameras_to_use)

    if weights == "None":
        weights = None
    resume_from = _resolve_resume(resume, cfg, mode)
    if resume is not None and resume != "None" and resume_from is None:
        return False
    trainer = EfficientTrackTrainer(mode, cfg, weights=weights, run_name=run_name,
                                    device=device)
    if not trainer.found_weights:
        clp.error("Could not load weights, aborting training!")
        return False
    out = trainer.train(train_set, val_set, num_epochs, streamlitWidgets=streamlit_widgets,
                        resume_from=resume_from)
    if results is not None:
        results.update(out, trainer=trainer)
    return _report_final(out, "px")


def train_hybridnet(project_name, num_epochs, weights_keypoint_detect,
                    weights, mode="3D_only", run_name=None, finetune=False,
                    streamlit_widgets=None, cameras_to_use=None,
                    resume=None, device="cuda", results=None):
    """mode in {'all', 'bifpn', 'last_layers', '3D_only'} (reference:
    jarvis/train_interface.py:124-213). ``resume`` is a
    train_state.ckpt path or 'latest'. ``results``, a dict when given,
    receives the trainer's results (with ``history``) and the trainer
    (``"trainer"``)."""
    project = ProjectManager()
    if not project.load(project_name):
        return False
    cfg = project.get_cfg()
    if num_epochs is None:
        num_epochs = int(cfg.HYBRIDNET.NUM_EPOCHS)
    clp.info(f"Training HybridNet ({mode}) on project {project_name} for "
             f"{num_epochs} epochs!")

    train_set = Dataset3D(cfg, set="train", cameras_to_use=cameras_to_use)
    val_set = Dataset3D(cfg, set="val", cameras_to_use=cameras_to_use)

    if weights_keypoint_detect == "None":
        weights_keypoint_detect = None
    if weights == "None":
        weights = None
    if finetune:
        cfg.HYBRIDNET.MAX_LEARNING_RATE = float(cfg.HYBRIDNET.MAX_LEARNING_RATE) / 10.0

    resume_from = _resolve_resume(resume, cfg, "HybridNet")
    if resume is not None and resume != "None" and resume_from is None:
        return False
    trainer = HybridNetTrainer(
        "train", cfg, weights=weights, efficienttrack_weights=weights_keypoint_detect,
        run_name=run_name, training_mode=mode, device=device)
    out = trainer.train(train_set, val_set, num_epochs,
                        streamlitWidgets=streamlit_widgets, resume_from=resume_from)
    if results is not None:
        results.update(out, trainer=trainer)
    return _report_final(out, "mm")
