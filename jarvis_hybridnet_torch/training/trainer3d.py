"""HybridNet (3D) trainer (port of ``jarvis_hybridnet_tpu/training/trainer3d.py``),
on one device, in the freeze modes ``all`` (the default, as JAX's),
``bifpn``, ``last_layers`` and ``3D_only``.

The loop of the JAX trainer (``trainer3d.py:195-383``): masked voxel-MSE
training with AdamW / SGD, OneCycle or plateau schedules, the mm-accuracy
(mean 3D distance to the GT keypoints over labeled joints), a validation pass
every ``VAL_INTERVAL`` epochs, checkpoints every ``CHECKPOINT_SAVE_INTERVAL``
epochs and ``.ckpt`` + ``.pth`` at the end, ``resume_from`` a train state and
a resumable save on preemption.

A step on the card: the batch goes to the device through the pinned staging
pair (``utils/transfer.HostToDevice``); K9 turns the raw uint8 crops into
the normalized input there, with the per-camera color augmentation of the
batch's ``aug`` record on the train split when ``TPU.DEVICE_AUG`` is on (as
the JAX trainer's ``prepare``, trainer3d.py:113-124; no border re-zero in
3D); the 2D net and the reprojection gather run with a graph
in ``all``, ``bifpn`` and ``last_layers`` (the gather's backward is K11, or
K12 in the exact / half / half_fused modes) and without one in ``3D_only``,
where the 2D net is frozen; V2V runs with one; the InstanceNorms of both
nets run through K1 forward and K6 backward (``kernels.InstanceNormAct``).
``optim.apply_freeze`` sets ``requires_grad`` from the mode's labels, so the
frozen tensors stay out of AdamW's updates and weight decay, as JAX's
``set_to_zero`` keeps them. K7 (``kernels.hybridnet_loss``)
builds the Gaussian target from ``kp_vox`` / ``keypoints3D`` and gives the
loss and V2V's output gradient; K3 gives the points for the mm-accuracy.
Step k's loss and points are read back after step k + 1 is dispatched, as
the JAX trainer does. Dropout and drop-connect draw from one
``torch.Generator`` the trainer holds, reseeded from (``seed``, epoch) at
every epoch, so a resumed run draws the masks the uninterrupted run drew.

Not ported yet, and raising: ``TPU.TRAIN_DTYPE`` bfloat16 (ROADMAP.md
A.10b) and the Streamlit monitor (A.13). The loader runs thread workers
whatever ``DATALOADER_WORKER_MODE`` says, and says so when it asks for
process workers (``loader.trainer_worker_mode``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.hybridnet import HybridNetBackbone
from ..models.layers import cast_convs, set_generator
from ..kernels import hybridnet_loss
from ..ops.augment import make_color_aug, record_arrays, record_of
from ..utils import clp
from ..utils.logger import AverageMeter, NetLogger
from ..utils.transfer import HostToDevice
from . import checkpoints, optim

BATCH_KEYS = ("imgs", "center_hm", "center3d", "kp_vox", "keypoints3D",
              "camera_matrices", "intrinsics", "distortions")


def host_batch(b: dict) -> dict:
    """The flat dict of host arrays a step uploads from a collated 3D batch:
    ``BATCH_KEYS`` and, when the batch carries the color record ``aug``, its
    leaves as ``aug.<key>`` (float32; the seeds int32)."""
    out = {k: b[k] for k in BATCH_KEYS}
    if "aug" in b:
        out.update(record_arrays(b["aug"]))
    return out


def calculate_accuracy_mm(points3d: np.ndarray, gt: np.ndarray) -> float:
    """Mean euclidean mm distance over labeled joints
    (hybridnet.py:224-233)."""
    labeled = np.any(gt != 0, axis=-1)
    if not labeled.any():
        return -1.0
    dist = np.linalg.norm(gt - points3d, axis=-1)
    return float(dist[labeled].mean())


def _progress(iterable, total):
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, total=total)


class HybridNetTrainer:
    def __init__(self, mode: str, cfg, weights=None, efficienttrack_weights=None,
                 run_name=None, training_mode: str = "all", device="cuda", seed: int = 2):
        self.cfg = cfg
        self.training_mode = training_mode
        self.device = torch.device(device)
        self.seed = seed
        train_dtype = str(cfg.get("TPU", {}).get("TRAIN_DTYPE", "float32"))
        if train_dtype != "float32":
            raise NotImplementedError(f"TPU.TRAIN_DTYPE {train_dtype!r}: the port trains in "
                                      "float32 only")
        self.model = HybridNetBackbone(
            num_joints=int(cfg.KEYPOINTDETECT.NUM_JOINTS),
            model_size=cfg.KEYPOINTDETECT.MODEL_SIZE,
            roi_cube_size=int(cfg.HYBRIDNET.ROI_CUBE_SIZE),
            grid_spacing=int(cfg.HYBRIDNET.GRID_SPACING),
            repro_mode=str(cfg.get("TPU", {}).get("REPRO_MODE", "exact")),
        )
        if run_name is None:
            run_name = "Run_" + time.strftime("%Y%m%d-%H%M%S")
        self.model_savepath = os.path.join(cfg.savePaths["HybridNet"], run_name)
        os.makedirs(self.model_savepath, exist_ok=True)
        self.logger = NetLogger(os.path.join(cfg.logPaths["HybridNet"], run_name))
        self.lossMeter = AverageMeter()
        self.accuracyMeter = AverageMeter()

        from ..prediction.loaders import init_hybridnet_state

        state = init_hybridnet_state(cfg)
        loaded = checkpoints.load_hybridnet_state(
            cfg, weights, init_state=state, efficienttrack_weights=efficienttrack_weights)
        # None only when an explicitly requested checkpoint failed to load
        self.found_weights = loaded is not None
        self.model.load_state_dict(loaded if loaded is not None else state, strict=True)
        cast_convs(self.model.to(self.device), torch.float32)
        if self.device.type == "cuda":  # float32 at full precision, as the JAX package
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(self.model, self.generator)
        self.color_aug = make_color_aug(cfg.AUGMENTATION, cfg.DATASET.MEAN, cfg.DATASET.STD)

    def set_training_mode(self, mode: str) -> None:
        """'all' | 'bifpn' | 'last_layers' | '3D_only' (reference:
        hybridnet.py:367-388)."""
        self.training_mode = mode

    def _device_aug(self) -> bool:
        return (bool(self.cfg.get("TPU", {}).get("DEVICE_AUG", True))
                and bool(self.cfg.AUGMENTATION.COLOR_MANIPULATION.ENABLED))

    def prepare(self, b: dict) -> torch.Tensor:
        """Raw uint8 crops (B, C, S, S, 3) -> normalized float32 through K9,
        color-augmented first where the batch carries the record."""
        return self.color_aug(b["imgs"], record_of(b))

    def forward(self, b: dict):
        """(loss, points3D) of one batch already on the device."""
        out, points = self.model.train_outputs(
            self.prepare(b), b["center_hm"], b["center3d"], b["camera_matrices"],
            b["intrinsics"], b["distortions"])
        return hybridnet_loss(out, b["kp_vox"], b["keypoints3D"]), points

    def train_step(self, b: dict, optimizer, lr: float):
        """One optimizer step at ``lr``; (loss, points3D) on the device."""
        loss, points = self.forward(b)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optim.set_learning_rate(optimizer, lr)
        optimizer.step()
        return loss.detach(), points

    @torch.no_grad()
    def eval_step(self, b: dict):
        self.model.eval()
        try:
            return self.forward(b)
        finally:
            self.model.train()

    def train(self, training_set, validation_set, num_epochs, start_epoch=0,
              streamlitWidgets=None, resume_from=None) -> dict:
        from ..dataset.loader import DataLoader, maybe_preload, trainer_worker_mode

        cfg = self.cfg.HYBRIDNET
        if streamlitWidgets is not None:
            raise NotImplementedError("the Streamlit monitor is not ported yet (ROADMAP.md A.13)")
        device_aug = (self._device_aug() and training_set.set_name == "train"
                      and not training_set.analysisMode)
        training_set.device_targets = True
        validation_set.device_targets = True
        training_set.device_aug = device_aug
        maybe_preload(self.cfg, training_set, validation_set)

        workers = int(self.cfg.get("DATALOADER_NUM_WORKERS", 4))
        worker_mode = trainer_worker_mode(self.cfg)
        batch = int(cfg.BATCH_SIZE)
        train_loader = DataLoader(training_set, batch_size=batch, shuffle=True,
                                  num_workers=workers, worker_mode=worker_mode)
        val_loader = DataLoader(validation_set, batch_size=batch, shuffle=False,
                                num_workers=workers, worker_mode=worker_mode)
        steps_per_epoch = len(train_loader)
        max_lr = float(cfg.MAX_LEARNING_RATE)
        labels = optim.hybridnet_freeze_labels(self.model, self.training_mode)
        trained = optim.apply_freeze(self.model, labels)
        optimizer = optim.make_optimizer(cfg.OPTIMIZER, trained, max_lr)
        if bool(cfg.USE_ONECYLCLE):
            schedule = optim.onecycle_schedule(max_lr, steps_per_epoch * num_epochs)
            plateau = None
        else:
            schedule = lambda step: max_lr  # noqa: E731
            plateau = optim.PlateauScheduler(max_lr)
        step = 0
        if resume_from is not None:
            state, opt_state, start_epoch = checkpoints.load_train_state(
                resume_from, self.cfg.KEYPOINTDETECT.MODEL_SIZE)
            self.model.load_state_dict(state, strict=True)
            optimizer.load_state_dict(opt_state["optimizer"])
            step = opt_state["step"]
            clp.info(f"Resumed training state from {resume_from} (epoch {start_epoch})")
            if start_epoch >= num_epochs:
                clp.warning(
                    f"Resumed state is already at epoch {start_epoch} of "
                    f"{num_epochs}: training was complete; nothing to do.")
                return {"train_loss": 0, "train_acc": 0, "val_loss": 0,
                        "val_acc": 0, "already_complete": True}
        self.optimizer = optimizer
        self.model.train()

        lr_scale = 1.0
        results = {"train_loss": 0, "train_acc": 0, "val_loss": 0, "val_acc": 0}
        history = {k: [] for k in ("train_loss", "train_acc", "val_loss", "val_acc")}
        results["history"] = history  # per-epoch curves (tests, GUI)

        from ..utils.preemption import POD_POLL_STRIDE, PreemptionGuard

        upload = HostToDevice(self.device)
        guard = PreemptionGuard()

        def to_device(b):
            return upload(host_batch(b))

        # One-step-delayed metric readback (as the JAX trainer): step k + 1
        # is dispatched before step k's loss and points are read.
        pending = None  # (loss, pts, gt_np)

        def consume(p):
            loss, pts, gt = p
            acc = calculate_accuracy_mm(pts.cpu().numpy(), gt)
            self.lossMeter.update(float(loss))
            if acc != -1:
                self.accuracyMeter.update(acc)

        def opt_state():
            return {"optimizer": optimizer.state_dict(), "step": step}

        with guard:
            for epoch in range(start_epoch, num_epochs):
                train_loader.set_epoch(epoch)
                self.generator.manual_seed(
                    int(np.random.SeedSequence([self.seed, epoch]).generate_state(1)[0]))
                bar = _progress(train_loader, steps_per_epoch)
                for b in bar:
                    lr = schedule(step) * lr_scale
                    loss, pts = self.train_step(to_device(b), optimizer, lr)
                    step += 1
                    if guard.should_stop_global(stride=POD_POLL_STRIDE):
                        if pending is not None:
                            consume(pending)
                            pending = None
                        self._save_preempted(opt_state(), epoch)
                        results["preempted"] = True
                        return results
                    if pending is not None:
                        consume(pending)
                    pending = (loss, pts, np.asarray(b["keypoints3D"]))
                    if hasattr(bar, "set_description"):
                        bar.set_description(
                            "Epoch: {}/{}. Loss: {:.4f}. Acc: {:.2f}".format(
                                epoch + 1, num_epochs, self.lossMeter.read(),
                                self.accuracyMeter.read()))
                if pending is not None:  # flush before epoch-end readers
                    consume(pending)
                    pending = None

                if plateau is not None:
                    lr_scale = plateau.step(self.lossMeter.read()) / max_lr

                self.logger.update_train_loss(self.lossMeter.read())
                self.logger.update_train_accuracy(self.accuracyMeter.read())
                results["train_loss"] = self.lossMeter.read()
                results["train_acc"] = self.accuracyMeter.read()
                history["train_loss"].append(results["train_loss"])
                history["train_acc"].append(results["train_acc"])
                self.lossMeter.reset()
                self.accuracyMeter.reset()

                size = self.cfg.KEYPOINTDETECT.MODEL_SIZE
                if (epoch + 1) % int(cfg.CHECKPOINT_SAVE_INTERVAL) == 0 \
                        and epoch + 1 < num_epochs:
                    self.save_checkpoint(f"HybridNet-{size}_Epoch_{epoch + 1}")
                    checkpoints.save_train_state(
                        os.path.join(self.model_savepath, "train_state.ckpt"),
                        self.model.state_dict(), opt_state(), epoch + 1, size)
                if epoch + 1 == num_epochs:
                    self.save_checkpoint(f"HybridNet-{size}_final")

                if epoch % int(cfg.VAL_INTERVAL) == 0:
                    for b in val_loader:
                        loss, pts = self.eval_step(to_device(b))
                        acc = calculate_accuracy_mm(pts.cpu().numpy(),
                                                    np.asarray(b["keypoints3D"]))
                        self.lossMeter.update(float(loss))
                        if acc != -1:
                            self.accuracyMeter.update(acc)
                    print("Val. Epoch: {}/{}. Loss: {:.3f}. Acc: {:.2f}".format(
                        epoch + 1, num_epochs, self.lossMeter.read(),
                        self.accuracyMeter.read()))
                    results["val_loss"] = self.lossMeter.read()
                    results["val_acc"] = self.accuracyMeter.read()
                    history["val_loss"].append(results["val_loss"])
                    history["val_acc"].append(results["val_acc"])
                    self.logger.update_val_loss(self.lossMeter.read())
                    self.logger.update_val_accuracy(self.accuracyMeter.read())
                    self.lossMeter.reset()
                    self.accuracyMeter.reset()

                # a signal during epoch-end work must not start another epoch
                # (unless this was the last one: then training is complete)
                if guard.should_stop_global() and epoch + 1 < num_epochs:
                    self._save_preempted(opt_state(), epoch + 1)
                    results["preempted"] = True
                    return results

        return results

    def _save_preempted(self, opt_state: dict, resume_epoch: int) -> None:
        """Write a full resumable train state; a resumed run restarts the
        interrupted epoch from its beginning."""
        path = os.path.join(self.model_savepath, "train_state.ckpt")
        checkpoints.save_train_state(path, self.model.state_dict(), opt_state, resume_epoch,
                                     self.cfg.KEYPOINTDETECT.MODEL_SIZE)
        clp.warning(f"Training preempted; resumable state saved to "
                    f"{path} (resumes at epoch {resume_epoch + 1})")

    def save_checkpoint(self, name: str) -> None:
        state = self.model.state_dict()
        checkpoints.save_checkpoint(state, os.path.join(self.model_savepath, name + ".ckpt"),
                                    self.cfg.KEYPOINTDETECT.MODEL_SIZE)
        checkpoints.save_torch_checkpoint(state, os.path.join(self.model_savepath,
                                                              name + ".pth"))
