"""EfficientTrack (2D) trainer (port of
``jarvis_hybridnet_tpu/training/trainer2d.py``), on one device.

CenterDetect or KeypointDetect training as the JAX trainer does it
(``trainer2d.py:63-442``): AdamW / SGD with the OneCycle or plateau
schedules, the summed two-scale heatmap MSE, the px-accuracy of the stride-2
argmax (the reference's ``(pred + 0.5) * 2`` decode), a validation pass every
``VAL_INTERVAL`` epochs, checkpoints every ``CHECKPOINT_SAVE_INTERVAL``
epochs and ``EfficientTrack-<size>_final`` (``.ckpt`` + ``.pth``) at the end,
``resume_from`` a train state.

A step on the card: the batch (raw uint8 images, the (B, J, 2) keypoints
and, on the train split with ``TPU.DEVICE_AUG``, the per-sample color record
with the affine's inverse map) goes to the device through the pinned
staging pair (``utils/transfer.HostToDevice``); K9 turns the images into the
normalized input (color augmentation, border re-zero and normalize in one
launch); the network runs forward in training mode, its InstanceNorms
through K1 and K6, drop-connect drawn from the trainer's ``torch.Generator``;
K8 builds both targets and gives the loss and the heads' gradients; the
optimizer steps; K10 gives the stride-2 argmax for the px meter. Step k's
loss and argmax are read back after step k + 1 is dispatched, as the JAX
trainer does.

With ``graph=True`` (the default, the counterpart of JAX's ``jax.jit``) each
train step (forward, backward, AdamW / SGD, K10) and each eval step on the
card is one replay of a CUDA graph captured per batch shape and train /
eval (``training/graphed.py``), taking the eager run's updates, learning
rates and random draws step for step; ``graph=False`` launches the step op
by op. On the CPU both run the step as it is.

Preemption contract: a resumed run equals the uninterrupted one. The
generator is reseeded from (``seed``, epoch) at every epoch and the loader's
order follows (seed, epoch), so an epoch replays from its start. A stop
request seen at an epoch's end saves the state after that epoch; one seen
inside an epoch saves the state the epoch started from (kept on the device
at every epoch start: parameters, optimizer state and step count), and the
resumed run redoes that epoch whole. The JAX trainer saves the mid-epoch
parameters instead, so its resumed run replays part of an epoch on them.
The host-side augmentation draws of thread workers are not replayed.

At ``TPU.TRAIN_DTYPE: bfloat16`` (JAX's mixed precision) the parameters,
the optimizer's state and the checkpoints stay float32 and the network
computes in bf16 (``layers.set_compute_dtype``); K8 reads the bf16 heads,
keeps its loss in float32 and writes their gradients in bf16.

Several processes (``torchrun --nproc_per_node=N``, ``parallel/``): with
``WORLD_SIZE`` > 1 the trainer joins the world (NCCL on the card, or it
raises) and runs data-parallel over it when ``BATCH_SIZE`` divides across
the ranks (``auto_data_mesh``, the JAX trainer's rule; else rank 0 trains
alone); ``mesh=`` gives one explicitly (gloo needs ``graph=False`` on the
card). Each rank loads its slice of every global batch
(``multihost.make_dp_loaders``), and the step
(``train_step.make_data_parallel_train_step``) averages the gradients and
the loss over the ranks in one all-reduce, inside the CUDA graph under
NCCL; drop-connect keeps the rank's part of the global batch's draws.
Rank 0 alone writes checkpoints, train states and logs; a stop signalled
on any rank stops every rank at the same step.

Not ported, and raising: the Streamlit monitor (ROADMAP.md A.13). The loader runs
thread workers whatever ``DATALOADER_WORKER_MODE`` says, and says so when it
asks for process workers (``loader.trainer_worker_mode``).
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from ..kernels import heatmap2d_loss
from ..models.efficienttrack import EfficientTrackBackbone
from ..models.layers import DrawShard, cast_convs, set_compute_dtype, set_draw_shard, set_generator
from ..models.weights import params_from_jax, params_to_jax
from ..ops.augment import make_color_aug, record_arrays, record_of
from ..ops.heatmap import argmax_2d
from ..parallel import multihost
from ..parallel.mesh import auto_data_mesh
from ..parallel.train_step import global_loss, make_data_parallel_train_step
from ..utils import clp
from ..utils.logger import AverageMeter, NetLogger, NullLogger
from ..utils.preemption import is_primary_host
from ..utils.transfer import HostToDevice
from . import checkpoints, graphed, optim

SIGMA_BASE = {"CenterDetect": 1.0, "KeypointDetect": 1.5}  # trainer2d.py:130


def heatmap_loss(outputs, targets) -> torch.Tensor:
    """Per-scale mean MSE, summed (the JAX package's ``heatmap_loss``,
    trainer2d.py:31; reference efficienttrack.py:266-271), on tensors of one
    layout. The train step computes it inside K8 instead."""
    total = 0.0
    for out, tgt in zip(outputs, targets):
        total = total + (out - tgt).square().mean()
    return total


def accuracy_from_preds(preds: np.ndarray, gt: np.ndarray) -> float:
    """Mean px distance of the stride-2 argmax decode to the GT
    (efficienttrack.py:383-396). preds: (B, J, 2) argmax coordinates on the
    stride-2 heatmap; gt: (B, J, 2) input-resolution px; joints at (0, 0)
    are unlabeled. -1 when none is labeled."""
    mask = gt.sum(axis=2)
    dist = np.linalg.norm((preds + 0.5) * 2 - gt, axis=2)
    masked = np.ma.masked_where(mask == 0, dist)
    if masked.mask.all():
        return -1.0
    return float(np.nanmean(masked))


def calculate_accuracy(heatmaps: np.ndarray, gt: np.ndarray) -> float:
    """:func:`accuracy_from_preds` of raw heatmaps (B, H, W, J)."""
    B, H, W, J = heatmaps.shape
    flat = heatmaps.transpose(0, 3, 1, 2).reshape(B, J, -1)
    m = flat.argmax(axis=2)
    preds = np.stack([m % W, m // W], axis=-1)
    return accuracy_from_preds(preds, gt)


def _progress(iterable, total):
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, total=total)


def host_batch(b) -> tuple[dict, np.ndarray]:
    """A collated 2D batch ``(imgs, keypoints[, aug])`` as the flat dict of
    host arrays the step uploads (``imgs``, ``kxy`` (B, J, 2) contiguous,
    and ``aug.<key>`` / ``minv`` when the record is there; the seeds as
    int32), and the GT (B, J, 2) for the px meter."""
    imgs, kps = np.asarray(b[0]), np.asarray(b[1], np.float32)
    kxy = np.ascontiguousarray(kps.reshape(kps.shape[0], -1, 3)[..., :2])
    out = {"imgs": imgs, "kxy": kxy}
    if len(b) > 2:
        out.update(record_arrays(b[2]), minv=np.asarray(b[2]["minv"], np.float32))
    return out, kxy


class EfficientTrackTrainer:
    def __init__(self, mode: str, cfg, weights=None, run_name=None, device="cuda",
                 seed: int = 1, graph: bool = True, mesh="auto"):
        if mode not in SIGMA_BASE:
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.main_cfg = cfg
        self.cfg = cfg[mode.upper()]
        if isinstance(mesh, str):  # "auto": the JAX trainer's mesh over the world
            mesh = None
            if multihost.world_size() > 1:
                multihost.initialize_distributed()
                mesh = auto_data_mesh(int(self.cfg.BATCH_SIZE))
        self.mesh = mesh
        self.idle = (mesh is not None and not mesh.member) or (
            mesh is None and not is_primary_host())
        self.primary = is_primary_host()
        graphed.check_capturable(graph, device, mesh)
        self.device = graphed.rank_device(device) if mesh is not None else torch.device(device)
        self.seed = seed
        # float32 masters computing in bf16 at TPU.TRAIN_DTYPE bfloat16, as JAX's
        # dtype=jnp.bfloat16 with param_dtype float32
        train_dtype = str(cfg.get("TPU", {}).get("TRAIN_DTYPE", "float32"))
        self.dtype = torch.bfloat16 if train_dtype == "bfloat16" else torch.float32
        self.model = EfficientTrackBackbone(self.cfg.MODEL_SIZE, int(self.cfg.NUM_JOINTS))
        if run_name is None:
            run_name = "Run_" + time.strftime("%Y%m%d-%H%M%S")
        self.model_savepath = os.path.join(cfg.savePaths[mode], run_name)
        if self.primary:
            os.makedirs(self.model_savepath, exist_ok=True)
            self.logger = NetLogger(os.path.join(cfg.logPaths[mode], run_name))
        else:
            self.logger = NullLogger()
        self.lossMeter = AverageMeter()
        self.accuracyMeter = AverageMeter()
        self.input_size = int(self.cfg.IMAGE_SIZE if mode == "CenterDetect"
                              else cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE)

        from ..prediction.loaders import init_efficienttrack_state

        state = init_efficienttrack_state(cfg, mode)
        loaded = checkpoints.load_efficienttrack_state(cfg, mode, weights, init_state=state)
        self.found_weights = loaded is not None or weights is None
        # the reference's dead parameters (final_conv2, the stage < 4 expand
        # convs) are zeros, as the JAX package's trees synthesize them: a
        # resumed run reads them back so
        state = params_from_jax(params_to_jax(loaded if loaded is not None else state,
                                              self.cfg.MODEL_SIZE), self.cfg.MODEL_SIZE)
        self.model.load_state_dict(state, strict=True)
        set_compute_dtype(cast_convs(self.model.to(self.device), torch.float32), self.dtype)
        if self.device.type == "cuda":  # float32 at full precision, as the JAX package
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(self.model, self.generator)
        if mesh is not None and mesh.member:
            set_draw_shard(self.model, DrawShard(mesh.n_data, mesh.data_index))
        self.graphs = graphed.TrainGraphs(self.device, self.generator, enabled=graph)
        self.color_aug = make_color_aug(cfg.AUGMENTATION, cfg.DATASET.MEAN, cfg.DATASET.STD)

    def _device_aug(self) -> bool:
        """True when the color pipeline runs in the train step (TPU.DEVICE_AUG
        with color manipulation enabled): the host then does only the
        mirror / affine half and ships the per-sample parameter record."""
        return (bool(self.main_cfg.get("TPU", {}).get("DEVICE_AUG", True))
                and bool(self.main_cfg.AUGMENTATION.COLOR_MANIPULATION.ENABLED))

    def prepare(self, b: dict) -> torch.Tensor:
        """Raw uint8 images (B, S, S, 3) on the device -> the normalized input
        (B, 3, S, S) in channels-last memory, through K9: with the batch's
        color record (``aug.*``, ``minv``) the color augmentation and the
        warp-border re-zero first (trainer2d.py:140-148)."""
        return self.color_aug(b["imgs"], record_of(b), b.get("minv")).permute(0, 3, 1, 2)

    def forward(self, b: dict):
        """(loss, the stride-2 head) of one batch already on the device."""
        out4, out2 = self.model(self.prepare(b))
        loss = heatmap2d_loss(out4, out2, b["kxy"], self.input_size, SIGMA_BASE[self.mode])
        return loss, out2

    def train_step(self, b: dict, optimizer, lr: float):
        """One optimizer step at ``lr``; (loss, stride-2 argmax (B, J, 2)) on
        the device, a graph replay on the card with ``graph=True``."""
        optim.set_learning_rate(optimizer, lr)
        return self.graphs.run("train", (optimizer, self.model.training, self.dtype),
                               lambda: self._train_fn(optimizer), b)

    def _train_fn(self, optimizer):
        sharded = (make_data_parallel_train_step(self, optimizer, self.mesh)
                   if self.mesh is not None else None)

        def step(b: dict):
            if sharded is not None:
                loss, out2 = sharded(b)
                return loss, argmax_2d(out2.permute(0, 2, 3, 1))[0]
            loss, out2 = self.forward(b)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optim.fill_missing_grads(optimizer)
            optimizer.step()
            xy, _ = argmax_2d(out2.detach().permute(0, 2, 3, 1))
            return loss.detach(), xy

        return step

    @torch.no_grad()
    def eval_step(self, b: dict):
        """(loss, stride-2 argmax) of one batch in ``eval()``, a graph replay
        on the card with ``graph=True``."""
        return self.graphs.run("eval", (self.dtype,), lambda: self._eval_fn, b)

    def _eval_fn(self, b: dict):
        self.model.eval()
        try:
            loss, out2 = self.forward(b)
        finally:
            self.model.train()
        if self.mesh is not None:
            loss = global_loss(loss, self.mesh, 1.0 / self.mesh.n_data)
        return loss, argmax_2d(out2.permute(0, 2, 3, 1))[0]

    def train(self, training_set, validation_set, num_epochs, start_epoch=0,
              streamlitWidgets=None, resume_from=None) -> dict:
        from ..dataset.loader import maybe_preload, trainer_worker_mode

        cfg = self.cfg
        if streamlitWidgets is not None:
            raise NotImplementedError("the Streamlit monitor is not ported yet (ROADMAP.md A.13)")
        if self.idle:
            clp.info("this rank is outside the training mesh and idles")
            return {"idle": True}
        training_set.device_targets = True
        validation_set.device_targets = True
        training_set.device_aug = self._device_aug() and training_set.set_name == "train"
        maybe_preload(self.main_cfg, training_set, validation_set)

        workers = int(self.main_cfg.get("DATALOADER_NUM_WORKERS", 4))
        worker_mode = trainer_worker_mode(self.main_cfg)
        batch = int(cfg.BATCH_SIZE)
        self.graphs.reset()  # graphs live for one call, as JAX's jitted closures
        train_loader, val_loader = multihost.make_dp_loaders(
            training_set, validation_set, batch, workers, self.mesh, drop_last=True,
            worker_mode=worker_mode)
        steps_per_epoch = len(train_loader)
        max_lr = float(cfg.MAX_LEARNING_RATE)
        optimizer = optim.make_optimizer(cfg.OPTIMIZER, list(self.model.parameters()), max_lr)
        use_onecycle = bool(cfg.USE_ONECYLCLE)
        if use_onecycle:
            schedule = optim.onecycle_schedule(max_lr, steps_per_epoch * num_epochs)
            plateau = None
        else:
            schedule = lambda step: max_lr  # noqa: E731
            plateau = optim.PlateauScheduler(max_lr)
        step = 0
        if resume_from is not None:
            state, opt_state, start_epoch = checkpoints.load_train_state(
                resume_from, cfg.MODEL_SIZE)
            self.model.load_state_dict(state, strict=True)
            optim.load_optimizer_state(optimizer, opt_state["optimizer"])
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
        guard = PreemptionGuard(group=None if self.mesh is None else self.mesh.group,
                                device=self.device if self.mesh is not None
                                and self.mesh.backend == "nccl" else "cpu")

        def to_device(b):
            arrays, gt = host_batch(b)
            return upload(arrays), gt

        # One-step-delayed metric readback (as the JAX trainer): step k + 1
        # is dispatched before step k's loss and argmax are read.
        pending = None  # (loss, preds, gt)

        def consume(p):
            loss, preds, gt = p
            acc = accuracy_from_preds(multihost.local_np(preds), gt)
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
                # the state this epoch starts from, for a stop inside it
                start = ({k: v.clone() for k, v in self.model.state_dict().items()},
                         copy.deepcopy(optimizer.state_dict()), step)
                bar = _progress(train_loader, steps_per_epoch) if self.primary else train_loader
                for b in bar:
                    batch_dev, gt = to_device(b)
                    loss, preds = self.train_step(batch_dev, optimizer,
                                                  schedule(step) * lr_scale)
                    step += 1
                    if guard.should_stop_global(stride=POD_POLL_STRIDE):
                        pending = None
                        self._save_preempted(start[0], {"optimizer": start[1],
                                                        "step": start[2]}, epoch)
                        results["preempted"] = True
                        return results
                    if pending is not None:
                        consume(pending)
                    pending = (loss, preds, gt)
                    if hasattr(bar, "set_description"):
                        bar.set_description(
                            "Epoch: {}/{}. Loss: {:.5f}. Acc: {:1.3f}".format(
                                epoch + 1, num_epochs, self.lossMeter.read(),
                                self.accuracyMeter.read()))
                if pending is not None:  # flush before epoch-end readers
                    consume(pending)
                    pending = None

                if plateau is not None:
                    lr_scale = plateau.step(self.lossMeter.read()) / max_lr
                self.logger.update_learning_rate(schedule(step) if use_onecycle else plateau.lr)
                self.logger.update_train_loss(self.lossMeter.read())
                self.logger.update_train_accuracy(self.accuracyMeter.read())
                results["train_loss"] = self.lossMeter.read()
                results["train_acc"] = self.accuracyMeter.read()
                history["train_loss"].append(results["train_loss"])
                history["train_acc"].append(results["train_acc"])
                self.lossMeter.reset()
                self.accuracyMeter.reset()

                if (epoch + 1) % int(cfg.CHECKPOINT_SAVE_INTERVAL) == 0 \
                        and epoch + 1 < num_epochs and self.primary:
                    self.save_checkpoint(f"EfficientTrack-{cfg.MODEL_SIZE}_Epoch_{epoch + 1}")
                    checkpoints.save_train_state(
                        os.path.join(self.model_savepath, "train_state.ckpt"),
                        self.model.state_dict(), opt_state(), epoch + 1, cfg.MODEL_SIZE)
                if epoch + 1 == num_epochs:
                    self.save_checkpoint(f"EfficientTrack-{cfg.MODEL_SIZE}_final")

                if (epoch + 1) % int(cfg.VAL_INTERVAL) == 0:
                    for b in val_loader:
                        batch_dev, gt = to_device(b)
                        loss, preds = self.eval_step(batch_dev)
                        acc = accuracy_from_preds(multihost.local_np(preds), gt)
                        self.lossMeter.update(float(loss))
                        if acc != -1:
                            self.accuracyMeter.update(acc)
                    if self.primary:
                        print("Val. Epoch: {}/{}. Loss: {:1.5f}. Acc: {:1.3f}".format(
                            epoch + 1, num_epochs, self.lossMeter.read(),
                            self.accuracyMeter.read()))
                    results["val_loss"] = self.lossMeter.read()
                    results["val_acc"] = self.accuracyMeter.read()
                    if np.isnan(results["val_acc"]):
                        results["val_acc"] = 0
                    history["val_loss"].append(results["val_loss"])
                    history["val_acc"].append(results["val_acc"])
                    self.logger.update_val_loss(self.lossMeter.read())
                    self.logger.update_val_accuracy(self.accuracyMeter.read())
                    self.lossMeter.reset()
                    self.accuracyMeter.reset()

                # a signal during epoch-end work must not start another epoch
                # (unless this was the last one: then training is complete)
                if guard.should_stop_global() and epoch + 1 < num_epochs:
                    self._save_preempted(self.model.state_dict(), opt_state(), epoch + 1)
                    results["preempted"] = True
                    return results

        return results

    def _save_preempted(self, state: dict, opt_state: dict, resume_epoch: int) -> None:
        """Write a resumable train state: the run resumes at the start of
        epoch ``resume_epoch`` from ``state`` (rank 0)."""
        if not self.primary:
            return
        path = os.path.join(self.model_savepath, "train_state.ckpt")
        checkpoints.save_train_state(path, state, opt_state, resume_epoch, self.cfg.MODEL_SIZE)
        clp.warning(f"Training preempted; resumable state saved to "
                    f"{path} (resumes at epoch {resume_epoch + 1})")

    def save_checkpoint(self, name: str) -> None:
        if not self.primary:
            return
        state = self.model.state_dict()
        checkpoints.save_checkpoint(state, os.path.join(self.model_savepath, name + ".ckpt"),
                                    self.cfg.MODEL_SIZE)
        checkpoints.save_torch_checkpoint(state, os.path.join(self.model_savepath,
                                                              name + ".pth"))
