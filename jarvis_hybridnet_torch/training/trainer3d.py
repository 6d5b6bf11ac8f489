"""HybridNet (3D) trainer (port of ``jarvis_hybridnet_tpu/training/trainer3d.py``),
on one device or a (data, cameras) mesh of processes, in the freeze modes
``all`` (the default, as JAX's), ``bifpn``, ``last_layers`` and
``3D_only``.

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

With ``graph=True`` (the default, the counterpart of JAX's ``jax.jit``) each
train step (forward, backward, AdamW / SGD, points) and each eval step on
the card is one replay of a CUDA graph captured per batch shape, freeze
mode and train / eval (``training/graphed.py``), taking the eager run's
updates, learning rates and random draws step for step; ``graph=False``
launches the step op by op. On the CPU both run the step as it is.

At ``TPU.TRAIN_DTYPE: bfloat16`` (JAX's mixed precision) the parameters,
the optimizer's state and the checkpoints stay float32, and both nets
compute in bf16 (``layers.set_compute_dtype``): every convolution casts its
input, weight and bias to bf16 in each call, V2V's fused front kernels are
transformed from the float32 weight and rounded once, the heatmap rows are
gathered as bf16 (K11 / K12 sum their gradient in float32 and round it
once), and the loss (K7) and the points (K3) read V2V's output cast to
float32, as JAX's softplus does.

Several processes (``torchrun --nproc_per_node=N``, ``parallel/``): with
``WORLD_SIZE`` > 1 the trainer joins the world (NCCL on the card, or it
raises) and meshes it as the JAX trainer does
(``auto_train_mesh(BATCH_SIZE, NUM_CAMERAS)``: the data axis splits the
global batch ``BATCH_SIZE``, the camera axis the cameras); ``mesh=`` gives
one explicitly (gloo where the caller made it so; a gloo step cannot be
captured, so gloo needs ``graph=False``). Each data group loads its slice
of every global batch (``multihost.make_dp_loaders``), the camera ranks of
a data group take the group root's batch and their own cameras
(``train_step.shard_batch``), and the sharded step
(``train_step.make_hybridnet_train_step``) reduces the gradients and the
loss in one all-reduce, inside the CUDA graph under NCCL. Rank 0 alone
writes checkpoints, train states and logs; a stop signalled on any rank
stops every rank at the same step (``utils/preemption``). Ranks outside
the mesh idle.

The loaders run the config's ``DATALOADER_WORKER_MODE`` (``process`` by
default: forked workers, ``dataset/loader.py``), and ``streamlitWidgets``
drive the Streamlit monitor (``utils/st_monitor``) as the JAX trainer drives
it: ``start`` once, ``step`` every step, ``epoch`` every epoch. The train
state is the JAX package's layout, ``multi_transform``'s labelled state with
``{}`` at the frozen tensors (``checkpoints.save_train_state``), so either
package resumes the other's.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.hybridnet import HybridNetBackbone
from ..models.layers import cast_convs, set_compute_dtype, set_generator
from ..models.v2v import set_fused_cache
from ..kernels import hybridnet_loss
from ..ops.augment import make_color_aug, record_arrays, record_of
from ..parallel import multihost
from ..parallel.mesh import auto_train_mesh
from ..parallel.train_step import global_loss, make_hybridnet_train_step, shard_batch
from ..utils import clp
from ..utils.logger import AverageMeter, NetLogger, NullLogger
from ..utils.preemption import is_primary_host
from ..utils.transfer import HostToDevice
from . import checkpoints, graphed, optim

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
                 run_name=None, training_mode: str = "all", device="cuda", seed: int = 2,
                 graph: bool = True, mesh="auto"):
        self.cfg = cfg
        self.training_mode = training_mode
        if isinstance(mesh, str):  # "auto": the JAX trainer's mesh over the world
            mesh = None
            if multihost.world_size() > 1:
                multihost.initialize_distributed()
                mesh = auto_train_mesh(int(cfg.HYBRIDNET.BATCH_SIZE),
                                       int(cfg.HYBRIDNET.NUM_CAMERAS))
        self.mesh = mesh
        # a rank outside the mesh, or past rank 0 when the mesh is one device
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
        if self.primary:
            os.makedirs(self.model_savepath, exist_ok=True)
            self.logger = NetLogger(os.path.join(cfg.logPaths["HybridNet"], run_name))
        else:
            self.logger = NullLogger()
        self.lossMeter = AverageMeter()
        self.accuracyMeter = AverageMeter()

        from ..prediction.loaders import init_hybridnet_state

        state = init_hybridnet_state(cfg)
        loaded = checkpoints.load_hybridnet_state(
            cfg, weights, init_state=state, efficienttrack_weights=efficienttrack_weights)
        # None only when an explicitly requested checkpoint failed to load
        self.found_weights = loaded is not None
        self.model.load_state_dict(loaded if loaded is not None else state, strict=True)
        set_compute_dtype(cast_convs(self.model.to(self.device), torch.float32), self.dtype)
        if self.device.type == "cuda":  # float32 at full precision, as the JAX package
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(self.model, self.generator)
        if mesh is not None and mesh.member:
            self.model.set_mesh(mesh, int(cfg.HYBRIDNET.NUM_CAMERAS))
        set_fused_cache(self.model, False)  # the eval step reads the weights trained in place
        self.graphs = graphed.TrainGraphs(self.device, self.generator, enabled=graph)
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
        """One optimizer step at ``lr``; (loss, points3D) on the device, a
        graph replay on the card with ``graph=True``."""
        optim.set_learning_rate(optimizer, lr)
        return self.graphs.run("train", (optimizer, self.training_mode, self.model.training,
                                         self.dtype),
                               lambda: self._train_fn(optimizer), b)

    def _train_fn(self, optimizer):
        if self.mesh is not None:
            return make_hybridnet_train_step(self, optimizer, self.mesh)

        def step(b: dict):
            loss, points = self.forward(b)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optim.fill_missing_grads(optimizer)
            optimizer.step()
            return loss.detach(), points

        return step

    @torch.no_grad()
    def eval_step(self, b: dict):
        """(loss, points3D) of one batch in ``eval()``, a graph replay on the
        card with ``graph=True``."""
        return self.graphs.run("eval", (self.training_mode, self.dtype), lambda: self._eval_fn, b)

    def _eval_fn(self, b: dict):
        self.model.eval()
        try:
            loss, points = self.forward(b)
        finally:
            self.model.train()
        if self.mesh is not None:
            loss = global_loss(loss, self.mesh, 1.0 / self.mesh.n_cameras)
        return loss, points

    def upload(self, upload, b: dict) -> dict:
        """A collated host batch on the device, as this rank's step takes it
        (``train_step.shard_batch`` under a camera-sharded mesh)."""
        return shard_batch(upload(host_batch(b)), self.mesh, b["imgs"].shape[1])

    def train(self, training_set, validation_set, num_epochs, start_epoch=0,
              streamlitWidgets=None, resume_from=None) -> dict:
        from ..dataset.loader import maybe_preload

        cfg = self.cfg.HYBRIDNET
        if self.idle:
            clp.info("this rank is outside the training mesh and idles")
            return {"idle": True}
        device_aug = (self._device_aug() and training_set.set_name == "train"
                      and not training_set.analysisMode)
        training_set.device_targets = True
        validation_set.device_targets = True
        training_set.device_aug = device_aug
        maybe_preload(self.cfg, training_set, validation_set)

        workers = int(self.cfg.get("DATALOADER_NUM_WORKERS", 4))
        worker_mode = str(self.cfg.get("DATALOADER_WORKER_MODE", "thread"))
        batch = int(cfg.BATCH_SIZE)
        self.graphs.reset()  # graphs live for one call, as JAX's jitted closures
        train_loader, val_loader = multihost.make_dp_loaders(
            training_set, validation_set, batch, workers, self.mesh, worker_mode=worker_mode)
        steps_per_epoch = len(train_loader)
        max_lr = float(cfg.MAX_LEARNING_RATE)
        labels = optim.hybridnet_freeze_labels(self.model, self.training_mode)
        trained = optim.apply_freeze(self.model, labels)
        optimizer = optim.make_optimizer(cfg.OPTIMIZER, trained, max_lr)
        use_onecycle = bool(cfg.USE_ONECYLCLE)
        if use_onecycle:
            schedule = optim.onecycle_schedule(max_lr, steps_per_epoch * num_epochs)
            plateau = None
        else:
            schedule = lambda step: max_lr  # noqa: E731
            plateau = optim.PlateauScheduler(max_lr)
        step = 0
        size = self.cfg.KEYPOINTDETECT.MODEL_SIZE
        names = optim.param_names(self.model, optimizer)
        if resume_from is not None:
            state, opt_state, start_epoch = checkpoints.load_train_state(resume_from, size)
            self.model.load_state_dict(state, strict=True)
            step = checkpoints.restore_optimizer(optimizer, names, opt_state, state, size)
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
        from ..utils.st_monitor import StreamlitTrainingMonitor

        monitor = StreamlitTrainingMonitor(streamlitWidgets, "HybridNet", acc_unit="mm")
        monitor.start(num_epochs)

        upload = HostToDevice(self.device)
        guard = PreemptionGuard(*self._stop_group())

        def to_device(b):
            return self.upload(upload, b)

        # One-step-delayed metric readback (as the JAX trainer): step k + 1
        # is dispatched before step k's loss and points are read.
        pending = None  # (loss, pts, gt_np)

        def consume(p):
            loss, pts, gt = p
            acc = calculate_accuracy_mm(multihost.local_np(pts), gt)
            self.lossMeter.update(float(loss))
            if acc != -1:
                self.accuracyMeter.update(acc)

        def saved_opt_state():
            """The optimizer's state in the JAX package's layout."""
            return optim.optax_state(optimizer.state_dict(), names, self.model.state_dict(),
                                     step, use_onecycle, size, self.training_mode)

        with guard:
            for epoch in range(start_epoch, num_epochs):
                train_loader.set_epoch(epoch)
                self.generator.manual_seed(
                    int(np.random.SeedSequence([self.seed, epoch]).generate_state(1)[0]))
                bar = _progress(train_loader, steps_per_epoch) if self.primary else train_loader
                for count, b in enumerate(bar):
                    lr = schedule(step) * lr_scale
                    loss, pts = self.train_step(to_device(b), optimizer, lr)
                    step += 1
                    if guard.should_stop_global(stride=POD_POLL_STRIDE):
                        if pending is not None:
                            consume(pending)
                            pending = None
                        self._save_preempted(saved_opt_state(), epoch)
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
                    if streamlitWidgets is not None:
                        monitor.step(count, steps_per_epoch)
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

                if (epoch + 1) % int(cfg.CHECKPOINT_SAVE_INTERVAL) == 0 \
                        and epoch + 1 < num_epochs and self.primary:
                    self.save_checkpoint(f"HybridNet-{size}_Epoch_{epoch + 1}")
                    checkpoints.save_train_state(
                        os.path.join(self.model_savepath, "train_state.ckpt"),
                        self.model.state_dict(), saved_opt_state(), epoch + 1, size)
                if epoch + 1 == num_epochs:
                    self.save_checkpoint(f"HybridNet-{size}_final")

                if epoch % int(cfg.VAL_INTERVAL) == 0:
                    for b in val_loader:
                        loss, pts = self.eval_step(to_device(b))
                        acc = calculate_accuracy_mm(multihost.local_np(pts),
                                                    np.asarray(b["keypoints3D"]))
                        self.lossMeter.update(float(loss))
                        if acc != -1:
                            self.accuracyMeter.update(acc)
                    if self.primary:
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

                if streamlitWidgets is not None:
                    monitor.epoch(epoch, num_epochs, history)

                # a signal during epoch-end work must not start another epoch
                # (unless this was the last one: then training is complete)
                if guard.should_stop_global() and epoch + 1 < num_epochs:
                    self._save_preempted(saved_opt_state(), epoch + 1)
                    results["preempted"] = True
                    return results

        return results

    def _stop_group(self) -> tuple:
        """The preemption guard's (signals, group, device): the mesh's group,
        its flag on the rank's GPU under NCCL."""
        from ..utils.preemption import DEFAULT_SIGNALS

        if self.mesh is None:
            return DEFAULT_SIGNALS, None, "cpu"
        return (DEFAULT_SIGNALS, self.mesh.group,
                self.device if self.mesh.backend == "nccl" else "cpu")

    def _save_preempted(self, opt_state: dict, resume_epoch: int) -> None:
        """Write a full resumable train state (rank 0); a resumed run
        restarts the interrupted epoch from its beginning."""
        if not self.primary:
            return
        path = os.path.join(self.model_savepath, "train_state.ckpt")
        checkpoints.save_train_state(path, self.model.state_dict(), opt_state, resume_epoch,
                                     self.cfg.KEYPOINTDETECT.MODEL_SIZE)
        clp.warning(f"Training preempted; resumable state saved to "
                    f"{path} (resumes at epoch {resume_epoch + 1})")

    def save_checkpoint(self, name: str) -> None:
        if not self.primary:
            return
        state = self.model.state_dict()
        checkpoints.save_checkpoint(state, os.path.join(self.model_savepath, name + ".ckpt"),
                                    self.cfg.KEYPOINTDETECT.MODEL_SIZE)
        checkpoints.save_torch_checkpoint(state, os.path.join(self.model_savepath,
                                                              name + ".pth"))
