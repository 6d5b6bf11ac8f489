"""Sharded train steps (port of ``jarvis_hybridnet_tpu/parallel/train_step.py``).

Data parallelism: each data group takes its slice of the global batch, the
parameters and the optimizer's state are replicated, and the gradients are
reduced over the mesh before the optimizer steps. The camera axis of the
multi-view batch can be sharded too: each camera rank runs the 2D net on
its cameras, the reprojection layer's camera mean becomes a sum over the
camera group (``collectives.camera_sum``), and V2V, the loss and the points
run replicated on every camera rank.

The gradient rules follow from the losses, so that a sharded step computes
what the single-process step computes on the whole batch:

- HybridNet's loss (K7, the JAX package's ``hybridnet_mse_loss``) is a sum
  over the batch's (frameset, joint) pairs, so the global loss is the sum
  of the data groups' losses. V2V's gradients are the same on every camera
  rank of a data group: they are summed over the data axis and averaged
  over the camera axis. The 2D net's gradients on a camera rank cover its
  own cameras only (the camera sum's backward passes the volume's gradient
  through): they are summed over both axes (modes ``all``, ``bifpn``,
  ``last_layers``; in ``3D_only`` the 2D net has none). A plain average
  over the world would divide them by ``n_cameras`` once too often.
- EfficientTrack's loss (K8) is a mean over the batch, so the data-parallel
  2D step averages gradients and loss over the data axis.

Both are one all-reduce of one flat buffer (each gradient scaled first),
with the step's loss in its last element: under NCCL it is captured with
the rest of the step in the trainer's CUDA graph (``training/graphed.py``).
"""

from __future__ import annotations

import torch

from ..training import optim
from .collectives import all_reduce_flat, broadcast_batch

# the keys of a 3D batch with a camera axis (axis 1)
CAMERA_KEYS = ("imgs", "center_hm", "camera_matrices", "intrinsics", "distortions")


def shard_batch(b: dict, mesh, num_cameras: int) -> dict:
    """A 3D batch of this data group (on the device, every camera) as this
    rank sees it: the camera group root's batch (``broadcast_batch``, so
    the camera ranks agree on the host's random draws), then this rank's
    cameras of the camera-axis keys and of the color record."""
    if mesh is None or mesh.n_cameras == 1:
        return b
    broadcast_batch(b, mesh)
    cams = mesh.cameras(num_cameras)
    return {k: (v[:, cams].contiguous() if k in CAMERA_KEYS or k.startswith("aug.") else v)
            for k, v in b.items()}


def _params(optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def reduce_step(optimizer, loss: torch.Tensor, scales: list, loss_scale: float, group):
    """After the backward: each trained tensor's gradient and the loss
    reduced over ``group`` in one all-reduce, each scaled by its factor
    first. Returns the reduced loss (a 0-dim tensor)."""
    optim.fill_missing_grads(optimizer)
    out = loss.detach().float().reshape(1).clone()
    params = _params(optimizer)
    all_reduce_flat([p.grad for p in params] + [out], list(scales) + [loss_scale], group)
    return out[0]


def hybridnet_scales(model, optimizer, mesh) -> list:
    """The factor of each trained tensor's gradient before the sum over the
    mesh (module docstring): 1 / n_cameras for V2V's, 1 for the 2D net's."""
    v2v = {id(p) for p in model.v2vNet.parameters()}
    return [1.0 / mesh.n_cameras if id(p) in v2v else 1.0 for p in _params(optimizer)]


def make_hybridnet_train_step(trainer, optimizer, mesh):
    """``step(batch) -> (global loss, this rank's points3D)``: one sharded
    optimizer step of ``trainer`` (a ``HybridNetTrainer`` whose model runs
    on ``mesh``) on this rank's part of the batch."""
    scales = hybridnet_scales(trainer.model, optimizer, mesh)

    def step(b: dict):
        loss, points = trainer.forward(b)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = reduce_step(optimizer, loss, scales, 1.0 / mesh.n_cameras, mesh.group)
        optimizer.step()
        return loss, points

    return step


def make_data_parallel_train_step(trainer, optimizer, mesh):
    """``step(batch) -> (global loss, this rank's outputs...)``: one
    data-parallel optimizer step of an ``EfficientTrackTrainer``: its
    ``forward(batch)`` gives (loss, outputs...); the gradients and the loss
    are averaged over the data axis."""
    scale = 1.0 / mesh.n_data

    def step(b: dict):
        loss, *rest = trainer.forward(b)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = reduce_step(optimizer, loss, [scale] * len(_params(optimizer)), scale,
                           mesh.group)
        optimizer.step()
        return (loss, *(r.detach() for r in rest))

    return step


def global_loss(loss: torch.Tensor, mesh, scale: float) -> torch.Tensor:
    """An evaluation step's loss over the mesh: ``scale`` times the sum of
    the ranks' losses (``1 / n_cameras`` for HybridNet's summed loss,
    ``1 / n_data`` for EfficientTrack's mean)."""
    out = loss.detach().float().reshape(1).clone()
    all_reduce_flat([out], [scale], mesh.group)
    return out[0]
