"""The collectives of the sharded steps, on ``torch.distributed``.

Every one is an ``all_reduce`` or a ``broadcast``: NCCL runs both on CUDA
tensors (and a CUDA graph captures them), gloo runs both on CPU and CUDA
tensors, so one code path serves the card and the CPU tests.

- :func:`camera_sum`: the camera group's sum of the partial voxel volumes,
  each rank's cameras' rows gathered and divided by the rig's camera count
  (``models/repro.py``). Its backward passes the gradient through
  unchanged: V2V downstream runs replicated on every camera rank, so each
  rank already holds the whole volume's gradient, and the gradient of its
  own partial volume is that gradient. (An all-reduce in the backward, as
  ``torch.distributed.nn.functional.all_reduce`` has, would count it
  ``n_cameras`` times.) This is how GSPMD treats the replicated V2V of the
  JAX package's camera-sharded step.
- :func:`camera_gather`: this rank's slice of a camera axis gathered over
  the camera group in camera order, as a sum of zero-padded buffers (exact:
  every element has one non-zero term).
- :func:`broadcast_batch`: a batch from the camera group's root to the
  group, so every camera rank of a data group sees the same samples.
- :func:`all_reduce_flat`: one all-reduce of many tensors through one flat
  buffer (the train steps' gradients and loss).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class CameraSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over ``group``; backward: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def camera_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over ``mesh``'s camera group (module docstring); ``x``
    itself without a mesh or with one camera rank."""
    if mesh is None or mesh.n_cameras == 1:
        return x
    return CameraSum.apply(x, mesh.camera_group)


def camera_gather(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """``x``, this rank's block of a camera axis ``dim``, gathered over the
    camera group in camera order; ``x`` itself with one camera rank."""
    if mesh is None or mesh.n_cameras == 1:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.n_cameras
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, mesh.camera_index * n, n).copy_(x)
    dist.all_reduce(buf, group=mesh.camera_group)
    return buf


def broadcast_batch(batch: dict, mesh) -> dict:
    """The tensors of ``batch`` overwritten by the camera group root's, in
    place (every rank holds tensors of the same shapes); ``batch``."""
    if mesh is None or mesh.n_cameras == 1:
        return batch
    for name in sorted(batch):
        dist.broadcast(batch[name], src=mesh.camera_root, group=mesh.camera_group)
    return batch


def all_reduce_flat(tensors, scales, group) -> None:
    """Each tensor of ``tensors`` (float32) replaced, in place, by the sum
    over ``group`` of ``scale *`` its value on every rank: one all-reduce of
    one flat buffer."""
    flat = torch.cat([t.reshape(-1) * s if s != 1.0 else t.reshape(-1)
                      for t, s in zip(tensors, scales)])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
