"""K7: HybridNet's training loss with its 3D Gaussian target, forward and
backward (``csrc/hybridnet_loss.cu``).

Replaces the jnp ops of the JAX package's 3D train step
(``jarvis_hybridnet_tpu/training/trainer3d.py:140-180``): the target
``ops/heatmap.py::gaussian_heatmaps_3d_on_device`` (:113), the double
softplus of ``models/hybridnet.py`` (:104, :116) and
``models/hybridnet.py::hybridnet_mse_loss`` (:118), and their VJP. The
target is built on the fly and never stored.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops.heatmap import gaussian_heatmaps_3d_on_device
from . import build

THREADS = 256
_BLOCKS = 264  # blocks per sample the forward and backward aim at (2 per SM)


def hybridnet_mse_loss(pred_heatmaps: torch.Tensor, gt_heatmaps: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``models/hybridnet.py::hybridnet_mse_loss`` (the
    reference MSELoss, jarvis/hybridnet/loss.py:11-22): the sum over (batch,
    joint) of the per-joint mean squared voxel error of (B, g, g, g, J)
    volumes, skipping joints whose target sums to <= 1 (unlabeled)."""
    sq = (pred_heatmaps - gt_heatmaps).square().mean(dim=(1, 2, 3))
    return torch.where(_valid(gt_heatmaps), sq, torch.zeros_like(sq)).sum()


def _valid(gt_heatmaps: torch.Tensor) -> torch.Tensor:
    return gt_heatmaps.sum(dim=(1, 2, 3)) > 1.0


def hybridnet_loss_fwd_plain(out: torch.Tensor, kp_vox: torch.Tensor, kp_world: torch.Tensor,
                             return_volume: bool = False):
    """Plain PyTorch version of K7's forward: (loss (), valid (B, J) float
    0 / 1, the double-softplus volume or None): ``hybridnet_mse_loss`` of
    softplus(softplus(out)) and the Gaussian target; valid: sum_v t > 1."""
    sp2 = F.softplus(F.softplus(out.float()))
    t = gaussian_heatmaps_3d_on_device(kp_vox, kp_world, out.shape[1])
    return (hybridnet_mse_loss(sp2, t), _valid(t).float(),
            sp2 if return_volume else None)


def hybridnet_loss_bwd_plain(out: torch.Tensor, kp_vox: torch.Tensor, kp_world: torch.Tensor,
                             valid: torch.Tensor, dloss: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7's backward: dL/dout = dloss * (2 / g^3) *
    (sp2 - t) * sigmoid(sp1) * sigmoid(out) on valid (b, j), 0 elsewhere."""
    o = out.float()
    sp1 = F.softplus(o)
    sp2 = F.softplus(sp1)
    t = gaussian_heatmaps_3d_on_device(kp_vox, kp_world, out.shape[1])
    g3 = float(out.shape[1]) ** 3
    scale = (dloss * (2.0 / g3)) * valid[:, None, None, None, :]
    return scale * (sp2 - t) * torch.sigmoid(sp1) * torch.sigmoid(o)


def loss_plan(g: int, j: int) -> tuple[int, int, int]:
    """(threads, voxels per block, blocks per sample) of K7's grid."""
    threads = THREADS // j * j
    per_block = max(1, -(-g ** 3 // _BLOCKS))
    return threads, per_block, -(-g ** 3 // per_block)


def _check(out, kp_vox, kp_world):
    build.require(out, "out", (torch.float32,), ndim=5)
    B, g, J = out.shape[0], out.shape[1], out.shape[-1]
    if out.shape[1:4] != (g, g, g):
        raise ValueError(f"out must be (B, g, g, g, J), got {tuple(out.shape)}")
    for t, name in ((kp_vox, "kp_vox"), (kp_world, "kp_world")):
        build.require(t, name, (torch.float32,), ndim=3)
        if t.shape != (B, J, 3):
            raise ValueError(f"{name} must be ({B}, {J}, 3), got {tuple(t.shape)}")
    if J > THREADS:
        raise ValueError(f"hybridnet_loss: {J} joints, more than {THREADS}")
    return B, g, J


def hybridnet_loss_fwd(out: torch.Tensor, kp_vox: torch.Tensor, kp_world: torch.Tensor,
                       return_volume: bool = False):
    """K7's forward: (loss, valid, volume or None) as
    :func:`hybridnet_loss_fwd_plain`. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (two kernels on the current stream)."""
    if build.on_cpu(out, kp_vox, kp_world):
        return hybridnet_loss_fwd_plain(out, kp_vox, kp_world, return_volume)
    B, g, J = _check(out, kp_vox, kp_world)
    threads, per_block, nblk = loss_plan(g, J)
    dev = out.device
    vol = torch.empty_like(out) if return_volume else None
    part = torch.empty(B * nblk * J * 2, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    valid = torch.empty((B, J), dtype=torch.float32, device=dev)
    err = _fwd_fn()(*(build.ptr(t) for t in (out, kp_vox, kp_world, vol, part, loss, valid)),
                    B, g, J, threads, per_block, nblk, build.stream())
    build.check(err, "hybridnet_loss_fwd")
    hybridnet_loss_fwd.launches += 1
    return loss, valid, vol


def hybridnet_loss_bwd(out: torch.Tensor, kp_vox: torch.Tensor, kp_world: torch.Tensor,
                       valid: torch.Tensor, dloss: torch.Tensor) -> torch.Tensor:
    """K7's backward, dL/dout, as :func:`hybridnet_loss_bwd_plain`; ``dloss``
    is a one-element tensor on the tensors' device (read there, no host
    synchronization). A CUDA tensor launches one kernel."""
    if build.on_cpu(out, kp_vox, kp_world, valid, dloss):
        return hybridnet_loss_bwd_plain(out, kp_vox, kp_world, valid, dloss)
    B, g, J = _check(out, kp_vox, kp_world)
    build.require(valid, "valid", (torch.float32,), ndim=2)
    dloss = dloss.float().reshape(1).contiguous()
    threads, per_block, nblk = loss_plan(g, J)
    dout = torch.empty_like(out)
    err = _bwd_fn()(*(build.ptr(t) for t in (out, kp_vox, kp_world, valid, dloss, dout)),
                    B, g, J, threads, per_block, nblk, build.stream())
    build.check(err, "hybridnet_loss_bwd")
    hybridnet_loss_bwd.launches += 1
    return dout


hybridnet_loss_fwd.launches = 0
hybridnet_loss_bwd.launches = 0


class _HybridNetLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, kp_vox, kp_world, return_volume):
        loss, valid, vol = hybridnet_loss_fwd(out, kp_vox, kp_world, return_volume)
        ctx.save_for_backward(out, kp_vox, kp_world, valid)
        if vol is not None:
            ctx.mark_non_differentiable(vol)
        return loss, vol

    @staticmethod
    def backward(ctx, dloss, _dvol):
        out, kp_vox, kp_world, valid = ctx.saved_tensors
        return hybridnet_loss_bwd(out, kp_vox, kp_world, valid, dloss), None, None, None


def hybridnet_loss(out: torch.Tensor, kp_vox: torch.Tensor, kp_world: torch.Tensor,
                   return_volume: bool = False):
    """HybridNet's training loss from the V2V output ``out`` (B, g, g, g, J)
    float32, with the Gaussian target of ``kp_vox`` / ``kp_world`` (B, J, 3);
    differentiable in ``out``. Returns the loss, or (loss, the detached
    double-softplus volume) with ``return_volume``."""
    loss, vol = _HybridNetLoss.apply(out, kp_vox.float().contiguous(),
                                     kp_world.float().contiguous(), return_volume)
    return (loss, vol) if return_volume else loss


@functools.cache
def _fwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("hybridnet_loss", "hybridnet_loss_forward", [p] * 7 + [i] * 6 + [p])


@functools.cache
def _bwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("hybridnet_loss", "hybridnet_loss_backward", [p] * 6 + [i] * 6 + [p])
