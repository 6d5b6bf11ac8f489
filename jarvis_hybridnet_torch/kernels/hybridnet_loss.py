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
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ..ops.heatmap import gaussian_heatmaps_3d_on_device
from . import build

THREADS = 512
SMEM_MAX = 232_448  # dynamic shared memory a block may use
_BLOCKS = 264  # blocks per launch the plan aims at: two per SM of an H100


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


@dataclasses.dataclass(frozen=True)
class LossPlan:
    """How K7 covers a (B, g, g, g, J) volume.

    A sample's g^3 * J elements are walked in ``groups`` groups of lcm(J,
    ``vec``) elements, ``w`` vectors of ``vec`` (16 bytes, or 1 element
    where g^3 * J is not a multiple of 4); block b * parts + k of the
    ``B * parts`` takes groups [k * per_part, (k + 1) * per_part) of sample
    b. The forward's last block sums each (b, j)'s ``parts`` partials.
    ``tab_off``, ``red_off``, ``fin_off``: byte offsets of the d^2 tables,
    the lanes' sums and the final sums in shared memory; ``smem``: bytes
    (the backward uses the tables alone)."""

    vec: int
    w: int
    groups: int
    parts: int
    per_part: int
    threads: int
    tab_off: int
    red_off: int
    fin_off: int
    smem: int

    def runs(self) -> list[tuple[int, int]]:
        """Each block's groups [first, end) of its sample, block k of a sample."""
        return [(min(self.groups, k * self.per_part), min(self.groups, (k + 1) * self.per_part))
                for k in range(self.parts)]


def loss_plan(b: int, g: int, j: int) -> LossPlan:
    """K7's launch plan for a (b, g, g, g, j) float32 volume; the
    shared-memory arithmetic is the source's."""
    n = g ** 3 * j
    vec = 4 if n % 4 == 0 else 1
    ge = math.lcm(j, vec)
    w, groups = ge // vec, n // ge
    if w > THREADS:
        raise ValueError(f"hybridnet_loss: {j} joints need {w} vectors a group, more than "
                         f"{THREADS} threads")
    lanes = THREADS // w
    want = max(1, min(_BLOCKS // b, -(-groups // lanes)))
    per_part = -(-groups // want)
    parts = -(-groups // per_part)
    pairs = b * j
    red_off = -(-(3 * g * j + 4 * j) * 4 // 16) * 16  # tables, flags, the sample's kp_vox
    fin_off = red_off + 2 * lanes * ge * 4
    # the block's sums and their slices, or the last block's sums, their
    # slices and the per-(b, j) losses (csrc: ordered_sums)
    smem = fin_off + max(2 * j + max(THREADS, 2 * j),
                         3 * pairs + max(THREADS, 2 * pairs)) * 4
    if smem > SMEM_MAX:
        raise ValueError(f"hybridnet_loss: {smem} bytes of shared memory for g = {g}, "
                         f"J = {j}, B = {b}")
    return LossPlan(vec, w, groups, parts, per_part, THREADS, 0, red_off, fin_off, smem)


def _check(out, kp_vox, kp_world):
    build.require(out, "out", (torch.float32,), ndim=5)
    B, g, J = out.shape[0], out.shape[1], out.shape[-1]
    if out.shape[1:4] != (g, g, g):
        raise ValueError(f"out must be (B, g, g, g, J), got {tuple(out.shape)}")
    for t, name in ((kp_vox, "kp_vox"), (kp_world, "kp_world")):
        build.require(t, name, (torch.float32,), ndim=3)
        if t.shape != (B, J, 3):
            raise ValueError(f"{name} must be ({B}, {J}, 3), got {tuple(t.shape)}")
    for t, name in ((out, "out"), (kp_vox, "kp_vox"), (kp_world, "kp_world")):
        if t.data_ptr() % 16:
            raise ValueError(f"hybridnet_loss: {name} must be 16-byte aligned")
    return B, g, J


def _plan_args(plan: LossPlan, B: int, g: int, J: int) -> tuple:
    return (B, g, J, plan.vec, plan.w, plan.groups, plan.parts, plan.per_part, plan.threads,
            plan.tab_off, plan.red_off, plan.fin_off, plan.smem, build.stream())


def hybridnet_loss_fwd(out: torch.Tensor, kp_vox: torch.Tensor, kp_world: torch.Tensor,
                       return_volume: bool = False):
    """K7's forward: (loss, valid, volume or None) as
    :func:`hybridnet_loss_fwd_plain`. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (one ``__global__`` launch on the
    current stream)."""
    if build.on_cpu(out, kp_vox, kp_world):
        return hybridnet_loss_fwd_plain(out, kp_vox, kp_world, return_volume)
    B, g, J = _check(out, kp_vox, kp_world)
    plan = loss_plan(B, g, J)
    dev = out.device
    vol = torch.empty_like(out) if return_volume else None
    part = torch.empty(B * plan.parts * 2 * J, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    valid = torch.empty((B, J), dtype=torch.float32, device=dev)
    ticket = build.sync_words(dev, "hybridnet_loss_fwd")
    err = _fwd_fn()(*(build.ptr(t) for t in (out, kp_vox, kp_world, vol, part, ticket, loss,
                                               valid)), *_plan_args(plan, B, g, J))
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
    plan = loss_plan(B, g, J)
    dout = torch.empty_like(out)
    err = _bwd_fn()(*(build.ptr(t) for t in (out, kp_vox, kp_world, valid, dloss, dout)),
                    *_plan_args(plan, B, g, J))
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
    return build.bind("hybridnet_loss", "hybridnet_loss_forward", [p] * 8 + [i] * 13 + [p])


@functools.cache
def _bwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("hybridnet_loss", "hybridnet_loss_backward", [p] * 6 + [i] * 13 + [p])
