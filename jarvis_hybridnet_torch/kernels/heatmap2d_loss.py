"""K8: EfficientTrack's training loss with its two Gaussian targets, forward
and backward (``csrc/heatmap2d_loss.cu``).

Replaces the jnp ops of the JAX package's 2D train step
(``jarvis_hybridnet_tpu/training/trainer2d.py:140-160``): the targets
``ops/heatmap.py::gaussian_heatmaps_on_device`` (:73) at input/4 and input/2
and ``trainer2d.py::heatmap_loss`` (:31), and their VJP. The targets are
built on the fly and never stored.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.heatmap import gaussian_heatmaps_on_device, stamp
from . import build

_BLOCKS = 528  # blocks per launch at most: four per SM of an H100
_PER_BLOCK = 2048  # elements a block takes at least


def sigmas(sigma_base: float, input_size: int) -> tuple[float, float]:
    """The targets' sigma at input/4 and input/2: ``sigma_base * out / 64``
    (1.0 for CenterDetect, 1.5 for KeypointDetect; trainer2d.py:151-154)."""
    return tuple(sigma_base * (input_size // f) / 64 for f in (4, 2))


def _targets(out4, out2, kps, input_size, sigma_base):
    return [gaussian_heatmaps_on_device(kps, input_size, o.shape[-1], s).permute(0, 3, 1, 2)
            for o, s in zip((out4, out2), sigmas(sigma_base, input_size))]


def heatmap2d_loss_fwd_plain(out4: torch.Tensor, out2: torch.Tensor, kps: torch.Tensor,
                             input_size: int, sigma_base: float):
    """Plain PyTorch version of K8's forward: (loss (), per-scale means (2,)),
    the JAX package's ``heatmap_loss``: the mean squared error of each head
    (B, J, h, h) against its target, summed over the two scales."""
    t4, t2 = _targets(out4, out2, kps, input_size, sigma_base)
    means = torch.stack([(out4.float() - t4).square().mean(), (out2.float() - t2).square().mean()])
    return means[0] + means[1], means


def heatmap2d_loss_bwd_plain(out4, out2, kps, input_size: int, sigma_base: float,
                             dloss: torch.Tensor):
    """Plain PyTorch version of K8's backward: dL/dout_s = dloss * (2 /
    numel_s) * (out_s - t_s), in each head's layout."""
    t4, t2 = _targets(out4, out2, kps, input_size, sigma_base)
    return tuple((dloss * (2.0 / o.numel())) * (o.float() - t) for o, t in ((out4, t4),
                                                                          (out2, t2)))


def _layout(t: torch.Tensor, name: str) -> int:
    """0 for contiguous NCHW, 1 for channels-last memory; raises otherwise."""
    if t.dtype != torch.float32 or t.device.type != "cuda" or t.dim() != 4:
        raise ValueError(f"heatmap2d_loss: {name} must be a float32 (B, J, h, w) CUDA tensor")
    if t.is_contiguous():
        return 0
    if t.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"heatmap2d_loss: {name} is neither contiguous nor channels-last "
                     f"(strides {t.stride()})")


def _args(out4, out2, kps, input_size, sigma_base):
    B, J = out4.shape[:2]
    cl = [_layout(out4, "out4"), _layout(out2, "out2")]
    if out2.shape[:2] != (B, J):
        raise ValueError(f"heatmap2d_loss: heads {tuple(out4.shape)} and {tuple(out2.shape)}")
    build.require(kps, "kps", (torch.float32,), ndim=3)
    if tuple(kps.shape) != (B, J, 2):
        raise ValueError(f"heatmap2d_loss: kps must be ({B}, {J}, 2), got {tuple(kps.shape)}")
    total = out4.numel() + out2.numel()
    if total >= 2 ** 31:
        raise ValueError("heatmap2d_loss: heads of 2^31 elements or more")
    st = [stamp(input_size, o.shape[-1], s) for o, s in zip((out4, out2),
                                                         sigmas(sigma_base, input_size))]
    blocks = max(1, min(_BLOCKS, -(-total // _PER_BLOCK)))
    return (B, J, out4.shape[2], out4.shape[3], cl[0], out2.shape[2], out2.shape[3], cl[1],
            st[0].scale, st[0].off, st[0].den, st[0].ksize, st[1].scale, st[1].off, st[1].den,
            st[1].ksize, blocks, build.stream()), blocks


def heatmap2d_loss_fwd(out4: torch.Tensor, out2: torch.Tensor, kps: torch.Tensor,
                       input_size: int, sigma_base: float):
    """K8's forward: (loss, per-scale means) as :func:`heatmap2d_loss_fwd_plain`.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one ``__global__`` launch on the current stream), reading the heads in
    their layout (channels-last or contiguous NCHW)."""
    if build.on_cpu(out4, out2, kps):
        return heatmap2d_loss_fwd_plain(out4, out2, kps, input_size, sigma_base)
    args, blocks = _args(out4, out2, kps, input_size, sigma_base)
    dev = out4.device
    part = torch.empty(blocks * 2, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    means = torch.empty(2, dtype=torch.float32, device=dev)
    ticket = build.sync_words(dev, "heatmap2d_loss_fwd")
    err = _fwd_fn()(*(build.ptr(t) for t in (out4, out2, kps, part, ticket, loss, means)), *args)
    build.check(err, "heatmap2d_loss_fwd")
    heatmap2d_loss_fwd.launches += 1
    return loss, means


def heatmap2d_loss_bwd(out4, out2, kps, input_size: int, sigma_base: float,
                       dloss: torch.Tensor):
    """K8's backward, (dL/dout4, dL/dout2) in the heads' layouts, as
    :func:`heatmap2d_loss_bwd_plain`; ``dloss`` is a one-element tensor on
    the heads' device (read there). A CUDA tensor launches one kernel."""
    if build.on_cpu(out4, out2, kps, dloss):
        return heatmap2d_loss_bwd_plain(out4, out2, kps, input_size, sigma_base, dloss)
    args, _ = _args(out4, out2, kps, input_size, sigma_base)
    dloss = dloss.float().reshape(1)
    d4, d2 = torch.empty_like(out4), torch.empty_like(out2)
    if d4.stride() != out4.stride() or d2.stride() != out2.stride():
        raise ValueError("heatmap2d_loss: the gradients' layout differs from the heads'")
    err = _bwd_fn()(*(build.ptr(t) for t in (out4, out2, kps, dloss, d4, d2)), *args)
    build.check(err, "heatmap2d_loss_bwd")
    heatmap2d_loss_bwd.launches += 1
    return d4, d2


heatmap2d_loss_fwd.launches = 0
heatmap2d_loss_bwd.launches = 0


class Heatmap2DLoss(torch.autograd.Function):
    """K8's forward with K8's backward, through their wrappers (``fwd`` and
    ``bwd`` below): a CPU tensor runs the plain versions, a CUDA tensor the
    kernels."""

    @staticmethod
    def forward(ctx, out4, out2, kps, input_size, sigma_base):
        loss, _ = Heatmap2DLoss.fwd(out4, out2, kps, input_size, sigma_base)
        ctx.save_for_backward(out4, out2, kps)
        ctx.cfg = (input_size, sigma_base)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        out4, out2, kps = ctx.saved_tensors
        d4, d2 = Heatmap2DLoss.bwd(out4, out2, kps, *ctx.cfg, dloss)
        return d4, d2, None, None, None


Heatmap2DLoss.fwd = staticmethod(heatmap2d_loss_fwd)
Heatmap2DLoss.bwd = staticmethod(heatmap2d_loss_bwd)


def heatmap2d_loss(out4: torch.Tensor, out2: torch.Tensor, kps: torch.Tensor,
                   input_size: int, sigma_base: float) -> torch.Tensor:
    """EfficientTrack's training loss from its heads (B, J, S/4, S/4) and
    (B, J, S/2, S/2) float32 and the keypoints ``kps`` (B, J, 2) at input
    resolution ``input_size`` S, with targets of sigma ``sigma_base * out /
    64``; differentiable in both heads."""
    return Heatmap2DLoss.apply(out4, out2, kps, input_size, sigma_base)


@functools.cache
def _fwd_fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("heatmap2d_loss", "heatmap2d_loss_forward",
                      [p] * 7 + [i] * 8 + [f, f, f, i, f, f, f, i, i, p])


@functools.cache
def _bwd_fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("heatmap2d_loss", "heatmap2d_loss_backward",
                      [p] * 6 + [i] * 8 + [f, f, f, i, f, f, f, i, i, p])
