"""K8: EfficientTrack's training loss with its two Gaussian targets, forward
and backward (``csrc/heatmap2d_loss.cu``).

Replaces the jnp ops of the JAX package's 2D train step
(``jarvis_hybridnet_tpu/training/trainer2d.py:140-160``): the targets
``ops/heatmap.py::gaussian_heatmaps_on_device`` (:73) at input/4 and input/2
and ``trainer2d.py::heatmap_loss`` (:31), and their VJP. The targets are
built on the fly and never stored. The heads are float32 or bf16 (bf16
training): the loss stays float32 and the gradients come in the heads'
dtype, each element rounded once, as JAX's promotion of a bf16 head to
float32 and its transpose give them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..ops.heatmap import gaussian_heatmaps_on_device, stamp
from . import build

_TARGET_BLOCKS = 528  # blocks a launch aims at: four per SM of an H100
THREADS = 128  # kernel_sweep.py: 128 beat 256 and 512 at KeypointDetect's heads


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
    numel_s) * (out_s - t_s) in float32, then in each head's layout and
    dtype."""
    t4, t2 = _targets(out4, out2, kps, input_size, sigma_base)
    return tuple(((dloss * (2.0 / o.numel())) * (o.float() - t)).to(o.dtype)
                 for o, t in ((out4, t4), (out2, t2)))


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _layout(t: torch.Tensor, name: str) -> int:
    """0 for contiguous NCHW, 1 for channels-last memory; raises otherwise."""
    if t.dtype not in _DTYPES or t.device.type != "cuda" or t.dim() != 4:
        raise ValueError(f"heatmap2d_loss: {name} must be a float32 or bf16 (B, J, h, w) CUDA "
                         "tensor")
    if t.is_contiguous():
        return 0
    if t.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"heatmap2d_loss: {name} is neither contiguous nor channels-last "
                     f"(strides {t.stride()})")


@dataclasses.dataclass(frozen=True)
class Walk:
    """K8's walk of one head (``csrc/heatmap2d_loss.cu``): ``planes`` planes
    (an image of a channels-last head, an (image, joint) of an NCHW one) of
    ``h`` rows of ``length`` elements (``w * jr``, ``jr`` joints a pixel), cut
    into ``bands`` bands of ``rows`` rows, one block each."""

    planes: int
    h: int
    w: int
    jr: int
    rows: int

    @property
    def length(self) -> int:
        return self.w * self.jr

    @property
    def bands(self) -> int:
        return -(-self.h // self.rows)

    @property
    def blocks(self) -> int:
        return self.planes * self.bands


@functools.cache
def walk_plan(b: int, j: int, heads: tuple, threads: int = THREADS,
              blocks: int = _TARGET_BLOCKS) -> tuple[Walk, Walk]:
    """The walks of both heads, ``heads`` ((h, w, channels_last) of out4 and
    out2): bands of whole rows of about the heads' elements / ``blocks``
    (at least a 16-byte vector a thread), at most a plane."""
    total = b * j * sum(h * w for h, w, _ in heads)
    per = max(4 * threads, -(-total // blocks))
    walks = []
    for h, w, cl in heads:
        jr = j if cl else 1
        walks.append(Walk(b if cl else b * j, h, w, jr, min(h, max(1, per // (w * jr)))))
    return tuple(walks)


def _args(out4, out2, kps, input_size, sigma_base, threads=THREADS, blocks=_TARGET_BLOCKS):
    """The C functions' head arguments and the launch's blocks (``threads``
    and ``blocks`` other than the defaults: kernel_sweep.py's plans)."""
    B, J = out4.shape[:2]
    cl = [_layout(out4, "out4"), _layout(out2, "out2")]
    if out2.shape[:2] != (B, J) or out2.dtype != out4.dtype:
        raise ValueError(f"heatmap2d_loss: heads {tuple(out4.shape)} {out4.dtype} and "
                         f"{tuple(out2.shape)} {out2.dtype}")
    build.require(kps, "kps", (torch.float32,), ndim=3)
    if tuple(kps.shape) != (B, J, 2):
        raise ValueError(f"heatmap2d_loss: kps must be ({B}, {J}, 2), got {tuple(kps.shape)}")
    if out4.numel() + out2.numel() >= 2 ** 31:
        raise ValueError("heatmap2d_loss: heads of 2^31 elements or more")
    st = [stamp(input_size, o.shape[-1], s) for o, s in zip((out4, out2),
                                                         sigmas(sigma_base, input_size))]
    w4, w2 = walk_plan(B, J, ((*out4.shape[2:], cl[0]), (*out2.shape[2:], cl[1])), threads,
                       blocks)
    return (B, J, *out4.shape[2:], cl[0], w4.rows, *out2.shape[2:], cl[1], w2.rows,
            st[0].scale, st[0].off, st[0].den, st[0].ksize, st[1].scale, st[1].off, st[1].den,
            st[1].ksize, _DTYPES[out4.dtype], threads, build.stream()), w4.blocks + w2.blocks


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
    part = torch.empty(blocks, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    means = torch.empty(2, dtype=torch.float32, device=dev)
    ticket = build.sync_words(dev, "heatmap2d_loss_fwd")
    err = _fwd_fn()(*(build.ptr(t) for t in (out4, out2, kps, part, ticket, loss, means)), *args)
    build.check(err, "heatmap2d_loss_fwd")
    heatmap2d_loss_fwd.launches += 1
    return loss, means


def heatmap2d_loss_bwd(out4, out2, kps, input_size: int, sigma_base: float,
                       dloss: torch.Tensor):
    """K8's backward, (dL/dout4, dL/dout2) in the heads' layouts and dtype, as
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
    (B, J, S/2, S/2), float32 or bf16, and the keypoints ``kps`` (B, J, 2) at input
    resolution ``input_size`` S, with targets of sigma ``sigma_base * out /
    64``; differentiable in both heads."""
    return Heatmap2DLoss.apply(out4, out2, kps, input_size, sigma_base)


_i, _f = ctypes.c_int, ctypes.c_float
_HEAD_ARGTYPES = [_i] * 10 + [_f, _f, _f, _i, _f, _f, _f, _i, _i, _i, ctypes.c_void_p]


@functools.cache
def _fwd_fn():
    p = ctypes.c_void_p
    return build.bind("heatmap2d_loss", "heatmap2d_loss_forward", [p] * 7 + _HEAD_ARGTYPES)


@functools.cache
def _bwd_fn():
    p = ctypes.c_void_p
    return build.bind("heatmap2d_loss", "heatmap2d_loss_backward", [p] * 6 + _HEAD_ARGTYPES)
