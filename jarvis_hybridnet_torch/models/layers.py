"""Shared building blocks (port of ``jarvis_hybridnet_tpu/models/layers.py``).

Modules take and return NCHW / NCDHW tensors in channels-last memory, so
cuDNN's convolutions and the InstanceNorm kernel (K1) share NHWC / NDHWC
storage with no transposes. Numerics follow the reference's torch layers:
InstanceNorm with eps 1e-5, no affine, biased variance and float32
statistics; nearest upsampling by pixel repetition; floor-mode 2x2 max pool.

Convolutions compute in the dtype of their weights (float32 or bfloat16,
set once by :func:`cast_convs`); their input is cast to it first, as flax's
``nn.Conv(dtype=...)`` casts its input. ``sigmoid`` and ``silu`` evaluate
1 / (1 + exp(-x)) op by op, so in bfloat16 they round where XLA rounds
``jax.nn.sigmoid`` / ``jax.nn.silu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import instance_norm_act

_CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def instance_norm(x: torch.Tensor, act: str = "none",
                  skip: torch.Tensor | None = None) -> torch.Tensor:
    """InstanceNorm over the spatial dims of (N, C, *spatial), then ``act``
    (none / silu / relu / add_relu = relu(IN(x) + skip)), through K1."""
    n, c = x.shape[0], x.shape[1]
    perm = (0, *range(2, x.dim()), 1)
    inv = (0, x.dim() - 1, *range(1, x.dim() - 1))
    xl = x.permute(perm).contiguous()
    sl = None if skip is None else skip.permute(perm).contiguous()
    y = instance_norm_act(xl.reshape(n, -1, c), act,
                          None if sl is None else sl.reshape(n, -1, c))
    return y.reshape(xl.shape).permute(inv)


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a conv module in its weights' dtype."""
    return m(x.to(m.weight.dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def cast_convs(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every convolution's weight and bias to the compute dtype and
    channels-last memory; other parameters (fusion weights) stay float32."""
    for m in module.modules():
        if isinstance(m, _CONVS):
            fmt = (torch.channels_last if m.weight.dim() == 4
                   else torch.channels_last_3d)
            m.to(dtype=dtype, memory_format=fmt)
    return module


class SeparableConvBlock(nn.Module):
    """Depthwise 3x3 (no bias), pointwise 1x1 (bias), InstanceNorm if
    ``norm`` and SiLU if ``activation`` (reference model.py:180-232)."""

    def __init__(self, in_channels: int, out_channels: int, norm: bool = True,
                 activation: bool = False):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(in_channels, in_channels, 3, padding=1,
                                        groups=in_channels, bias=False)
        self.pointwise_conv = nn.Conv2d(in_channels, out_channels, 1)
        self.norm = norm
        self.activation = activation

    def forward(self, x):
        x = conv(self.pointwise_conv, conv(self.depthwise_conv, x))
        if self.norm:
            return instance_norm(x, "silu" if self.activation else "none")
        return silu(x) if self.activation else x
