"""Shared building blocks (port of ``jarvis_hybridnet_tpu/models/layers.py``).

Modules take and return NCHW / NCDHW tensors in channels-last memory, so
cuDNN's convolutions and the InstanceNorm kernel (K1) share NHWC / NDHWC
storage with no transposes. Numerics follow the reference's torch layers:
InstanceNorm with eps 1e-5, no affine, biased variance and float32
statistics; nearest upsampling by pixel repetition; floor-mode 2x2 max pool.

Convolutions compute in their compute dtype (float32 or bfloat16, set by
:func:`set_compute_dtype`): every call casts the input, the weight and the
bias to it, as flax's ``nn.Conv(dtype=..., param_dtype=float32)`` promotes
them, so in training autograd carries the gradient back to the float32
master. Serving rounds the weights once instead (:func:`cast_convs`), which
gives the same bits. ``sigmoid`` and ``silu`` evaluate 1 / (1 + exp(-x)) op
by op, so in bfloat16 they round where XLA rounds ``jax.nn.sigmoid`` /
``jax.nn.silu``. Dropout and drop-connect round their Python scalars to the
input's dtype first, as JAX rounds a weak-typed scalar (:func:`weak`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import InstanceNormAct, instance_norm_act

_CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
_FUNCTIONS = {nn.Conv2d: F.conv2d, nn.Conv3d: F.conv3d,
              nn.ConvTranspose2d: F.conv_transpose2d, nn.ConvTranspose3d: F.conv_transpose3d}


@functools.cache
def weak(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the scalar JAX computes with when a
    weak-typed Python float meets an array of ``dtype`` (PyTorch would keep
    it in float32 for a bf16 tensor)."""
    return float(torch.tensor(value, dtype=dtype))


def instance_norm(x: torch.Tensor, act: str = "none",
                  skip: torch.Tensor | None = None) -> torch.Tensor:
    """InstanceNorm over the spatial dims of (N, C, *spatial), then ``act``
    (none / silu / relu / add_relu = relu(IN(x) + skip)), through K1. When
    grad is enabled and an input requires it, through ``InstanceNormAct``
    (K1 forward, K6 backward); else one K1 call and no graph."""
    n, c = x.shape[0], x.shape[1]
    perm = (0, *range(2, x.dim()), 1)
    inv = (0, x.dim() - 1, *range(1, x.dim() - 1))
    xl = x.permute(perm).contiguous()
    sl = None if skip is None else skip.permute(perm).contiguous().reshape(n, -1, c)
    if torch.is_grad_enabled() and (x.requires_grad or (skip is not None and skip.requires_grad)):
        y = InstanceNormAct.apply(xl.reshape(n, -1, c), sl, act)
    else:
        y = instance_norm_act(xl.reshape(n, -1, c), act, sl)
    return y.reshape(xl.shape).permute(inv)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: keep each element with probability 1 - rate
    and scale it by 1 / (1 - rate). The keep mask is drawn from
    ``generator`` (uniform < 1 - rate) unless ``mask`` is given."""
    keep = 1.0 - rate
    if mask is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / weak(keep, x.dtype), torch.zeros_like(x))


def drop_connect(x: torch.Tensor, rate: float, generator: torch.Generator | None,
                 uniform: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample stochastic depth, as ``models/layers.py::drop_connect`` of
    the JAX package: x / keep * floor(keep + u), u ~ U[0, 1) per sample in
    x's dtype, drawn from ``generator`` unless ``uniform`` (N,) is given."""
    keep = weak(1.0 - rate, x.dtype)
    if uniform is None:
        uniform = torch.rand(x.shape[0], generator=generator, device=x.device)
    binary = torch.floor(keep + uniform.to(x.dtype)).reshape(-1, *(1,) * (x.dim() - 1))
    return x / keep * binary


def set_generator(module: nn.Module, generator: torch.Generator | None) -> nn.Module:
    """Give every dropout and drop-connect site under ``module`` the
    generator its masks are drawn from in training mode."""
    for m in module.modules():
        if hasattr(type(m), "generator"):
            m.generator = generator
    return module


def compute_dtype(m: nn.Module) -> torch.dtype:
    """The dtype a conv module computes in: the one :func:`set_compute_dtype`
    gave it, else its weight's."""
    return getattr(m, "compute_dtype", None) or m.weight.dtype


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a conv module in its compute dtype: input, weight and bias cast
    to it in this call (a no-op where they are in it already). Below
    float32 the bias is added to the rounded convolution, so the sum is
    rounded twice as flax's ``nn.Conv`` rounds it (``lax.conv`` then ``+
    bias``); oneDNN on the CPU would fold the bias into the convolution's
    one rounding, cuDNN's path adds it after as here."""
    dt = compute_dtype(m)
    w = m.weight.to(dt)
    b = None if m.bias is None else m.bias.to(dt)
    fn = _FUNCTIONS[type(m)]
    if isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        args = (m.stride, m.padding, m.output_padding, m.groups, m.dilation)
    else:
        args = (m.stride, m.padding, m.dilation, m.groups)
    if b is None or dt == torch.float32:
        return _apply(fn, x.to(dt), w, b, args)
    y = _apply(fn, x.to(dt), w, None, args)
    return y + b.reshape(-1, *(1,) * (y.dim() - 2))


def _apply(fn, x: torch.Tensor, w: torch.Tensor, b, args: tuple) -> torch.Tensor:
    """``fn(x, w, b, *args)`` in x's dtype, its sums in float32 and each
    result (output, input and weight gradients) rounded once. A convolution
    of one pixel (the SE gates; the last BiFPN level of a 128^2 input) runs
    in float32 and rounds after: on an H100 cuDNN's bf16 input gradient of
    the SE gates is not rounded once (up to 2.3x the error of one rounding,
    about half its elements off; PERF.md)."""
    if x.dtype != torch.float32 and all(n == 1 for n in x.shape[2:]):
        b = None if b is None else b.float()
        return fn(x.float(), w.float(), b, *args).to(x.dtype)
    return fn(x, w, b, *args)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Pixel repetition. With a graph it is a broadcast, whose backward sums
    each block's gradient in float32 and rounds once, as XLA's VJP of
    ``jnp.repeat`` does; ``repeat_interleave``'s would add in bf16."""
    if torch.is_grad_enabled() and x.requires_grad:
        n, c, h, w = x.shape
        return x[:, :, :, None, :, None].expand(n, c, h, factor, w, factor).reshape(
            n, c, h * factor, w * factor)
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make every convolution under ``module`` compute in ``dtype``; the
    parameters keep theirs (bf16 training on float32 masters)."""
    for m in module.modules():
        if isinstance(m, _CONVS):
            m.compute_dtype = dtype
    return module


def cast_convs(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Serving: make ``dtype`` the compute dtype and cast every convolution's
    weight and bias to it once, in channels-last memory; other parameters
    (fusion weights) stay float32, and so does a weight marked
    ``transformed`` (V2V's fused front conv, whose kernels are transformed
    from the float32 weight and then rounded once)."""
    set_compute_dtype(module, dtype)
    for m in module.modules():
        if isinstance(m, _CONVS):
            fmt = (torch.channels_last if m.weight.dim() == 4
                   else torch.channels_last_3d)
            m.to(memory_format=fmt, **({} if getattr(m, "transformed", False)
                                       else {"dtype": dtype}))
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
