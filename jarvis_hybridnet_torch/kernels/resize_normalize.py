"""K4: uint8 or float32 frames -> bilinear resize (no antialias) -> ImageNet
normalize.

Replaces ``ops/image.py`` ``resize_bilinear`` (:64), ``resize_bilinear_mxu``
(:101) and ``normalize_imagenet`` (:127) as ``predictor3d.py:96-108`` and
``predictor2d.py:83-92`` use them: uint8 frames are divided by 255 after the
resize, float32 frames in [0, 1] are not (the JAX ``value_scale``). CUDA
source: ``csrc/resize_normalize.cu``, one instantiation per (input, output)
type. Registered as ``jarvis_torch::resize_normalize`` (``kernels/__init__``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INPUTS = (torch.uint8, torch.float32)


def value_scale(x: torch.Tensor) -> float:
    """255 for uint8 frames, 1 for float frames in [0, 1]
    (``predictor3d.py:88-89``)."""
    return 255.0 if x.dtype == torch.uint8 else 1.0


@functools.lru_cache(maxsize=None)
def linear_tables(out_size: int, in_size: int):
    """Half-pixel source taps (i0, i1) and weight w1 per output index, as
    ``ops/image.py:_linear_tables``."""
    i = np.arange(out_size, dtype=np.float64)
    s = (i + 0.5) * (in_size / out_size) - 0.5
    s = np.clip(s, 0.0, in_size - 1)
    i0 = np.floor(s).astype(np.int32)
    i1 = np.minimum(i0 + 1, in_size - 1).astype(np.int32)
    w1 = (s - i0).astype(np.float32)
    return i0, i1, w1


@functools.lru_cache(maxsize=None)
def _device_tables(out_size: int, in_size: int, device: str):
    return tuple(torch.from_numpy(t).to(device)
                 for t in linear_tables(out_size, in_size))


def _resize_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    i0, i1, w1 = (torch.from_numpy(t).to(x.device) for t in
                  linear_tables(out_size, x.shape[axis]))
    a = x.index_select(axis, i0.long()).float()
    b = x.index_select(axis, i1.long()).float()
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = w1.reshape(shape)
    return a * (1.0 - w) + b * w


def resize_normalize_plain(x: torch.Tensor, height: int, width: int, mean,
                           std, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: uint8 or float32 (N, H, W, 3) ->
    (N, height, width, 3)."""
    y = _resize_axis(_resize_axis(x, 1, height), 2, width)
    if x.dtype == torch.uint8:
        y = y / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return ((y - mean) / std).to(dtype)


def resize_normalize(x: torch.Tensor, height: int, width: int, mean, std,
                     dtype=torch.float32) -> torch.Tensor:
    """Resize frames (N, H, W, 3) to (N, height, width, 3) with half-pixel
    bilinear taps and no antialias, then (x / value_scale - mean) / std, for
    uint8 frames (value_scale 255) or float32 frames in [0, 1] (value_scale
    1). Computes in float32 and rounds once to ``dtype`` (f32 or bf16).
    Runs the registered op ``jarvis_torch::resize_normalize``: the plain
    version on a CPU tensor, K4 on a CUDA tensor."""
    build.on_cpu(x)
    return _op(x, int(height), int(width), [float(v) for v in mean],
               [float(v) for v in std], dtype)


@torch.library.custom_op("jarvis_torch::resize_normalize", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, height: int, width: int, mean: list[float], std: list[float],
        dtype: torch.dtype) -> torch.Tensor:
    return resize_normalize_plain(x, height, width, mean, std, dtype)


@_op.register_kernel("cuda")
def _launch(x, height, width, mean, std, dtype):
    build.require(x, "x", _INPUTS, ndim=4)
    if x.shape[-1] != 3 or dtype not in _DTYPES:
        raise ValueError(f"expected (N, H, W, 3) uint8/f32 -> f32/bf16, got "
                         f"{tuple(x.shape)} -> {dtype}")
    N, H, W, _ = x.shape
    dev = str(x.device)
    hi0, hi1, hw1 = _device_tables(height, H, dev)
    wi0, wi1, ww1 = _device_tables(width, W, dev)
    out = torch.empty((N, height, width, 3), dtype=dtype, device=x.device)
    p = build.ptr
    err = _fn()(p(x), p(out), N, H, W, height, width, p(hi0), p(hi1), p(hw1),
                p(wi0), p(wi1), p(ww1), *mean, *std, _DTYPES[dtype],
                int(x.dtype == torch.float32), build.stream())
    build.check(err, "resize_normalize")
    resize_normalize.launches += 1
    return out


@_op.register_fake
def _(x, height, width, mean, std, dtype):
    return x.new_empty((x.shape[0], height, width, 3), dtype=dtype)


resize_normalize.launches = 0


@functools.cache
def _fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("resize_normalize", "resize_normalize",
                      [p, p, i, i, i, i, i] + [p] * 6 + [f] * 6 + [i, i, p])
