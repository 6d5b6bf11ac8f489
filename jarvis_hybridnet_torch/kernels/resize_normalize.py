"""K4: uint8 frames -> bilinear resize (no antialias) -> ImageNet normalize.

Replaces ``ops/image.py`` ``resize_bilinear`` (:64), ``resize_bilinear_mxu``
(:101) and ``normalize_imagenet`` (:127) as ``predictor3d.py:96-108`` uses
them. CUDA source: ``csrc/resize_normalize.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    """Plain PyTorch version: uint8 (N, H, W, 3) -> (N, height, width, 3)."""
    y = _resize_axis(_resize_axis(x, 1, height), 2, width) / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return ((y - mean) / std).to(dtype)


def resize_normalize(x: torch.Tensor, height: int, width: int, mean, std,
                     dtype=torch.float32) -> torch.Tensor:
    """Resize uint8 frames (N, H, W, 3) to (N, height, width, 3) with
    half-pixel bilinear taps and no antialias, then (x/255 - mean) / std.
    Computes in float32 and rounds once to ``dtype`` (f32 or bf16)."""
    if build.on_cpu(x):
        return resize_normalize_plain(x, height, width, mean, std, dtype)
    build.require(x, "x", (torch.uint8,), ndim=4)
    if x.shape[-1] != 3 or dtype not in _DTYPES:
        raise ValueError(f"expected (N, H, W, 3) uint8 -> f32/bf16, got "
                         f"{tuple(x.shape)} -> {dtype}")
    N, H, W, _ = x.shape
    dev = str(x.device)
    hi0, hi1, hw1 = _device_tables(height, H, dev)
    wi0, wi1, ww1 = _device_tables(width, W, dev)
    out = torch.empty((N, height, width, 3), dtype=dtype, device=x.device)
    m = [float(v) for v in mean]
    s = [float(v) for v in std]
    p = build.ptr
    err = _fn()(p(x), p(out), N, H, W, height, width, p(hi0), p(hi1), p(hw1),
                p(wi0), p(wi1), p(ww1), *m, *s, _DTYPES[dtype], build.stream())
    build.check(err, "resize_normalize")
    resize_normalize.launches += 1
    return out


resize_normalize.launches = 0


@functools.cache
def _fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("resize_normalize", "resize_normalize",
                      [p, p, i, i, i, i, i] + [p] * 6 + [f] * 6 + [i, p])
