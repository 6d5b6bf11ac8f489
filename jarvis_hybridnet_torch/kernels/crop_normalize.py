"""K16: the crop windows of frames at their centers, normalized.

Replaces the crop and normalize of
``jarvis_hybridnet_tpu/prediction/predictor3d.py:136-143`` and
``predictor2d.py:106-113``: the ``size``^2 window whose corner is (cx -
size/2, cy - size/2), placed in the frame as ``jax.lax.dynamic_slice``
places it (a negative start counts from the end, then the start is clamped
to [0, extent - size]), of uint8 or float32 [0, 1] frames, then ``(x / value_scale -
mean) / std`` in float32 and one rounding to the output type. CUDA source:
``csrc/crop_normalize.cu``: one launch per call. Registered as
``jarvis_torch::crop_normalize``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .resize_normalize import value_scale

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INPUTS = (torch.uint8, torch.float32)


def corners(centers: torch.Tensor | None, size: int, height: int, width: int, n: int, device):
    """The windows' corners (x0, y0) (N,) each: center - size // 2, plus
    the extent where negative, clamped to [0, extent - size]
    (``jax.lax.dynamic_slice``'s start); (0, 0) without centers."""
    if centers is None:
        zero = torch.zeros(n, dtype=torch.int32, device=device)
        return zero, zero

    def start(c, extent):
        s = c - size // 2
        return torch.where(s < 0, s + extent, s).clamp(0, extent - size)

    return start(centers[:, 0], width), start(centers[:, 1], height)


def crop_normalize_plain(frames: torch.Tensor, centers: torch.Tensor | None, size: int, mean,
                         std, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: frames (N, H, W, 3) uint8 or float32, centers
    (N, 2) int32 (cx, cy) or None -> (N, size, size, 3) in ``dtype``. The
    divisors are tensors on the frames' device: CUDA divides by a CPU
    scalar as a product with its reciprocal, which is not IEEE division."""
    n, height, width = frames.shape[:3]
    x0, y0 = corners(centers, size, height, width, n, frames.device)
    r = torch.arange(size, device=frames.device)
    rows = (y0[:, None] + r)[:, :, None]  # (N, size, 1)
    cols = (x0[:, None] + r)[:, None, :]  # (N, 1, size)
    idx = torch.arange(n, device=frames.device)[:, None, None]
    crops = frames[idx, rows, cols].float()  # (N, size, size, 3)

    def dev(v):
        return torch.as_tensor(v, dtype=torch.float32, device=frames.device)

    return ((crops / dev(value_scale(frames)) - dev(mean)) / dev(std)).to(dtype)


def crop_normalize(frames: torch.Tensor, centers: torch.Tensor | None, size: int, mean, std,
                   dtype=torch.float32) -> torch.Tensor:
    """The ``size``^2 windows of frames (N, H, W, 3), uint8 (value_scale
    255) or float32 in [0, 1] (value_scale 1), at centers (N, 2) int32 (cx,
    cy; None: each frame's window at (0, 0)), each (x / value_scale - mean)
    / std in float32, rounded once to ``dtype`` (float32 or bf16): (N,
    size, size, 3), which is the channels-last (N, 3, size, size) a stem
    convolution reads. The registered op ``jarvis_torch::crop_normalize``:
    the plain version on CPU tensors, K16 on CUDA tensors."""
    build.on_cpu(frames, centers)
    if centers is not None:
        centers = centers.reshape(-1, 2).to(torch.int32).contiguous()
    return _op(frames, centers, int(size), [float(v) for v in mean], [float(v) for v in std],
               dtype)


@torch.library.custom_op("jarvis_torch::crop_normalize", mutates_args=(), device_types="cpu")
def _op(frames: torch.Tensor, centers: torch.Tensor | None, size: int, mean: list[float],
        std: list[float], dtype: torch.dtype) -> torch.Tensor:
    return crop_normalize_plain(frames, centers, size, mean, std, dtype)


@_op.register_kernel("cuda")
def _launch(frames, centers, size, mean, std, dtype):
    build.require(frames, "frames", _INPUTS, ndim=4)
    n, height, width, ch = frames.shape
    if ch != 3 or dtype not in _DTYPES or len(mean) != 3 or len(std) != 3:
        raise ValueError(f"crop_normalize: expected (N, H, W, 3) uint8/f32 -> f32/bf16 with 3 "
                         f"means and stds, got {tuple(frames.shape)} -> {dtype}")
    if not 0 < size <= min(height, width):
        raise ValueError(f"crop_normalize: window {size} does not fit {height}x{width} frames")
    if centers is not None:
        build.require(centers, "centers", (torch.int32,), ndim=2)
        if tuple(centers.shape) != (n, 2) or centers.device != frames.device:
            raise ValueError(f"crop_normalize: centers {tuple(centers.shape)} on "
                             f"{centers.device} for {n} frames on {frames.device}")
    out = torch.empty((n, size, size, 3), dtype=dtype, device=frames.device)
    vec = next(v for v in (8, 4, 2, 1) if (3 * size) % v == 0)
    err = _fn()(build.ptr(frames), build.ptr(centers), build.ptr(out), n, height, width, size,
                vec, *mean, *std, _DTYPES[dtype], int(frames.dtype == torch.float32),
                build.stream())
    build.check(err, "crop_normalize")
    crop_normalize.launches += 1
    return out


@_op.register_fake
def _(frames, centers, size, mean, std, dtype):
    return frames.new_empty((frames.shape[0], size, size, 3), dtype=dtype)


crop_normalize.launches = 0


@functools.cache
def _fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("crop_normalize", "crop_normalize",
                      [p, p, p, i, i, i, i, i] + [f] * 6 + [i, i, p])
