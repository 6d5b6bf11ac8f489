"""K10: per (image, channel) heatmap argmax and maximum (``csrc/argmax2d.cu``).

Replaces the JAX package's ``ops/heatmap.py::argmax_2d`` (:15);
``ops/heatmap.argmax_2d`` dispatches between it and its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def argmax_2d_plain(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K10: the per-channel spatial argmax of
    (..., H, W, C) NHWC heatmaps. Returns (xy (..., C, 2) int32, maxvals
    (..., C) float32): the first maximal index m in row-major order, x = m %
    W, y = m // W."""
    h, w, c = heatmaps.shape[-3:]
    flat = torch.movedim(heatmaps, -1, -3).reshape(*heatmaps.shape[:-3], c, h * w)
    maxvals, m = flat.max(dim=-1)
    xy = torch.stack([m % w, torch.div(m, w, rounding_mode="floor")], dim=-1)
    return xy.to(torch.int32), maxvals.float()


def vector_loads(hm: torch.Tensor) -> bool:
    """True when K10 reads ``hm`` (N, H, W, C) 16 bytes at a time: each
    channel's rows contiguous (x stride 1), and W, the row, image and channel
    strides and the base whole 16-byte units."""
    v = 16 // hm.element_size()
    sn, sy, sx, sc = hm.stride()
    return (sx == 1 and hm.shape[2] % v == 0 and sy % v == 0 and sn % v == 0
            and (hm.shape[3] == 1 or sc % v == 0) and hm.data_ptr() % 16 == 0)


_BLOCKS = 264  # blocks the tiled launch aims at: two per SM of an H100


def channels_last(hm: torch.Tensor) -> bool:
    """True when ``hm`` (N, H, W, C), C > 1, holds each pixel's C values
    contiguously and its pixels densely (the channels-last heads): K10 then
    takes the tiled launch."""
    _, _, w, c = hm.shape
    _, sy, sx, sc = hm.stride()
    return c > 1 and sc == 1 and sx == c and sy == w * c


def tile_plan(n: int, hw: int, c: int) -> tuple[int, int, int]:
    """(threads, tiles, per) of the tiled launch: blocks of c * L threads
    (L lanes a channel, c * L <= 512 unless c alone is more), ``tiles``
    tiles of ``per`` pixels an image, about ``_BLOCKS`` blocks in all and no
    tile shorter than its lanes."""
    lanes = max(1, 512 // c)
    tiles = max(1, min(-(-_BLOCKS // n), -(-hw // lanes)))
    return c * lanes, tiles, -(-hw // tiles)


def argmax2d(hm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(xy (N, C, 2) int32, maxvals (N, C) float32) of heatmaps ``hm`` (N, H,
    W, C), float32 or bfloat16, read through their strides (no copy). A CPU
    tensor runs the plain version; a CUDA tensor launches K10 (one
    ``__global__`` launch on the current stream: the tiled one for
    channels-last heads, else a block per channel)."""
    if build.on_cpu(hm):
        return argmax_2d_plain(hm)
    if hm.dtype not in _DTYPES or hm.dim() != 4:
        raise ValueError(f"argmax2d: expected float32 or bfloat16 (N, H, W, C), got "
                         f"{hm.dtype} {tuple(hm.shape)}")
    N, H, W, C = hm.shape
    xy = torch.empty((N, C, 2), dtype=torch.int32, device=hm.device)
    maxv = torch.empty((N, C), dtype=torch.float32, device=hm.device)
    if channels_last(hm):
        if C > 1024:
            raise ValueError(f"argmax2d: {C} channels, more than a block's 1024 threads")
        threads, tiles, per = tile_plan(N, H * W, C)
        part_v = torch.empty(N * tiles * C, dtype=torch.float32, device=hm.device)
        part_i = torch.empty(N * tiles * C, dtype=torch.int32, device=hm.device)
        ticket = build.sync_words(hm.device, "argmax2d")
        err = _tiles_fn()(build.ptr(hm), N, H, W, C, hm.stride(0), _DTYPES[hm.dtype], tiles,
                          per, threads, build.ptr(part_v), build.ptr(part_i), build.ptr(ticket),
                          build.ptr(xy), build.ptr(maxv), build.stream())
    else:
        err = _fn()(build.ptr(hm), N, H, W, C, *hm.stride(), _DTYPES[hm.dtype],
                    int(vector_loads(hm)), build.ptr(xy), build.ptr(maxv), build.stream())
    build.check(err, "argmax2d")
    argmax2d.launches += 1
    return xy, maxv


argmax2d.launches = 0


@functools.cache
def _fn():
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return build.bind("argmax2d", "argmax2d", [p, i, i, i, i, q, q, q, q, i, i, p, p, p])


@functools.cache
def _tiles_fn():
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return build.bind("argmax2d", "argmax2d_tiles", [p, i, i, i, i, q, i, i, i, i] + [p] * 6)
