"""K15: the stride-2 heatmap head, torch's ConvTranspose2d(k=4, s=2, p=1,
no bias), on a channels-last map.

Replaces ``jarvis_hybridnet_tpu/models/layers.py:90-135``
(``ConvTranspose2dTorch``) as EfficientTrack's ``deconv1`` uses it
(``models/efficienttrack.py:75-78``). CUDA source: ``csrc/heatmap_head.cu``:
one launch per call; bf16 on warp-level tensor cores (``mma.sync``, float32
accumulators: a product per output parity with 8 or more output channels,
the four parities in one product with 1 or 2), anything else (float32, 3
to 7 channels) in float32 FFMA. Sums in float32 over the operands in
the working type, rounded once. With ``width`` the output is the padded
rows buffer of the 3D cascade (``models/hybridnet.py``): the interior at
(1, 1) of (N, 2h + 2, 2w + 2, width), its border and lanes Cout..width
zeros. Registered as ``jarvis_torch::heatmap_head``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132  # H100 SXM
_SMEM_MAX = 232448  # a block's dynamic shared memory on an H100
MAX_CIN = 160  # EfficientTrack large's final_layer_sizes
FFMA_THREADS = 128  # csrc/heatmap_head.cu's head_ffma block
FFMA_BLOCKS_PER_SM = 4
MMA_BLOCKS_PER_SM = {1: 2, 2: 4}  # head_mma, head_mma_par: 8 warps each


def heatmap_head_plain(x: torch.Tensor, w: torch.Tensor, width: int = 0) -> torch.Tensor:
    """Plain PyTorch version: ``conv_transpose2d(x, w, stride 2, padding
    1)`` summed in float32 over x (N, Cin, h, w) and w (Cin, Cout, 4, 4) in
    the working type and rounded once to it, channels-last (N, Cout, 2h,
    2w). With ``width`` >= Cout the padded rows (N, 2h + 2, 2w + 2, width):
    the head's output at (1, 1), zeros elsewhere."""
    y = F.conv_transpose2d(x.float(), w.float(), stride=2, padding=1).to(x.dtype)
    if not width:
        return y.contiguous(memory_format=torch.channels_last)
    n, cout, h2, w2 = y.shape
    rows = y.new_zeros((n, h2 + 2, w2 + 2, width))
    rows[:, 1:-1, 1:-1, :cout] = y.permute(0, 2, 3, 1)
    return rows


def heatmap_head(x: torch.Tensor, w: torch.Tensor, width: int = 0) -> torch.Tensor:
    """ConvTranspose2d(k=4, s=2, p=1, no bias) of x (N, Cin, h, w) by w
    (Cin, Cout, 4, 4), both in one working type (float32 or bf16), as
    :func:`heatmap_head_plain`. The registered op
    ``jarvis_torch::heatmap_head``: the plain version on CPU tensors, K15 on
    CUDA tensors (x in channels-last memory, Cin a multiple of 8 up to
    MAX_CIN). No autograd: where a graph is recorded the caller runs the
    convolution itself (``models/efficienttrack.py``)."""
    build.on_cpu(x, w)
    return _op(x, w, int(width))


@torch.library.custom_op("jarvis_torch::heatmap_head", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, w: torch.Tensor, width: int) -> torch.Tensor:
    return heatmap_head_plain(x, w, width)


def _empty(x: torch.Tensor, w: torch.Tensor, width: int) -> torch.Tensor:
    n, _, h, wd = x.shape
    if width:
        return x.new_empty((n, 2 * h + 2, 2 * wd + 2, width))
    return torch.empty((n, w.shape[1], 2 * h, 2 * wd), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def plan(x: torch.Tensor, cout: int, lanes: int) -> tuple[int, int, int]:
    """(path, FFMA lanes, blocks) of a call with ``lanes`` output lanes a
    pixel, ``blocks`` persistent blocks. bf16 runs on tensor cores: path 1
    with 8 or more output channels, path 2 (the four parities in one
    product) with 1 or 2 and at most 8 lanes, as many blocks as fit on the
    SMs (MMA_BLOCKS_PER_SM at most, one per tile at least); else path 0, the
    FFMA kernel with 1 output lane a thread for a single-channel head, else
    8, FFMA_BLOCKS_PER_SM blocks an SM at most."""
    n, cin, h, wd = x.shape
    path = 0
    if x.dtype == torch.bfloat16:
        path = 1 if cout >= 8 else 2 if cout <= 2 and lanes <= 8 else 0
    if path:
        smem = _mma_smem(path, cin, lanes)
        per_sm = max(1, min(MMA_BLOCKS_PER_SM[path], _SMEM_MAX // (smem + 1024)))
        tiles = n * -(-h // 8) * -(-wd // 16)
        return path, 0, max(1, min(tiles, per_sm * _SMS))
    groups = FFMA_THREADS // 8  # input positions a block takes at once
    return 0, (1 if cout == 1 else 8), max(1, min(-(-n * h * wd // groups),
                                                  FFMA_BLOCKS_PER_SM * _SMS))


@_op.register_kernel("cuda")
def _launch(x, w, width):
    if x.dtype not in _DTYPES or w.dtype != x.dtype or x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"heatmap_head: expected float32 or bfloat16 x (N, Cin, h, w) and w of "
                         f"its type, got {x.dtype} {tuple(x.shape)}, {w.dtype} {tuple(w.shape)}")
    n, cin, h, wd = x.shape
    cout = w.shape[1]
    if tuple(w.shape) != (cin, cout, 4, 4) or w.device != x.device:
        raise ValueError(f"heatmap_head: w {tuple(w.shape)} on {w.device} is not a k4 "
                         f"ConvTranspose2d weight for x {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("heatmap_head: x must be in channels-last memory, 16-byte aligned")
    if cin % 8 or cin > MAX_CIN:
        raise ValueError(f"heatmap_head: Cin = {cin} must be a multiple of 8 up to {MAX_CIN}")
    if width and width < cout:
        raise ValueError(f"heatmap_head: rows of width {width} cannot hold {cout} channels")
    out = _empty(x, w, width)
    path, lanes, blocks = plan(x, cout, width or cout)
    err = _fn()(build.ptr(x), build.ptr(w), build.ptr(out), n, h, wd, cin, cout,
                width or cout, int(bool(width)), *w.stride(), _DTYPES[x.dtype], path, lanes,
                blocks, build.stream())
    build.check(err, "heatmap_head")
    heatmap_head.launches += 1
    return out


@_op.register_fake
def _(x, w, width):
    return _empty(x, w, width)


heatmap_head.launches = 0


@functools.cache
def _mma_smem(path: int, cin: int, lanes: int) -> int:
    """A tensor-core path's dynamic shared memory (csrc's MmaPlan)."""
    return build.bind("heatmap_head", "heatmap_head_mma_smem", [ctypes.c_int] * 3)(path, cin,
                                                                                  lanes)


@functools.cache
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("heatmap_head", "heatmap_head", [p] * 3 + [i] * 15 + [p])
