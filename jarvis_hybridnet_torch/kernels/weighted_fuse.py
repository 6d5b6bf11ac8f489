"""K13: a BiFPN fusion, or EfficientTrack's merge, in one pass.

Replaces ``jarvis_hybridnet_tpu/models/bifpn.py:20-30`` (``_FusionWeights``)
with the fusions at :78-118, and the merge of
``models/efficienttrack.py:62-69``. CUDA source: ``csrc/weighted_fuse.cu``:
one launch per call, channels-last inputs read in place in their modes
(the same size, a nearest x2 or x4 upsample, a floor-mode 2x2 max pool), the
weights normalized in the kernel, the sum (and a fusion's SiLU) in float32,
the output written once in the inputs' dtype. Registered as
``jarvis_torch::weighted_fuse``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .se_gate import silu_plain
from .soft_argmax import softplus

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"same": 0, "up2": 1, "up4": 2, "pool": 3}
THREADS = 256  # csrc/weighted_fuse.cu's block
BLOCKS = 132 * 16  # the grid's cap: a grid-stride loop covers the rest


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


def _in_mode(x: torch.Tensor, mode: str) -> torch.Tensor:
    """An input as the sum reads it."""
    if mode == "pool":
        return max_pool_2x2(x)
    if mode == "same":
        return x
    return upsample_nearest(x, 2 if mode == "up2" else 4)


def fusion_weights(w: torch.Tensor, merge: bool) -> torch.Tensor:
    """ReLU-ed weights (the merge: softplus) normalized to sum one (+1e-4),
    as ``_FusionWeights`` and ``efficienttrack.py:64-66``."""
    w = softplus(w) if merge else torch.clamp_min(w, 0.0)
    return w / (w.sum() + 1e-4)


def _chain(w: torch.Tensor, xs, modes, merge: bool) -> torch.Tensor:
    """The weighted sum ((w0 x0) + w1 x1) + w2 x2 of the inputs in their
    modes, float32, then SiLU for a fusion: float32 (N, C, H, W)."""
    wn = fusion_weights(w, merge)
    out = wn[0] * _in_mode(xs[0], modes[0]).float()
    for i in range(1, len(xs)):
        out = out + wn[i] * _in_mode(xs[i], modes[i]).float()
    return out if merge else silu_plain(out)


def weighted_fuse_plain(w: torch.Tensor, xs, modes, merge: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the float32 fusion of :func:`_chain` rounded
    to the inputs' dtype (what the next convolution casts it to), laid out
    as :func:`_empty_out`."""
    out = _chain(w, xs, modes, merge).to(xs[0].dtype)
    return out.contiguous() if out.shape[2] * out.shape[3] == 1 else out.contiguous(
        memory_format=torch.channels_last)


def _empty_out(shape, like: torch.Tensor) -> torch.Tensor:
    """An empty (N, C, H, W) output in channels-last memory; contiguous at
    one pixel, as torch lays out the chain's sum there."""
    fmt = torch.contiguous_format if shape[2] * shape[3] == 1 else torch.channels_last
    return torch.empty(shape, dtype=like.dtype, device=like.device, memory_format=fmt)


def weighted_fuse(w: torch.Tensor, xs, modes, merge: bool = False) -> torch.Tensor:
    """Fuse 2 or 3 maps xs (N, C, h_i, w_i), each read in its mode of
    ``MODES`` (``same``, ``up2`` / ``up4``: nearest upsample, ``pool``: 2x2
    max pool), with the raw float32 weights ``w``: ReLU-ed (``merge``:
    softplus) and normalized, the float32 weighted sum, then SiLU unless
    ``merge``. Where grad is enabled and an input requires it, the plain
    autograd chain runs and returns the float32 sum (the kernel has no
    backward yet); otherwise the registered op ``jarvis_torch::weighted_fuse``
    returns it rounded to the inputs' dtype: the plain version on CPU
    tensors, K13 on CUDA tensors."""
    if len(xs) not in (2, 3) or len(modes) != len(xs):
        raise ValueError(f"weighted_fuse takes 2 or 3 inputs with a mode each, got "
                         f"{len(xs)} and {len(modes)}")
    if any(m not in MODES for m in modes):
        raise ValueError(f"unknown modes {modes}; expected {tuple(MODES)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w, *xs)):
        return _chain(w, xs, modes, merge)
    build.on_cpu(w, *xs)
    return _op(w, xs[0], xs[1], xs[2] if len(xs) == 3 else None,
               [MODES[m] for m in modes], merge)


def _out_size(x: torch.Tensor, mode: int) -> tuple[int, int]:
    h, w = x.shape[2], x.shape[3]
    if mode == MODES["pool"]:
        return h // 2, w // 2
    f = {MODES["up2"]: 2, MODES["up4"]: 4}.get(mode, 1)
    return h * f, w * f


def _inputs(x0, x1, x2):
    return [t for t in (x0, x1, x2) if t is not None]


@torch.library.custom_op("jarvis_torch::weighted_fuse", mutates_args=(), device_types="cpu")
def _op(w: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor | None,
        modes: list[int], merge: bool) -> torch.Tensor:
    names = {v: k for k, v in MODES.items()}
    return weighted_fuse_plain(w, _inputs(x0, x1, x2), [names[m] for m in modes], merge)


@_op.register_kernel("cuda")
def _launch(w, x0, x1, x2, modes, merge):
    xs = _inputs(x0, x1, x2)
    build.require(w, "w", (torch.float32,), ndim=1)
    if w.numel() != len(xs):
        raise ValueError(f"weighted_fuse: {w.numel()} weights for {len(xs)} inputs")
    n, c = x0.shape[:2]
    h, wd = _out_size(x0, modes[0])
    rows = []
    for i, (x, m) in enumerate(zip(xs, modes)):
        if x.dim() != 4 or x.dtype != x0.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"weighted_fuse: input {i} {tuple(x.shape)} {x.dtype}: expected "
                             f"(N, C, H, W) in float32 or bfloat16, all in one dtype")
        if x.shape[:2] != (n, c) or _out_size(x, m) != (h, wd):
            raise ValueError(f"weighted_fuse: input {i} {tuple(x.shape)} in mode {m} does not "
                             f"give ({n}, {c}, {h}, {wd})")
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"weighted_fuse: input {i} is not in channels-last memory")
        rows.append(x)
    out = _empty_out((n, c, h, wd), x0)
    size = x0.element_size()
    vec = next(v for v in (8, 4, 2, 1)
               if v * size <= 16 and c % v == 0
               and all((t.data_ptr() // size) % v == 0 for t in rows))
    items = n * h * wd * (c // vec)
    blocks = max(1, min(BLOCKS, -(-items // THREADS)))
    dims = [(t.shape[2], t.shape[3], m) for t, m in zip(rows, modes)] + [(0, 0, 0)]
    err = _fn()(build.ptr(x0), build.ptr(x1), build.ptr(x2), build.ptr(w), build.ptr(out),
                *dims[0], *dims[1], *dims[2], len(rows), n, h, wd, c, vec, int(merge),
                _DTYPES[x0.dtype], blocks, build.stream())
    build.check(err, "weighted_fuse")
    weighted_fuse.launches += 1
    return out


@_op.register_fake
def _(w, x0, x1, x2, modes, merge):
    h, wd = _out_size(x0, modes[0])
    return _empty_out((x0.shape[0], x0.shape[1], h, wd), x0)


weighted_fuse.launches = 0


@functools.cache
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("weighted_fuse", "weighted_fuse", [p] * 5 + [i] * 18 + [p])
