"""K14: x * sigmoid(g), the squeeze-and-excitation gate and SiLU.

Replaces ``jarvis_hybridnet_tpu/models/efficientnet.py:171-175``
(``jax.nn.sigmoid(se) * x``) and ``models/layers.py:46`` (``jax.nn.silu``)
between the gate's two 1x1 convolutions, taken as ``se_gate(r, r)``. CUDA
source: ``csrc/se_gate.cu``: one launch per call, g (N, C) broadcast over
x's spatial positions, x in channels-last memory. The sigmoid is
:func:`sigmoid`'s, rounded to the working type after each op as XLA rounds
``jax.nn.sigmoid`` in bfloat16. Registered as ``jarvis_torch::se_gate``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .instance_norm import _exp

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # a block's threads, rounded to whole rows of channel vectors
BLOCKS_PER_SM = 4  # blocks the grid aims at per SM of an H100
_SMS = 132


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) op by op (``exp`` through ``_exp``'s check), so in
    bfloat16 it rounds where XLA rounds ``jax.nn.sigmoid``."""
    return 1.0 / (1.0 + _exp(-x))


def silu_plain(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), as ``jax.nn.silu``."""
    return x * sigmoid(x)


def se_gate_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: sigmoid(g) * x, g (N, C, 1, 1) broadcast over
    x (N, C, *spatial). Differentiable through autograd."""
    return sigmoid(g) * x


def se_gate(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(g) for x (N, C, *spatial) and g (N, C, 1, ...) in one
    dtype; ``se_gate(r, r)`` is SiLU of r. Where grad is enabled and an
    input requires it, the plain version's autograd chain runs (the kernel
    has no backward yet); otherwise the registered op
    ``jarvis_torch::se_gate``: the plain version on CPU tensors, K14 on
    CUDA tensors (x in channels-last memory). The output is laid out as the
    plain version's (:func:`_like`)."""
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad):
        return se_gate_plain(x, g)
    build.on_cpu(x, g)
    return _op(x, g)


@torch.library.custom_op("jarvis_torch::se_gate", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return se_gate_plain(x, g)


def _like(x: torch.Tensor) -> torch.Tensor:
    """An empty output laid out as torch lays out ``sigmoid(g) * x``:
    contiguous where x is (a gate's (N, C, 1, 1)), else x's strides."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device) if x.is_contiguous() \
        else torch.empty_like(x)


def _rows(x: torch.Tensor) -> tuple[int, int, int]:
    """(N, S, C) of x (N, C, *spatial)."""
    n, c = x.shape[0], x.shape[1]
    return n, x.numel() // max(1, n * c), c


@_op.register_kernel("cuda")
def _launch(x, g):
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError(f"se_gate: expected a float32 or bfloat16 CUDA x, got {x.dtype} on "
                         f"{x.device}")
    n, s, c = _rows(x)
    if x.dim() < 2 or x.dim() > 5:
        raise ValueError(f"se_gate: x must be (N, C, *spatial), got {tuple(x.shape)}")
    layout = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    if x.dim() > 3 and not x.is_contiguous(memory_format=layout):
        raise ValueError("se_gate: x must be in channels-last memory")
    if x.dim() <= 3 and s > 1:
        raise ValueError("se_gate: x without spatial dims of its own must be (N, C[, 1])")
    if g.dtype != x.dtype or g.numel() != n * c or g.shape[:2] != x.shape[:2]:
        raise ValueError(f"se_gate: g {tuple(g.shape)} {g.dtype} does not gate x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not g.is_contiguous():
        raise ValueError("se_gate: expected a contiguous g")
    vec = next(v for v in (8, 4, 2, 1)
               if v * x.element_size() <= 16 and c % v == 0
               and (x.data_ptr() // x.element_size()) % v == 0)
    groups = c // vec
    if groups > 1024:
        raise ValueError(f"se_gate: C = {c} needs {groups} channel vectors, more than 1024")
    lanes = max(1, THREADS // groups)
    blocks = max(1, min(-(-s // lanes), -(-BLOCKS_PER_SM * _SMS // n)))
    span = -(-s // blocks)
    blocks = -(-s // span)
    out = _like(x)
    err = _fn()(build.ptr(x), build.ptr(g), build.ptr(out), n, s, c, vec, groups * lanes, blocks,
                span, _DTYPES[x.dtype], build.stream())
    build.check(err, "se_gate")
    se_gate.launches += 1
    return out


@_op.register_fake
def _(x, g):
    return _like(x)


se_gate.launches = 0


@functools.cache
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("se_gate", "se_gate", [p] * 3 + [i] * 8 + [p])
