"""K1: InstanceNorm fused with the activation or residual that follows it.

Replaces ``tools/fused_norm_bench.py::_kernel`` (the repo's Pallas kernel)
and ``models/layers.py:22`` ``instance_norm`` with its consumers. CUDA source:
``csrc/instance_norm_act.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

ACTS = {"none": 0, "silu": 1, "relu": 2, "add_relu": 3}
EPS = 1e-5  # torch InstanceNorm's default, as models/layers.py:22
# enough blocks for a few waves over the H100's 132 SMs
_TARGET_BLOCKS = 4 * 132
_MIN_ROWS_PER_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance_norm_act_plain(x: torch.Tensor, act: str = "none",
                            skip: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: x (N, S, C), statistics over S in float32.

    As the JAX reference, the normalized value is rounded to x's dtype
    before the activation, ``add_relu`` rounds the sum before the ReLU, and
    SiLU is y * (1 / (1 + exp(-y))) rounded after each op, as XLA evaluates
    ``jax.nn.silu`` in bfloat16.
    """
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + EPS)).to(x.dtype)
    if act == "silu":
        return y * (1.0 / (1.0 + torch.exp(-y)))
    if act == "relu":
        return F.relu(y)
    if act == "add_relu":
        return F.relu(y + skip)
    return y


def _vector_width(c: int, itemsize: int, *tensors) -> int:
    """Channels a thread loads at once: up to 16 bytes, dividing C and the
    tensors' alignment."""
    for v in (8, 4, 2):
        if (v * itemsize <= 16 and c % v == 0
                and all(t.data_ptr() % (v * itemsize) == 0 for t in tensors if t is not None)):
            return v
    return 1


def _chunking(n: int, s: int, tiles: int) -> tuple[int, int]:
    chunks = -(-_TARGET_BLOCKS // (n * tiles))
    chunks = max(1, min(chunks, s // _MIN_ROWS_PER_CHUNK))
    rows = -(-s // chunks)
    return rows, -(-s // rows)


def instance_norm_act(x: torch.Tensor, act: str = "none",
                      skip: torch.Tensor | None = None) -> torch.Tensor:
    """InstanceNorm of x (N, S, C) over S, then ``act``.

    ``act`` is one of none / silu / relu / add_relu; add_relu returns
    relu(IN(x) + skip). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel.
    """
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if (act == "add_relu") != (skip is not None):
        raise ValueError("skip is given exactly when act == 'add_relu'")
    if build.on_cpu(x, skip):
        return instance_norm_act_plain(x, act, skip)
    build.require(x, "x", _DTYPES, ndim=3)
    if skip is not None:
        build.require(skip, "skip", (x.dtype,), ndim=3)
        if skip.shape != x.shape:
            raise ValueError(f"skip shape {tuple(skip.shape)} != {tuple(x.shape)}")
    n, s, c = x.shape
    out = torch.empty_like(x)
    vec = _vector_width(c, x.element_size(), x, skip, out)
    tile_c = min(c, 256 * vec)
    rows, chunks = _chunking(n, s, -(-c // tile_c))
    part = torch.empty((n, chunks, c, 2), dtype=torch.float32, device=x.device)
    err = _fn()(build.ptr(x), build.ptr(skip), build.ptr(out), build.ptr(part),
                n, s, c, vec, tile_c, rows, chunks, EPS, ACTS[act], _DTYPES[x.dtype],
                build.stream())
    build.check(err, "instance_norm_act")
    instance_norm_act.launches += 1
    return out


instance_norm_act.launches = 0


@functools.cache
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("instance_norm_act", "instance_norm_act",
                      [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, p])
