"""K3: softplus + soft-argmax + confidences, the HybridNet epilogue.

Replaces ``models/hybridnet.py:95-112``. CUDA source: ``csrc/soft_argmax.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 2 * 132
_MIN_VOXELS_PER_CHUNK = 512


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), with no large-x threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def soft_argmax_plain(vol: torch.Tensor, center3d: torch.Tensor,
                      grid_spacing: float, cube: float):
    """Plain PyTorch version: vol (B, g, g, g, J) -> (points (B, J, 3) mm,
    confidences (B, J))."""
    out = softplus(vol.float())
    B, g, J = out.shape[0], out.shape[1], out.shape[-1]
    coords = torch.arange(g, dtype=torch.float32, device=vol.device)
    norm = out.sum(dim=(1, 2, 3))
    x = torch.einsum("bxyzj,x->bj", out, coords) / norm
    y = torch.einsum("bxyzj,y->bj", out, coords) / norm
    z = torch.einsum("bxyzj,z->bj", out, coords) / norm
    points = torch.stack([x, y, z], dim=-1)
    points3d = (points * grid_spacing * 2.0 - cube / 2.0
                + center3d[:, None, :].float())
    maxvals = out.reshape(B, -1, J).amax(dim=1)
    return points3d, torch.clamp(maxvals, max=255.0) / 255.0


def soft_argmax(vol: torch.Tensor, center3d: torch.Tensor, grid_spacing: float,
                cube: float):
    """Soft-argmax of the V2V output in world mm, and per-joint confidence.

    vol: (B, g, g, g, J) contiguous, bf16 or f32 (J <= 256); center3d (B, 3)
    int32 cube centers. Voxel (x, y, z) maps to
    ``(x, y, z) * grid_spacing * 2 - cube / 2 + center3d``.
    """
    if build.on_cpu(vol, center3d):
        return soft_argmax_plain(vol, center3d, grid_spacing, cube)
    build.require(vol, "vol", _DTYPES, ndim=5)
    build.require(center3d, "center3d", (torch.int32,), ndim=2)
    B, g, J = vol.shape[0], vol.shape[1], vol.shape[-1]
    if vol.shape[1:4] != (g, g, g) or J > 256 or center3d.shape != (B, 3):
        raise ValueError(f"vol must be (B, g, g, g, J<=256), got {tuple(vol.shape)}")
    nvox = g ** 3
    chunks = max(1, min(-(-_TARGET_BLOCKS // B), nvox // _MIN_VOXELS_PER_CHUNK))
    per_chunk = -(-nvox // chunks)
    chunks = -(-nvox // per_chunk)
    dev = vol.device
    part = torch.empty((B, chunks, 5, J), dtype=torch.float32, device=dev)
    points = torch.empty((B, J, 3), dtype=torch.float32, device=dev)
    conf = torch.empty((B, J), dtype=torch.float32, device=dev)
    p = build.ptr
    err = _fn()(p(vol), p(center3d), p(part), p(points), p(conf), B, g, J,
                per_chunk, chunks, float(grid_spacing), float(cube),
                _DTYPES[vol.dtype], build.stream())
    build.check(err, "soft_argmax")
    soft_argmax.launches += 1
    return points, conf


soft_argmax.launches = 0


@functools.cache
def _fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("soft_argmax", "soft_argmax",
                      [p] * 5 + [i, i, i, i, i, f, f, i, p])
