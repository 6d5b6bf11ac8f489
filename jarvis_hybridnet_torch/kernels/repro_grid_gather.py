"""K5: the exact, half and half_fused voxel reprojection modes.

Replaces ``models/repro.py`` ``reprojection_layer``'s exact mode
(repro.py:266-273: ``reproject_indices`` with the trilinear index upsample
and ``gather_voxel_volume``) and its half / half_fused modes (:302-317: the
half-grid gather and, for half, the 0.25/0.75 value upsample). CUDA source:
``csrc/repro_grid_gather.cu``: one launch per call, a block per tile of
``TILE[mode]``^3 half-grid points of one frameset.

The rows are gathered in their own dtype and summed in float32. JAX's
exact mode gathers float32 (``hybridnet.py:73,84-85``); a bf16 row widened
to float32 is exactly the value it gathers from its float32 cast of the
same bf16 heatmaps, so every mode may read bf16 rows.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .repro_gather import _DTYPES, _upsample2, camera_mean, check_cameras, reproject_indices_plain

MODES = {"exact": 0, "half": 1, "half_fused": 2}
# half-grid points per tile edge, by mode (kernel_sweep.py times the others)
TILE = {"exact": 4, "half": 6, "half_fused": 6}


def repro_grid_gather_plain(rows, center3d, center_hm, P, K, D, grid_size: int,
                            grid_spacing: float, mode: str):
    """Plain PyTorch version; returns (volume, indices)."""
    B, hs2, J = rows.shape[0], rows.shape[2], rows.shape[3]
    idx = reproject_indices_plain(center3d, center_hm, P, K, D, grid_size, grid_spacing,
                                  math.isqrt(hs2), upsample=mode == "exact")
    n = grid_size if mode == "exact" else grid_size // 2
    vol = camera_mean(rows, idx).reshape(B, n, n, n, J)
    if mode == "half":
        for axis in (1, 2, 3):
            vol = _upsample2(vol, axis)
    return vol, idx


def repro_grid_gather(rows: torch.Tensor, center3d: torch.Tensor,
                      center_hm: torch.Tensor, P: torch.Tensor, K: torch.Tensor,
                      D: torch.Tensor, grid_size: int, grid_spacing: float, mode: str,
                      return_indices: bool = False):
    """Voxel volume of the G^3 cube (G = ``grid_size``, even) in float32:
    (B, G, G, G, J) for exact and half, (B, G/2, G/2, G/2, J) for half_fused.

    rows: (B, C, hs*hs, J) padded heatmaps, J contiguous (bf16 or f32);
    center3d (B, 3) and center_hm (B, C, 2) int32; P (B, C, 4, 3),
    K (B, C, 3, 3), D (B, C, 1, 5) float32. With ``return_indices`` the
    int32 gather indices come back too: (B, C, G^3) for exact, (B, C,
    (G/2)^3) for the half modes.
    """
    if mode not in MODES:
        raise ValueError(f"repro_grid_gather: unknown mode {mode!r}")
    if grid_size % 2:
        raise ValueError(f"repro_grid_gather: grid_size must be even, got {grid_size}")
    if build.on_cpu(rows, center3d, center_hm, P, K, D):
        vol, idx = repro_grid_gather_plain(rows, center3d, center_hm, P, K, D, grid_size,
                                           grid_spacing, mode)
        return (vol, idx) if return_indices else vol
    B, C, hs, J = check_cameras(rows, center3d, center_hm, P, K, D)
    n = grid_size // 2 if mode == "half_fused" else grid_size
    dev = rows.device
    out = torch.empty((B, n, n, n, J), dtype=torch.float32, device=dev)
    n_idx = grid_size ** 3 if mode == "exact" else (grid_size // 2) ** 3
    idx = (torch.empty((B, C, n_idx), dtype=torch.int32, device=dev)
           if return_indices else None)
    p = build.ptr
    err = _fn()(p(rows), p(center3d), p(center_hm), p(P), p(K), p(D), p(out), p(idx),
                B, C, J, hs, grid_size // 2, TILE[mode], float(grid_spacing) * 2.0,
                MODES[mode], _DTYPES[rows.dtype], build.stream())
    build.check(err, "repro_grid_gather")
    repro_grid_gather.launches += 1
    return (out, idx) if return_indices else out


repro_grid_gather.launches = 0


@functools.cache
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("repro_grid_gather", "repro_grid_gather",
                      [p] * 8 + [i] * 6 + [ctypes.c_float, i, i, p])
