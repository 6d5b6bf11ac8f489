"""K5: the exact, half and half_fused voxel reprojection modes.

Replaces ``models/repro.py`` ``reprojection_layer``'s exact mode
(repro.py:266-273: ``reproject_indices`` with the trilinear index upsample
and ``gather_voxel_volume``) and its half / half_fused modes (:302-317: the
half-grid gather and, for half, the 0.25/0.75 value upsample). CUDA source:
``csrc/repro_grid_gather.cu``: one launch per call, a block per
(frameset, tile) work item, a tile being ``TILE[mode]``^3 half-grid points;
the rows are read in 16-byte loads, so they must be padded
(``repro_gather.pad_rows``).

The rows are gathered in their own dtype and summed in float32. JAX's
exact mode gathers float32 (``hybridnet.py:73,84-85``); a bf16 row widened
to float32 is exactly the value it gathers from its float32 cast of the
same bf16 heatmaps, so every mode may read bf16 rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import build
from .repro_gather import (_DTYPES, _upsample2, camera_mean, check_cameras,
                           reproject_indices_plain)

MODES = {"exact": 0, "half": 1, "half_fused": 2}
# the kernel's constants (csrc/repro_grid_gather.cu)
THREADS = 256
SMEM_MAX = 232_448
CAM_FIELDS = 20
# the tile edges compiled per mode (K5_TILES in the source)
TILES = {"exact": (3, 4), "half": (4, 6), "half_fused": (6, 8)}
# the launch plan's choices (kernel_sweep.py times the others)
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


def _rup4(w: int) -> int:
    return -(-w // 4) * 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers one call.

    Work items are the (frameset, tile) pairs, ``tiles``^3 tiles of
    ``tile``^3 half-grid points per frameset, numbered frameset by frameset;
    block k takes item k. A tile gathers ``points`` points (its full-grid
    voxels for exact, its half-grid points with their halo for half, its own
    for half_fused) in rounds of ``round_points``, each thread holding
    ``tasks`` (point, lane) tasks of ``lanes`` 16-byte loads per row.
    ``smem``: bytes of dynamic shared memory per block."""

    mode: str
    tile: int
    tiles: int
    work: int
    lanes: int
    tasks: int
    points: int
    round_points: int
    smem: int

    def item(self, block: int) -> tuple[int, int, int, int]:
        """Block ``block``'s work item: (frameset, x0, y0, z0), x0.. the
        tile's first half-grid point."""
        b, t = divmod(block, self.tiles ** 3)
        return (b, t // self.tiles ** 2 * self.tile, t // self.tiles % self.tiles * self.tile,
                t % self.tiles * self.tile)

    def rounds(self) -> list[tuple[int, int]]:
        """The [p0, p1) point ranges of a tile's gather rounds."""
        return [(p, min(p + self.round_points, self.points))
                for p in range(0, self.points, self.round_points)]


def make_plan(B: int, C: int, J: int, G: int, mode: str, itemsize: int, tile: int) -> Plan:
    """The plan for a given tile edge; the shared-memory layout and round
    size mirror ``layout`` and ``round_points`` in the source."""
    if tile not in TILES[mode]:
        raise ValueError(f"repro_grid_gather: tile {tile} is not compiled for {mode}")
    halo = 0 if mode == "half_fused" else 1
    e = tile + 2 * halo
    ne = e ** 3
    F = tile if mode == "half_fused" else 2 * tile
    points = F ** 3 if mode == "exact" else ne
    row = 1 if mode == "half" else F
    V = 16 // itemsize
    lanes = -(-J // V)
    tasks = 3 if itemsize == 2 else 4
    rp = min(THREADS * tasks // lanes // row * row, points)
    if rp < 1:
        raise ValueError(f"repro_grid_gather: J = {J} leaves no whole row per round")
    if mode == "exact":
        a = max(2 * C * ne, 2 * C * F * F * e, rp * J)
        b = max(2 * C * F * e * e, C * points)
    elif mode == "half":
        a, b = max(C * ne, 2 * F * e * J), ne * J
    else:
        a, b = C * ne, rp * J
    smem = 4 * (_rup4(C * CAM_FIELDS) + _rup4(a) + _rup4(b))
    if smem > SMEM_MAX:
        raise ValueError(f"repro_grid_gather: {smem} bytes of shared memory")
    tiles = -(-(G // 2) // tile)
    return Plan(mode, tile, tiles, B * tiles ** 3, lanes, tasks, points, rp, smem)


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, C: int, J: int, hs: int, G: int, mode: str, itemsize: int) -> Plan:
    """The kernel's launch plan for a call: the tile edge ``TILE[mode]``
    (the fastest in ``kernel_sweep.py`` at the main path's shapes), or the
    largest compiled edge below it whose shared memory fits. ``hs`` does
    not change the plan; it is part of the key as it is of the call."""
    del hs
    for tile in sorted((t for t in TILES[mode] if t <= TILE[mode]), reverse=True):
        try:
            return make_plan(B, C, J, G, mode, itemsize, tile)
        except ValueError:
            continue
    raise ValueError(f"repro_grid_gather: no tile fits C = {C}, J = {J} in {mode}")


def repro_grid_gather(rows: torch.Tensor, center3d: torch.Tensor,
                      center_hm: torch.Tensor, P: torch.Tensor, K: torch.Tensor,
                      D: torch.Tensor, grid_size: int, grid_spacing: float, mode: str,
                      return_indices: bool = False):
    """Voxel volume of the G^3 cube (G = ``grid_size``, even) in float32:
    (B, G, G, G, J) for exact and half, (B, G/2, G/2, G/2, J) for half_fused.

    rows: (B, C, hs*hs, J) padded heatmaps (bf16 or f32), J contiguous; on
    the card the rows must be the J-view of a 16-byte aligned buffer whose
    rows are a multiple of 16 bytes apart (``repro_gather.pad_rows``).
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
    B, C, hs, J, S = check_cameras(rows, center3d, center_hm, P, K, D)
    if (S * rows.element_size()) % 16 or rows.data_ptr() % 16:
        raise ValueError("repro_grid_gather: rows must start on 16 bytes and lie a multiple of "
                         f"16 bytes apart (row stride {S}); pad them with pad_rows")
    plan = launch_plan(B, C, J, hs, grid_size, mode, rows.element_size())
    out = run_plan(plan, rows, center3d, center_hm, P, K, D, grid_size, grid_spacing,
                   return_indices)
    repro_grid_gather.launches += 1
    return out


repro_grid_gather.launches = 0


def run_plan(plan: Plan, rows, center3d, center_hm, P, K, D, grid_size: int,
             grid_spacing: float, return_indices: bool = False):
    """Launch the kernel with ``plan`` on checked CUDA tensors (the wrapper's
    launch; ``kernel_sweep.py`` times other plans through it)."""
    B, C, hs2, J = rows.shape
    n = grid_size // 2 if plan.mode == "half_fused" else grid_size
    dev = rows.device
    out = torch.empty((B, n, n, n, J), dtype=torch.float32, device=dev)
    n_idx = grid_size ** 3 if plan.mode == "exact" else (grid_size // 2) ** 3
    idx = (torch.empty((B, C, n_idx), dtype=torch.int32, device=dev)
           if return_indices else None)
    p = build.ptr
    err = _fn()(p(rows), p(center3d), p(center_hm), p(P), p(K), p(D), p(out), p(idx),
                B, C, J, rows.stride(2), math.isqrt(hs2), grid_size // 2, plan.tile,
                float(grid_spacing) * 2.0, MODES[plan.mode], plan.smem,
                _DTYPES[rows.dtype], build.stream())
    build.check(err, "repro_grid_gather")
    return (out, idx) if return_indices else out


def occupancy(plan: Plan, dtype: torch.dtype) -> int:
    """Blocks of ``plan`` one SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = ctypes.c_int(0)
    i = ctypes.c_int
    fn = build.bind("repro_grid_gather", "repro_grid_occupancy", [i] * 4 + [ctypes.c_void_p])
    build.check(fn(MODES[plan.mode], plan.tile, plan.smem, _DTYPES[dtype], ctypes.byref(n)),
                "repro_grid_occupancy")
    return n.value


@functools.cache
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("repro_grid_gather", "repro_grid_gather",
                      [p] * 8 + [i] * 7 + [ctypes.c_float] + [i] * 3 + [p])
