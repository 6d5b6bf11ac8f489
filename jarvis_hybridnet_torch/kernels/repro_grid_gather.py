"""K5: the exact, half and half_fused voxel reprojection modes.

Replaces ``models/repro.py`` ``reprojection_layer``'s exact mode
(repro.py:266-273: ``reproject_indices`` with the trilinear index upsample
and ``gather_voxel_volume``) and its half / half_fused modes (:302-317: the
half-grid gather and, for half, the 0.25/0.75 value upsample). CUDA source:
``csrc/repro_grid_gather.cu``: one launch per call, a block per
(frameset, tile) work item, a tile being ``TILE[mode]``^3 half-grid points;
the rows are read in 16-byte loads, so they must be padded
(``repro_gather.pad_rows``). The forward is registered as
``jarvis_torch::repro_grid_gather``.

The rows are gathered in their own dtype and summed in float32. JAX's
exact mode gathers float32 (``hybridnet.py:73,84-85``); a bf16 row widened
to float32 is exactly the value it gathers from its float32 cast of the
same bf16 heatmaps, so every mode may read bf16 rows.

With grad enabled and ``rows.requires_grad`` (float32 or bf16 rows) the
gather is differentiable with respect to the rows, its backward K12
(``repro_grid_gather_backward``, ``csrc/repro_grid_gather_backward.cu``):
the VJP of the mode's ``reprojection_layer`` (repro.py:266-273, :302-317),
the 0.25/0.75 value upsample transposed along z, y and x for half, then the
camera mean's scatter at the saved indices. One launch (``BackwardPlan``),
a block per (frameset, tile of ``BACKWARD_TILE[mode]``^3 gather points):
the tile's values in shared memory, then 16-byte reductions into the
rows: with a window, a camera whose box of the tile's pixels holds at most
``BACKWARD_WIN[mode]`` pixels sorts the points by pixel and adds each
pixel's sum once, any other (the overflow branch) adds point by point.
Tile 0 (half_fused's plan) has no tile: a thread per (point, 4 joints).
For bf16 rows a second launch rounds the float32 sums once to bf16 rows
(``repro_gather.round_rows``): at exact, JAX's VJP rounds once too (at
the transpose of its float32 cast); at half and half_fused it adds rounded
cotangents into a bf16 table.

``c_total``, where given, divides the camera sum in place of C, forward and
backward (``repro_gather``'s docstring); its default, C, leaves every
output as it was.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import build
from .repro_gather import (_DTYPES, _c_total, _upsample2, _upsample2_transposed, camera_mean,
                           check_backward, check_cameras, padded_width,
                           reproject_indices_plain, require_row_dtype, round_rows,
                           scatter_rows_plain)

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
                            grid_spacing: float, mode: str, c_total: int | None = None):
    """Plain PyTorch version; returns (volume, indices)."""
    B, hs2, J = rows.shape[0], rows.shape[2], rows.shape[3]
    idx = reproject_indices_plain(center3d, center_hm, P, K, D, grid_size, grid_spacing,
                                  math.isqrt(hs2), upsample=mode == "exact")
    n = grid_size if mode == "exact" else grid_size // 2
    vol = camera_mean(rows, idx, c_total).reshape(B, n, n, n, J)
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
                      return_indices: bool = False, c_total: int | None = None):
    """Voxel volume of the G^3 cube (G = ``grid_size``, even) in float32:
    (B, G, G, G, J) for exact and half, (B, G/2, G/2, G/2, J) for half_fused.

    rows: (B, C, hs*hs, J) padded heatmaps (bf16 or f32), J contiguous; on
    the card the rows must be the J-view of a 16-byte aligned buffer whose
    rows are a multiple of 16 bytes apart (``repro_gather.pad_rows``).
    center3d (B, 3) and center_hm (B, C, 2) int32; P (B, C, 4, 3),
    K (B, C, 3, 3), D (B, C, 1, 5) float32. With ``return_indices`` the
    int32 gather indices come back too: (B, C, G^3) for exact, (B, C,
    (G/2)^3) for the half modes. ``c_total``: the camera sum's divisor
    (module docstring). With grad enabled and ``rows.requires_grad`` the
    volume carries the gather's graph, whose backward is K12.
    """
    if mode not in MODES:
        raise ValueError(f"repro_grid_gather: unknown mode {mode!r}")
    if grid_size % 2:
        raise ValueError(f"repro_grid_gather: grid_size must be even, got {grid_size}")
    ct = _c_total(rows, c_total)
    if torch.is_grad_enabled() and rows.requires_grad:
        require_row_dtype(rows)
        vol, idx = GridGather.apply(rows, center3d, center_hm, P, K, D, grid_size,
                                    grid_spacing, mode, ct)
        return (vol, idx) if return_indices else vol
    return _grid_gather(rows, center3d, center_hm, P, K, D, grid_size, grid_spacing, mode,
                        return_indices, ct)


repro_grid_gather.launches = 0


def _grid_gather(rows, center3d, center_hm, P, K, D, grid_size: int, grid_spacing: float,
                 mode: str, return_indices: bool, ct: int):
    """The forward alone, through the registered op
    ``jarvis_torch::repro_grid_gather``: the plain version on the CPU, else
    one K5 launch."""
    build.on_cpu(rows, center3d, center_hm, P, K, D)
    vol, idx = _op(rows, center3d, center_hm, P, K, D, int(grid_size), float(grid_spacing),
                   mode, return_indices, int(ct))
    return (vol, idx) if return_indices else vol


@torch.library.custom_op("jarvis_torch::repro_grid_gather", mutates_args=(), device_types="cpu")
def _op(rows: torch.Tensor, center3d: torch.Tensor, center_hm: torch.Tensor, P: torch.Tensor,
        K: torch.Tensor, D: torch.Tensor, grid_size: int, grid_spacing: float, mode: str,
        return_indices: bool, ct: int) -> tuple[torch.Tensor, torch.Tensor]:
    vol, idx = repro_grid_gather_plain(rows, center3d, center_hm, P, K, D, grid_size,
                                       grid_spacing, mode, ct)
    return vol, idx if return_indices else build.no_output(rows)


@_op.register_kernel("cuda")
def _launch(rows, center3d, center_hm, P, K, D, grid_size, grid_spacing, mode, return_indices,
            ct):
    B, C, hs, J, S = check_cameras(rows, center3d, center_hm, P, K, D)
    if (S * rows.element_size()) % 16 or rows.data_ptr() % 16:
        raise ValueError("repro_grid_gather: rows must start on 16 bytes and lie a multiple of "
                         f"16 bytes apart (row stride {S}); pad them with pad_rows")
    plan = launch_plan(B, C, J, hs, grid_size, mode, rows.element_size())
    out = run_plan(plan, rows, center3d, center_hm, P, K, D, grid_size, grid_spacing,
                   return_indices, c_total=ct)
    repro_grid_gather.launches += 1
    return out if return_indices else (out, build.no_output(rows))


@_op.register_fake
def _(rows, center3d, center_hm, P, K, D, grid_size, grid_spacing, mode, return_indices, ct):
    B, C, J = rows.shape[0], rows.shape[1], rows.shape[3]
    n = grid_size // 2 if mode == "half_fused" else grid_size
    n_idx = grid_size ** 3 if mode == "exact" else (grid_size // 2) ** 3
    return (rows.new_empty((B, n, n, n, J), dtype=torch.float32),
            rows.new_empty((B, C, n_idx), dtype=torch.int32) if return_indices
            else build.no_output(rows))


class GridGather(torch.autograd.Function):
    """K5 with respect to the rows: the forward saves its indices, the
    backward is ``repro_grid_gather_backward``."""

    @staticmethod
    def forward(ctx, rows, center3d, center_hm, P, K, D, grid_size, grid_spacing, mode, ct):
        vol, idx = _grid_gather(rows, center3d, center_hm, P, K, D, grid_size, grid_spacing,
                                mode, True, ct)
        ctx.save_for_backward(idx)
        ctx.hs2, ctx.J, ctx.mode, ctx.dtype = rows.shape[2], rows.shape[3], mode, rows.dtype
        ctx.ct = ct
        ctx.mark_non_differentiable(idx)
        return vol, idx

    @staticmethod
    @once_differentiable
    def backward(ctx, grad, _):
        (idx,) = ctx.saved_tensors
        return (repro_grid_gather_backward(grad.contiguous(), idx, ctx.hs2, ctx.J, ctx.mode,
                                           ctx.dtype, ctx.ct),
                None, None, None, None, None, None, None, None, None)


def repro_grid_gather_backward_plain(grad: torch.Tensor, idx: torch.Tensor, hs2: int, J: int,
                                     mode: str, c_total: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K12: for half the 0.25/0.75 upsample
    transposed along z, then y, then x; then ``scatter_rows_plain`` at the
    (B, C, G^3) (exact) or (B, C, (G/2)^3) indices; in grad's dtype."""
    if mode == "half":
        for axis in (3, 2, 1):
            grad = _upsample2_transposed(grad, axis)
    return scatter_rows_plain(grad.reshape(grad.shape[0], -1, grad.shape[-1]), idx, hs2, J,
                              c_total)


def repro_grid_gather_backward(grad: torch.Tensor, idx: torch.Tensor, hs2: int, J: int,
                               mode: str, dtype: torch.dtype = torch.float32,
                               c_total: int | None = None) -> torch.Tensor:
    """K12, the VJP of K5 with respect to the rows: grad float32 in the
    forward's output layout ((B, G, G, G, J) for exact and half, (B, G/2,
    G/2, G/2, J) for half_fused) and K5's int32 indices -> the rows'
    gradient (B, C, hs2, J) in the rows' ``dtype`` (float32 or bf16), the
    J-view of a zeroed buffer whose rows are ``padded_width(J, itemsize)``
    apart. The plain version on the CPU, else one K12 launch (after a
    ``cudaMemsetAsync`` of the buffer) with ``backward_plan``, and for bf16
    the rounding launch (``repro_gather.round_rows``). ``c_total``: the
    forward's divisor (default C)."""
    if mode not in MODES:
        raise ValueError(f"repro_grid_gather_backward: unknown mode {mode!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"repro_grid_gather_backward: rows of {dtype}")
    ct = _c_total(idx, c_total)
    if build.on_cpu(grad, idx):
        return round_rows(repro_grid_gather_backward_plain(grad, idx, hs2, J, mode, ct), dtype)
    F = grad.shape[1]
    n = F // 2 if mode == "half" else F
    check_backward(grad, idx, J, 2 * n if mode == "half" else n, n)
    buf = round_rows(run_backward(backward_plan(idx.shape[1], J, n, mode), grad, idx, hs2,
                                  c_total=ct), dtype)
    repro_grid_gather_backward.launches += 1
    return buf


repro_grid_gather_backward.launches = 0

# K12 (csrc/repro_grid_gather_backward.cu): the tile edges compiled per
# mode (K12_TILES in the source; 0: point_backward, a thread per (point, 4
# joints) and no tile), and the wrapper's plan: gather points per tile
# edge, the window's capacity in pixels (0: every (tile, camera) takes the
# overflow branch) and the block, per mode (kernel_sweep.py --only k12
# times the others)
BACKWARD_TILES = {"exact": (0, 4, 6, 8), "half": (2, 3, 4), "half_fused": (0, 4)}
BACKWARD_TILE = {"exact": 6, "half": 3, "half_fused": 0}
BACKWARD_WIN = {"exact": 128, "half": 0, "half_fused": 0}
BACKWARD_THREADS = {"exact": 256, "half": 256, "half_fused": 512}


def backward_layout(mode: str, C: int, tile: int, J: int, S: int, win: int) -> dict[str, int]:
    """The kernel's shared-memory layout in 4-byte words (``layout`` in the
    source): the values (tile^3 rows of S), the points' pixels in every
    camera, the cameras' boxes, then on 16 bytes a region that first holds
    the staged upstream rows J apart (the tile's, or for half its (e, e, e)
    block, e = 2t + 2, with the z pass's (e, e, t) rows of S behind it at
    ``tz`` and the y pass's rows over the block), then with a window the
    counting sort's C rows of win + 1 counts and C rows of P points."""
    P, e = tile ** 3, 2 * tile + 2
    box = P * S + C * P
    wnd = -(-(box + 4 * C) // 4) * 4
    tz = wnd + -(-e ** 3 * J // 4) * 4
    staged = tz - wnd + e * e * tile * S if mode == "half" else P * J
    sort = C * (win + 1) + C * P if win else 0
    return {"val": 0, "pix": P * S, "box": box, "wnd": wnd, "tz": tz,
            "total": wnd + max(sort, staged)}


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How K12 covers one call: ``tiles``^3 tiles of ``tile``^3 gather points
    per frameset (n per axis), a block of ``threads`` each, numbered
    frameset by frameset; a (tile, camera) whose pixels' box holds at most
    ``win`` pixels adds through the window, any other through the overflow
    branch. Tile 0: no tile, a thread per (point, 4 joints), every point
    through the overflow branch. Rows S floats apart; ``smem`` bytes of
    shared memory a block."""

    mode: str
    n: int
    tile: int
    tiles: int
    win: int
    threads: int
    S: int
    smem: int

    def item(self, block: int) -> tuple[int, int, int, int]:
        """Block ``block``'s work item: (frameset, x0, y0, z0), its first
        gather point."""
        b, t = divmod(block, self.tiles ** 3)
        return (b, t // self.tiles ** 2 * self.tile, t // self.tiles % self.tiles * self.tile,
                t % self.tiles * self.tile)


def make_backward_plan(C: int, J: int, n: int, mode: str, tile: int, win: int,
                       threads: int = 256) -> BackwardPlan:
    """K12's plan for a tile edge, window and block; raises where the
    kernel refuses it (the source's checks)."""
    S = padded_width(J, 4)
    smem = 4 * backward_layout(mode, C, tile, J, S, win)["total"] if tile else 0
    if (threads not in (256, 512) or S > threads or tile not in BACKWARD_TILES[mode]
            or not 0 <= win < 32768 or (tile == 0 and win)):
        raise ValueError(f"repro_grid_gather_backward: no plan for J = {J}, tile {tile}, "
                         f"win {win}, {threads} threads")
    if smem > SMEM_MAX:
        raise ValueError(f"repro_grid_gather_backward: {smem} bytes of shared memory")
    return BackwardPlan(mode, n, tile, -(-n // tile) if tile else n, win, threads, S, smem)


@functools.lru_cache(maxsize=None)
def backward_plan(C: int, J: int, n: int, mode: str) -> BackwardPlan:
    """The wrapper's plan: ``BACKWARD_TILE`` / ``BACKWARD_WIN`` /
    ``BACKWARD_THREADS`` of the mode (the fastest in ``kernel_sweep.py
    --only k12`` at the production key); where the shared memory does not
    fit (many cameras), the window halved, then the next smaller compiled
    tile edge, until it does."""
    tiles = sorted((t for t in BACKWARD_TILES[mode] if t <= BACKWARD_TILE[mode]), reverse=True)
    win = BACKWARD_WIN[mode]
    while True:
        try:
            return make_backward_plan(C, J, n, mode, tiles[0], win, BACKWARD_THREADS[mode])
        except ValueError:
            if win == 0 and len(tiles) == 1:
                raise
            if win:
                win //= 2
            else:
                tiles = tiles[1:]


def window_choice(idx: torch.Tensor, hs2: int, plan: BackwardPlan) -> tuple[int, int]:
    """(windowed, overflow): the (frameset, tile, camera) triples whose
    pixels' bounding box fits ``plan.win`` pixels and those that take the
    overflow branch, from the (B, C, n^3) indices, as the kernel decides
    (tile 0: every (frameset, point, camera) overflows)."""
    B, C = idx.shape[:2]
    n, t, T = plan.n, plan.tile, plan.tiles
    if t == 0:  # a point each
        return 0, idx.numel()
    hs = math.isqrt(hs2)
    hs = hs if hs * hs == hs2 else hs2
    q = idx.long().clamp(0, hs2 - 1).reshape(B, C, n, n, n)
    tiles = (B, C, T, t, T, t, T, t)
    boxes = []
    for part in (q // hs, q % hs):  # rows, columns; past the grid's edge no point
        lo = part.new_full((B, C, T * t, T * t, T * t), hs2)
        hi = part.new_full(lo.shape, -1)
        lo[:, :, :n, :n, :n] = hi[:, :, :n, :n, :n] = part
        boxes.append(hi.reshape(tiles).amax((3, 5, 7)) - lo.reshape(tiles).amin((3, 5, 7)) + 1)
    area = boxes[0] * boxes[1]
    windowed = int((area <= plan.win).sum()) if plan.win > 0 else 0
    return windowed, area.numel() - windowed


def run_backward(plan: BackwardPlan, grad: torch.Tensor, idx: torch.Tensor,
                 hs2: int, c_total: int | None = None) -> torch.Tensor:
    """Launch K12 with ``plan`` on checked CUDA tensors (the wrapper's
    launch; ``kernel_sweep.py`` times other plans through it), dividing by
    ``c_total`` (default C). Returns the J-view of the zeroed-and-filled
    buffer; counts no launch."""
    B, C = idx.shape[:2]
    J = grad.shape[-1]
    buf = torch.empty((B, C, hs2, plan.S), dtype=torch.float32, device=grad.device)
    p = build.ptr
    err = _backward_fn()(p(grad), p(idx), p(buf), B, C, J, plan.S, hs2, plan.n,
                         MODES[plan.mode], plan.tile, plan.win, plan.smem, plan.threads,
                         c_total or C, build.stream())
    build.check(err, "repro_grid_gather_backward")
    return buf[..., :J]


def backward_occupancy(plan: BackwardPlan) -> int:
    """Blocks of ``plan`` one SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = ctypes.c_int(0)
    i = ctypes.c_int
    fn = build.bind("repro_grid_gather_backward", "repro_grid_backward_occupancy",
                    [i] * 4 + [ctypes.c_void_p])
    build.check(fn(MODES[plan.mode], plan.tile, plan.threads, plan.smem, ctypes.byref(n)),
                "repro_grid_backward_occupancy")
    return n.value


@functools.cache
def _backward_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("repro_grid_gather_backward", "repro_grid_gather_backward",
                      [p] * 3 + [i] * 12 + [p])


def run_plan(plan: Plan, rows, center3d, center_hm, P, K, D, grid_size: int,
             grid_spacing: float, return_indices: bool = False, c_total: int | None = None):
    """Launch the kernel with ``plan`` on checked CUDA tensors (the wrapper's
    launch; ``kernel_sweep.py`` times other plans through it), dividing the
    camera sum by ``c_total`` (default C)."""
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
                _DTYPES[rows.dtype], c_total or C, build.stream())
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
                      [p] * 8 + [i] * 7 + [ctypes.c_float] + [i] * 4 + [p])
