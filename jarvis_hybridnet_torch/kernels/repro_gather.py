"""K2: quarter-grid voxel reprojection, gather, camera mean and 2x upsample.

Replaces ``models/repro.py`` ``reproject_indices(upsample=False)`` at
(grid_size // 2, 2 * spacing), ``gather_voxel_volume`` and the three
``_upsample2_aligned_axis`` passes of ``reprojection_layer``'s
quarter_fused mode. CUDA source: ``csrc/repro_quarter_gather.cu``: one
launch per call, a block per tile of ``TILE``^3 quarter voxels (plus a
one-voxel halo on the high side) of one frameset.

The plain helpers here (``reproject_indices_plain``, the two upsample
stencils, ``camera_mean``) and the row layout (``pad_rows``,
``check_cameras``) also serve K5 (``repro_grid_gather.py``).

Heatmap rows are a (B, C, hs*hs, J) view whose rows lie S >= J elements
apart in a contiguous (B, C, hs*hs, S) buffer: ``pad_rows`` (and
``HybridNetBackbone.heatmap_rows``) make S * itemsize a multiple of 16
bytes, zero-filled, so K5 reads a row in 16-byte loads. K2 takes any S.

The gather is differentiable with respect to the float32 or bf16 rows (the
indices, centers and cameras get no gradient, as in JAX): with grad enabled
and ``rows.requires_grad`` the forward saves its indices and the backward is
K11 (``repro_quarter_gather_backward``, ``csrc/repro_gather_backward.cu``),
the VJP of ``reprojection_layer``'s quarter_fused mode (repro.py:280-300):
the aligned upsample transposed along z, y and x, divided by C and
scatter-added into each camera's rows at the saved indices. For bf16 rows
(bf16 training, ``gather_dtype=bf16`` in JAX) the sums stay float32 and
are rounded once to bf16 rows (``round_rows``); JAX adds rounded
cotangents into a bf16 table. Its plain version, the scatter
(``scatter_rows_plain``) and ``round_rows`` also serve K12
(``repro_grid_gather.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 6  # quarter voxels per tile edge: 27 tiles of the 18^3 production grid
BACKWARD_THREADS = 256  # K11's block (kernel_sweep.py --only k11 times the others)


def padded_width(j: int, itemsize: int) -> int:
    """J rounded up to a whole number of 16-byte loads (23 -> 24 for bf16
    and float32)."""
    per = 16 // itemsize
    return -(-j // per) * per


def pad_rows(rows: torch.Tensor) -> torch.Tensor:
    """(B, C, hs*hs, J) rows as the J-view of a zero-padded buffer whose rows
    are ``padded_width`` elements apart."""
    J = rows.shape[-1]
    buf = rows.new_zeros(rows.shape[:-1] + (padded_width(J, rows.element_size()),))
    buf[..., :J] = rows
    return buf[..., :J]


def crop_uv_plain(center3d, center_hm, P, K, D, grid_size: int, grid_spacing: float,
                  hs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The crop-local pixel coordinates (u, v), each (B, C, (G/2)^3), of the
    (G/2)^3 half grid at ``2 * grid_spacing`` mm, centered at index G/4:
    projected (k1/k2 distortion), clamped to the crop window and shifted
    (repro.py:107-147), one rounding per op in the JAX op order."""
    B, C = P.shape[0], P.shape[1]
    g2 = grid_size // 2
    dev = P.device
    r = (torch.arange(g2, dtype=torch.float32, device=dev) - float(g2 // 2)) * (
        grid_spacing * 2.0)
    coords = r[None, None, :] + center3d.float()[:, :, None]  # (B, 3, g2)
    X = coords[:, 0][:, None, :, None, None]
    Y = coords[:, 1][:, None, None, :, None]
    Z = coords[:, 2][:, None, None, None, :]

    def component(m):
        e = (None, None, None)
        term = (P[:, :, 0, m][(...,) + e] * X + P[:, :, 1, m][(...,) + e] * Y
                + P[:, :, 2, m][(...,) + e] * Z + P[:, :, 3, m][(...,) + e])
        return term.reshape(B, C, -1)

    pu, pv, pw = component(0), component(1), component(2)
    fx, fy = K[:, :, 0, 0, None], K[:, :, 1, 1, None]
    cx, cy = K[:, :, 2, 0, None], K[:, :, 2, 1, None]
    k1, k2 = D[:, :, 0, 0, None], D[:, :, 0, 1, None]

    u = pu / pw - cx
    v = pv / pw - cy
    r2 = torch.square(u / fx) + torch.square(v / fy)
    distort = 1.0 + (k1 + k2 * r2) * r2
    u = u * distort + cx
    v = v * distort + cy

    chx = center_hm[:, :, 0:1].float()
    chy = center_hm[:, :, 1:2].float()
    u = torch.clamp(u, chx - (hs - 1), chx + hs - 2) - chx + (hs - 1)
    v = torch.clamp(v, chy - (hs - 1), chy + hs - 2) - chy + (hs - 1)
    return u, v


def reproject_indices_plain(center3d, center_hm, P, K, D, grid_size: int,
                            grid_spacing: float, hs: int,
                            upsample: bool = True) -> torch.Tensor:
    """Flat pixel indices into each camera's padded heatmap, batched:
    (B, C, G^3), or (B, C, (G/2)^3) with ``upsample=False``.

    Mirrors ``reproject_indices`` (repro.py:94-154) op for op, so the
    indices are bit-identical to the JAX ones: with ``upsample`` the (u, v)
    maps of :func:`crop_uv_plain` are upsampled to G^3 by the 0.25/0.75
    stencil before the truncation. Called with (G/2, 2 * spacing) it gives
    the quarter grid of quarter_fused.
    """
    u, v = crop_uv_plain(center3d, center_hm, P, K, D, grid_size, grid_spacing, hs)
    if upsample:
        B, C, g2 = P.shape[0], P.shape[1], grid_size // 2
        u, v = (upsample_trilinear(a.reshape(B, C, g2, g2, g2)).reshape(B, C, -1)
                for a in (u, v))
    return (v / 2.0).to(torch.int32) * hs + (u / 2.0).to(torch.int32)


def _upsample2(x: torch.Tensor, axis: int) -> torch.Tensor:
    """2x linear upsample along ``axis`` (align_corners=False):
    out[2k] = 0.25 in[k-1] + 0.75 in[k], out[2k+1] = 0.75 in[k] + 0.25 in[k+1],
    both edges clamped; ``_upsample2_axis`` of repro.py:47-66, op for op."""
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    shape = list(x.shape)
    shape[axis] *= 2
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def upsample_trilinear(x: torch.Tensor) -> torch.Tensor:
    """``_upsample2`` over the trailing three axes, X then Y then Z."""
    for axis in (x.dim() - 3, x.dim() - 2, x.dim() - 1):
        x = _upsample2(x, axis)
    return x


def _upsample2_aligned(x: torch.Tensor, axis: int) -> torch.Tensor:
    """out[2k] = in[k], out[2k+1] = (in[k] + in[k+1]) / 2, top edge clamped."""
    nxt = torch.cat([x.narrow(axis, 1, x.shape[axis] - 1),
                     x.narrow(axis, x.shape[axis] - 1, 1)], dim=axis)
    odd = 0.5 * (x + nxt)
    out = torch.stack([x, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample2_transposed(g: torch.Tensor, axis: int) -> torch.Tensor:
    """The VJP of ``_upsample2`` along ``axis``: in[k] receives 0.75 of
    out[2k] and out[2k+1], 0.25 of out[2k+2] and out[2k-1], and the clamped
    edges' quarters (out[0] at the bottom, out[2L-1] at the top) besides."""
    L = g.shape[axis] // 2
    g = g.unflatten(axis, (L, 2))
    even, odd = g.select(axis + 1, 0), g.select(axis + 1, 1)
    out = 0.75 * even + 0.75 * odd
    out.narrow(axis, 0, L - 1).add_(0.25 * even.narrow(axis, 1, L - 1))
    out.narrow(axis, 0, 1).add_(0.25 * even.narrow(axis, 0, 1))
    out.narrow(axis, 1, L - 1).add_(0.25 * odd.narrow(axis, 0, L - 1))
    out.narrow(axis, L - 1, 1).add_(0.25 * odd.narrow(axis, L - 1, 1))
    return out


def _upsample2_aligned_transposed(g: torch.Tensor, axis: int) -> torch.Tensor:
    """The VJP of ``_upsample2_aligned`` along ``axis``: in[k] receives
    out[2k] and half of out[2k+1] and out[2k-1]; at the top edge the clamped
    odd output gives in[L-1] its whole weight."""
    L = g.shape[axis] // 2
    g = g.unflatten(axis, (L, 2))
    half = 0.5 * g.select(axis + 1, 1)
    out = g.select(axis + 1, 0) + half
    out.narrow(axis, 1, L - 1).add_(half.narrow(axis, 0, L - 1))
    out.narrow(axis, L - 1, 1).add_(half.narrow(axis, L - 1, 1))
    return out


def scatter_rows_plain(q: torch.Tensor, idx: torch.Tensor, hs2: int, J: int) -> torch.Tensor:
    """The VJP of ``camera_mean``: q (B, N, J), the gradient of the mean,
    divided by C and added (``index_add_``) to each camera's row at idx
    (B, C, N). Returns (B, C, hs2, J) in q's dtype, the J-view of a zeroed
    buffer whose rows are ``padded_width(J, 4)`` apart."""
    B, C, N = idx.shape
    if q.shape != (B, N, J):
        raise ValueError(f"gradient {tuple(q.shape)} does not fit indices {tuple(idx.shape)}, "
                         f"J = {J}")
    S = padded_width(J, 4)
    buf = q.new_zeros((B, C, hs2, S))
    base = torch.arange(B * C, device=idx.device).view(B, C, 1) * hs2
    buf.view(-1, S)[:, :J].index_add_(0, (idx.long() + base).reshape(-1),
                                      (q / C)[:, None].expand(B, C, N, J).reshape(-1, J))
    return buf[..., :J]


def check_backward(grad: torch.Tensor, idx: torch.Tensor, J: int, grid: int,
                   points: int) -> tuple[int, int]:
    """Raise unless the arguments are what the gather backwards (K11, K12)
    take: a contiguous float32 upstream gradient (B, grid, grid, grid, J) and
    the forward's contiguous int32 indices (B, C, points^3) on the card.
    Returns (B, C)."""
    build.require(grad, "grad", (torch.float32,), 5)
    build.require(idx, "idx", (torch.int32,), 3)
    B, C = idx.shape[0], idx.shape[1]
    if tuple(grad.shape) != (B, grid, grid, grid, J) or idx.shape[2] != points ** 3:
        raise ValueError(f"gradient {tuple(grad.shape)} and indices {tuple(idx.shape)} do not "
                         f"fit a {grid}^3 grid of J = {J} gathered at {points}^3 points")
    return B, C


def camera_mean(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows (B, C, hs*hs, J) gathered at idx (B, C, N), summed over the
    cameras in camera order in float32 and divided by C: (B, N, J), as
    ``gather_voxel_volume`` (repro.py:157-213)."""
    C, J = rows.shape[1], rows.shape[3]
    acc = None
    for c in range(C):
        vals = torch.gather(rows[:, c], 1,
                            idx[:, c, :, None].long().expand(-1, -1, J)).float()
        acc = vals if acc is None else acc + vals
    return acc / C


def repro_quarter_gather_plain(rows, center3d, center_hm, P, K, D, g4: int,
                               step: float):
    """Plain PyTorch version; returns (half volume, indices)."""
    B, hs2, J = rows.shape[0], rows.shape[2], rows.shape[3]
    # reproject_indices(G/2, 2 * spacing, upsample=False) is the quarter grid
    idx = reproject_indices_plain(center3d, center_hm, P, K, D, 2 * g4, step / 2.0,
                                  math.isqrt(hs2), upsample=False)
    half = camera_mean(rows, idx).reshape(B, g4, g4, g4, J)
    for axis in (1, 2, 3):
        half = _upsample2_aligned(half, axis)
    return half, idx


def row_stride(rows: torch.Tensor) -> int:
    """S, the elements between consecutive rows of the (B, C, hs*hs, J) view
    ``rows``; raises unless it is the J-view of a contiguous (B, C, hs*hs, S)
    buffer."""
    if rows.dim() != 4:
        raise ValueError(f"rows must be (B, C, hs*hs, J), got {tuple(rows.shape)}")
    B, C, hs2, J = rows.shape
    S = rows.stride(2) if hs2 > 1 else J
    want = (C * hs2 * S, hs2 * S, S, 1)
    if S < J or any(n > 1 and st != w for n, st, w in zip(rows.shape, rows.stride(), want)):
        raise ValueError(f"rows must be the J-view of a contiguous (B, C, hs*hs, S) buffer, got "
                         f"shape {tuple(rows.shape)}, strides {rows.stride()}")
    return S


def check_cameras(rows, center3d, center_hm, P, K, D) -> tuple[int, int, int, int, int]:
    """Raise unless the arguments are what the repro kernels take; returns
    (B, C, hs, J, S)."""
    if rows.device.type != "cuda" or rows.dtype not in _DTYPES:
        raise ValueError(f"rows: expected a CUDA tensor of {tuple(_DTYPES)}, got {rows.dtype} "
                         f"on {rows.device}")
    S = row_stride(rows)
    B, C, hs2, J = rows.shape
    hs = math.isqrt(hs2)
    if hs * hs != hs2 or J > 32 or C * hs2 * S >= 2 ** 31:
        raise ValueError(f"rows must be (B, C, hs*hs, J<=32), got {tuple(rows.shape)}")
    for t, name, shape in ((center3d, "center3d", (B, 3)),
                           (center_hm, "center_hm", (B, C, 2)),
                           (P, "P", (B, C, 4, 3)), (K, "K", (B, C, 3, 3)),
                           (D, "D", (B, C, 1, 5))):
        build.require(t, name, (torch.int32,) if name.startswith("center")
                      else (torch.float32,))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    return B, C, hs, J, S


def repro_quarter_gather(rows: torch.Tensor, center3d: torch.Tensor,
                         center_hm: torch.Tensor, P: torch.Tensor,
                         K: torch.Tensor, D: torch.Tensor, g4: int,
                         step: float, return_indices: bool = False):
    """Half-grid voxel volume (B, 2g4, 2g4, 2g4, J) float32.

    rows: (B, C, hs*hs, J) padded heatmaps (bf16 or f32), J contiguous, rows
    S >= J elements apart (module docstring); center3d (B, 3) and center_hm
    (B, C, 2) int32; P (B, C, 4, 3), K (B, C, 3, 3), D (B, C, 1, 5) float32.
    The quarter grid has g4 points per axis at ``step`` mm around center3d.
    With ``return_indices`` the (B, C, g4^3) int32 gather indices come back
    too. With grad enabled and ``rows.requires_grad`` the volume carries the
    gather's graph, whose backward is K11.
    """
    if torch.is_grad_enabled() and rows.requires_grad:
        require_row_dtype(rows)
        out, idx = QuarterGather.apply(rows, center3d, center_hm, P, K, D, g4, step)
        return (out, idx) if return_indices else out
    return _quarter_gather(rows, center3d, center_hm, P, K, D, g4, step, return_indices)


repro_quarter_gather.launches = 0


def require_row_dtype(rows: torch.Tensor) -> None:
    """Raise unless the gathers' backwards (K11, K12) take ``rows``' dtype."""
    if rows.dtype not in _DTYPES:
        raise ValueError(f"the reprojection gather's backward takes rows of {tuple(_DTYPES)}, "
                         f"got {rows.dtype}")


def _quarter_gather(rows, center3d, center_hm, P, K, D, g4: int, step: float,
                    return_indices: bool):
    """The forward alone: the plain version on the CPU, else one K2 launch."""
    if build.on_cpu(rows, center3d, center_hm, P, K, D):
        half, idx = repro_quarter_gather_plain(rows, center3d, center_hm, P, K,
                                               D, g4, step)
        return (half, idx) if return_indices else half
    B, C, hs, J, S = check_cameras(rows, center3d, center_hm, P, K, D)
    dev = rows.device
    out = torch.empty((B, 2 * g4, 2 * g4, 2 * g4, J), dtype=torch.float32,
                      device=dev)
    idx = (torch.empty((B, C, g4 ** 3), dtype=torch.int32, device=dev)
           if return_indices else None)
    p = build.ptr
    err = _fn()(p(rows), p(center3d), p(center_hm), p(P), p(K), p(D),
                p(out), p(idx), B, C, J, S, hs, g4, TILE, step,
                _DTYPES[rows.dtype], build.stream())
    build.check(err, "repro_quarter_gather")
    repro_quarter_gather.launches += 1
    return (out, idx) if return_indices else out


class QuarterGather(torch.autograd.Function):
    """K2 with respect to the rows: the forward saves its (B, C, g4^3)
    indices, the backward is ``repro_quarter_gather_backward``."""

    @staticmethod
    def forward(ctx, rows, center3d, center_hm, P, K, D, g4, step):
        out, idx = _quarter_gather(rows, center3d, center_hm, P, K, D, g4, step, True)
        ctx.save_for_backward(idx)
        ctx.hs2, ctx.J, ctx.dtype = rows.shape[2], rows.shape[3], rows.dtype
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    @once_differentiable
    def backward(ctx, grad, _):
        (idx,) = ctx.saved_tensors
        return (repro_quarter_gather_backward(grad.contiguous(), idx, ctx.hs2, ctx.J, ctx.dtype),
                None, None, None, None, None, None, None)


def repro_quarter_gather_backward_plain(grad_half: torch.Tensor, idx: torch.Tensor, hs2: int,
                                        J: int) -> torch.Tensor:
    """Plain PyTorch version of K11: the aligned upsample transposed along
    z, then y, then x, then ``scatter_rows_plain``; in grad_half's dtype."""
    g = grad_half
    for axis in (3, 2, 1):
        g = _upsample2_aligned_transposed(g, axis)
    return scatter_rows_plain(g.reshape(g.shape[0], -1, g.shape[-1]), idx, hs2, J)


def repro_quarter_gather_backward(grad_half: torch.Tensor, idx: torch.Tensor, hs2: int,
                                  J: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K11, the VJP of K2 with respect to the rows: grad_half (B, 2g4, 2g4,
    2g4, J) float32 and K2's indices (B, C, g4^3) int32 -> the rows'
    gradient (B, C, hs2, J) in the rows' ``dtype`` (float32 or bf16), the
    J-view of a zeroed buffer whose rows are ``padded_width(J, itemsize)``
    apart. The plain version on the CPU, else one K11 launch (after a
    ``cudaMemsetAsync`` of the buffer), and for bf16 the rounding launch
    (``round_rows``)."""
    if dtype not in _DTYPES:
        raise ValueError(f"repro_quarter_gather_backward: rows of {dtype}")
    if build.on_cpu(grad_half, idx):
        return round_rows(repro_quarter_gather_backward_plain(grad_half, idx, hs2, J), dtype)
    g4 = grad_half.shape[1] // 2
    B, C = check_backward(grad_half, idx, J, 2 * g4, g4)
    buf = round_rows(launch_backward(grad_half, idx, B, C, J, hs2, g4), dtype)
    repro_quarter_gather_backward.launches += 1
    return buf


repro_quarter_gather_backward.launches = 0


def round_rows(buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gradient rows ``buf`` (B, C, hs2, J) float32, the J-view of a
    buffer, in ``dtype``: ``buf`` itself for float32; for bf16 each element
    rounded once to nearest even, as the J-view of a zero-padded buffer whose
    rows are ``padded_width(J, 2)`` apart: by ``pad_rows`` on the CPU, on the
    card by ``repro_rows_to_bf16`` in K11's source (K11 and K12 call it)."""
    if dtype == torch.float32:
        return buf
    if buf.device.type == "cpu":
        return pad_rows(buf.to(dtype))
    B, C, hs2, J = buf.shape
    So = padded_width(J, 2)
    out = torch.empty((B, C, hs2, So), dtype=dtype, device=buf.device)
    err = _round_fn()(build.ptr(buf), build.ptr(out), B * C * hs2, J, buf.stride(2), So,
                      build.stream())
    build.check(err, "repro_rows_to_bf16")
    return out[..., :J]


def launch_backward(grad, idx, B: int, C: int, J: int, hs2: int, g4: int,
                    threads: int = BACKWARD_THREADS) -> torch.Tensor:
    """One K11 launch (``csrc/repro_gather_backward.cu``) on checked tensors,
    in blocks of ``threads``; g4: the gather grid's points per axis. Returns
    the J-view of the buffer. Counts no launch (the wrapper counts its)."""
    S = padded_width(J, 4)
    buf = torch.empty((B, C, hs2, S), dtype=torch.float32, device=grad.device)
    p = build.ptr
    err = _backward_fn()(p(grad), p(idx), p(buf), B, C, J, S, hs2, g4, threads, build.stream())
    build.check(err, "repro_quarter_gather_backward")
    return buf[..., :J]


@functools.cache
def _backward_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("repro_gather_backward", "repro_quarter_gather_backward",
                      [p] * 3 + [i] * 7 + [p])


@functools.cache
def _round_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("repro_gather_backward", "repro_rows_to_bf16",
                      [p, p, ctypes.c_longlong, i, i, i, p])


@functools.cache
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("repro_quarter_gather", "repro_quarter_gather",
                      [p] * 8 + [i] * 7 + [ctypes.c_float, i, p])
