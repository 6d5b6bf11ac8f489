"""K10: per (image, channel) heatmap argmax and maximum (``csrc/argmax2d.cu``).

Replaces the JAX package's ``ops/heatmap.py::argmax_2d`` (:15);
``ops/heatmap.argmax_2d`` dispatches between it and its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

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


# CTAs a launch aims at: two per SM of an H100 for planar runs, four for
# interleaved ones (kernel_sweep.py: their staged shares gain from more)
_TARGET_CTAS = {"planar": 264, "strided": 264, "interleaved": 528}
THREADS = 256
_STAGE_BYTES = 32 * 1024  # most an interleaved share stages in shared memory


@dataclasses.dataclass(frozen=True)
class Plan:
    """K10's launch for one heads layout (``csrc/argmax2d.cu``): ``runs``
    runs of ``length`` elements, each cut into ``shares`` CTAs of ``threads``
    threads and ``per`` elements (the last share ends at ``length``).
    ``interleaved``: a run per image of channels-last heads (``cr`` = C
    channels a pixel); else a run per (image, channel) plane (``cr`` = 1).
    ``vec``: 16-byte loads. More than one share merge through
    ``keys_words`` zeroed int32 words (64-bit keys, then tickets)."""

    interleaved: bool
    runs: int
    cr: int
    length: int
    shares: int
    per: int
    vec: bool
    threads: int
    itemsize: int

    @property
    def keys_words(self) -> int:
        return 0 if self.shares == 1 else self.runs * (2 * self.cr + 1)

    def share(self, s: int) -> range:
        """The elements of a run that its share ``s`` reads."""
        return range(s * self.per, min(self.length, (s + 1) * self.per))


def layout(shape, strides) -> str:
    """"interleaved" for channels-last heads (C > 1, a pixel's C values
    contiguous, pixels dense), "planar" where every channel is one dense
    row-major plane (x stride 1, y stride W), else "strided"."""
    _, _, w, c = shape
    _, sy, sx, sc = strides
    if c > 1 and sc == 1 and sx == c and sy == w * c:
        return "interleaved"
    return "planar" if sx == 1 and sy == w else "strided"


@functools.cache
def launch_plan(shape: tuple, strides: tuple, itemsize: int, aligned: bool,
                ctas: int | None = None, threads: int = THREADS) -> Plan:
    """K10's plan for heads of ``shape`` (N, H, W, C) at element ``strides``
    whose data starts on 16 bytes when ``aligned``: shares of at least two
    16-byte loads a thread (an element where loads are scalar), about
    ``ctas`` CTAs in all (by default ``_TARGET_CTAS`` of the layout),
    interleaved shares a whole number of pixels and vectors of at most
    ``_STAGE_BYTES``. Other ``ctas`` and ``threads``: kernel_sweep.py's
    plans."""
    n, h, w, c = shape
    sn, _, _, sc = strides
    v = 16 // itemsize
    kind = layout(shape, strides)
    if kind == "interleaved":
        runs, cr = n, c
        vec = aligned and sn % v == 0
        unit = math.lcm(v, c) if vec else c
    else:
        runs, cr = n * c, 1
        vec = kind == "planar" and aligned and sn % v == 0 and (c == 1 or sc % v == 0)
        unit = v if vec else 1
    length = h * w * cr
    ctas = ctas or _TARGET_CTAS[kind]
    per = max(-(-length // -(-ctas // runs)), threads * (2 * v if vec else 1))
    per = -(-per // unit) * unit
    if kind == "interleaved":
        per = min(per, max(unit, _STAGE_BYTES // itemsize // unit * unit))
    return Plan(kind == "interleaved", runs, cr, length, -(-length // per), per, vec, threads,
                itemsize)


def plan_of(hm: torch.Tensor, **kw) -> Plan:
    """:func:`launch_plan` of heads ``hm`` (N, H, W, C)."""
    return launch_plan(tuple(hm.shape), hm.stride(), hm.element_size(),
                       hm.data_ptr() % 16 == 0, **kw)


def argmax2d(hm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(xy (N, C, 2) int32, maxvals (N, C) float32) of heatmaps ``hm`` (N, H,
    W, C), float32 or bfloat16, read through their strides (no copy). A CPU
    tensor runs the plain version; a CUDA tensor launches K10 (one
    ``__global__`` launch on the current stream, planned by
    :func:`launch_plan`)."""
    if build.on_cpu(hm):
        return argmax_2d_plain(hm)
    if hm.dtype not in _DTYPES or hm.dim() != 4:
        raise ValueError(f"argmax2d: expected float32 or bfloat16 (N, H, W, C), got "
                         f"{hm.dtype} {tuple(hm.shape)}")
    xy, maxv = launch(hm, plan_of(hm))
    argmax2d.launches += 1
    return xy, maxv


argmax2d.launches = 0


def launch(hm: torch.Tensor, plan: Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K10 on heads ``hm`` by ``plan``, counting no launch (the
    wrapper counts its own; chip_smoke.py and kernel_sweep.py run other
    plans through it)."""
    N, H, W, C = hm.shape
    xy = torch.empty((N, C, 2), dtype=torch.int32, device=hm.device)
    maxv = torch.empty((N, C), dtype=torch.float32, device=hm.device)
    keys = (build.sync_words(hm.device, "argmax2d", plan.keys_words) if plan.keys_words
            else None)
    err = _fn()(build.ptr(hm), N, H, W, C, *hm.stride(), _DTYPES[hm.dtype],
                int(plan.interleaved), int(plan.vec), plan.shares, plan.per, plan.threads,
                build.ptr(keys), build.ptr(xy), build.ptr(maxv), build.stream())
    build.check(err, "argmax2d")
    return xy, maxv


@functools.cache
def _fn():
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return build.bind("argmax2d", "argmax2d", [p, i, i, i, i, q, q, q, q] + [i] * 6 + [p] * 4)
