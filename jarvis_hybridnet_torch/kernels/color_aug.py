"""K9: on-device color augmentation, uint8 images to the normalized float32
network input in one launch (``csrc/color_aug.cu``).

Replaces the jnp ops of the JAX package's train steps: the ``/255``,
``ops/augment.py::make_color_aug`` (:161, with ``_sep_blur`` :130),
``make_border_zero`` (:92) and the normalize (``training/trainer2d.py:140-148``,
``training/trainer3d.py:120-125``). The noise cannot be JAX's threefry draw;
it keeps its contract instead: the field is a pure function of each image's
``noise_seed`` and the pixel (Philox-4x32-10 and Box-Muller, the same
integers in the kernel and in :func:`noise_field`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import build
from .instance_norm import _exp

PARAM_KEYS = ("blur_sigma", "noise_scale", "noise_pc", "noise_seed",
              "contrast", "mul", "chan_mul")

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for a 32-bit constant ``a`` and int64
    ``b`` < 2^32, without overflowing int64: b is split in 16-bit halves."""
    p0 = a * (b & 0xFFFF)  # < 2^48
    p1 = a * (b >> 16)  # < 2^48
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (t >> 32) + (p1 >> 16), t & _M32


def philox4x32(counter: torch.Tensor, key: torch.Tensor) -> list[torch.Tensor]:
    """Philox-4x32-10 of the counters (c, 0, 0, 0) under the keys (k, 0), in
    int64 arithmetic masked to 32 bits; ``counter`` and ``key`` broadcast.
    Returns the four output words."""
    c0, k0 = torch.broadcast_tensors(counter.to(torch.int64), key.to(torch.int64) & _M32)
    zero = torch.zeros_like(c0)
    c, k1 = [c0, zero, zero, zero], zero
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c


def _uniform(w: torch.Tensor) -> torch.Tensor:
    """((w >> 9) + 0.5) / 2^23: a uniform in (0, 1), exact in float32."""
    return ((w >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def noise_field(seeds: torch.Tensor, h: int, w: int, per_channel: torch.Tensor) -> torch.Tensor:
    """The unit-normal noise (N, h, w, 3) float32 of N images: Philox on the
    counter y * w + x keyed by each image's seed, Box-Muller on words (0, 1)
    for channels 0 and 1 and on (2, 3) for channel 2; channel 0 on all three
    channels where ``per_channel`` is 0."""
    dev = seeds.device
    pix = torch.arange(h * w, dtype=torch.int64, device=dev)
    words = philox4x32(pix[None, :], seeds.reshape(-1, 1))
    u = [_uniform(t) for t in words]
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=dev)
    r01 = torch.sqrt(-2.0 * torch.log(u[0]))
    t01 = two_pi * u[1]
    n0 = r01 * torch.cos(t01)
    n1 = r01 * torch.sin(t01)
    n2 = torch.sqrt(-2.0 * torch.log(u[2])) * torch.cos(two_pi * u[3])
    field = torch.stack([n0, n1, n2], dim=-1).reshape(-1, h, w, 3)
    pc = per_channel.reshape(-1, 1, 1, 1) != 0
    return torch.where(pc, field, field[..., :1].expand_as(field))


def blur_taps(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, 2R + 1) Gaussian taps of each image's sigma, as JAX's
    ``make_color_aug``: exp(-o^2 / (2 s^2)), s = max(sigma, 1e-3), divided by
    their sum (summed in order); the delta where sigma <= 1e-3."""
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    sig = torch.clamp_min(sigma.reshape(-1, 1).float(), 1e-3)
    taps = _exp(-(offs * offs) / ((2.0 * sig) * sig))
    total = taps[:, 0]
    for k in range(1, taps.shape[1]):
        total = total + taps[:, k]
    taps = taps / total[:, None]
    delta = (offs == 0).to(torch.float32).expand_as(taps)
    return torch.where((sigma.reshape(-1, 1) > 1e-3), taps, delta)


def _reflect101(n: int, radius: int, device) -> torch.Tensor:
    """The indices -radius .. n + radius - 1 reflected into [0, n) as
    BORDER_REFLECT_101 (and ``jnp.pad``'s "reflect") reflects them, as many
    times as a radius beyond the edge needs."""
    i = torch.arange(-radius, n + radius, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def sep_blur(x: torch.Tensor, taps: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable blur of (N, H, W, 3) with per-image taps (N, K), rows first
    (along H), then columns, BORDER_REFLECT_101 edges, taps summed in order."""
    n, h, w, _ = x.shape
    xp = x[:, _reflect101(h, radius, x.device)]
    t = taps[:, :, None, None, None]
    acc = t[:, 0] * xp[:, 0:h]
    for k in range(1, taps.shape[1]):
        acc = acc + t[:, k] * xp[:, k:k + h]
    xp = acc[:, :, _reflect101(w, radius, x.device)]
    out = t[:, 0] * xp[:, :, 0:w]
    for k in range(1, taps.shape[1]):
        out = out + t[:, k] * xp[:, :, k:k + w]
    return out


def border_mask(h: int, w: int, minv: torch.Tensor) -> torch.Tensor:
    """(N, h, w) bool: the pixels whose inverse-mapped source (``minv`` (N,
    2, 3) applied to (x, y, 1)) lies inside the frame, as JAX's
    ``make_border_zero``."""
    m = minv.reshape(-1, 6).float()
    xo = torch.arange(w, dtype=torch.float32, device=m.device)[None, None, :]
    yo = torch.arange(h, dtype=torch.float32, device=m.device)[None, :, None]

    def col(i):
        return m[:, i, None, None]

    sx = (col(0) * xo + col(1) * yo) + col(2)
    sy = (col(3) * xo + col(4) * yo) + col(5)
    return (sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)


def color_aug_plain(imgs: torch.Tensor, params: dict | None, mean, std,
                    minv: torch.Tensor | None = None, radius: int = 0,
                    noise: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K9. ``imgs`` uint8 (..., H, W, 3); ``params``
    the per-image record (each leaf of the lead shape, ``chan_mul`` of lead +
    (3,)), or None for ``/255`` and normalize alone; ``minv`` (lead, 2, 3) or
    None; ``radius`` the blur's (0: none); ``noise`` whether the record's
    noise applies. Returns float32 (..., H, W, 3): ((color(x / 255)) - mean)
    / std, the steps in the order of ``csrc/color_aug.cu``."""
    if params is None and radius > 0:
        raise ValueError("color_aug: a blur needs the per-image record")
    h, w = imgs.shape[-3], imgs.shape[-2]
    x = imgs.reshape(-1, h, w, 3).to(torch.float32) / 255.0
    n = x.shape[0]
    if params is not None:
        p = {k: params[k].reshape(n, -1) for k in PARAM_KEYS}
        if radius > 0:
            x = sep_blur(x, blur_taps(p["blur_sigma"], radius), radius)
        if noise:
            field = noise_field(p["noise_seed"], h, w, p["noise_pc"])
            x = x + field * p["noise_scale"].reshape(n, 1, 1, 1)
        con = p["contrast"].reshape(n, 1, 1, 1)
        x = torch.where(con != 1.0, (x - 0.5) * con + 0.5, x)
        x = x * p["mul"].reshape(n, 1, 1, 1)
        x = x * p["chan_mul"].reshape(n, 1, 1, 3)
        x = torch.clamp(x, 0.0, 1.0)
    if minv is not None:
        x = torch.where(border_mask(h, w, minv)[..., None], x, torch.zeros_like(x))
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).reshape(imgs.shape)


# The kernel's constants (csrc/color_aug.cu: kMaxThreads, kPad, kMaxFast)
# and the card's shared memory a block may take
MAX_THREADS = 512
PAD = 4
MAX_FAST = 4
SMEM_LIMIT = 227 * 1024
# The plan's defaults (kernel_sweep.py --only k9): threads a CTA, the
# tallest band that still gives TARGET_BLOCKS CTAs, the flat walk's most
# CTAs (4 a SM; grid-stride beyond)
THREADS = 256
BAND_ROWS = (16, 8, 4, 2, 1)
TARGET_BLOCKS = 264
FLAT_BLOCKS = 528


@dataclasses.dataclass(frozen=True)
class Plan:
    """K9's launch (``csrc/color_aug.cu``). ``rows`` 0: ``k9_flat``, /255 and
    normalize alone over the batch's bytes in units of 4 (``blocks`` CTAs of
    ``threads``, grid-stride); else ``k9_bands``, a CTA per band of ``rows``
    rows of one image (``blocks`` = N * bands). ``vec``: the runs' bytes are
    read as 4-byte words (a word-aligned base and, for bands, W % 4 == 0);
    ``smem``: the band's shared memory in bytes."""

    rows: int
    blocks: int
    threads: int
    vec: bool
    smem: int


def band_floats(w: int, radius: int, rows: int) -> int:
    """The shared floats of a band (``band_floats`` in the source): the taps
    rounded up to 4, the staged rows (rows + 2R of 3 W4 floats, W4 = W
    rounded up to 4) and the three planar column-blurred channels (rows of
    W4 + 2 PAD floats for radii up to MAX_FAST, else W4)."""
    if radius == 0:
        return 0
    w4 = -(-w // 4) * 4
    pad = PAD if radius <= MAX_FAST else 0
    return ((2 * radius + 1 + 3) & ~3) + (rows + 2 * radius) * 3 * w4 + 3 * rows * (w4 + 2 * pad)


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, h: int, w: int, radius: int, flat: bool, aligned: bool,
                rows: int | None = None, threads: int = THREADS,
                flat_blocks: int = FLAT_BLOCKS) -> Plan:
    """The plan for N images (h, w, 3): ``flat`` for /255 and normalize alone
    (no record, no border); ``aligned`` when the images' base is 4-byte
    aligned. A band is ``rows`` rows (by default the tallest of BAND_ROWS
    that gives TARGET_BLOCKS CTAs: halo rows staged again cost less than
    idle SMs), fewer where the blur's staged rows would not fit
    SMEM_LIMIT; raises where even one row does not."""
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"color_aug: {threads} threads a CTA")
    if flat:
        units = -(-(n * h * w * 3) // 4)
        return Plan(0, max(1, min(flat_blocks, -(-units // threads))), threads, aligned, 0)
    if rows is None:
        rows = next((r for r in BAND_ROWS if n * -(-h // r) >= TARGET_BLOCKS), 1)
    rows = max(1, min(rows, h))
    while rows > 1 and band_floats(w, radius, rows) * 4 > SMEM_LIMIT:
        rows -= 1
    smem = band_floats(w, radius, rows) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"color_aug: a band of one row of width {w} at radius {radius} needs "
                         f"{smem} bytes of shared memory, more than {SMEM_LIMIT}")
    return Plan(rows, n * -(-h // rows), threads, aligned and w % 4 == 0, smem)


def plan_of(imgs: torch.Tensor, params: dict | None, minv: torch.Tensor | None = None,
            radius: int = 0, **kw) -> Plan:
    """The wrapper's plan for a call (``kw``: ``launch_plan``'s rows,
    threads and flat_blocks)."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    return launch_plan(imgs.numel() // (h * w * 3), h, w,
                       int(radius) if params is not None else 0,
                       params is None and minv is None, imgs.data_ptr() % 4 == 0, **kw)


def color_aug(imgs: torch.Tensor, params: dict | None, mean, std,
              minv: torch.Tensor | None = None, radius: int = 0,
              noise: bool = True) -> torch.Tensor:
    """K9: as :func:`color_aug_plain`. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (one ``__global__`` launch on the current
    stream). On the card every leaf of ``params`` is a contiguous float32
    tensor (``noise_seed`` int32) and ``minv`` float32."""
    leaves = [] if params is None else [params[k] for k in PARAM_KEYS]
    if build.on_cpu(imgs, minv, *leaves):
        return color_aug_plain(imgs, params, mean, std, minv, radius, noise)
    build.require(imgs, "imgs", (torch.uint8,))
    if imgs.dim() < 3 or imgs.shape[-1] != 3:
        raise ValueError(f"color_aug: expected (..., H, W, 3) images, got {tuple(imgs.shape)}")
    lead = tuple(imgs.shape[:-3])
    if params is not None:
        for k in PARAM_KEYS:
            t = params[k]
            build.require(t, k, (torch.int32,) if k == "noise_seed" else (torch.float32,))
            want = lead + ((3,) if k == "chan_mul" else ())
            if tuple(t.shape) != want:
                raise ValueError(f"color_aug: {k} has shape {tuple(t.shape)}, expected {want}")
    elif radius > 0:
        raise ValueError("color_aug: a blur needs the per-image record")
    if minv is not None:
        build.require(minv, "minv", (torch.float32,))
        if tuple(minv.shape) != lead + (2, 3):
            raise ValueError(f"color_aug: minv has shape {tuple(minv.shape)}, expected "
                             f"{lead + (2, 3)}")
    out = launch(imgs, params, mean, std, minv, radius, noise, plan_of(imgs, params, minv, radius))
    color_aug.launches += 1
    return out


color_aug.launches = 0


def launch(imgs: torch.Tensor, params: dict | None, mean, std, minv, radius: int, noise: bool,
           plan: Plan, fn=None) -> torch.Tensor:
    """One launch of K9 under ``plan`` on checked arguments; counts no
    launch (``color_aug`` does; kernel_sweep.py times other plans, and
    variants of the source through ``fn``, their ``color_aug`` bound by
    :func:`bind`)."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    if not all(2.0 ** -20 <= abs(float(v)) <= 2.0 ** 20 for v in std):
        raise ValueError(f"color_aug: std {tuple(std)} outside [2^-20, 2^20]")
    out = torch.empty(imgs.shape, dtype=torch.float32, device=imgs.device)
    leaves = [None] * 7 if params is None else [params[k] for k in PARAM_KEYS]
    err = (fn or _fn())(
        build.ptr(imgs), build.ptr(out), imgs.numel() // (h * w * 3), h, w,
        int(radius) if params is not None else 0, int(bool(noise) and params is not None),
        *(build.ptr(t) for t in leaves), build.ptr(minv), *(float(v) for v in mean),
        *(float(v) for v in std), plan.rows, plan.blocks, plan.threads, int(plan.vec),
        build.stream())
    build.check(err, "color_aug")
    return out


def bind(lib: ctypes.CDLL):
    """The C entry point ``color_aug`` of a library built from the source."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.color_aug
    fn.argtypes = [p, p, i, i, i, i, i] + [p] * 8 + [f] * 6 + [i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.library("color_aug"))
