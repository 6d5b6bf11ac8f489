"""K3: softplus + soft-argmax + confidences, the HybridNet epilogue.

Replaces ``models/hybridnet.py:95-114``. CUDA source: ``csrc/soft_argmax.cu``:
one launch per call, a thread block cluster per frameset whose CTAs stream
contiguous spans of its volume and merge their sums in rank order through
distributed shared memory. Optionally it also writes the double-softplus
volume (``heatmap_final``) in the same pass. Registered as
``jarvis_torch::soft_argmax``.

Without the volume output the kernel's softplus uses the fast intrinsics
``__expf`` and ``__logf`` (CUDA's documented bounds: 2 + |1.173 x| ulps,
2^-21.41 absolute on [1, 2]); with it, the
accurate ``expf`` and ``log1pf``, so the volume matches the plain version
to float32 ulps. Its sums are float32 in another order than the plain
version's: points agree to 1e-3 mm and confidences to 1e-6 (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import build
from .instance_norm import _exp

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's constants (csrc/soft_argmax.cu)
STAGES = 4  # ring buffers of tiles per CTA
MAX_THREADS = 1024
MAX_CLUSTER = 16
SMEM_MAX = 232_448
# the launch plan's choices (kernel_sweep.py times the others)
CLUSTER = 9  # clusters of 10-16 CTAs of 1024 threads fit 7 at a time: two waves
THREADS = 1024
RUN = 24  # consecutive voxels per lane and tile


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), with no large-x threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(_exp(-x.abs()))


def soft_argmax_plain(vol: torch.Tensor, center3d: torch.Tensor,
                      grid_spacing: float, cube: float, return_volume: bool = False):
    """Plain PyTorch version: vol (B, g, g, g, J) -> (points (B, J, 3) mm,
    confidences (B, J)[, softplus(softplus(vol)) float32])."""
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
    conf = torch.clamp(maxvals, max=255.0) / 255.0
    return (points3d, conf, softplus(out)) if return_volume else (points3d, conf)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers a (B, g, g, g, J) volume.

    ``cluster`` CTAs of ``threads`` threads per frameset; rank r owns voxels
    [r * span, (r + 1) * span) clipped to g^3 and reads them ``tile`` voxels
    at a time into a ring of ``STAGES`` buffers; lane l (threads // J lanes)
    takes the ``run`` voxels from l * run of each tile. ``span`` and
    ``tile`` are multiples of 8 voxels, so every tile starts on 16 bytes.
    ``smem``: bytes of dynamic shared memory per CTA (the ring, the lanes'
    partials and the CTA's five per-joint sums)."""

    cluster: int
    threads: int
    span: int
    run: int
    tile: int
    smem: int

    def spans(self, nvox: int) -> list[tuple[int, int]]:
        return [(min(nvox, r * self.span), min(nvox, r * self.span + self.span))
                for r in range(self.cluster)]

    def tiles(self, nvox: int, rank: int) -> list[tuple[int, int]]:
        """Rank's tiles, as voxel ranges, in the order the kernel reads them."""
        lo, hi = self.spans(nvox)[rank]
        return [(a, min(hi, a + self.tile)) for a in range(lo, hi, self.tile)]


def make_plan(g: int, j: int, itemsize: int, cluster: int, threads: int,
              run: int = RUN) -> Plan:
    """The plan for a given cluster size, block size and run length (at most
    what a span needs, rounded up so that a tile is a multiple of 8
    voxels)."""
    if not (5 * j <= threads <= MAX_THREADS and cluster <= MAX_CLUSTER):
        raise ValueError(f"soft_argmax: {cluster} x {threads} threads cannot cover J = {j}")
    lanes = threads // j
    span = _round_up(-(-g ** 3 // cluster), 8)
    run = _round_up(min(run, -(-span // lanes)), 8 // math.gcd(lanes, 8))
    tile = lanes * run
    smem = STAGES * tile * j * itemsize + (5 * threads + 5 * j) * 4
    if smem > SMEM_MAX:
        raise ValueError(f"soft_argmax: {smem} bytes of shared memory")
    return Plan(cluster, threads, span, run, tile, smem)


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, g: int, j: int, itemsize: int) -> Plan:
    """The kernel's launch plan for a (b, g, g, g, j) volume of ``itemsize``
    bytes: clusters of ``CLUSTER`` CTAs of ``THREADS`` threads with runs of
    ``RUN`` voxels (the fastest in ``kernel_sweep.py`` at the main path's
    shape), fewer CTAs where a frameset has fewer than 8 voxels per CTA,
    shorter runs where the ring would not fit shared memory."""
    cluster, run = CLUSTER, RUN
    while cluster > 1 and g ** 3 < 8 * cluster:
        cluster //= 2
    while True:
        try:
            return make_plan(g, j, itemsize, cluster, max(_round_up(5 * j, 32), THREADS), run)
        except ValueError:
            if run == 1:
                raise
            run //= 2


def soft_argmax(vol: torch.Tensor, center3d: torch.Tensor, grid_spacing: float,
                cube: float, return_volume: bool = False):
    """Soft-argmax of the V2V output in world mm, and per-joint confidence.

    vol: (B, g, g, g, J) contiguous, bf16 or f32 (J <= 204); center3d (B, 3)
    int32 cube centers. Voxel (x, y, z) maps to
    ``(x, y, z) * grid_spacing * 2 - cube / 2 + center3d``. With
    ``return_volume`` the double-softplus volume (B, g, g, g, J) float32
    (JAX's ``heatmap_final``) comes back third, from the same pass. Runs the
    registered op ``jarvis_torch::soft_argmax``: the plain version on CPU
    tensors, K3 on CUDA tensors.
    """
    build.on_cpu(vol, center3d)
    points, conf, heat = _op(vol, center3d, float(grid_spacing), float(cube), return_volume)
    return (points, conf, heat) if return_volume else (points, conf)


@torch.library.custom_op("jarvis_torch::soft_argmax", mutates_args=(), device_types="cpu")
def _op(vol: torch.Tensor, center3d: torch.Tensor, grid_spacing: float, cube: float,
        return_volume: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    out = soft_argmax_plain(vol, center3d, grid_spacing, cube, return_volume)
    return out if return_volume else (*out, build.no_output(vol))


@_op.register_kernel("cuda")
def _launch(vol, center3d, grid_spacing, cube, return_volume):
    build.require(vol, "vol", _DTYPES, ndim=5)
    build.require(center3d, "center3d", (torch.int32,), ndim=2)
    B, g, J = vol.shape[0], vol.shape[1], vol.shape[-1]
    if vol.shape[1:4] != (g, g, g) or 5 * J > MAX_THREADS or center3d.shape != (B, 3):
        raise ValueError(f"vol must be (B, g, g, g, J<={MAX_THREADS // 5}), got "
                         f"{tuple(vol.shape)}")
    plan = launch_plan(B, g, J, vol.element_size())
    _check_schedulable(plan, _DTYPES[vol.dtype])
    out = run_plan(plan, vol, center3d, grid_spacing, cube, return_volume)
    soft_argmax.launches += 1
    return out if return_volume else (*out, build.no_output(vol))


@_op.register_fake
def _(vol, center3d, grid_spacing, cube, return_volume):
    B, J = vol.shape[0], vol.shape[-1]
    f32 = torch.float32
    return (vol.new_empty((B, J, 3), dtype=f32), vol.new_empty((B, J), dtype=f32),
            vol.new_empty(vol.shape, dtype=f32) if return_volume else build.no_output(vol))


soft_argmax.launches = 0


def run_plan(plan: Plan, vol: torch.Tensor, center3d: torch.Tensor, grid_spacing: float,
             cube: float, return_volume: bool = False):
    """Launch the kernel with ``plan`` on checked CUDA tensors (the wrapper's
    launch; ``kernel_sweep.py`` times other plans through it)."""
    B, g, J = vol.shape[0], vol.shape[1], vol.shape[-1]
    dev = vol.device
    points = torch.empty((B, J, 3), dtype=torch.float32, device=dev)
    conf = torch.empty((B, J), dtype=torch.float32, device=dev)
    heat = torch.empty(vol.shape, dtype=torch.float32, device=dev) if return_volume else None
    aligned = vol.data_ptr() % 16 == 0 and (g ** 3 * J * vol.element_size()) % 16 == 0
    p = build.ptr
    err = _fn()(p(vol), p(center3d), p(points), p(conf), p(heat), B, g, J, plan.cluster,
                plan.threads, plan.span, plan.run, plan.smem, int(aligned),
                float(grid_spacing), float(cube), _DTYPES[vol.dtype], build.stream())
    build.check(err, "soft_argmax")
    return (points, conf, heat) if return_volume else (points, conf)


def max_active_clusters(plan: Plan, dtype: torch.dtype) -> int:
    """Clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    i = ctypes.c_int
    fn = build.bind("soft_argmax", "soft_argmax_max_clusters", [i] * 4 + [ctypes.c_void_p])
    build.check(fn(plan.cluster, plan.threads, plan.smem, _DTYPES[dtype], ctypes.byref(n)),
                "soft_argmax_max_clusters")
    return n.value


@functools.lru_cache(maxsize=None)
def _check_schedulable(plan: Plan, dtype_code: int) -> None:
    dtype = next(t for t, code in _DTYPES.items() if code == dtype_code)
    if max_active_clusters(plan, dtype) < 1:
        raise RuntimeError(f"soft_argmax: the card cannot schedule {plan}")


@functools.cache
def _fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.bind("soft_argmax", "soft_argmax",
                      [p] * 5 + [i] * 9 + [f, f, i, p])
