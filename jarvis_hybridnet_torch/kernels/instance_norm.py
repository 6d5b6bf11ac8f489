"""K1: InstanceNorm fused with the activation or residual that follows it.

Replaces ``tools/fused_norm_bench.py::_kernel`` (the repo's Pallas kernel)
and ``models/layers.py:22`` ``instance_norm`` with its consumers. CUDA source:
``csrc/instance_norm_act.cu``: one launch per call, one thread block cluster
per sample, each CTA holding its span of rows in shared memory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from . import build

ACTS = {"none": 0, "silu": 1, "relu": 2, "add_relu": 3}
EPS = 1e-5  # torch InstanceNorm's default, as models/layers.py:22
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's constants (csrc/instance_norm_act.cu)
MAX_THREADS = 1024
STAGES = 4  # bulk copies of the resident rows
RING = 4  # stages of x and of skip in the ring that streams the other rows
SMEM_MAX = 232_448  # dynamic shared memory one block may use
_AUX_OFFSET = 256  # the mbarriers sit below this byte offset
# the launch plan's choices
MAX_CLUSTER = 8  # the portable limit; an H100 holds 7 clusters of 10-16 at a time
_SMS = 132  # H100 SXM
_SMEM_PER_SM = 233_472
_TWO_PER_SM = _SMEM_PER_SM // 2 - 1024  # a block's share when two share an SM
_MIN_CTA_BYTES = 64 * 1024  # below this a CTA is not split further
RING_BYTES = 24 * 1024  # bytes of x per ring stage (as many again for skip)


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


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers an (N, S, C) tensor.

    ``cluster`` CTAs of ``threads`` threads per sample; rank r owns rows
    [r * span, (r + 1) * span) clipped to S. Its first ``resident`` rows
    (fewer at a shorter span: rounded down to a multiple of ``ring_rows``,
    or of ``q``, the rows in 16 bytes, without a ring) are copied into shared
    memory at ``data_off`` by bulk copies. With ``ring_rows`` > 0 the other
    rows stream through a ring at ``ring_off`` of ``RING`` stages of
    ``ring_rows`` rows of x and of skip, once per pass; with ``resident`` 0
    (a sample that does not start on 16 bytes) every row takes plain loads.
    ``reread``: some rows are read from global memory more than once.
    ``vec``: channels per thread and load; ``smem``: bytes of dynamic
    shared memory per CTA."""

    vec: int
    cluster: int
    threads: int
    span: int
    resident: int
    ring_rows: int
    q: int
    data_off: int
    ring_off: int
    smem: int

    @property
    def reread(self) -> bool:
        return self.ring_rows > 0 or self.resident == 0

    def spans(self, s: int) -> list[tuple[int, int]]:
        return [(min(s, r * self.span), min(s, (r + 1) * self.span))
                for r in range(self.cluster)]

    def copies(self, s: int, c: int, itemsize: int, rank: int) -> list[tuple[int, int]]:
        """One rank's bulk copies of x, as (byte offset in the sample, bytes):
        the resident stages, then one pass of the ring (the kernel's stage
        arithmetic)."""
        lo, hi = self.spans(s)[rank]
        res = min(self.resident, hi - lo)
        res -= res % (self.ring_rows or self.q)
        st = _round_up(-(-res // STAGES), self.q)
        row = c * itemsize
        out = [((lo + a) * row, (b - a) * row)
               for a, b in ((min(res, k * st), min(res, (k + 1) * st)) for k in range(STAGES))
               if b > a]
        if self.ring_rows:
            out += [((lo + a) * row, (min(hi - lo, a + self.ring_rows) - a) * row)
                    for a in range(res, hi - lo, self.ring_rows)]
        return out


def make_plan(n: int, s: int, c: int, itemsize: int, cluster: int, threads: int,
              ring_bytes: int = RING_BYTES) -> Plan:
    """The plan for a given cluster size, block size and ring stage size.

    A thread loads ``vec`` channels of a row at once (at most 16 bytes); the
    block's threads cover threads // (C / vec) rows per step."""
    vec = next(v for v in (8, 4, 2, 1) if v * itemsize <= 16 and c % v == 0)
    groups = c // vec
    if groups > threads:
        raise ValueError(f"instance_norm_act: C = {c} needs {groups} channel vectors "
                         f"of {vec}, more than the {threads} threads of a block")
    row = c * itemsize
    q = 16 // math.gcd(row, 16)
    aux = _AUX_OFFSET + _round_up(((threads // groups) * c + 4 * c) * 4, 128)
    span = _round_up(-(-s // cluster), q)
    ring_rows = 0
    if (s * row) % 16:  # a bulk copy needs 16-byte aligned addresses
        resident = 0
    elif aux + span * row <= SMEM_MAX:
        resident = span
    else:
        ring_rows = max(q, ring_bytes // row // q * q)
        room = SMEM_MAX - aux - 2 * RING * ring_rows * row
        resident = room // row // ring_rows * ring_rows
    data_off = aux + 2 * RING * ring_rows * row
    return Plan(vec, cluster, threads, span, resident, ring_rows, q, data_off, aux,
                data_off + resident * row)


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, s: int, c: int, itemsize: int) -> Plan:
    """The kernel's launch plan for an (n, s, c) tensor of ``itemsize`` bytes.

    The cluster is the smallest that holds a sample in shared memory with
    two CTAs to an SM, else with one, else ``MAX_CLUSTER`` (the rest of a
    span streams through the ring); it doubles while the card has fewer CTAs
    than SMs and each CTA would still hold ``_MIN_CTA_BYTES``. A block has
    512 threads where fewer than three CTAs share an SM and the wider block
    keeps as many on it, else 256.
    """
    row = c * itemsize

    def smem(cs):
        return make_plan(n, s, c, itemsize, cs, 256).ring_off + _round_up(-(-s // cs) * row, 16)

    sizes = (1, 2, 4, MAX_CLUSTER)
    cluster = next((cs for cs in sizes if smem(cs) <= _TWO_PER_SM),
                   next((cs for cs in sizes if smem(cs) <= SMEM_MAX), MAX_CLUSTER))
    while (cluster < MAX_CLUSTER and n * cluster < _SMS
           and -(-s // (2 * cluster)) * row >= _MIN_CTA_BYTES):
        cluster *= 2
    plan = make_plan(n, s, c, itemsize, cluster, 256)
    wide = make_plan(n, s, c, itemsize, cluster, 512)
    per_sm = _SMEM_PER_SM // (plan.smem + 1024)
    return wide if per_sm < 3 and _SMEM_PER_SM // (wide.smem + 1024) == per_sm else plan


def instance_norm_act(x: torch.Tensor, act: str = "none",
                      skip: torch.Tensor | None = None) -> torch.Tensor:
    """InstanceNorm of x (N, S, C) over S, then ``act``.

    ``act`` is one of none / silu / relu / add_relu; add_relu returns
    relu(IN(x) + skip). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (one ``__global__`` launch).
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
    for t, name in ((x, "x"), (skip, "skip")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"instance_norm_act: {name} must be 16-byte aligned")
    n, s, c = x.shape
    plan = launch_plan(n, s, c, x.element_size())
    _check_schedulable(plan, _DTYPES[x.dtype])
    out = torch.empty_like(x)
    err = _fn()(build.ptr(x), build.ptr(skip), build.ptr(out), n, s, c, plan.vec, plan.cluster,
                plan.threads, plan.span, plan.resident, plan.ring_rows, plan.q, plan.data_off,
                plan.ring_off, plan.smem, EPS, ACTS[act], _DTYPES[x.dtype], build.stream())
    build.check(err, "instance_norm_act")
    instance_norm_act.launches += 1
    return out


instance_norm_act.launches = 0


def max_active_clusters(plan: Plan, dtype: torch.dtype) -> int:
    """Clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.bind("instance_norm_act", "instance_norm_act_max_clusters", [i] * 5 + [p])
    build.check(fn(plan.vec, plan.cluster, plan.threads, plan.smem, _DTYPES[dtype],
                   ctypes.byref(n)),
                "instance_norm_act_max_clusters")
    return n.value


@functools.lru_cache(maxsize=None)
def _check_schedulable(plan: Plan, dtype_code: int) -> None:
    dtype = next(t for t, code in _DTYPES.items() if code == dtype_code)
    if max_active_clusters(plan, dtype) < 1:
        raise RuntimeError(f"instance_norm_act: the card cannot schedule {plan}")


@functools.cache
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("instance_norm_act", "instance_norm_act",
                      [p, p, p] + [i] * 13 + [ctypes.c_float, i, i, p])
