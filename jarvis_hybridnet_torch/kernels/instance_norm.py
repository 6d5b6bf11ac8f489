"""K1: InstanceNorm fused with the activation or residual that follows it.

Replaces ``tools/fused_norm_bench.py::_kernel`` (the repo's Pallas kernel)
and ``models/layers.py:22`` ``instance_norm`` with its consumers. CUDA source:
``csrc/instance_norm_act.cu``: one launch per call, one thread block cluster
per sample, each CTA holding its span of rows in shared memory. An optional
per-channel ``bias`` is added to x as it is read, rounded to x's dtype: the
bias of a bf16 convolution that flax adds after the convolution's rounding
(``jarvis_hybridnet_tpu/models/layers.py:127-131``), so the port's
convolution before the norm leaves it to K1 (``models/layers.conv_norm``).
Registered as ``jarvis_torch::instance_norm_act``.
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
                            skip: torch.Tensor | None = None,
                            bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: x (N, S, C), statistics over S in float32;
    ``bias`` (C,) in x's dtype is added to x first, rounded to x's dtype.

    As the JAX reference, the normalized value is rounded to x's dtype
    before the activation, ``add_relu`` rounds the sum before the ReLU, and
    SiLU is y * (1 / (1 + exp(-y))) rounded after each op, as XLA evaluates
    ``jax.nn.silu`` in bfloat16 (``exp`` through :func:`_exp`).
    Differentiable through autograd.
    """
    if bias is not None:
        x = x + bias
    mean, rstd = _statistics(x)
    y = ((x.float() - mean) * rstd).to(x.dtype)
    if act == "silu":
        return y * (1.0 / (1.0 + _exp(-y)))
    if act == "relu":
        return F.relu(y)
    if act == "add_relu":
        return F.relu(y + skip)
    return y


def _exp(t: torch.Tensor) -> torch.Tensor:
    """``torch.exp``; a float32 result on the CPU is checked against float64.
    torch's float32 ``exp`` on the CPU goes to MKL's vector library, a chunk
    of at most 2048 values a thread, which now and then computes one worker
    thread's chunk at reduced accuracy (4e-5 relative) on a process's first
    call and not again (ROADMAP.md C.4). A result more than 1e-6 relative
    from float64 is computed once more, and the call raises if it is still
    off; so the result is torch's usual one whatever the call's order."""
    out = torch.exp(t)
    if t.device.type != "cpu" or t.dtype != torch.float32:
        return out
    big = torch.finfo(torch.float32).max
    exact = torch.exp(t.detach().double()).float().clamp(max=big)

    def close(r):
        return bool(torch.isclose(r.detach().clamp(max=big), exact, rtol=1e-6, atol=1e-30,
                                  equal_nan=True).all())

    if not close(out):
        out = torch.exp(t)
        if not close(out):
            raise RuntimeError("float32 exp on the CPU stays more than 1e-6 from float64")
    return out


def _statistics(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 mean and 1 / sqrt(var + eps) of x (N, S, C) over S, (N, 1, C),
    two passes, as the JAX reference (``models/layers.py:22``)."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    return mean, torch.rsqrt(var + EPS)


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


def stats_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 (N, C, 2): the (mean, rstd) of x (N, S, C) over S, as
    ``instance_norm_act(..., return_stats=True)`` returns them."""
    mean, rstd = _statistics(x)
    return torch.stack((mean[:, 0], rstd[:, 0]), dim=-1)


def instance_norm_act(x: torch.Tensor, act: str = "none", skip: torch.Tensor | None = None,
                      return_stats: bool = False, bias: torch.Tensor | None = None):
    """InstanceNorm of x (N, S, C) over S, then ``act``.

    ``act`` is one of none / silu / relu / add_relu; add_relu returns
    relu(IN(x) + skip). Runs the registered op
    ``jarvis_torch::instance_norm_act``: a CPU tensor runs the plain version;
    a CUDA tensor launches the kernel (one ``__global__`` launch). With
    ``return_stats`` it returns (out, stats): stats float32 (N, C, 2), the
    (mean, rstd) the normalization used, which the backward (K6) starts from.
    ``bias`` (C,) in x's dtype is added to x as it is read (rounded to x's
    dtype, the value of ``x + bias``); the backward takes no bias, so the
    training step's ``InstanceNormAct`` never passes one.
    """
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if (act == "add_relu") != (skip is not None):
        raise ValueError("skip is given exactly when act == 'add_relu'")
    build.on_cpu(x, skip, bias)
    out, stats = _op(x, act, skip, return_stats, bias)
    return (out, stats) if return_stats else out


@torch.library.custom_op("jarvis_torch::instance_norm_act", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, act: str, skip: torch.Tensor | None, return_stats: bool,
        bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    # ``bias`` trails with a default, so an artifact exported before it
    # existed (four arguments) loads and runs as it did
    out = instance_norm_act_plain(x, act, skip, bias)
    if not return_stats:
        return out, build.no_output(x)
    return out, stats_plain(x if bias is None else x + bias)


@_op.register_kernel("cuda")
def _launch(x, act, skip, return_stats, bias=None):
    build.require(x, "x", _DTYPES, ndim=3)
    if bias is not None:
        build.require(bias, "bias", (x.dtype,), ndim=1)
        if bias.shape[0] != x.shape[2]:
            raise ValueError(f"bias shape {tuple(bias.shape)} != ({x.shape[2]},)")
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
    stats = (torch.empty((n, c, 2), dtype=torch.float32, device=x.device) if return_stats
             else None)
    err = _fn()(build.ptr(x), build.ptr(skip), build.ptr(bias), build.ptr(out),
                build.ptr(stats), n, s, c,
                plan.vec, plan.cluster, plan.threads, plan.span, plan.resident, plan.ring_rows,
                plan.q, plan.data_off, plan.ring_off, plan.smem, EPS, ACTS[act],
                _DTYPES[x.dtype], build.stream())
    build.check(err, "instance_norm_act")
    instance_norm_act.launches += 1
    return out, stats if return_stats else build.no_output(x)


@_op.register_fake
def _(x, act, skip, return_stats, bias=None):
    n, _, c = x.shape
    return (torch.empty_like(x),
            x.new_empty((n, c, 2), dtype=torch.float32) if return_stats else build.no_output(x))


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
                      [p] * 5 + [i] * 13 + [ctypes.c_float, i, i, p])


# K6: the backward of K1 (csrc/instance_norm_act_backward.cu)
BWD_STAGES = 4  # bulk copies that bring in a span's rows
BWD_MAX_THREADS = 512
_BWD_AUX = 128  # the mbarriers sit below this byte offset
_BWD_BLOCKS = 2 * _SMS  # co-resident blocks the plan assumes: two per SM
_BWD_CLUSTERS = (8, 4, 2)
_MIN_PART_BYTES = 32 * 1024  # a sample is not cut into spans of fewer bytes of x


def instance_norm_act_backward_plain(x: torch.Tensor, dy: torch.Tensor, out: torch.Tensor,
                                     act: str = "none", stats: torch.Tensor | None = None):
    """Plain PyTorch version of K6: (dx, dskip) of ``instance_norm_act(x, act,
    skip)`` with output ``out`` and incoming gradient ``dy``, all (N, S, C);
    dskip is None unless act is add_relu.

    With xhat = (x - mean) * rstd and g = dy * act', per (n, c):
    dx = rstd * (g - mean_S(g) - xhat * mean_S(g * xhat)) and dskip = g.
    act' is the mask out > 0 for relu and add_relu, and SiLU's derivative
    at the normalized value rounded to x's dtype (the value the forward
    passed to SiLU). mean and rstd are ``stats`` (N, C, 2), the forward's,
    where given, else computed from x. float32 arithmetic; dx and dskip in
    x's dtype.
    """
    if stats is None:
        mean, rstd = _statistics(x)
    else:
        mean, rstd = stats[:, None, :, 0], stats[:, None, :, 1]
    xhat = (x.float() - mean) * rstd
    g = dy.float()
    if act == "silu":
        v = xhat.to(x.dtype).float()
        s = torch.sigmoid(v)
        g = g * (s * (1.0 + v * (1.0 - s)))
    elif act in ("relu", "add_relu"):
        g = torch.where(out > 0, g, torch.zeros_like(g))
    mg = g.mean(dim=1, keepdim=True)
    mgx = (g * xhat).mean(dim=1, keepdim=True)
    dx = (rstd * (g - mg - xhat * mgx)).to(x.dtype)
    return dx, (g.to(x.dtype) if act == "add_relu" else None)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How K6 covers an (N, S, C) tensor.

    Each sample's rows are cut into ``parts`` spans of ``span`` rows
    (clipped to S; a multiple of ``q``), one per block of a grid of
    ``blocks`` = N * parts co-resident blocks in clusters of ``cluster``;
    with ``parts`` 1 the grid has ``blocks`` <= N and a block walks samples
    b, b + blocks, ... A thread loads ``vec`` elements (16 bytes, or 1 where
    a sample does not start on 16 bytes); a group of ``q`` rows is ``w``
    such vectors. The first ``resident`` rows of a span of each of the
    ``tensors`` inputs (x, dy, and y for add_relu) are bulk-copied into
    shared memory at ``data_off`` in ``BWD_STAGES`` stages of ``stage_rows``;
    the others are read twice. ``red_off``, ``part_off``, ``tot_off``: the
    lanes' sums, the cluster's blocks' sums (in rank 0) and the sample's
    sums (then the ordered sums' scratch); ``smem``: bytes of dynamic
    shared memory per block."""

    vec: int
    w: int
    q: int
    parts: int
    cluster: int
    span: int
    resident: int
    stage_rows: int
    blocks: int
    threads: int
    tensors: int
    red_off: int
    part_off: int
    tot_off: int
    data_off: int
    smem: int

    def spans(self, n: int, s: int) -> list[tuple[int, int, int]]:
        """The (sample, first row, end row) of every item, in item order."""
        return [(k // self.parts, min(s, (k % self.parts) * self.span),
                 min(s, (k % self.parts + 1) * self.span)) for k in range(n * self.parts)]

    def items(self, block: int, n: int) -> list[int]:
        """The items one block takes, in order."""
        return list(range(block, n * self.parts, self.blocks))


def backward_plan(n: int, s: int, c: int, itemsize: int, act: str,
                  capacity: int = _BWD_BLOCKS) -> BackwardPlan:
    """K6's launch plan for an (n, s, c) tensor of ``itemsize`` bytes.

    ``capacity`` is the co-resident blocks the grid may use (the wrapper
    gives the card's, from the occupancy query). A sample is cut into as
    many spans as the capacity gives it, in whole clusters, and no span
    holds fewer than ``_MIN_PART_BYTES`` of x; a sample that would get one
    span is a block's alone. The shared-memory arithmetic is the source's.
    """
    tensors = 3 if act == "add_relu" else 2
    row = c * itemsize
    aligned = (s * row) % 16 == 0
    vec = 16 // itemsize if aligned else 1
    ge = math.lcm(c, vec)  # elements in a group of q rows
    q, w = ge // c, ge // vec
    threads = 256 if w <= 256 else BWD_MAX_THREADS
    if w > threads:
        raise ValueError(f"instance_norm_act_backward: C = {c} needs {w} vectors a group, "
                         f"more than {threads} threads")
    lanes = threads // w
    want = min(capacity // n, -(-s * row // _MIN_PART_BYTES), -(-s // q))
    cluster = next((cs for cs in _BWD_CLUSTERS if want >= cs), 1)
    parts = want // cluster * cluster
    if parts >= 2:
        blocks = n * parts
    else:
        parts, cluster, blocks = 1, 1, min(n, capacity)
    red_off = _BWD_AUX
    part_off = red_off + 2 * lanes * ge * 4
    tot_off = part_off + cluster * 2 * c * 4  # every rank's sums, in rank 0
    data_off = _round_up(tot_off + (2 * c + max(threads, 2 * c)) * 4, 128)
    span = _round_up(-(-s // parts), q)
    room = (_TWO_PER_SM - data_off) // (tensors * row) // q * q
    resident = min(span, room) if aligned else 0
    stage_rows = _round_up(-(-resident // BWD_STAGES), q)
    return BackwardPlan(vec, w, q, parts, cluster, span, resident, stage_rows, blocks, threads,
                        tensors, red_off, part_off, tot_off, data_off,
                        data_off + tensors * resident * row)


@functools.lru_cache(maxsize=None)
def backward_launch_plan(n: int, s: int, c: int, dtype: torch.dtype, act: str) -> BackwardPlan:
    """K6's plan at the card's capacity: the grid shrinks until the
    occupancy query holds all of its clusters at once."""
    capacity = _BWD_BLOCKS
    while True:
        plan = backward_plan(n, s, c, dtype.itemsize, act, capacity)
        fit = backward_max_clusters(plan, dtype) * plan.cluster
        if plan.blocks <= fit:
            return plan
        if fit < 1:
            raise RuntimeError(f"instance_norm_act_backward: the card cannot schedule {plan}")
        capacity = min(capacity - 1, fit)


def backward_max_clusters(plan: BackwardPlan, dtype: torch.dtype) -> int:
    """Clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.bind("instance_norm_act_backward", "instance_norm_act_backward_max_clusters",
                    [i] * 5 + [p])
    build.check(fn(plan.vec, plan.cluster, plan.threads, plan.smem, _DTYPES[dtype],
                   ctypes.byref(n)), "instance_norm_act_backward_max_clusters")
    return n.value


def instance_norm_act_backward(x: torch.Tensor, dy: torch.Tensor, out: torch.Tensor,
                               act: str = "none", stats: torch.Tensor | None = None):
    """(dx, dskip) of K1 (see :func:`instance_norm_act_backward_plain`). A
    CPU tensor runs the plain version; a CUDA tensor launches K6 (one
    ``__global__`` launch, a cooperative grid), which needs ``stats``, the
    forward's (``instance_norm_act(..., return_stats=True)``): relu's mask
    is the sign of the normalized value, which equals out > 0 only with
    the forward's own statistics."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if build.on_cpu(x, dy, out, stats):
        return instance_norm_act_backward_plain(x, dy, out, act, stats)
    for t, name in ((x, "x"), (dy, "dy"), (out, "out")):
        build.require(t, name, (x.dtype,) if t is not x else _DTYPES, ndim=3)
        if t.shape != x.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(x.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"instance_norm_act_backward: {name} must be 16-byte aligned")
    n, s, c = x.shape
    if stats is None:
        raise ValueError("instance_norm_act_backward: a CUDA call needs the forward's stats")
    build.require(stats, "stats", (torch.float32,), ndim=3)
    if stats.shape != (n, c, 2):
        raise ValueError(f"stats shape {tuple(stats.shape)} != {(n, c, 2)}")
    plan = backward_launch_plan(n, s, c, x.dtype, act)
    dx = torch.empty_like(x)
    dskip = torch.empty_like(x) if act == "add_relu" else None
    clusters = plan.parts // plan.cluster if plan.parts > 1 else 0
    clsum = torch.empty(max(1, n * clusters * 2 * c), dtype=torch.float32, device=x.device)
    bar = build.sync_words(x.device, "instance_norm_act_backward")
    err = _bwd_fn()(build.ptr(x), build.ptr(dy), build.ptr(out), build.ptr(stats),
                    build.ptr(dx), build.ptr(dskip), build.ptr(clsum), build.ptr(bar), n, s, c,
                    plan.vec, plan.w, plan.q, plan.parts, plan.cluster, plan.span,
                    plan.resident, plan.stage_rows, plan.blocks, plan.threads, plan.red_off,
                    plan.part_off, plan.tot_off, plan.data_off, plan.smem, ACTS[act],
                    _DTYPES[x.dtype], build.stream())
    build.check(err, "instance_norm_act_backward")
    instance_norm_act_backward.launches += 1
    return dx, dskip


instance_norm_act_backward.launches = 0


@functools.cache
def _bwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("instance_norm_act_backward", "instance_norm_act_backward",
                      [p] * 8 + [i] * 20 + [p])


class InstanceNormAct(torch.autograd.Function):
    """K1 with K6 as its backward: ``InstanceNormAct.apply(x, skip, act)``.
    The forward keeps K1's statistics for the backward. Both go through their
    wrappers (``k1`` and ``k6`` below), so a CPU tensor runs the plain
    versions and a CUDA tensor the kernels."""

    @staticmethod
    def forward(ctx, x, skip, act):
        out, stats = InstanceNormAct.k1(x, act, skip, return_stats=True)
        ctx.act = act
        ctx.save_for_backward(x, out, stats)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, out, stats = ctx.saved_tensors
        dx, dskip = InstanceNormAct.k6(x, dy.contiguous(), out, ctx.act, stats)
        return dx, dskip, None


InstanceNormAct.k1 = staticmethod(instance_norm_act)
InstanceNormAct.k6 = staticmethod(instance_norm_act_backward)
