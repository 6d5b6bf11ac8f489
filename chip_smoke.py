#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --baseline-csrc DIR [--baseline-kernel k9|k12]

Builds the twelve CUDA kernel sources from ``jarvis_hybridnet_torch/kernels/csrc``,
loads the committed MonkeyHand checkpoints through the port's own reader,
and drives ``make_predictor3d`` at the production configuration (bf16,
quarter_fused, 12 cameras of 1280x1024 on the synthetic rig, 23 joints,
256^2 crops and CenterDetect input, 144 mm cube at 2 mm, T = 8 framesets of
seeded uint8 frames), then the same cascade in the exact, half_fused and
half repro modes on the same frames, the production cascade on the same
frames as float32 in [0, 1], ``make_predictor2d`` on T = 8 frames of one
camera, the two-phase cascade (``make_predictor3d_twophase``: low-resolution
frames reduced 4x, host crops, phase B) and the streaming loop of the
``predict3D`` driver writing ``data3D.csv`` from a reader of seeded
batches, each path eager (``graph=False``) with the launch counts set to 0
before one step and read after it; the arguments of K1, K2, K4 and K10 are
recorded over each path's step. Then every serving path as captured CUDA
graphs (``graph=True``, ``prediction/export.py``) against its eager step:
predict3D quarter_fused on uint8 and float32 frames, exact, half_fused,
half, two-phase phase A and phase B, predict2D, each with its eager step
run under ``torch.cuda.set_sync_debug_mode("error")``, four alternating
replays of two seeded batches bit-equal to the eager step and the two
batches' replays different, eager and graphed steps/s (median of 3 runs of
5 steps), the host's ms to issue one step, a profiled run of 5 steps (the
CUDA-event span, kernel time and busy share of the same steps), the
graphed profile's calls of K1-K5 and K10 equal to the eager launch counts,
capture ms and pool bytes; and the three drivers' loops
(``stream_predict3d``, ``stream_predict3d_twophase``, predict2D's
``stream_rows``) with the graphed predictors, their CSV rows equal to the
eager predictor's outputs batch by batch over 4 alternating batches, their
rates beside the eager loops' (``chip_smoke_graphs.txt``: the graphed
steps' kernels). Then the training phases, on a synthetic COCO-style dataset written to
a temporary directory (12 cameras of 1280x1024 JPEG frames, 23 keypoints
with each image's bounding box, 4 train and 2 val framesets: 48 and 24
images), at the default ``TPU`` section (color augmentation on the device,
K9): ``train_hybridnet`` in 3D_only from the committed HybridNet checkpoint
(float32, quarter_fused, G = 72), then in ``all`` with ``finetune`` (the
CLI's ``jarvis train hybridNet --mode all``: the 2D net trains too, its
gradient crossing the gather's backward, K11), one step each in ``bifpn``
and ``last_layers`` and one ``all`` step in each of the exact, half_fused
and half repro modes (K12), then ``train_efficienttrack`` for
CenterDetect and KeypointDetect from theirs (256^2, batch 4, float32), two
epochs each, each run with the launch counts set to 0 before it and read
after it and the arguments of K1, K2, K6, K8, K9 and K10 recorded; the
3D_only run leaves the 2D net bit-equal, calls K2 without a graph and
launches no K11, the ``all`` run changes the 2D net and launches K11 once
a training step, the ``bifpn`` / ``last_layers`` steps leave exactly their
frozen tensors bit-equal, every 3D run changes V2V's weights, the 2D runs
change their nets' weights, and every written ``.ckpt`` / ``.pth``
reloads equal to the trained state; each step's rate (framesets/s or
images/s), ms and device busy share; one small step of each kind (3D_only,
all, 2D) on the card against the same step on the CPU (float32, TF32 off,
dropout and drop-connect off; the 3D ones with the CPU's ReLU masks set to
the card's; a TF32 step as each gate's control, which it must refuse); K6
(at every key of the 3D and 2D steps, every act at V2V's largest float32
shape and one bf16 key), K7, K8, K9 (the noise at the config's upper bound)
and K10 against their plain versions, each called twice and required
bit-equal
(K8's gradients equal to the plain version's; K9 also at the edge keys of
``K9_EDGE_KEYS``: radii 0-12, odd sizes, unaligned bases, the border alone;
K10 also under other plans and on hand-made edge batches in both dtypes
and layouts); K11 and K12 (each mode) at the ``all`` step's rows and at
edge keys (B = 2, C = 1, J = 1 and 23 with rows S = J and 24 apart, every
point clamped to one pixel, an odd gather grid) against their plain
versions in float64, within twice the float32 plain version's own error,
with K12's windowed and overflow (tile, camera) counts at every key.
The training phases above run their steps eagerly (``graph=False``: the
kernels line's launch counts). Then the training-graphs phase holds the
train and eval steps replayed from captured CUDA graphs
(``training/graphed.py``) to the eager steps on every training path
(3D_only and ``all`` at quarter_fused, ``bifpn``, ``last_layers``, ``all``
in exact, half_fused and half, CenterDetect and KeypointDetect): two eager
trainers and a graphed one from the same checkpoint and seed take 5 train
steps (AdamW, an lr that changes every step, two alternating batches: 2
eager steps, the capture, 2 more replays), then 5 eval steps; where the
eager twins are bit-equal every replay must be bit-equal to its eager twin
(loss, points or argmax, parameters, AdamW's state), else within
GAP_FACTOR times the eager gap, which is printed; the eager steps after
the first run under ``set_sync_debug_mode("error")``; rates, host issue
ms, a profiled run's event span, kernel time and busy share, the graphed
profile's calls of every hand-written kernel equal to the eager launch
counts, capture ms, pool bytes, the batch's copy into the static buffers;
then each path's ``train()`` for 2 epochs graphed against eager (seeded
host draws, one loader thread; the generator reseeded per epoch between
replays) under the same rule (against TRAIN_RUN_EAGER eager runs where
they are not bit-equal) (``chip_smoke_train_graphs.txt``: the graphed
steps' kernels by name and count). Then bf16 training
(``TPU.TRAIN_DTYPE: bfloat16``: float32 masters, bf16 compute): every
training path's eager bf16 step counted (its kernels launched, the bf16
keys of K1, K6, K8, K10 and the bf16 rows of K2 recorded; the parameters,
gradients and AdamW moments float32), every path's bf16 steps and its
2-epoch ``train()`` graphed against eager as above (``train graph bf16
<path>`` lines, ``chip_smoke_train_graphs_bf16.txt``; where K11 / K12 add
and a replay is not bit-equal, ``flip_verdict``); the bf16 ``all`` and
KeypointDetect steps (4 framesets / images, two seeds) on the card and the
CPU at bf16 and float32: the card's bf16-vs-float32 gradient gap within
BF16_GAP_FACTOR times the CPU's on the mean over the tensors and within
BF16_TENSOR_FACTOR on each, every bf16 convolution on the card within
CONV_ROUND_TOL of its float64 value rounded once; K11 and K12 (each mode) at the bf16
``all`` step's rows within half a bf16 ulp of the float64 plain value plus
twice the float32 plain version's error, timed beside ``index_add_`` into
bf16 rows.
Then the loaders phase (``loaders_phase``): the loops of 3D_only, ``all``
and both 2D nets as a user runs them (``train_hybridnet`` /
``train_efficienttrack``, host augmentation and decode included), eager
and graphed with 4 loader threads, and graphed with 4 process workers (the
default ``DATALOADER_WORKER_MODE``) at float32 and at bf16: each loop's rate
from its steps' call times and its ratio to the step's rate of this run
(eager or graphed), its set-up, first step and each epoch's start, its launch counts
(the kernels line's ``loop_<kind>_<path>`` paths; the process loops' equal
to the thread loops'); the float32 process KeypointDetect loop drives the
Streamlit monitor's protocol on five recording widgets, call for call the
JAX trainers'; the threads' and the process workers' batches byte for byte
(host augmentation off); two process-pool epochs forked after the graph
captures under ``PreemptionGuard`` (every batch, no worker left, an eval
replay bit-equal before and after); KeypointDetect's 2-epoch run against
one epoch saved in the JAX package's train-state layout and resumed
(bit-equal, or else ``run_verdict`` against eight eager runs).
Then the C.9 trace (ROADMAP.md: the bf16 ``all`` exact eager twins on four
seeds of the batches; where a pair parts, the first tensor that differs,
``flip_verdict``'s readings, K12's bf16 rows and ``repro_rows_to_bf16``
against their plain versions) and the multi-device phase (``parallel/``):
NCCL in a world of one rank in this process, the graphed ``all``
quarter_fused float32 step at full width on a 1 x 1 mesh against the
non-distributed graphed step (the all-reduce issued eagerly twice, once
under capture, never by the replays; both steps' rates); two gloo ranks
spawned on the one card (``spawn``, a ``file://`` store): the sharded
``all`` step at 1 x 2 and 2 x 1 (quarter_fused) and 1 x 2 (exact) against
two single-process runs of the step (MULTI_LOSS_TOL, MULTI_STEP_TOL or
GAP_FACTOR times their own gap; a one-process split as the control at 2 x
1), predict3D at the production configuration at 2 x 1 and 1 x 2 against
the main path's predictor (the crop centers and gates that differ, the V2V
volume within MULTI_VOLUME_ULPS on the framesets that agree), each rank's
rate and busy share (two ranks share the card); K2, K5, K11 and K12 at
``c_total`` = 12 on 6 cameras against their plain versions (the kernels
line's ``[c_total=12]`` keys).
It then checks every kernel against its plain PyTorch version on the card:
K1, K2 and K4 at every shape a driven path gave them, K3 and K5 at the main
path's, and times kernel, plain version and library call. A kernel's
``ms`` is device time: a CUDA graph of ``GRAPH_CALLS`` captured calls is
replayed, so host launch gaps do not count; ``wall_ms`` is the event time
of calls launched one by one from Python; the kernels line counts each
path's launches on its eager step. Prints the card, the predict3D
rates, one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. The last phase, ``cli``, drives the port through its command line
(``jarvis-torch``, ``ui/cli.py``) in this process with click's ``CliRunner``
at full width: create-project on a 12-camera dataset, the production
values set in the project's config.yaml, train hybridNet for one epoch,
predict predict3D on a 16-frame recording, analyze analyze-validation-data
and visualize create-videos3D, each checked against the direct calls
(:func:`cli_phase`; the kernels line's ``cli`` path counts the wrappers'
launches over the commands: eager calls, graph warm-ups and captures; the
replays of a captured graph call no wrapper and are not counted). On its
project ``chip_smoke_export.py`` then runs the phases ``export`` (predict3D
``--trt_mode new`` under ``TPU.PROFILE_DIR``, predict2D off / new /
previous) and ``launch-cli`` (a scripted interactive session predicting 3D
from the saved artifact); their paths ``export_predict3d`` and
``export_predict2d`` on the kernels line. Every path but the production
predict3D and predict2D and their drivers' loops is timed at SHORT depth
(``FULL`` / ``SHORT``).
Each phase's seconds are printed before the kernels line. Exits non-zero
on any failure, or when no CUDA device is present.
Per-shape details go to ``chiprun_out/chip_smoke.txt``; the training
steps' device time by kernel to ``chip_smoke_train_profile.txt`` (3D_only),
``chip_smoke_train_all_profile.txt`` and ``chip_smoke_train2d_profile.txt``.

With ``--baseline-csrc DIR`` (and ``--baseline-kernel k9``, the default),
DIR holds an earlier version of the kernel sources whose ``color_aug.cu``
has the C interface of ``BASELINE_SIGNATURE`` (that of b3d34a0: K9 over 32
x 32 tiles staged with their halo); it builds that K9 too and times it
beside the current one at every recorded key, in the order baseline,
current, current, baseline, into ``chiprun_out/chip_smoke_baseline.txt``.
K9's outputs must equal the baseline's bit for bit at every recorded key
and every edge key. With ``--baseline-kernel k12`` DIR's
``repro_gather_backward.cu`` has K12 with the C interface of
``BASELINE_K12_SIGNATURE`` (that of 3ddb97d: a thread a (gather point,
joint), scalar atomics); that K12 is timed beside the current one at the
production key in each mode, in the same order, both held to the float64
plain version (float atomics: not bit for bit).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import faulthandler
import functools
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
REPO = os.path.dirname(os.path.abspath(__file__))
T, CAMS, H, W = 8, 12, 1024, 1280
ITERS = 5
REPEATS = 3
# timing depth (runs, steps a run) of the rates, the host's issue time and
# the profiled runs: the production predict3D (quarter_fused, uint8 frames)
# and predict2D keep FULL, their drivers' loops too; every other path takes SHORT, one run of fewer
# steps (no check reads its rates; its profile's kernel counts are held to
# the same run's launches, at any number of steps)
FULL = (REPEATS, ITERS)
SHORT = (1, 3)
GRAPH_CALLS = 20
GRAPH_REPLAYS = 5


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS) -> float:
    """Device time of one fn() in ms: a CUDA graph of ``calls`` captured
    calls, replayed ``replays`` times between two CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def bf16_ulps(kernel_out, plain_out) -> float:
    """Largest |kernel - plain| in bf16 ulps of max(|plain|, 1)."""
    import torch

    mag = plain_out.float().abs().clamp_min(1.0)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((kernel_out.float() - plain_out.float()).abs() / ulp).max())


def f32_ulps(kernel_out, plain_out) -> float:
    """Largest |kernel - plain| in float32 ulps of |plain|."""
    import torch

    mag = plain_out.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 23)
    return float(((kernel_out - plain_out).abs() / ulp).max())


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stage_breakdown(predictor, frames, note, iters: int = 5) -> None:
    """Device time of each stage of one step, timed alone (CUDA events over
    ``iters`` calls)."""
    import torch

    from jarvis_hybridnet_torch import kernels

    hybrid = predictor.hybrid_model
    with torch.no_grad():
        center_hm, center3d, _ = predictor.centers(frames)
        crops = predictor.crops(frames, center_hm)
        rows = hybrid.heatmap_rows(crops)
        c3d = center3d.to(torch.int32).contiguous()
        cams = [a.expand(frames.shape[0], *a.shape) for a in (predictor.P, predictor.K,
                                                              predictor.D)]
        out = hybrid.v2v_output(rows, center_hm, c3d, *cams).contiguous()
        preds, maxvals = predictor.detect(frames)
        H, W = frames.shape[2], frames.shape[3]
        stages = {
            "detect (K4 resize + normalize, CenterDetect, argmax)":
                lambda: predictor.detect(frames),
            "place (gate, DLT by QR, reprojection, clamp)":
                lambda: predictor.place(preds, maxvals, H, W),
            "crops + normalize": lambda: predictor.crops(frames, center_hm),
            "KeypointDetect + pad (heatmap_rows)": lambda: hybrid.heatmap_rows(crops),
            f"repro + V2V (v2v_output, {hybrid.repro_mode})":
                lambda: hybrid.v2v_output(rows, center_hm, c3d, *cams),
            "K3 soft_argmax": lambda: kernels.soft_argmax(
                out, c3d, float(hybrid.grid_spacing), float(hybrid.roi_cube_size)),
        }
        for name, fn in stages.items():
            note(f"stage {name}: {cuda_ms(fn, iters=iters, warmup=1):.3f} ms")


def profile_steps(predictor, frames, out_dir, note) -> None:
    """torch.profiler over two steps: device time by kernel and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            predictor(frames[i % 2])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: an operator's entry repeats the time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in kernels),
                  reverse=True)
    device_us = sum(r[0] for r in rows)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"two steps, wall {wall_us:.0f} us, device kernel time {device_us:.0f} us\n")
        for us, count, key in rows[:40]:
            f.write(f"{us:12.0f} us {count:6d}x  {key[:110]}\n")
    if device_us == 0:
        note("profile: torch.profiler recorded no device time")
    else:
        note(f"profile: device busy {device_us / wall_us:.3f} of the wall time of two steps; "
             f"top kernel {rows[0][2][:60]} {rows[0][0] / 2e3:.3f} ms per step")


# The C interface of the earlier K9 design that --baseline-csrc builds (that
# of b3d34a0: a 32 x 32 tile with its halo staged as float32 in shared
# memory): N, H, W, R and noise are ints, m0-s2 floats, the rest pointers.
BASELINE_SIGNATURE = ("src, dst, N, H, W, R, noise, sigma, scale, pc, seed, contrast, mul, "
                      "chan_mul, minv, m0, m1, m2, s0, s1, s2, stream")


def bind_baseline(lib):
    """``color_aug`` of a library built from the earlier K9 source, with the
    argument types of ``BASELINE_SIGNATURE``."""
    fn = lib.color_aug
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int if a in ("N", "H", "W", "R", "noise") else
                   ctypes.c_float if a[1:].isdigit() else ctypes.c_void_p
                   for a in BASELINE_SIGNATURE.split(", ")]
    return fn


def call_baseline(fn, imgs, params, mean, std, minv=None, radius=0, noise=True):
    """As ``kernels.color_aug`` on the card (contiguous images), through the
    earlier design's C interface ``fn``."""
    import torch

    from jarvis_hybridnet_torch.kernels import build
    from jarvis_hybridnet_torch.kernels.color_aug import PARAM_KEYS

    h, w = imgs.shape[-3], imgs.shape[-2]
    out = torch.empty(imgs.shape, dtype=torch.float32, device=imgs.device)
    leaves = [build.ptr(None if params is None else params[k]) for k in PARAM_KEYS]
    build.check(fn(build.ptr(imgs), build.ptr(out), imgs.numel() // (h * w * 3), h, w,
                   int(radius), int(bool(noise)), *leaves, build.ptr(minv),
                   *(float(v) for v in mean), *(float(v) for v in std), build.stream()),
                "baseline K9")
    return out


def build_baseline(csrc: str):
    """K9 of an earlier design, built from ``<csrc>/color_aug.cu`` against
    that directory's own headers: a function with ``color_aug``'s
    arguments."""
    from jarvis_hybridnet_torch.kernels import build

    out_dir = os.path.join(csrc, "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libcolor_aug.so")
    proc = subprocess.run([build._nvcc(), *build._flags("color_aug"), "-o", path,
                           os.path.join(csrc, "color_aug.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc failed for the baseline color_aug.cu:\n{proc.stdout}{proc.stderr}")
    return functools.partial(call_baseline, bind_baseline(ctypes.CDLL(path)))


# The C interface of the earlier K12 design that --baseline-kernel k12
# builds from <DIR>/repro_gather_backward.cu (that of 3ddb97d: a thread a
# (gather point, joint) and scalar atomics; mode and threads are ints).
BASELINE_K12_SIGNATURE = "grad, idx, out, B, C, J, S, hs2, n, mode, threads, stream"


def build_k12_baseline(csrc: str):
    """K12 of an earlier design, built from ``<csrc>/repro_gather_backward.cu``
    against that directory's own headers: a function (grad, idx, hs2, J,
    mode) -> the rows' gradient, as ``kernels.repro_grid_gather_backward``
    on the card, in blocks of 256."""
    from jarvis_hybridnet_torch.kernels import build
    from jarvis_hybridnet_torch.kernels.repro_grid_gather import MODES
    from jarvis_hybridnet_torch.kernels.repro_gather import padded_width

    out_dir = os.path.join(csrc, "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "librepro_gather_backward.so")
    proc = subprocess.run([build._nvcc(), *build._flags("repro_gather_backward"), "-o", path,
                           os.path.join(csrc, "repro_gather_backward.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc failed for the baseline repro_gather_backward.cu:\n{proc.stdout}"
             f"{proc.stderr}")
    fn = ctypes.CDLL(path).repro_grid_gather_backward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if a in ("grad", "idx", "out", "stream") else ctypes.c_int
                   for a in BASELINE_K12_SIGNATURE.split(", ")]

    def call(grad, idx, hs2, J, mode):
        import torch

        B, C, n = idx.shape[0], idx.shape[1], grad.shape[1] // (2 if mode == "half" else 1)
        S = padded_width(J, 4)
        buf = torch.empty((B, C, hs2, S), dtype=torch.float32, device=grad.device)
        b = build.ptr
        build.check(fn(b(grad), b(idx), b(buf), B, C, J, S, hs2, n, MODES[mode], 256,
                       build.stream()), "baseline K12")
        return buf[..., :J]

    return call


def against_baseline(current, baseline, check) -> tuple[float, float]:
    """Device ms of the current and the baseline call, timed in the order
    baseline, current, current, baseline (the mean of each pair); ``check``
    compares their outputs first."""
    check(current(), baseline())
    b1, c1, c2, b2 = (graph_ms(f) for f in (baseline, current, current, baseline))
    return (c1 + c2) / 2, (b1 + b2) / 2


# the kernels of the quarter_fused main path, and of the paths of the other
# repro modes (K5 in place of K2)
MAIN_PATH_KERNELS = ("instance_norm_act", "repro_quarter_gather", "soft_argmax",
                     "resize_normalize", "argmax2d")
OTHER_MODES = ("exact", "half_fused", "half")
MODE_PATH_KERNELS = ("instance_norm_act", "repro_grid_gather", "soft_argmax", "resize_normalize",
                     "argmax2d")


def rows_touched(idx, hs2: int) -> int:
    """Distinct heatmap rows a gather reads: a pixel index names a different
    row in every frameset, so (frameset, index) pairs, counted per camera."""
    import torch

    frameset = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64)[:, None] * hs2
    return sum(int(torch.unique(idx[:, c].long() + frameset).numel())
               for c in range(idx.shape[1]))


def check_k5(kernels, rows, c3d, center_hm, cams, grid_size, spacing, mode_launches, note):
    """K5 in each mode against its plain version: indices equal and volumes
    within 1e-5 relative at the production grid and at G = 44 (a partial
    tile at the top edge in every mode), then timed at the production grid."""
    import importlib

    import torch

    k5 = importlib.import_module("jarvis_hybridnet_torch.kernels.repro_grid_gather")
    out = []
    J, hs2 = rows.shape[-1], rows.shape[2]
    for mode in OTHER_MODES:
        for G, sp in ((44, 3.0), (grid_size, spacing)):
            a = (rows, c3d, center_hm, *cams, G, sp, mode)
            k_vol, k_idx = kernels.repro_grid_gather(*a, return_indices=True)
            p_vol, p_idx = kernels.repro_grid_gather_plain(*a)
            if not torch.equal(k_idx, p_idx):
                fail(f"repro_grid_gather {mode} G={G}: indices differ at "
                     f"{int((k_idx != p_idx).sum())} places")
            rel = float((k_vol - p_vol).abs().max() / p_vol.abs().max().clamp_min(1e-30))
            plan = k5.launch_plan(rows.shape[0], rows.shape[1], J, math.isqrt(hs2), G, mode,
                                  rows.element_size())
            note(f"repro_grid_gather {mode} G={G}: indices equal, volume {rel:.2e} relative to "
                 f"the plain version (tol 1e-5); {plan}, {k5.occupancy(plan, rows.dtype)} "
                 f"blocks per SM")
            if rel > 1e-5:
                fail(f"repro_grid_gather {mode} volume differs by {rel} relative (tol 1e-5)")
        nbytes = rows_touched(p_idx, hs2) * J * rows.element_size() + k_vol.numel() * 4
        a = (rows, c3d, center_hm, *cams, grid_size, spacing, mode)
        entry = dict(
            name=f"repro_grid_gather[{mode}]", route="cuda", kernels_per_call=1, mode=mode,
            source="jarvis_hybridnet_torch/kernels/csrc/repro_grid_gather.cu",
            replaces=("jarvis_hybridnet_tpu/models/repro.py:266" if mode == "exact"
                      else "jarvis_hybridnet_tpu/models/repro.py:302"),
            launches=mode_launches[mode]["repro_grid_gather"],
            max_abs_err=float((k_vol - p_vol).abs().max()),
            ms=graph_ms(lambda: kernels.repro_grid_gather(*a)),
            wall_ms=cuda_ms(lambda: kernels.repro_grid_gather(*a)),
            plain_ms=cuda_ms(lambda: kernels.repro_grid_gather_plain(*a), iters=3, warmup=1),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)
        out.append(entry)
        del k_vol, p_vol, k_idx, p_idx
    return out


def backward_inputs(B, C, J, S, hs, seed=0, clamp=False):
    """Seeded float32 heatmap rows (B, C, hs^2, J), the J-view of a buffer
    whose rows are S apart, cube centers, crop centers around the centers'
    projections into the synthetic rig (4000 px off them with ``clamp``: every
    point of every camera then clamps to one corner pixel) and the cameras,
    on the card."""
    import torch

    from jarvis_hybridnet_torch.testing import synthetic_rig
    from jarvis_hybridnet_torch.utils.reprojection import project_points

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = (torch.rand((B, C, hs * hs, S), device=dev, generator=g) * 255)[..., :J]
    rig = synthetic_rig(C, W, H)
    P, K, D = (torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in (rig.camera_matrices, rig.intrinsics, rig.distortions))
    c3d = torch.randint(-30, 30, (B, 3), device=dev, generator=g, dtype=torch.int32)
    chm = project_points(c3d.float(), P, K, D).round().int()
    chm = chm + (4000 if clamp else torch.randint(-60, 60, chm.shape, device=dev, generator=g,
                                                  dtype=torch.int32))
    cams = [a.expand(B, *a.shape).contiguous() for a in (P, K, D)]
    return rows, c3d, chm.to(torch.int32).contiguous(), cams


# the edge keys of K11 and K12: (label, B, C, J, S, hs, clamp); each also at
# an odd gather grid (K11: g4 = 9; K12: G = 38, 19 half-grid points an axis)
BACKWARD_EDGE_KEYS = (("B = 2", 2, 12, 23, 24, 130, False), ("C = 1", 1, 1, 23, 24, 130, False),
                      ("J = 1, S = 1", 1, 12, 1, 1, 130, False),
                      ("J = 1, S = 24", 1, 12, 1, 24, 130, False),
                      ("J = 23, S = 23", 1, 12, 23, 23, 130, False),
                      ("all points clamped to one pixel", 1, 12, 23, 24, 130, True))


def check_gather_backward(name, forward, backward, plain, label, note):
    """One gather backward (K11 or K12) against its plain version at one
    key: ``forward()`` gives the forward's volume and indices; the upstream
    gradient is seeded noise of the volume's shape. The kernel and the plain
    version in float32 against the plain version in float64: the kernel's
    error at most 2x the float32 plain version's own, in RMS over the rows'
    gradient (or half a float32 ulp of its largest element where that is 0),
    and at every element under 1e-5 of that largest element, or under twice
    the float32 plain version's largest error where that is larger (where
    every point clamps to one pixel, exact mode sums 373,248 terms into one
    element: the float32 sum's own error passes 1e-5 there); two kernel
    calls within the same bounds of each other. Both float32 versions add
    with atomics in a changing order (``index_add_`` on the card too), so
    one element's error is a draw: the plain version runs three times, and
    the RMS over the tensor is the stable measure of the round-off. Returns
    (grad, idx, the kernel's largest error)."""
    import torch

    vol, idx = forward()
    g = torch.Generator(device=vol.device).manual_seed(7)
    grad = torch.randn(vol.shape, device=vol.device, generator=g)
    k, k2 = backward(grad, idx), backward(grad, idx)
    p64 = plain(grad.double(), idx)
    m = float(p64.abs().max())

    def gaps(a, b):
        d = a.double() - b.double()
        return float(d.abs().max()), float(d.square().mean().sqrt())

    (err, rms), (twice, rms_twice) = gaps(k, p64), gaps(k, k2)
    plain_gaps = [gaps(plain(grad, idx), p64) for _ in range(3)]
    err_p = max(e for e, _ in plain_gaps)
    rms_p = sum(r for _, r in plain_gaps) / 3
    tol = max(2 * rms_p, m * 2.0 ** -24)
    tol_max = max(1e-5 * m, 2 * err_p)
    same = torch.equal(k, k2)
    note(f"{name} {label}: grad {tuple(grad.shape)}, indices {tuple(idx.shape)}, rows' gradient "
         f"{tuple(k.shape)} (rows {k.stride(2)} apart): from the float64 plain version the "
         f"kernel {rms:.2e} RMS, {err:.2e} max; the float32 plain version {rms_p:.2e} RMS, "
         f"{err_p:.2e} max over 3 calls (tol {tol:.2e} RMS, {tol_max:.2e} max: "
         + ("1e-5" if tol_max == 1e-5 * m else "2x the plain version's") + f" of {m:.3e}); "
         f"two calls {rms_twice:.2e} RMS, {twice:.2e} max apart ("
         + ("bit-equal this time" if same else "not bit-equal: the float atomics add in an order "
            "that changes from run to run") + ")")
    if rms > tol or rms_twice > tol or max(err, twice) > tol_max or k.stride(2) * 4 % 16:
        fail(f"{name} {label}: kernel {rms} RMS, {err} max from float64, two calls {rms_twice} "
             f"RMS, {twice} max apart (tol {tol} RMS, {tol_max} max)")
    return grad, idx, err


def index_add_call(grad, idx, hs2: int, dtype=None):
    """The library call beside K12 in exact and half_fused: one
    ``index_add_`` of the per-camera rows (grad / C, expanded over the
    cameras) at the int64 flat indices into the (B * C * hs2, J) view of a
    padded buffer, both built here, outside the timed call (which adds into
    the same buffer every time; zeroing it is ``zero_ms``). At bf16 rows
    (``dtype``) the rows and the buffer are bf16: JAX's VJP adds rounded
    cotangents into a bf16 table."""
    import torch

    from jarvis_hybridnet_torch.kernels.repro_gather import padded_width

    dtype = dtype or torch.float32
    B, C, N = idx.shape
    J = grad.shape[-1]
    flat = (idx.long() + torch.arange(B * C, device=idx.device).view(B, C, 1) * hs2).reshape(-1)
    src = (grad.reshape(B, N, J) / C).to(dtype)[:, None].expand(B, C, N, J).reshape(-1, J)
    src = src.contiguous()
    view = torch.zeros((B * C * hs2, padded_width(J, src.element_size())), dtype=dtype,
                       device=grad.device)[:, :J]
    return lambda: view.index_add_(0, flat, src)


def backward_entry(name, mode, call, plain, grad, idx, err, launches, per_step, note, smi):
    """The kernels line's entry of a gather backward at the production key:
    device and wall ms, the plain version's, the bytes bound (the upstream
    gradient and the indices read once, the padded rows' buffer written
    once, in the rows' dtype), the adds it makes (B * C * points * J) and,
    for K12 in exact and half_fused, one ``index_add_`` as the library call.
    At bf16 rows the call is the float32 pass and the rounding pass."""
    import torch

    from jarvis_hybridnet_torch.kernels.repro_gather import padded_width

    out = call(grad, idx)
    B, C, hs2, S = out.shape[0], out.shape[1], out.shape[2], out.stride(2)
    nbytes = grad.numel() * 4 + idx.numel() * 4 + B * C * hs2 * S * out.element_size()
    atomics = idx.numel() * grad.shape[-1]
    library = (graph_ms(index_add_call(grad, idx, hs2, out.dtype))
               if mode in ("exact", "half_fused") else None)
    S32 = padded_width(out.shape[3], 4)  # the float32 buffer K11 / K12 zero and add into
    e = dict(name=name, route="cuda", kernels_per_call=1 if out.dtype == torch.float32 else 2,
             source="jarvis_hybridnet_torch/kernels/csrc/" + (
                 "repro_gather_backward.cu" if mode == "quarter_fused"
                 else "repro_grid_gather_backward.cu"),
             replaces="jarvis_hybridnet_tpu/models/repro.py:280" if mode == "quarter_fused"
             else ("jarvis_hybridnet_tpu/models/repro.py:266" if mode == "exact"
                   else "jarvis_hybridnet_tpu/models/repro.py:302"),
             launches=launches, calls_per_step=per_step, max_abs_err=err,
             ms=graph_ms(lambda: call(grad, idx)), wall_ms=cuda_ms(lambda: call(grad, idx)),
             plain_ms=cuda_ms(lambda: plain(grad, idx), iters=3, warmup=1),
             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=library,
             atomics=atomics,
             zero_ms=graph_ms(lambda: torch.zeros((B, C, hs2, S32), device=grad.device)))
    if mode != "quarter_fused":
        e["mode"] = mode
    note(f"{name} at the production key: device {e['ms']:.4f} ms (of which zeroing the "
         f"{B * C * hs2 * S32 * 4 / 1e6:.2f} MB buffer alone takes {e['zero_ms']:.4f}), wall "
         f"{e['wall_ms']:.4f}, plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.4f} "
         f"({nbytes / 1e6:.2f} MB)"
         + (f", index_add_ {library:.4f}" if library is not None else "")
         + (f" ({out.dtype} rows)" if out.dtype != torch.float32 else "") + "; "
         f"{atomics / 1e6:.2f} M adds, {atomics / e['ms'] / 1e6:.1f} G adds/s; "
         f"{per_step} a step; card: {smi}")
    return e


def check_k11_k12(kernels, recorder, path_counts, note, smi, k12_baseline=None,
                  base_log=None) -> list:
    """K11 at the ``all`` step's key (the float32 training rows K2 was
    called with, g4 = 18) and K12 in each mode at G = 72 on the same rows and
    cameras, each against its plain version (``check_gather_backward``), then at
    ``BACKWARD_EDGE_KEYS`` and an odd gather grid; K12's windowed and
    overflow (tile, camera) counts at every key, the overflow branch taken
    at one key at least; timed at the production key, with
    ``k12_baseline`` in turns with the earlier K12 design, both held to the
    float64 plain version. Returns the kernels line's entries."""
    import importlib

    import torch

    from jarvis_hybridnet_torch.kernels.repro_gather import pad_rows

    k5 = importlib.import_module("jarvis_hybridnet_torch.kernels.repro_grid_gather")
    overflowed = []

    def k12_choice(mode, grad, idx, hs2, label):
        n = grad.shape[1] // 2 if mode == "half" else grad.shape[1]
        plan = k5.backward_plan(idx.shape[1], grad.shape[-1], n, mode)
        windowed, overflow = k5.window_choice(idx, hs2, plan)
        note(f"repro_grid_gather_backward[{mode}] {label}: {windowed} windowed / {overflow} "
             f"overflow (frameset, tile, camera) triples under tile {plan.tile}, window "
             f"{plan.win} pixels, {plan.threads} threads")
        if overflow:
            overflowed.append(f"{mode} {label}")

    k11 = kernels.repro_quarter_gather_backward
    k11_plain = kernels.repro_quarter_gather_backward_plain
    (args,) = [a for a, per in recorder.k2.values() if "training_all_step" in per]
    rows, c3d, chm, P, K, D, g4, step = args
    entries = []

    def quarter(rows, c3d, chm, cams, g4, step):
        return (lambda: kernels.repro_quarter_gather(rows, c3d, chm, *cams, g4, step, True),
                lambda grad, idx: k11(grad, idx, rows.shape[2], rows.shape[3]),
                lambda grad, idx: k11_plain(grad, idx, rows.shape[2], rows.shape[3]))

    def grid(rows, c3d, chm, cams, G, sp, mode):
        # K5 reads 16-byte rows; the indices, and so K12, do not depend on S
        padded = rows if rows.stride(2) * 4 % 16 == 0 else pad_rows(rows)
        return (lambda: kernels.repro_grid_gather(padded, c3d, chm, *cams, G, sp, mode, True),
                lambda grad, idx: kernels.repro_grid_gather_backward(grad, idx, rows.shape[2],
                                                                     rows.shape[3], mode),
                lambda grad, idx: kernels.repro_grid_gather_backward_plain(
                    grad, idx, rows.shape[2], rows.shape[3], mode))

    fwd, call, plain = quarter(rows, c3d, chm, (P, K, D), g4, step)
    grad, idx, err = check_gather_backward("repro_quarter_gather_backward", fwd, call, plain,
                                           f"training all step key g4 = {g4}", note)
    entries.append(backward_entry(
        "repro_quarter_gather_backward", "quarter_fused", call, plain, grad, idx, err,
        path_counts["training_all"]["repro_quarter_gather_backward"],
        path_counts["training_all_step"]["repro_quarter_gather_backward"], note, smi))
    G, sp = 4 * g4, step / 4.0
    for mode in OTHER_MODES:
        fwd, call, plain = grid(rows, c3d, chm, (P, K, D), G, sp, mode)
        grad, idx, err = check_gather_backward(f"repro_grid_gather_backward[{mode}]", fwd,
                                               call, plain, f"training rows G = {G}", note)
        k12_choice(mode, grad, idx, rows.shape[2], f"training rows G = {G}")
        counts = path_counts[f"training_all_step_{mode}"]
        e = backward_entry(f"repro_grid_gather_backward[{mode}]", mode, call, plain, grad, idx,
                           err, counts["repro_grid_gather_backward"],
                           counts["repro_grid_gather_backward"], note, smi)
        e["path"] = f"training_all_step_{mode}"
        if k12_baseline is not None:
            hs2, J = rows.shape[2], rows.shape[3]
            want = plain(grad.double(), idx)
            bound = 1e-5 * float(want.abs().max())

            def held(cur, base):
                gaps = [float((o.double() - want).abs().max()) for o in (cur, base)]
                if max(gaps) > bound:
                    fail(f"K12 {mode}: current {gaps[0]}, baseline {gaps[1]} from the float64 "
                         f"plain version (tol {bound})")

            cur, e["baseline_ms"] = against_baseline(
                lambda: call(grad, idx), lambda: k12_baseline(grad, idx, hs2, J, mode), held)
            line = (f"repro_grid_gather_backward[{mode}] at the production key, in turns "
                    f"(baseline, current, current, baseline): current {cur:.4f} ms, baseline "
                    f"{e['baseline_ms']:.4f} ms ({e['baseline_ms'] / cur:.2f}x); both within "
                    f"1e-5 of the largest element of the float64 plain version; card: {smi}")
            note(line)
            base_log.write(line + "\n")
        entries.append(e)
        del grad, idx
    for label, B, C, Je, S, hs, clamp in BACKWARD_EDGE_KEYS:
        r, c, h, cams = backward_inputs(B, C, Je, S, hs, seed=B + C + Je + S, clamp=clamp)
        for g4e in (g4, 9):
            check_gather_backward("repro_quarter_gather_backward",
                                  *quarter(r, c, h, cams, g4e, step), f"{label}, g4 = {g4e}",
                                  note)
        for mode in OTHER_MODES:
            for Ge in (G, 38):
                grad, idx, _ = check_gather_backward(f"repro_grid_gather_backward[{mode}]",
                                                     *grid(r, c, h, cams, Ge, sp, mode),
                                                     f"{label}, G = {Ge}", note)
                k12_choice(mode, grad, idx, r.shape[2], f"{label}, G = {Ge}")
        del r
    if not overflowed:
        fail("repro_grid_gather_backward: no checked key took the overflow branch")
    note(f"repro_grid_gather_backward: the overflow branch taken at {len(overflowed)} checked "
         f"keys ({', '.join(overflowed[:4])}{', ...' if len(overflowed) > 4 else ''})")
    torch.cuda.empty_cache()
    return entries


def ptxas_lines(name: str) -> list[str]:
    """The register, shared memory and spill lines ``nvcc -Xptxas -v`` wrote
    for a kernel library (``build.py`` keeps the log beside it)."""
    from jarvis_hybridnet_torch.kernels import build

    log = build.log_path(name)
    if not log.is_file():
        return [f"no build log for {name}"]
    keep = ("Compiling entry", "registers", "spill")
    return [ln.strip() for ln in log.read_text().splitlines() if any(k in ln for k in keep)]


def check_k3(kernels, vout, c3d, spacing, cube, launches, note):
    """K3 against its plain version (points and confidences with the fast
    softplus of the predict path and with the accurate one of the volume
    output, and the double-softplus volume), timed with and without the
    volume output."""
    from jarvis_hybridnet_torch.kernels.soft_argmax import launch_plan, max_active_clusters

    args = (vout, c3d, spacing, cube)
    pp, pc, pv = kernels.soft_argmax_plain(*args, return_volume=True)
    kp, kc = kernels.soft_argmax(*args)
    vp, vc, kv = kernels.soft_argmax(*args, return_volume=True)
    perr = max(float((kp - pp).abs().max()), float((vp - pp).abs().max()))
    cerr = max(float((kc - pc).abs().max()), float((vc - pc).abs().max()))
    ulps = f32_ulps(kv, pv)
    plan = launch_plan(vout.shape[0], vout.shape[1], vout.shape[-1], vout.element_size())
    note(f"soft_argmax {tuple(vout.shape)} {vout.dtype}: points {perr:.2e} mm (tol 1e-3), "
         f"conf {cerr:.2e} (tol 1e-6), volume {ulps:.1f} float32 ulps (tol 4); plan {plan}, "
         f"{max_active_clusters(plan, vout.dtype)} clusters at once")
    if perr > 1e-3 or cerr > 1e-6 or ulps > 4.0:
        fail(f"soft_argmax differs: points {perr} mm, conf {cerr}, volume {ulps} ulps")
    in_bytes = vout.numel() * vout.element_size()
    entry = dict(
        name="soft_argmax", route="cuda", kernels_per_call=1,
        source="jarvis_hybridnet_torch/kernels/csrc/soft_argmax.cu",
        replaces="jarvis_hybridnet_tpu/models/hybridnet.py:95",
        launches=launches, max_abs_err=max(perr, cerr),
        ms=graph_ms(lambda: kernels.soft_argmax(*args)),
        wall_ms=cuda_ms(lambda: kernels.soft_argmax(*args)),
        plain_ms=cuda_ms(lambda: kernels.soft_argmax_plain(*args)),
        bound_ms=in_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
        volume_ms=graph_ms(lambda: kernels.soft_argmax(*args, return_volume=True)),
        volume_bound_ms=(in_bytes + kv.numel() * 4) / HBM_BYTES_PER_S * 1e3,
        volume_ulps=ulps)
    return entry



def kernel_entry(name, source, replaces, launches, max_abs_err, call, plain, bound_ms,
                 **extra):
    """One entry of the kernels line: device time of ``call`` by graph
    replay (``ms``), event time of one-by-one calls (``wall_ms``), the
    plain version's time."""
    return dict(name=name, route="cuda", kernels_per_call=1,
                source=f"jarvis_hybridnet_torch/kernels/csrc/{source}", replaces=replaces,
                launches=launches, max_abs_err=max_abs_err, ms=graph_ms(call),
                wall_ms=cuda_ms(call), plain_ms=cuda_ms(plain, iters=5), bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, **extra)


def k4_bytes(x, out, height: int) -> int:
    """Bytes K4 must move: the rows its H taps touch, whole (at 1280 wide
    a tap every 5 pixels touches every 32-byte sector), and its output."""
    from jarvis_hybridnet_torch.kernels.resize_normalize import linear_tables

    N, H, W = x.shape[:3]
    i0, i1, _ = linear_tables(height, H)
    rows = len(set(i0) | set(i1))
    return N * rows * W * 3 * x.element_size() + out.numel() * out.element_size()


def run_rates(step, count: int, depth=FULL) -> list:
    """``count`` items a call of ``step(i)``, per second, in each of the
    ``depth`` (runs, calls a run) runs (host clock around
    ``torch.cuda.synchronize``)."""
    import torch

    repeats, iters = depth
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            step(i)
        torch.cuda.synchronize()
        rates.append(count * iters / (time.perf_counter() - t0))
    return rates


def timed_launches(kernels, step, count: int, depth, profile: bool) -> tuple:
    """(:func:`run_rates`, the step's launches over ``depth[1]`` calls): a
    profiled run (:func:`profiled_steps`) where ``profile``, else the
    counts of the rate runs, a run's worth (no profile: its kernel time
    and busy share are not measured)."""
    kernels.reset_launch_counts()
    rates = run_rates(step, count, depth)
    if profile:
        return rates, profiled_steps(kernels, step, depth[1])
    return rates, dict(launches={w: n // depth[0] for w, n in kernels.launch_counts().items()})


def profiled_words(r: dict, iters: int) -> str:
    """A profiled run's numbers for a note, or that there was none."""
    if "busy" not in r:
        return "not profiled (SHORT depth)"
    return (f"profiled {iters} steps: wall {r['wall_ms']:.3f} ms a step, CUDA-event span "
            f"{r['event_ms']:.3f} ms, kernel time {r['device_ms']:.3f} ms, busy {r['busy']:.3f}")


def rate(step, count: int, note, label: str, unit: str, depth=FULL) -> float:
    """The median of :func:`run_rates`, noted."""
    rates = run_rates(step, count, depth)
    r = sorted(rates)[len(rates) // 2]
    note(f"{label}: {r:.2f} {unit}, median of {depth[0]} runs of {depth[1]} steps: "
         f"{', '.join(f'{x:.2f}' for x in rates)}; {count / r * 1e3:.2f} ms per step")
    return r


class ShapeRecorder:
    """What K1, K2, K4, K6, K8, K9 and K10 are called with on each driven
    path: the (shape, dtype, act) of every K1 and K6 call, the (rows shape,
    rows dtype, g4, step) of every K2 call, the (input shape, input dtype,
    height, width, output dtype) of every K4 call, the heads' shapes,
    strides, input size and sigma of every K8 forward, the images' shape,
    record, border and blur of every K9 call and the heatmaps' shape, dtype
    and strides of every K10 call, each with its calls per path; K2, K4, K8,
    K9 and K10 keep their first call's arguments (K8's heads detached). It
    wraps the names by which the models, the predictors and the trainers
    call the wrappers, and the training steps' autograd Functions' own
    (``InstanceNormAct.k1``, ``.k6``, ``Heatmap2DLoss.fwd``)."""

    def __init__(self):
        self.k1: dict = {}  # key -> {path: calls}
        self.k2: dict = {}  # key -> (arguments, {path: calls})
        self.k2_graph: dict = {}  # path -> K2 calls with a graph (rows that require grad)
        self.k4: dict = {}  # key -> (arguments, {path: calls})
        self.k6: dict = {}  # key -> {path: calls}
        self.k8: dict = {}  # key -> (arguments, {path: calls})
        self.k9: dict = {}  # key -> (arguments, {path: calls})
        self.k10: dict = {}  # key -> (arguments, {path: calls})

    @contextlib.contextmanager
    def on(self, path: str):
        import torch

        from jarvis_hybridnet_torch.kernels import instance_norm
        from jarvis_hybridnet_torch.kernels.heatmap2d_loss import Heatmap2DLoss
        from jarvis_hybridnet_torch.models import layers, repro
        from jarvis_hybridnet_torch.ops import augment
        from jarvis_hybridnet_torch.prediction import predictor2d, predictor3d
        from jarvis_hybridnet_torch.training import trainer2d

        k1, k4 = layers.instance_norm_act, predictor3d.resize_normalize
        k2 = repro.repro_quarter_gather
        k6 = instance_norm.instance_norm_act_backward
        fn = instance_norm.InstanceNormAct

        def count(table, key, args=None):
            if args is None:
                per = table.setdefault(key, {})
            else:
                _, per = table.setdefault(key, (args, {}))
            per[path] = per.get(path, 0) + 1

        def rec_k1(x, act="none", skip=None, return_stats=False):
            count(self.k1, (tuple(x.shape), x.dtype, act))
            return k1(x, act, skip, return_stats)

        def rec_k2(rows, center3d, center_hm, P, K, D, g4, step, return_indices=False,
                   c_total=None):
            count(self.k2, (tuple(rows.shape), rows.dtype, g4, step),
                  (rows.detach(), center3d, center_hm, P, K, D, g4, step))
            if torch.is_grad_enabled() and rows.requires_grad:
                self.k2_graph[path] = self.k2_graph.get(path, 0) + 1
            return k2(rows, center3d, center_hm, P, K, D, g4, step, return_indices,
                      c_total=c_total)

        def rec_k4(x, height, width, mean, std, dtype):
            count(self.k4, (tuple(x.shape), x.dtype, height, width, dtype),
                  (x, height, width, mean, std, dtype))
            return k4(x, height, width, mean, std, dtype)

        def rec_k6(x, dy, out, act="none", stats=None):
            count(self.k6, (tuple(x.shape), x.dtype, act))
            return k6(x, dy, out, act, stats)

        k8, k9, k10 = Heatmap2DLoss.fwd, augment.color_aug, predictor3d.argmax_2d

        def rec_k8(out4, out2, kps, input_size, sigma_base):
            count(self.k8, (tuple(out4.shape), out4.stride(), tuple(out2.shape), out2.stride(),
                            input_size, sigma_base, out4.dtype),
                  (out4.detach(), out2.detach(), kps, input_size, sigma_base))
            return k8(out4, out2, kps, input_size, sigma_base)

        def rec_k9(imgs, params, mean, std, minv=None, radius=0, noise=True):
            count(self.k9, (tuple(imgs.shape), params is not None, minv is not None, radius,
                            noise), (imgs, params, mean, std, minv, radius, noise))
            return k9(imgs, params, mean, std, minv, radius, noise)

        def rec_k10(hm):
            count(self.k10, (tuple(hm.shape), hm.dtype, hm.stride()), (hm,))
            return k10(hm)

        k10_sites = (predictor2d, predictor3d, trainer2d)

        layers.instance_norm_act = rec_k1
        repro.repro_quarter_gather = rec_k2
        fn.k1, fn.k6 = staticmethod(rec_k1), staticmethod(rec_k6)
        predictor2d.resize_normalize = predictor3d.resize_normalize = rec_k4
        Heatmap2DLoss.fwd = staticmethod(rec_k8)
        augment.color_aug = rec_k9
        for m in k10_sites:
            m.argmax_2d = rec_k10
        try:
            yield
        finally:
            layers.instance_norm_act = k1
            repro.repro_quarter_gather = k2
            fn.k1, fn.k6 = staticmethod(k1), staticmethod(k6)
            predictor2d.resize_normalize = predictor3d.resize_normalize = k4
            Heatmap2DLoss.fwd = staticmethod(k8)
            augment.color_aug = k9
            for m in k10_sites:
                m.argmax_2d = k10

    def calls(self, name: str, path: str) -> int:
        table = {"instance_norm_act": self.k1, "instance_norm_act_backward": self.k6,
                 "repro_quarter_gather": {k: per for k, (_, per) in self.k2.items()},
                 "resize_normalize": {k: per for k, (_, per) in self.k4.items()},
                 "heatmap2d_loss_fwd": {k: per for k, (_, per) in self.k8.items()},
                 "color_aug": {k: per for k, (_, per) in self.k9.items()},
                 "argmax2d": {k: per for k, (_, per) in self.k10.items()}}[name]
        return sum(per.get(path, 0) for per in table.values())


def path_launches(run, kernels, names, path, recorder):
    """Launch counts of one call of ``run`` (counts set to 0 just before,
    read just after); fails unless every kernel of ``names`` launched, and
    unless ``recorder``, which records the arguments of K1, K2, K4, K6, K8,
    K9 and K10 over the call under ``path``, saw as many calls of each as
    were counted."""
    import torch

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with recorder.on(path):
        out = run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in names:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
    for name in ("instance_norm_act", "repro_quarter_gather", "resize_normalize",
                 "instance_norm_act_backward", "heatmap2d_loss_fwd", "color_aug", "argmax2d"):
        if recorder.calls(name, path) != counts[name]:
            fail(f"recorded {recorder.calls(name, path)} calls of {name} on the {path} path, "
                 f"counted {counts[name]} launches")
    return out, counts


def predict2d_phase(kernels, cfg, ckpt, frames, recorder, note):
    """``make_predictor2d`` (bf16) on T frames of camera 0: launches, frames/s,
    stage split; then float32 on the card against float32 on the CPU at the
    same size: argmax points and gate identical, confidences to 1e-4."""
    import torch

    from jarvis_hybridnet_torch.prediction.loaders import make_predictor2d

    imgs = [f[:, 0].contiguous() for f in frames]
    pred = make_predictor2d(cfg, ckpt["CenterDetect"], ckpt["KeypointDetect"],
                            dtype="bfloat16", device="cuda", graph=False)
    pred(imgs[0])
    out, counts = path_launches(lambda: pred(imgs[0]), kernels,
                                ("instance_norm_act", "resize_normalize", "argmax2d"), "predict2d",
                                recorder)
    points, conf, valid = out
    if not (torch.isfinite(points).all() and torch.isfinite(conf).all()):
        fail("non-finite outputs on the predict2D path")
    note(f"predict2D launches in one step: {json.dumps(counts)}; frames through the gate: "
         f"{int(valid.sum())}/{T}")
    rate(lambda i: pred(imgs[i % 2]), T, note, f"predict2D (T={T}, one camera of {W}x{H})",
         "frames/s")
    cx, cy, _, _ = pred.detect(imgs[0])
    for name, fn in (("detect (K4, CenterDetect, argmax, gate)", lambda: pred.detect(imgs[0])),
                     ("crop + KeypointDetect + argmax",
                      lambda: pred.keypoints(imgs[0], cx, cy))):
        note(f"predict2D stage {name}: {cuda_ms(fn, iters=5, warmup=1):.3f} ms")
    res = {}
    for device in ("cuda", "cpu"):
        p = make_predictor2d(cfg, ckpt["CenterDetect"], ckpt["KeypointDetect"],
                             dtype="float32", device=device)
        res[device] = [a.cpu() for a in p(imgs[0].to(device))]
    same = torch.equal(res["cuda"][0], res["cpu"][0]) and torch.equal(res["cuda"][2],
                                                                      res["cpu"][2])
    cerr = float((res["cuda"][1] - res["cpu"][1]).abs().max())
    note(f"predict2D f32, card vs CPU (T={T}, {W}x{H}): points and gate "
         f"{'identical' if same else 'DIFFER'}, confidences {cerr:.2e} (tol 1e-4)")
    if not same or cerr > 1e-4:
        fail("the predict2D cascade on the card disagrees with the CPU cascade")
    return counts


def area_reduce(frames, f: int):
    """Mean of f x f pixel blocks, rounded, on the card: the reader's area
    downscale of (T, C, H, W, 3) uint8 frames."""
    import torch
    import torch.nn.functional as F

    t, c, h, w, _ = frames.shape
    x = frames.reshape(t * c, h, w, 3).permute(0, 3, 1, 2).float()
    low = F.avg_pool2d(x, f).round().to(torch.uint8)
    return low.permute(0, 2, 3, 1).reshape(t, c, h // f, w // f, 3).contiguous()


def twophase_phase(kernels, cfg, rig, ckpt, frames, fused_points, recorder, note):
    """``make_predictor3d_twophase`` (bf16, f = 4) on host frames as a driver
    gives them: phase A on the low-resolution frames, ``cx, cy`` to the
    host, host crops, phase B. Launches, poses/s, host-to-device bytes;
    float32 on the card against float32 on the CPU at the small size."""
    import torch

    from jarvis_hybridnet_torch.prediction.loaders import make_predictor3d_twophase
    from jarvis_hybridnet_torch.testing import monkeyhand_cfg, synthetic_rig

    f = 4
    full = [fr.cpu().numpy() for fr in frames]
    low = [area_reduce(fr, f).cpu().numpy() for fr in frames]
    phase_a, phase_b, crop_fn = make_predictor3d_twophase(
        cfg, rig, (W, H), ckpt["CenterDetect"], ckpt["HybridNet"], lowres_factor=f,
        dtype="bfloat16", device="cuda", graph=False)

    def step(i):
        cx, cy, c3d, valid = phase_a(low[i % 2])
        crops = crop_fn(full[i % 2], cx.cpu().numpy(), cy.cpu().numpy())
        return (*phase_b(crops, cx, cy, c3d), valid, crops)

    step(0)
    out, counts = path_launches(lambda: step(0), kernels, MAIN_PATH_KERNELS, "twophase",
                                recorder)
    points, conf, valid, crops = out
    if not (torch.isfinite(points).all() and torch.isfinite(conf).all()):
        fail("non-finite outputs on the two-phase path")
    h2d = low[0].nbytes + crops.nbytes
    note(f"two-phase launches in one step: {json.dumps(counts)}; host-to-device bytes per "
         f"batch: {h2d} (low-res {low[0].nbytes} + crops {crops.nbytes}) against "
         f"{full[0].nbytes} for the fused path's frames ({full[0].nbytes / h2d:.2f}x)")
    rate(step, T, note, f"predict3D two-phase (f={f}, frames on the host)", "poses/s", SHORT)
    split = {"phase A (low-res frames to the card, K4, CenterDetect, gate, DLT)": 0.0,
             "cx, cy to the host + crop_fn": 0.0,
             "phase B (crops to the card, KeypointDetect, K2, V2V, K3)": 0.0}
    names = list(split)
    for i in range(5):
        t0 = time.perf_counter()
        cx, cy, c3d, _ = phase_a(low[i % 2])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        crops = crop_fn(full[i % 2], cx.cpu().numpy(), cy.cpu().numpy())
        t2 = time.perf_counter()
        phase_b(crops, cx, cy, c3d)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in zip(names, (t1 - t0, t2 - t1, t3 - t2)):
            split[name] += dt * 1e3 / 5
    note("two-phase step split (host clock, synchronized after each part, mean of 5): " +
         "; ".join(f"{k} {v:.2f} ms" for k, v in split.items()))
    dist = (points - fused_points).norm(dim=-1)
    note(f"points two-phase vs fused, bf16, frames of seed 1 (noise; information, not a "
         f"bound): max {float(dist.max()):.4f} mm, RMS {float(dist.square().mean().sqrt()):.4f} "
         f"mm; framesets through the gate {int(valid.sum())}/{T}")

    small_cfg = monkeyhand_cfg(center_size=64, bbox=128, cube=144, spacing=4, num_cameras=4)
    small_rig = synthetic_rig(4, 320, 256)
    small = torch.randint(0, 256, (2, 4, 256, 320, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(4))
    small_low = area_reduce(small.cuda(), f).cpu().numpy()
    res = {}
    for device in ("cuda", "cpu"):
        a, b, cf = make_predictor3d_twophase(small_cfg, small_rig, (320, 256),
                                             ckpt["CenterDetect"], ckpt["HybridNet"],
                                             lowres_factor=f, dtype="float32", device=device)
        cx, cy, c3d, v = a(small_low)
        pts, conf = b(cf(small.numpy(), cx.cpu().numpy(), cy.cpu().numpy()), cx, cy, c3d)
        res[device] = [t.cpu() for t in (cx, cy, c3d, v, pts, conf)]
    same = all(torch.equal(x, y) for x, y in zip(res["cuda"][:4], res["cpu"][:4]))
    perr = float((res["cuda"][4] - res["cpu"][4]).abs().max())
    cerr = float((res["cuda"][5] - res["cpu"][5]).abs().max())
    note(f"two-phase f32, card vs CPU (T=2, 4 cameras, 256x320, low-res 64x80): cx, cy, "
         f"center3d and gate {'identical' if same else 'DIFFER'}, points {perr:.2e} mm (tol "
         f"2e-2), confidences {cerr:.2e} (tol 1e-4)")
    if not same or perr > 2e-2 or cerr > 1e-4:
        fail("the two-phase cascade on the card disagrees with the CPU cascade")
    return counts


class BatchReader:
    """A reader with the driver's interface over seeded host batches:
    ``(frames, n)`` per batch, ``recycle``, ``release``, ``number_frames``,
    ``img_size``."""

    def __init__(self, batches, repeats: int):
        self.batches, self.repeats = batches, repeats
        self.number_frames = T * repeats
        self.img_size = (W, H)
        self.recycled = 0

    def __iter__(self):
        for i in range(self.repeats):
            yield self.batches[i % len(self.batches)], T

    def recycle(self, batch) -> None:
        self.recycled += 1

    def release(self) -> None:
        pass


def driver_phase(kernels, cfg, predictor, frames, out_dir, recorder, note):
    """The streaming loop of the predict3D driver (``stream_predict3d``) on
    the card over seeded host batches into ``data3D.csv``: launches, rows
    against the predictor's own outputs (NaN rows where ``valid`` is false),
    poses/s through the driver beside the bare predictor's."""
    import csv
    import tempfile

    import numpy as np
    import torch

    from jarvis_hybridnet_torch.prediction.predict3d import stream_predict3d

    cfg = cfg.clone()  # a project's joint names give the CSV its two header rows
    cfg.KEYPOINT_NAMES = [f"joint_{j}" for j in range(int(cfg.KEYPOINTDETECT.NUM_JOINTS))]
    host = [fr.cpu().numpy() for fr in frames]
    expect = [[a.cpu().numpy() for a in predictor(fr)] for fr in frames]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        reader = BatchReader(host, 2)
        _, counts = path_launches(lambda: stream_predict3d(cfg, predictor, reader, tmp),
                                  kernels, MAIN_PATH_KERNELS, "driver", recorder)
        with open(os.path.join(tmp, "data3D.csv"), newline="") as f:
            rows = list(csv.reader(f))
        if reader.recycled != 2:
            fail(f"the driver recycled {reader.recycled} of 2 ring buffers")
        header, body = rows[:2], np.array(rows[2:], dtype=np.float64)
        if header[1][:4] != ["x", "y", "z", "confidence"] or body.shape != (2 * T, 23 * 4):
            fail(f"data3D.csv has header {header[1][:4]} and shape {body.shape}")
        worst, nan_rows = 0.0, 0
        for k in range(2):
            points, conf, valid = expect[k]
            got = body[k * T:(k + 1) * T]
            nan = np.isnan(got).all(axis=1)
            if not np.array_equal(nan, ~valid):
                fail(f"data3D.csv batch {k}: NaN rows {nan.tolist()} where valid is "
                     f"{valid.tolist()}")
            nan_rows += int(nan.sum())
            ref = np.concatenate([points, conf[..., None]], axis=-1).reshape(T, -1)
            if (~nan).any():
                worst = max(worst, float(np.abs(got[~nan] - ref[~nan]).max()))
        note(f"driver: data3D.csv {len(rows)} rows (2 header rows, {2 * T} framesets, "
             f"{nan_rows} NaN rows where valid is false), values against the predictor's "
             f"own outputs {worst:.2e} (tol 1e-4); launches in the run of 2 batches: "
             f"{json.dumps(counts)}")
        if worst > 1e-4:
            fail(f"data3D.csv differs from the predictor's outputs by {worst}")
        repeats, iters = FULL
        runs = run_rates(lambda i: stream_predict3d(cfg, predictor, BatchReader(host, iters), tmp),
                         T * iters, (repeats, 1))
    r = sorted(runs)[len(runs) // 2]
    note(f"driver predict3D: {r:.2f} poses/s through the streaming loop (host batches, "
         f"host-to-device copy of {host[0].nbytes} bytes a batch, CSV rows), median of "
         f"{repeats} runs of {iters} batches: {', '.join(f'{x:.2f}' for x in runs)}")
    bare = rate(lambda i: predictor(frames[i % 2]), T, note,
                "bare predictor, same process (frames on the card)", "poses/s")
    from jarvis_hybridnet_torch.utils.transfer import HostToDevice

    upload = HostToDevice(predictor.device)
    for label, copy in (("pageable memory, synchronous",
                         lambda a: torch.from_numpy(a).to(predictor.device)),
                        ("the driver's pinned staging pair: host memcpy, then the async copy",
                         upload)):
        copies = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            copy(host[i % 2])
            torch.cuda.synchronize()
            copies.append((time.perf_counter() - t0) * 1e3)
        copy_ms = sorted(copies)[2]
        note(f"host-to-device copy of one batch ({label}): {copy_ms:.2f} ms, "
             f"{host[0].nbytes / copy_ms / 1e6:.2f} GB/s, median of 5")
    note(f"driver / bare predictor: {r / bare:.3f}")
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    from jarvis_hybridnet_torch import native
    note(f"host decode (information only): cv2 imports: {have_cv2}; native video library "
         f"builds and loads: {native.video_available()}")
    return counts, r


# The serving paths as captured CUDA graphs (prediction/export.py): each
# __global__ symbol of the serving kernels, as torch.profiler names it
KERNEL_SYMBOLS = {"instance_norm_act": r"\bin_fused<", "repro_quarter_gather": r"\brepro_tile<",
                  "repro_grid_gather": r"\brepro_grid<", "soft_argmax": r"\bsa_cluster<",
                  "resize_normalize": r"\bresize_norm<", "argmax2d": r"\bk10<"}


def pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments that belong to ``pool``."""
    import torch

    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))


def profiled_steps(kernels, step, n: int = ITERS, primer: bool = False) -> dict:
    """``n`` calls ``step(i)`` under torch.profiler, each between two CUDA
    events: the host's wall ms per step, the events' span per step
    (median), the kernels' device ms per step (profiler), the busy share
    (kernel time over the wall time of the same steps), the kernels by name
    (memory copies apart) and the wrappers' launch counts over the run.
    With ``primer`` one more call ``step(n)`` runs first, and the records
    up to a marker kernel after it are left out: the tracer misses some of
    the first kernel nodes of a graph's first replay after it starts (the
    same 1 K9 and 2 K1 records of 5 2D train steps' replays in every
    profile of one run)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first kernel after it starts: a marker
        # kernel first, left out below
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        if primer:
            step(n)
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(n):
            events[i][0].record()
            step(i)
            events[i][1].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    cuda = torch.autograd.DeviceType.CUDA
    if primer:
        records = [e for e in prof.events() if e.device_type == cuda]
        mark = max(e.time_range.start for e in records if "spin_kernel" in e.name)
        records = [(e.name, 1, e.time_range.elapsed_us()) for e in records
                   if e.time_range.start > mark]
    else:
        records = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                   if e.device_type == cuda]
    names, copies, device_us = collections.Counter(), collections.Counter(), 0.0
    for key, count, us in records:
        if "spin_kernel" in key:
            continue
        device_us += us
        # memory copies and sets: the runtime's, or its kernels for a
        # graph's copy and set nodes (memcpy32_post, memset32)
        is_copy = "memcpy" in key.lower() or "memset" in key.lower()
        (copies if is_copy else names)[key] += count
    spans = sorted(a.elapsed_time(b) for a, b in events)
    return dict(wall_ms=wall_ms / n, event_ms=spans[n // 2], device_ms=device_us / 1e3 / n,
                busy=device_us / 1e3 / wall_ms, kernels=names, copies=copies, launches=launches)


def issue_ms(step, n: int = ITERS) -> float:
    """Median host time of one call of ``step`` on an idle stream: the
    call's wall time before any synchronization."""
    import torch

    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return sorted(times)[n // 2]


def graphed_profile(kernels, step, launches: dict, symbols: dict, label: str,
                    attempts: int = 3, n: int = ITERS) -> dict:
    """:func:`profiled_steps` of a graphed ``step``, whose profile must show
    each kernel of ``symbols`` (wrapper -> its ``__global__`` names) exactly
    as often as ``launches`` counts the eager steps' launches, and no call
    of a wrapper from Python. The profile leaves a primer replay out
    (``profiled_steps``), and the tracer drops a kernel record now and then
    besides (5 of the 515 K1 records of the exact cascade's 5 graphed steps
    in one run, none in PR 13's), so a profile that lacks records is taken
    again, up to ``attempts`` times; one with more records fails at once."""
    import re

    for attempt in range(1, attempts + 1):
        prof = profiled_steps(kernels, step, n, primer=True)
        seen = {w: sum(c for k, c in prof["kernels"].items() if re.search(p, k))
                for w, p in symbols.items()}
        if any(seen[w] > launches[w] or prof["launches"][w] for w in symbols):
            fail(f"{label}: the graphed steps' profile shows {seen} (calls from Python "
                 f"{prof['launches']}), the eager steps launched {launches}")
        if all(seen[w] == launches[w] for w in symbols):
            prof["attempts"] = attempt
            return prof
    fail(f"{label}: the graphed steps' profile shows {seen} in each of {attempts} runs, the "
         f"eager steps launched {launches}")


def same_outputs(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def graph_path(kernels, label, eager, graphed, steps, count, unit, note, smi,
               depth=SHORT) -> dict:
    """One serving path eager (``eager(i)``) and graphed (``graphed(i)``),
    each a step on seeded batch i % 2 returning its outputs; ``steps`` are
    the path's ``export.GraphedStep`` objects. The eager step runs under
    ``torch.cuda.set_sync_debug_mode("error")``; four alternating replays
    equal the eager step's outputs bit for bit and the two batches' replays
    differ; then rates (the median of ``depth``'s runs), the host's
    issue time, the eager run's launch counts (at FULL depth from a
    profiled run: event span, kernel time, busy share), a profiled graphed
    run whose calls of K1-K5 and K10 must equal them (``graphed_profile``),
    capture ms and pool bytes."""
    import torch

    eager(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    replays = {}
    for i in range(4):
        g, e = graphed(i), eager(i)
        if not same_outputs(g, e):
            fail(f"{label}: the graph replay of batch {i % 2} differs from the eager step")
        replays[i % 2] = g
    if same_outputs(replays[0], replays[1]):
        fail(f"{label}: the replays of two different batches give the same outputs")
    repeats, iters = depth
    res = {"label": label, "iters": iters}
    for name, fn in (("eager", eager), ("graphed", graphed)):
        if name == "eager":  # profiled on the FULL paths alone
            rates, prof = timed_launches(kernels, fn, count, depth, depth == FULL)
        else:
            rates = run_rates(fn, count, depth)
            prof = graphed_profile(kernels, fn, res["eager"]["launches"], KERNEL_SYMBOLS, label,
                                   n=iters)
        res[name] = dict(rate=sorted(rates)[repeats // 2], rates=rates,
                         issue_ms=issue_ms(fn, iters), **prof)
    e, g = res["eager"], res["graphed"]
    # Beside the hand-written kernels (held below to the launch counters),
    # the two profiles are compared for information only: the tracer drops
    # a few kernel records of eager steps (the first after it starts, now
    # and then one in the run), the graphed step adds the clones of strided
    # outputs (phase A's crop centers), and PyTorch's elementwise kernels
    # take their vector width from the buffers' alignment
    res["renamed"] = {k: (e["kernels"][k], g["kernels"][k])
                      for k in set(e["kernels"]) | set(g["kernels"])
                      if e["kernels"][k] != g["kernels"][k]} if "kernels" in e else {}
    res["capture_ms"] = [ms for s in steps for ms in s.captures.values()]
    res["pool_bytes"] = pool_bytes(steps[0].pool)
    per = {w: e["launches"][w] // iters for w in KERNEL_SYMBOLS if e["launches"][w]}
    note(f"graph {label}: replays bit-equal to the eager step on two alternating batches, the "
         f"two batches' replays differ; eager step passes sync debug 'error'; kernels per step "
         f"(eager launches = graphed profile, profiled {g['attempts']} time(s)) "
         f"{json.dumps(per)}, "
         f"profiled kernels over {iters} steps eager "
         f"{sum(e['kernels'].values()) if 'kernels' in e else '(not profiled)'}, graphed "
         f"{sum(g['kernels'].values())}, {len(res['renamed'])} names with other counts "
         f"(chip_smoke_graphs.txt)")
    for name in ("eager", "graphed"):
        r = res[name]
        note(f"graph {label} {name}: {r['rate']:.2f} {unit} (median of {repeats} runs of "
             f"{iters} steps: {', '.join(f'{x:.2f}' for x in r['rates'])}); host issue "
             f"{r['issue_ms']:.3f} ms a step; {profiled_words(r, iters)}; copies "
             f"{json.dumps(dict(r.get('copies', {})))}; card: {smi}")
    note(f"graph {label}: capture (warm-up, capture, first replay) "
         f"{', '.join(f'{x:.1f}' for x in res['capture_ms'])} ms; pool {res['pool_bytes']} bytes; "
         f"graphed / eager rate {g['rate'] / e['rate']:.3f}")
    return res


class PairReader(BatchReader):
    """:class:`BatchReader` over (full, low-resolution) host batches, as the
    native reader's paired ring gives the two-phase driver."""

    def __iter__(self):
        for i in range(self.repeats):
            full, low = self.batches[i % len(self.batches)]
            yield full, low, T


def csv_batches(path: str, expect, per_joint: int) -> None:
    """``path``'s rows, batch k against ``expect[k % 2]`` = (points,
    confidences, valid) as numpy, exactly: each valid row the float32
    values, each invalid row NaN."""
    import csv

    import numpy as np

    with open(path, newline="") as f:
        body = np.array(list(csv.reader(f))[2:], dtype=np.float64)
    if body.shape[0] % T or body.shape[0] == 0:
        fail(f"{path}: {body.shape[0]} rows, not a whole number of batches of {T}")
    for k in range(body.shape[0] // T):
        points, conf, valid = expect[k % 2]
        ref = np.concatenate([points, conf[..., None]], axis=-1).reshape(T, -1).astype(np.float64)
        ref[~valid] = np.nan
        if body.shape[1] != ref.shape[1] or ref.shape[1] % per_joint:
            fail(f"{path}: rows of {body.shape[1]} values, expected {ref.shape[1]}")
        if not np.array_equal(body[k * T:(k + 1) * T], ref, equal_nan=True):
            fail(f"{path}: batch {k}'s rows differ from the eager outputs of batch {k % 2}")


class EventSpans:
    """Callables wrapped so that each call lies between two CUDA events on
    the current stream; :meth:`ms` sums the spans (for a graph replay, its
    device time; for an eager step, that and the launch gaps between)."""

    def __init__(self):
        self.pairs = []

    def wrap(self, fn):
        import torch

        def call(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args)
            end.record()
            self.pairs.append((start, end))
            return out

        return call

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


class SpannedPredictor:
    """A predictor's interface for a driver (``device``, a call) with each
    call between two CUDA events of ``spans``."""

    def __init__(self, predictor, spans: EventSpans):
        self.device = predictor.device
        self.call = spans.wrap(predictor)

    def __call__(self, imgs):
        return self.call(imgs)


def driver_graph_path(kernels, label, run, expect, per_joint, unit, note, smi,
                      depth=SHORT) -> dict:
    """A driver's loop with the graphed predictor (``run(True, n, dir,
    spans)``) against its loop with the eager one (``run(False, ...)``),
    each writing its CSV into ``dir`` over n alternating seeded batches and
    returning its path, the predictor's calls wrapped by ``spans`` (an
    :class:`EventSpans`): the graphed run's rows equal the eager
    predictor's outputs batch by batch over 4 batches; rates (the median of
    ``depth``'s runs of its batches); one more run of as many batches of each
    whose predictor calls' event spans are summed against its wall time,
    and the eager loop's kernel time in one profiled run. The graphed loop
    is traced in ``chip_smoke_export``'s ``export`` phase (the driver's
    ``TPU.PROFILE_DIR``), not here."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        csv_batches(run(True, 4, tmp, EventSpans()), expect, per_joint)
        res = {"label": label}
        repeats, iters = depth
        for name, graphed in (("eager", False), ("graphed", True)):
            rates = run_rates(lambda i: run(graphed, iters, tmp, EventSpans()), T * iters,
                              (repeats, 1))
            spans = EventSpans()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(graphed, iters, tmp, spans)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            res[name] = dict(rate=sorted(rates)[repeats // 2], rates=rates, wall_ms=wall_ms,
                             span_ms=spans.ms())
        prof = profiled_steps(kernels, lambda i: run(False, iters, tmp, EventSpans()), n=1)
        res["eager"].update(device_ms=prof["device_ms"], busy=prof["busy"],
                            profiled_wall_ms=prof["wall_ms"])
    for name in ("eager", "graphed"):
        r = res[name]
        prof = (f"; profiled run: wall {r['profiled_wall_ms'] / iters:.3f} ms a batch, kernel "
                f"time {r['device_ms'] / iters:.3f} ms a batch, busy {r['busy']:.3f}"
                if "busy" in r else "")
        note(f"graph driver {label} {name}: {r['rate']:.2f} {unit} (median of {repeats} runs of "
             f"{iters} batches: {', '.join(f'{x:.2f}' for x in r['rates'])}); a run of {iters} "
             f"batches: wall {r['wall_ms'] / iters:.3f} ms a batch, the predictor calls' "
             f"CUDA-event span {r['span_ms'] / iters:.3f} ms a batch, "
             f"{r['span_ms'] / r['wall_ms']:.3f} of the wall{prof}; card: {smi}")
    note(f"graph driver {label}: rows of 4 alternating batches equal the eager predictor's "
         f"outputs bit for bit; graphed / eager rate "
         f"{res['graphed']['rate'] / res['eager']['rate']:.3f}")
    return res


def graph_phase(kernels, cfg, rig, ckpt, frames, predictor, note, smi) -> list:
    """Every serving path eager against graphed (:func:`graph_path`):
    predict3D in the production mode on uint8 and float32 frames and in
    exact / half_fused / half, phase A and phase B of the two-phase cascade,
    predict2D; then the three drivers' loops (:func:`driver_graph_path`);
    and the copy of one batch into a graph's static input, timed beside
    the graphed step. ``predictor`` is the eager production predictor."""
    import torch

    from jarvis_hybridnet_torch.prediction.loaders import (
        make_predictor2d,
        make_predictor3d,
        make_predictor3d_twophase,
    )
    from jarvis_hybridnet_torch.prediction.predict2d import _fused_steps, stream_rows
    from jarvis_hybridnet_torch.prediction.predict3d import (
        PER_JOINT,
        stream_predict3d,
        stream_predict3d_twophase,
    )

    results = []

    def pred3d(mcfg, graph):
        return make_predictor3d(mcfg, rig, ckpt["CenterDetect"], ckpt["HybridNet"],
                                dtype="bfloat16", device="cuda", graph=graph)

    graphed = pred3d(cfg, True)
    float_frames = [f.float() / 255.0 for f in frames]
    for label, eager, gpred, batches in (
            ("predict3D quarter_fused", predictor, graphed, frames),
            ("predict3D quarter_fused, float32 frames", predictor, graphed, float_frames)):
        results.append(graph_path(kernels, label, lambda i: eager(batches[i % 2]),
                                  lambda i: gpred(batches[i % 2]), [gpred.step], T, "poses/s",
                                  note, smi, FULL if batches is frames else SHORT))
    # the copy of one batch into the static input of a graph, on the card
    # (the driver's upload lands in a tensor of its own first)
    static, fresh = torch.empty_like(frames[0]), frames[1].clone()
    copy_ms = graph_ms(lambda: static.copy_(fresh))
    step_ms = results[0]["graphed"]["event_ms"]
    note(f"graph input copy: {frames[0].nbytes} bytes into the static input {copy_ms:.4f} ms "
         f"(bound {2 * frames[0].nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, read and write), "
         f"{copy_ms / step_ms:.4f} of the graphed step's {step_ms:.3f} ms")
    del static, fresh, float_frames
    for mode in OTHER_MODES:
        mcfg = cfg.clone()
        mcfg.TPU.REPRO_MODE = mode
        eager, gpred = pred3d(mcfg, False), pred3d(mcfg, True)
        results.append(graph_path(kernels, f"predict3D {mode}", lambda i: eager(frames[i % 2]),
                                  lambda i: gpred(frames[i % 2]), [gpred.step], T, "poses/s",
                                  note, smi))
        del eager, gpred

    # the two-phase cascade, each phase on its device inputs of two batches.
    # The low-resolution frames take every f-th pixel: an area reduction
    # averages noise to grey, where no frameset passes the gate and phase A's
    # outputs would not tell two batches apart
    f = 4
    low = [fr[:, :, ::f, ::f].contiguous() for fr in frames]
    host_full = [fr.cpu().numpy() for fr in frames]
    phases = {g: make_predictor3d_twophase(cfg, rig, (W, H), ckpt["CenterDetect"],
                                           ckpt["HybridNet"], lowres_factor=f,
                                           dtype="bfloat16", device="cuda", graph=g)
              for g in (False, True)}
    a_out = [phases[False][0](lo) for lo in low]
    b_in = [(torch.from_numpy(phases[False][2](host_full[k], a_out[k][0].cpu().numpy(),
                                               a_out[k][1].cpu().numpy())).cuda(),
             *(a.contiguous() for a in a_out[k][:3])) for k in range(2)]
    results.append(graph_path(kernels, "two-phase A", lambda i: phases[False][0](low[i % 2]),
                              lambda i: phases[True][0](low[i % 2]), [phases[True][0].step],
                              T, "framesets/s", note, smi))
    results.append(graph_path(kernels, "two-phase B", lambda i: phases[False][1](*b_in[i % 2]),
                              lambda i: phases[True][1](*b_in[i % 2]),
                              [phases[True][1].step], T, "framesets/s", note, smi))

    imgs = [fr[:, 0].contiguous() for fr in frames]
    pred2d = {g: make_predictor2d(cfg, ckpt["CenterDetect"], ckpt["KeypointDetect"],
                                  dtype="bfloat16", device="cuda", graph=g) for g in (False, True)}
    results.append(graph_path(kernels, "predict2D", lambda i: pred2d[False](imgs[i % 2]),
                              lambda i: pred2d[True](imgs[i % 2]), [pred2d[True].step], T,
                              "frames/s", note, smi, FULL))

    # the drivers' loops over seeded host batches, the graphed predictors
    # built above against the eager ones
    dcfg = cfg.clone()
    dcfg.KEYPOINT_NAMES = [f"joint_{j}" for j in range(int(cfg.KEYPOINTDETECT.NUM_JOINTS))]
    preds = {False: predictor, True: graphed}

    def run3d(graph, n, tmp, spans):
        return stream_predict3d(dcfg, SpannedPredictor(preds[graph], spans),
                                BatchReader(host_full, n), tmp)

    expect3d = [[a.cpu().numpy() for a in predictor(fr)] for fr in frames]
    results.append(driver_graph_path(kernels, "predict3D (stream_predict3d)", run3d, expect3d,
                                     len(PER_JOINT), "poses/s", note, smi, FULL))
    host_low = [lo.cpu().numpy() for lo in low]

    def run_twophase(graph, n, tmp, spans):
        phase_a, phase_b, crop_fn = phases[graph]
        return stream_predict3d_twophase(
            dcfg, (spans.wrap(phase_a), spans.wrap(phase_b), crop_fn),
            PairReader(list(zip(host_full, host_low)), n), "cuda", tmp)

    expect2p = []
    for k in range(2):
        cx, cy, c3d, valid = a_out[k]
        pts, conf = phases[False][1](*b_in[k])
        expect2p.append([a.cpu().numpy() for a in (pts, conf, valid)])
    results.append(driver_graph_path(kernels, "two-phase (stream_predict3d_twophase)",
                                     run_twophase, expect2p, len(PER_JOINT), "poses/s", note,
                                     smi))
    host_imgs = [im.cpu().numpy() for im in imgs]

    def run2d(graph, n, tmp, spans):
        path = os.path.join(tmp, "data2D.csv")
        stream_rows(dcfg, _fused_steps(SpannedPredictor(pred2d[graph], spans),
                                       BatchReader(host_imgs, n)), path, ("x", "y", "confidence"))
        return path

    expect2d = [[a.cpu().numpy() for a in pred2d[False](im)] for im in imgs]
    results.append(driver_graph_path(kernels, "predict2D (stream_rows)", run2d, expect2d, 3,
                                     "frames/s", note, smi, FULL))
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_graphs.txt"), "w") as log:
        log.write(f"card: {smi}\nkernels a step of each graphed path (torch.profiler, "
                  f"over its profiled replays)\n")
        for r in results:
            if "kernels" not in r["graphed"]:  # the drivers' loops
                continue
            log.write(f"{r['label']}:\n")
            for key, count in r["graphed"]["kernels"].most_common():
                log.write(f"  {count / r['iters']:8.1f}  {key[:160]}\n")
            for key, (eager, graphed) in sorted(r.get("renamed", {}).items()):
                log.write(f"  name differs, calls eager {eager} graphed {graphed}: {key[:160]}\n")
    return results

TRAIN_EPOCHS = 2
TRAIN_SPLITS = (("train", 4), ("val", 2))
TRAINING_KERNELS = ("instance_norm_act", "repro_quarter_gather", "soft_argmax",
                    "instance_norm_act_backward", "hybridnet_loss_fwd", "hybridnet_loss_bwd",
                    "color_aug")
# the freeze modes that train the 2D net add the gather's backward, K11 (K12
# in the other repro modes, whose steps run K5 in place of K2)
TRAINING_ALL_KERNELS = TRAINING_KERNELS + ("repro_quarter_gather_backward",)
K12_STEP_KERNELS = ("instance_norm_act", "repro_grid_gather", "repro_grid_gather_backward",
                    "soft_argmax", "instance_norm_act_backward", "hybridnet_loss_fwd",
                    "hybridnet_loss_bwd")
TRAIN2D_KERNELS = ("instance_norm_act", "instance_norm_act_backward", "heatmap2d_loss_fwd",
                   "heatmap2d_loss_bwd", "color_aug", "argmax2d")
NETS_2D = ("CenterDetect", "KeypointDetect")


def training_project(parent: str, dataset: str, epochs: int, bbox: int, cube: int,
                     spacing: int, joints: int, cameras: int, workers: int = 4,
                     name: str = "Train", worker_mode: str = "process",
                     dtype: str = "float32") -> None:
    """The synthetic project ``name`` (``Train``) whose ``train_hybridnet`` and
    ``train_efficienttrack`` runs the training phases drive: MonkeyHand's
    networks (256^2 CenterDetect input, ``bbox``^2 crops), batch 4 for the
    2D nets and 1 for HybridNet (3D_only, quarter_fused), ``TPU.TRAIN_DTYPE``
    ``dtype`` (float32), the default color augmentation on the device
    (``TPU.DEVICE_AUG``), ``workers`` loader workers in ``worker_mode`` (the
    default's 'process')."""
    from jarvis_hybridnet_torch.testing import write_project

    write_project(parent, name, {
        "DATASET": {"DATASET_2D": dataset, "DATASET_3D": dataset},
        "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": 256, "BATCH_SIZE": 4,
                         "NUM_EPOCHS": epochs},
        "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": joints,
                           "BOUNDING_BOX_SIZE": bbox, "BATCH_SIZE": 4, "NUM_EPOCHS": epochs},
        "HYBRIDNET": {"ROI_CUBE_SIZE": cube, "GRID_SPACING": spacing, "BATCH_SIZE": 1,
                      "NUM_EPOCHS": epochs, "NUM_CAMERAS": cameras},
        "TPU": {"REPRO_MODE": "quarter_fused", "TRAIN_DTYPE": dtype},
        "DATALOADER_NUM_WORKERS": workers,
        "DATALOADER_WORKER_MODE": worker_mode,
    })


def k6_library(x, dy, act, skip):
    """The same backward through PyTorch's own ops: a function that runs
    autograd's backward of F.instance_norm + act, on (N, C, S) views of the
    (N, S, C) inputs, through a graph built once here (the forward is not
    timed)."""
    import torch
    import torch.nn.functional as F

    xn = x.permute(0, 2, 1).detach().requires_grad_()
    sn = None if skip is None else skip.permute(0, 2, 1).detach().requires_grad_()
    y = F.instance_norm(xn)
    y = {"none": lambda: y, "silu": lambda: F.silu(y), "relu": lambda: F.relu(y),
         "add_relu": lambda: F.relu(y + sn)}[act]()
    inputs, grad = [xn] + ([sn] if sn is not None else []), dy.permute(0, 2, 1)
    return lambda: torch.autograd.grad(y, inputs, grad, retain_graph=True)


# K6 keys checked beside the training run's: every act at V2V's largest
# float32 shape, and a bf16 one (a batch of 8 at that shape, SiLU)
K6_EXTRA_KEYS = (tuple(((1, 46656, 46), "float32", a) for a in ("none", "silu", "relu", "add_relu"))
                 + (((8, 46656, 46), "bfloat16", "silu"),))


def k6_inputs(shape, dtype, act, seed=11):
    """Seeded x, skip (add_relu), dy on the card, K1's output and stats."""
    import torch

    from jarvis_hybridnet_torch import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.5).to(dtype)
    skip = torch.randn(shape, device=dev, generator=g).to(dtype) if act == "add_relu" else None
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    out, stats = kernels.instance_norm_act(x, act, skip, return_stats=True)
    return x, skip, dy, out, stats


def check_k6(kernels, keys, launches, note, step_paths=()):
    """K6 at every (shape, dtype, act) the training run gave it and at
    ``K6_EXTRA_KEYS``, from K1's output and statistics: K1's statistics
    within 1e-6 relative of the plain ones; for relu, the sign of the
    normalized value (K6's mask) equal to out > 0 bit for bit; dx within
    1e-5 of max|dx| of the plain version, dskip equal; two calls bit-equal.
    Each key timed (device, wall, plain, autograd's backward, bound); the
    kernels line sums the 3D training step's calls, and under ``per_step``
    each of ``step_paths``' (the 2D steps)."""
    import torch

    from jarvis_hybridnet_torch.kernels.instance_norm import backward_launch_plan, stats_plain

    k6 = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0)
    per_step = {p: dict(calls=0, ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        library_ms=0.0) for p in step_paths}
    todo = {k: per for k, per in keys.items()}
    for shape, name, act in K6_EXTRA_KEYS:
        todo.setdefault((shape, getattr(torch, name), act), {})
    for (shape, dtype, act), per in sorted(todo.items(), key=lambda kv: str(kv[0])):
        x, skip, dy, out, stats = k6_inputs(shape, dtype, act)
        ref = stats_plain(x)
        srel = max(float((stats[..., i] - ref[..., i]).abs().max() / ref[..., i].abs().max())
                   for i in (0, 1))
        if srel > 1e-6:
            fail(f"instance_norm_act {shape} {dtype} {act}: stats {srel} relative from plain")
        same_out = torch.equal(out, kernels.instance_norm_act(x, act, skip))
        mask = ""
        if act == "relu":
            v = ((x.float() - stats[:, None, :, 0]) * stats[:, None, :, 1]).to(dtype)
            if not torch.equal(v > 0, out > 0):
                fail(f"instance_norm_act_backward {shape} {dtype} relu: the sign of the "
                     f"normalized value differs from out > 0 at {int(((v > 0) != (out > 0)).sum())}"
                     f" elements")
            mask = ", relu mask from x equal to out > 0"
        kd, ks = kernels.instance_norm_act_backward(x, dy, out, act, stats)
        kd2, ks2 = kernels.instance_norm_act_backward(x, dy, out, act, stats)
        pd, ps = kernels.instance_norm_act_backward_plain(x, dy, out, act, stats)
        err = float((kd - pd).abs().max())
        rel = err / max(float(pd.abs().max()), 1e-30)
        if dtype == torch.bfloat16:
            # both round the float32 dx to bf16: where the two float32 values
            # (sums in other orders) straddle a rounding boundary they land
            # one bf16 ulp apart, so each element may differ by one ulp of
            # its own magnitude beyond the float32 bound
            ulp = torch.exp2(torch.floor(torch.log2(pd.float().abs().clamp_min(1e-30))) - 7)
            rel = float(((kd.float() - pd.float()).abs() - ulp).clamp_min(0).max()
                        / pd.float().abs().max())
        serr = 0.0 if ks is None else float((ks - ps).abs().max())
        twice = torch.equal(kd, kd2) and (ks is None or torch.equal(ks, ks2))
        plan = backward_launch_plan(*shape, dtype, act)
        note(f"instance_norm_act_backward {shape} {dtype} {act} (calls per path "
             f"{json.dumps(per)}): dx {err:.2e} abs, {rel:.2e} of max|dx| (tol 1e-5"
             f"{'; bf16: beyond one ulp of each element' if dtype == torch.bfloat16 else ''}), "
             f"dskip "
             f"{serr:.2e} (tol 0), two calls {'bit-equal' if twice else 'DIFFER'}; K1 stats "
             f"{srel:.2e} relative (tol 1e-6), output with stats "
             f"{'equal' if same_out else 'DIFFERS'}{mask}; parts {plan.parts}, cluster "
             f"{plan.cluster}, blocks {plan.blocks}, span {plan.span}, resident {plan.resident}")
        if rel > 1e-5 or serr > 0 or not twice or not same_out:
            fail(f"instance_norm_act_backward {shape} {act} differs: dx {rel}, dskip {serr}, "
                 f"two calls equal {twice}, K1's output with stats equal {same_out}")
        k6["max_abs_err"] = max(k6["max_abs_err"], err)
        # the function reads x and dy (and, for add_relu, y) and writes dx
        # (and dskip); relu's mask is the sign of xhat, which x gives
        nbytes = x.numel() * x.element_size() * (3 if act != "add_relu" else 5)
        times = dict(
            ms=graph_ms(lambda: kernels.instance_norm_act_backward(x, dy, out, act, stats)),
            wall_ms=cuda_ms(lambda: kernels.instance_norm_act_backward(x, dy, out, act, stats)),
            plain_ms=cuda_ms(lambda: kernels.instance_norm_act_backward_plain(x, dy, out, act,
                                                                              stats)),
            library_ms=cuda_ms(k6_library(x, dy, act, skip)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        count = per.get("training_step", 0)
        note(f"  x{count} per step: device {times['ms']:.4f} ms, wall {times['wall_ms']:.4f}, "
             f"library (autograd's backward of F.instance_norm + act) "
             f"{times['library_ms']:.4f}, plain {times['plain_ms']:.4f}, bound "
             f"{times['bound_ms']:.4f}")
        for k, v in times.items():
            k6[k] += v * count
        for p, acc in per_step.items():
            acc["calls"] += per.get(p, 0)
            for k in ("ms", "wall_ms", "plain_ms", "bound_ms", "library_ms"):
                acc[k] += times[k] * per.get(p, 0)
        del x, skip, dy, out, stats, kd, ks, kd2, ks2, pd, ps
    return dict(name="instance_norm_act_backward", route="cuda", kernels_per_call=1,
                source="jarvis_hybridnet_torch/kernels/csrc/instance_norm_act_backward.cu",
                replaces="tools/fused_norm_bench.py:58", launches=launches, bound_by="bytes",
                per="training step", per_step=per_step, **k6)


def check_k7(kernels, out, kv, kw, counts, note):
    """K7 at the training step's volume against its plain version: the loss
    and the gradient within 1e-5 relative, the double-softplus volume within
    1e-6, valid equal; two calls of each bit-equal; timed."""
    import torch

    from jarvis_hybridnet_torch.kernels.hybridnet_loss import loss_plan

    kl, kvalid, kvol = kernels.hybridnet_loss_fwd(out, kv, kw, True)
    kl2, kvalid2, _ = kernels.hybridnet_loss_fwd(out, kv, kw)
    pl, pvalid, pvol = kernels.hybridnet_loss_fwd_plain(out, kv, kw, True)
    dl = torch.ones((), device=out.device)
    kg = kernels.hybridnet_loss_bwd(out, kv, kw, kvalid, dl)
    kg2 = kernels.hybridnet_loss_bwd(out, kv, kw, kvalid, dl)
    pg = kernels.hybridnet_loss_bwd_plain(out, kv, kw, pvalid, dl)
    lrel = abs(float(kl) - float(pl)) / max(abs(float(pl)), 1e-30)
    grel = float((kg - pg).abs().max()) / max(float(pg.abs().max()), 1e-30)
    vrel = float((kvol - pvol).abs().max()) / max(float(pvol.abs().max()), 1e-30)
    same_valid = torch.equal(kvalid, pvalid)
    twice = torch.equal(kl, kl2) and torch.equal(kvalid, kvalid2) and torch.equal(kg, kg2)
    note(f"hybridnet_loss {tuple(out.shape)}: loss {float(kl):.6f} vs plain {float(pl):.6f} "
         f"({lrel:.2e} relative, tol 1e-5), valid joints {int(kvalid.sum())}/"
         f"{kvalid.numel()} {'equal' if same_valid else 'DIFFER'}, gradient {grel:.2e} of "
         f"max (tol 1e-5), double-softplus volume {vrel:.2e} of max (tol 1e-6), two calls "
         f"{'bit-equal' if twice else 'DIFFER'}; "
         f"{loss_plan(out.shape[0], out.shape[1], out.shape[-1])}")
    if lrel > 1e-5 or grel > 1e-5 or vrel > 1e-6 or not same_valid or not twice:
        fail("hybridnet_loss differs from its plain version, or between two calls")
    o_bytes = out.numel() * 4
    entries = []
    for name, call, plain, nbytes, err in (
            ("hybridnet_loss_fwd", lambda: kernels.hybridnet_loss_fwd(out, kv, kw),
             lambda: kernels.hybridnet_loss_fwd_plain(out, kv, kw), o_bytes,
             float((kl - pl).abs())),
            ("hybridnet_loss_bwd", lambda: kernels.hybridnet_loss_bwd(out, kv, kw, kvalid, dl),
             lambda: kernels.hybridnet_loss_bwd_plain(out, kv, kw, kvalid, dl),
             2 * o_bytes, float((kg - pg).abs().max()))):
        e = kernel_entry(name, "hybridnet_loss.cu",
                         "jarvis_hybridnet_tpu/training/trainer3d.py:171", counts[name], err,
                         call, plain, nbytes / HBM_BYTES_PER_S * 1e3, per="training step")
        note(f"{name}: device {e['ms']:.4f} ms, wall {e['wall_ms']:.4f}, plain "
             f"{e['plain_ms']:.4f}, bound {e['bound_ms']:.4f} (no single library call)")
        entries.append(e)
    return entries


def step_rate(step, batch: int, out_path: str, title: str, note, label: str,
              unit: str = "images/s") -> dict:
    """A training step's rate with its batch on the card: 1 / the median of 8
    timed steps after 2 warm-up, times ``batch`` (``unit``); the device's
    busy share over two profiled steps (``torch.profiler``, device activity
    only), whose device time by kernel is appended to ``out_path``."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    times = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    dev_us = sum(r[0] for r in rows)
    with open(out_path, "a") as f:
        f.write(f"{title}: two steps, wall {wall_us:.0f} us, device {dev_us:.0f} us\n")
        for us, count, key in rows[:30]:
            f.write(f"{us:12.0f} us {count:6d}x  {key[:110]}\n")
    rate_ = batch * 1e3 / step_ms
    note(f"{label}: {rate_:.2f} {unit}, {step_ms:.2f} ms a step (median of 8 after 2 "
         f"warm-up: {', '.join(f'{t:.2f}' for t in times)}); device busy "
         f"{dev_us / wall_us:.3f} of two profiled steps ({dev_us / 1e3:.2f} ms of device time "
         f"in {wall_us / 1e3:.2f} ms)")
    return dict(images_s=rate_, step_ms=step_ms, busy=dev_us / wall_us,
                device_ms=dev_us / 2e3)


def training_data(parent: str, note) -> None:
    """The synthetic COCO-style dataset and project of the training phases
    under ``parent`` (12 cameras of 1280x1024 JPEG frames on the synthetic
    rig, 23 seeded keypoints spanning under 144 mm, each frame with its
    bounding box and 2D keypoints; 4 train and 2 val framesets: 48 and 24
    images for the 2D nets), the loaders phase's projects on it
    (``LOOP_KINDS``), and ``JARVIS_PARENT_DIR`` set to it."""
    from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d

    t0 = time.perf_counter()
    dataset = write_dataset3d(os.path.join(parent, "datasets", "Synth"),
                              synthetic_rig(CAMS, W, H), W, H, 23, splits=TRAIN_SPLITS,
                              extent_mm=100.0, seed=5)
    training_project(parent, dataset, TRAIN_EPOCHS, 256, 144, 2, 23, CAMS)
    for name, mode, dtype in sorted({k[:3] for k in LOOP_KINDS.values()} - {
            ("Train", "process", "float32")}):
        training_project(parent, dataset, TRAIN_EPOCHS, 256, 144, 2, 23, CAMS, name=name,
                         worker_mode=mode, dtype=dtype)
    note(f"training: synthetic dataset of {sum(n for _, n in TRAIN_SPLITS)} framesets "
         f"x {CAMS} cameras of {W}x{H} JPEG written in {time.perf_counter() - t0:.2f} s")
    os.environ["JARVIS_PARENT_DIR"] = parent


def training_phase(kernels, ckpt, recorder, smi, note, mode="3D_only") -> dict:
    """``train_hybridnet`` in ``mode`` on the card, from the committed
    checkpoints, on the dataset of :func:`training_data`, for TRAIN_EPOCHS
    epochs, with the default device color augmentation (K9); ``all`` as the
    CLI's ``jarvis train hybridNet --mode all`` runs it, finetuning at a
    tenth of the learning rate. The launches of the run; in 3D_only the 2D
    net bitwise frozen, K2 never called with a graph and K11 never launched;
    in ``all`` the 2D net (stem to heads) updated, K2 called with a graph
    and K11 launched once a training step; V2V (front conv included)
    updated; ``.ckpt`` and ``.pth`` written and reloaded; then the step's
    framesets/s, ms and busy share, its calls recorded (K6's keys). Returns
    the run's launch counts (``counts``), the step's (``step``), the trainer
    and the step's batch on the card."""
    import torch

    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.dataset.loader import _collate
    from jarvis_hybridnet_torch.models.weights import params_from_jax
    from jarvis_hybridnet_torch.training import checkpoints
    from jarvis_hybridnet_torch.training.train_interface import train_hybridnet
    from jarvis_hybridnet_torch.training.trainer3d import host_batch
    from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
    from jarvis_hybridnet_torch.utils.transfer import HostToDevice

    frozen_2d = mode == "3D_only"
    path = "training" if frozen_2d else f"training_{mode}"
    names = TRAINING_KERNELS if frozen_2d else TRAINING_ALL_KERNELS
    run_name = "Run" if frozen_2d else f"Run_{mode}"
    t_phase = time.perf_counter()
    parent = os.environ["JARVIS_PARENT_DIR"]
    start = {k: v.clone() for k, v in params_from_jax(read_ckpt(ckpt["HybridNet"]),
                                                      "small").items()}
    res = {}
    t0 = time.perf_counter()
    ok, counts = path_launches(
        lambda: train_hybridnet("Train", TRAIN_EPOCHS, None, ckpt["HybridNet"], mode=mode,
                                run_name=run_name, finetune=not frozen_2d, device="cuda",
                                results=res, graph=False),
        kernels, names, path, recorder)
    run_s = time.perf_counter() - t0
    if not ok:
        fail(f"train_hybridnet {mode} did not finish")
    trainer, hist = res["trainer"], res["history"]
    n_steps = TRAIN_EPOCHS * TRAIN_SPLITS[0][1]
    note(f"training: train_hybridnet {mode}{'' if frozen_2d else ', finetune'} (max LR "
         f"{float(trainer.cfg.HYBRIDNET.MAX_LEARNING_RATE):g}), {TRAIN_EPOCHS} epochs of "
         f"{TRAIN_SPLITS[0][1]} steps (batch 1) and {TRAIN_SPLITS[1][1]} val framesets, "
         f"{run_s:.2f} s (data loading, JPEG decode and checkpoints included: "
         f"{n_steps / run_s:.2f} framesets/s); history {json.dumps(hist)}; launches "
         f"{json.dumps(counts)}; card: {smi}")
    losses = hist["train_loss"] + hist["val_loss"]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    graph_calls = recorder.k2_graph.get(path, 0)
    k11 = counts["repro_quarter_gather_backward"]
    want = 0 if frozen_2d else n_steps
    note(f"training {mode}: K2 called with a graph (its indices saved) {graph_calls} of "
         f"{counts['repro_quarter_gather']} calls, K11 launched {k11} times (want {want}: "
         f"{'none in 3D_only' if frozen_2d else 'one a training step, none in validation'})")
    if graph_calls != want or k11 != want:
        fail(f"training {mode}: K2 with a graph {graph_calls}, K11 {k11}, want {want} each")
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    eff = [k for k in state if k.startswith("effTrack.")]
    moved_2d = [k for k in eff if not torch.equal(state[k], start[k].to(state[k].dtype))]
    v2v_w = [k for k in state if k.startswith("v2vNet.") and k.endswith(".weight")]
    still = [k for k in v2v_w if torch.equal(state[k], start[k])]
    front = "v2vNet.front_layers.0.block.0.weight"
    ends = ("effTrack.backbone_net.model._conv_stem.weight", "effTrack.deconv1.weight")
    want_2d = ("want none" if frozen_2d else "stem and stride-2 head: "
               + ", ".join(str(e in moved_2d) for e in ends))
    note(f"training {mode}: 2D net {len(moved_2d)} of {len(eff)} tensors changed ({want_2d}); "
         f"V2V weights changed: {len(v2v_w) - len(still)} of {len(v2v_w)} (front conv "
         f"{'changed' if front not in still else 'UNCHANGED'}, max |delta| "
         f"{float((state[front] - start[front]).abs().max()):.3e})")
    if still or (moved_2d if frozen_2d else len(moved_2d) < 100
                 or not all(e in moved_2d for e in ends)):
        fail(f"training {mode}: the 2D net moved as it should not ({moved_2d[:3]}) or V2V "
             f"weights did not move ({still[:3]})")
    run_dir = os.path.join(parent, "projects", "Train", "models", "HybridNet", run_name)
    final = os.path.join(run_dir, "HybridNet-small_final")
    back = params_from_jax(read_ckpt(final + ".ckpt"), "small")
    pth = checkpoints.load_torch_state_dict(final + ".pth")
    same_ckpt = set(back) <= set(state) and all(torch.equal(back[k], state[k])
                                                 for k in back)
    same_pth = set(pth) == set(state) and all(torch.equal(pth[k], state[k]) for k in pth)
    note(f"training {mode}: {os.path.basename(final)}.ckpt ({len(back)} tensors) and .pth "
         f"({len(pth)}) reload in the port equal to the trained state: "
         f"{same_ckpt and same_pth}")
    if not (same_ckpt and same_pth):
        fail("the written checkpoints do not reload to the trained state")

    note(f"training {mode} phase: {time.perf_counter() - t_phase:.1f} s so far")
    # the step alone: one batch of the run's data, on the card
    ds = Dataset3D(trainer.cfg, set="train", device_targets=True, device_aug=True)
    b = HostToDevice("cuda")(host_batch(_collate([ds[0]])))
    opt, model = trainer.optimizer, trainer.model
    model.train()
    prof_path = os.path.join(REPO, "chiprun_out", "chip_smoke_train_profile.txt" if frozen_2d
                             else f"chip_smoke_train_{mode}_profile.txt")
    open(prof_path, "w").close()
    step_rate(
        lambda: trainer.train_step(b, opt, 1e-6), 1, prof_path, f"HybridNet {mode}", note,
        f"training step (batch 1 frameset of {CAMS} crops of 256^2, G = 72, {mode}, float32, "
        f"AdamW, device color augmentation; batch on the card; card: {smi})",
        unit="framesets/s")

    note(f"training {mode} phase: {time.perf_counter() - t_phase:.1f} s so far")
    # the step's calls of K6 (checked with the 2D steps' later)
    _, step = path_launches(lambda: trainer.train_step(b, opt, 1e-6), kernels, names,
                            f"{path}_step", recorder)
    return dict(counts=counts, step=step, trainer=trainer, batch=b)


def k7_check(kernels, run, note):
    """K7 at the 3D_only training step's volume (:func:`check_k7`)."""
    import torch

    trainer, b = run["trainer"], run["batch"]
    with torch.no_grad():
        out, _ = trainer.model.train_outputs(trainer.prepare(b), b["center_hm"],
                                             b["center3d"], b["camera_matrices"],
                                             b["intrinsics"], b["distortions"])
    kv, kw = b["kp_vox"].float().contiguous(), b["keypoints3D"].float().contiguous()
    return check_k7(kernels, out, kv, kw, run["counts"], note)


def freeze_steps(kernels, run, ckpt, recorder, smi, note) -> dict:
    """One AdamW step (lr 1e-3) on the card in ``bifpn`` and in
    ``last_layers`` at full width, on the ``all`` run's batch, from the
    committed checkpoint: every tensor the mode's labels freeze bitwise
    unchanged and without a gradient; every trained tensor with a nonzero
    gradient changed; K11 launched. Returns each step's launch counts."""
    import torch

    from jarvis_hybridnet_torch.training import optim
    from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer

    out = {}
    for mode in ("bifpn", "last_layers"):
        trainer = HybridNetTrainer("train", run["trainer"].cfg, weights=ckpt["HybridNet"],
                                   device="cuda", run_name=f"Step_{mode}", training_mode=mode,
                                   graph=False)
        model = trainer.model.train()
        labels = optim.hybridnet_freeze_labels(model, mode)
        opt = optim.make_optimizer("adamw", optim.apply_freeze(model, labels), 1e-3)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        _, out[mode] = path_launches(lambda: trainer.train_step(run["batch"], opt, 1e-3),
                                     kernels, TRAINING_ALL_KERNELS, f"training_{mode}_step",
                                     recorder)
        params = dict(model.named_parameters())
        frozen = [n for n, v in labels.items() if v == "freeze"]
        moved = [n for n in frozen if params[n].grad is not None
                 or not torch.equal(params[n].detach(), before[n])]
        # AdamW's first step moves a tensor by about lr wherever |grad| >> its eps
        live = [n for n, v in labels.items() if v == "train" and params[n].grad is not None
                and float(params[n].grad.abs().max()) > 1e-8]
        still = [n for n in live if torch.equal(params[n].detach(), before[n])]
        trained_2d = sum(n.startswith("effTrack.") for n in live)
        held = ("bitwise unchanged, without a gradient" if not moved
                else f"MOVED: {moved[:3]}")
        note(f"training step {mode} (full width, AdamW lr 1e-3): {len(frozen)} frozen tensors "
             f"(the 2D backbone{' and BiFPN' if mode == 'last_layers' else ''}) {held}"
             f"; {len(live) - len(still)} of {len(live)} trained tensors with a gradient "
             f"above 1e-8 changed ({trained_2d} of them in the 2D net); launches "
             f"{json.dumps(out[mode])}; card: {smi}")
        if moved or still or not trained_2d:
            fail(f"training step {mode}: frozen tensors moved ({moved[:3]}) or trained ones did "
                 f"not ({still[:3]})")
        del trainer, model, opt, before
    return out


def k12_steps(kernels, run, ckpt, recorder, smi, note) -> dict:
    """One ``all`` step on the card in each of the exact, half_fused and half
    repro modes (K5 forward, K12 backward), at full width on the ``all``
    run's batch: the loss finite and K12 launched once. Returns each step's
    launch counts by mode."""
    import torch

    from jarvis_hybridnet_torch.training import optim
    from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer

    out = {}
    for mode in OTHER_MODES:
        cfg = run["trainer"].cfg.clone()
        cfg.TPU.REPRO_MODE = mode
        trainer = HybridNetTrainer("train", cfg, weights=ckpt["HybridNet"], device="cuda",
                                   run_name=f"Step_all_{mode}", graph=False)
        model = trainer.model.train()
        opt = optim.make_optimizer(
            "adamw", optim.apply_freeze(model, optim.hybridnet_freeze_labels(model, "all")),
            1e-6)
        trainer.train_step(run["batch"], opt, 1e-6)  # warm-up
        (loss, _), out[mode] = path_launches(lambda: trainer.train_step(run["batch"], opt, 1e-6),
                                             kernels, K12_STEP_KERNELS,
                                             f"training_all_step_{mode}", recorder)
        note(f"training step all, repro mode {mode} (full width): loss {float(loss):.4f}, "
             f"launches {json.dumps(out[mode])}; card: {smi}")
        if not math.isfinite(float(loss)) or out[mode]["repro_grid_gather_backward"] != 1:
            fail(f"training step all {mode}: loss {float(loss)}, K12 launched "
                 f"{out[mode]['repro_grid_gather_backward']} times (want 1)")
        del trainer, model, opt
        torch.cuda.empty_cache()
    return out


GRAD_TOL = 1e-3  # card vs CPU training step, ReLU masks matched: per element of the tensor's max
FLIP_TOL = 1e-3  # |pre-activation| of a ReLU element on another branch on the card than on the CPU
# the 2D net's gradients in the all step, card vs CPU: its backbone's gradient
# magnifies float32 round-off (the CPU's float32 step lies up to 3.6e-3 of a
# tensor's max from JAX's float64 one, tests/test_torch_training_modes.py);
# measured 5.97e-4, card (H100) against CPU (PERF.md section 6)
EFF_GRAD_TOL = 2e-3


def training_step_on(cfg, batch, ckpt, device, lr, tf32=False, like=None,
                     mode="3D_only") -> dict:
    """One SGD step (Nesterov momentum 0.9, ``lr``) in the freeze ``mode`` of
    a ``HybridNetTrainer`` from the committed HybridNet checkpoint on
    ``device``, float32, in ``eval()`` (dropout and drop-connect off), TF32
    as ``tf32`` says. Returns the loss, the trained tensors' gradients and
    updated parameters (on the CPU) and, for each ReLU of the step's K1 calls in
    order, (act, output, pre-activation) on the CPU. With ``like`` (another
    step's ReLU calls) each ReLU's mask is set to ``like``'s: the output
    takes ``like``'s value where only ``like``'s is positive and 0 where
    only this step's is; each element so set is listed under ``flips`` with
    its pre-activation on this device and in ``like``."""
    import torch

    from jarvis_hybridnet_torch.kernels.instance_norm import InstanceNormAct
    from jarvis_hybridnet_torch.training import optim
    from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer
    from jarvis_hybridnet_torch.utils.transfer import HostToDevice

    trainer = HybridNetTrainer("train", cfg, weights=ckpt["HybridNet"], device=device,
                               run_name=f"step_{device}", training_mode=mode)
    model = trainer.model
    trained = optim.apply_freeze(model, optim.hybridnet_freeze_labels(model, mode))
    opt = torch.optim.SGD(trained, lr=lr, momentum=0.9, nesterov=True)
    model.eval()
    k1 = InstanceNormAct.k1
    calls, flips = [], []

    def relu_k1(x, act="none", skip=None, return_stats=False):
        out, stats = k1(x, act, skip, return_stats=True)
        if act not in ("relu", "add_relu"):
            return (out, stats) if return_stats else out
        pre = k1(x, "none", None) + (0 if skip is None else skip)
        if like is not None:
            _, ref, ref_pre = like[len(calls)]
            want = ref.to(out.device) > 0
            for idx in (want != (out > 0)).nonzero().tolist():
                flips.append((len(calls), act, tuple(idx), float(pre[tuple(idx)]),
                              float(ref_pre[tuple(idx)])))
            out = torch.where(want, torch.where(out > 0, out, ref.to(out.device)),
                              torch.zeros_like(out))
        calls.append((act, out.cpu(), pre.cpu()))
        return (out, stats) if return_stats else out

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    InstanceNormAct.k1 = staticmethod(relu_k1)
    try:
        loss, _ = trainer.forward(HostToDevice(device)(batch))
        opt.zero_grad()
        loss.backward()
        live = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        # copied before the step: SGD's foreach path on the card adds the
        # momentum buffer to the gradients in place
        grads = {n: p.grad.detach().cpu().clone() for n, p in live}
        opt.step()
    finally:
        InstanceNormAct.k1 = staticmethod(k1)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return dict(loss=float(loss.detach()), calls=calls, flips=flips, grads=grads,
                params={n: p.detach().cpu().clone() for n, p in live})


def step_gap(a: dict, b: dict, lr: float) -> dict:
    """How far step ``a``'s V2V gradients and parameters lie from ``b``'s:
    ``elem``, the largest |difference| of a gradient over its tensor's
    largest |element| (the conv biases ahead of an InstanceNorm left out:
    their gradient is zero but for round-off; ``bias``, the largest of
    those over the largest weight gradient); ``norm``, the same in norm;
    ``param``, the largest parameter difference over 1.9 * lr * GRAD_TOL *
    max|grad| + 2 float32 ulps of the parameter (Nesterov's first step moves
    a parameter by lr * 1.9 * grad)."""
    import torch

    ga, gb, pa, pb = a["grads"], b["grads"], a["params"], b["params"]
    v2v = [n for n in gb if n.startswith("v2vNet.")]
    zero = [n for n in v2v if n.endswith(".bias") and "output_layer" not in n]
    rest = [n for n in v2v if n not in zero]
    scale = max(float(gb[n].abs().max()) for n in rest if n.endswith(".weight"))
    elem = {n: float((ga[n] - gb[n]).abs().max() / gb[n].abs().max().clamp_min(1e-30))
            for n in rest}
    norm = {n: float((ga[n] - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)) for n in rest}
    param = 0.0
    for n in rest:
        ulp = torch.exp2(torch.floor(torch.log2(pb[n].abs().clamp_min(1e-30))) - 23)
        allowed = 1.9 * lr * GRAD_TOL * float(gb[n].abs().max()) + 2 * ulp
        param = max(param, float(((pa[n] - pb[n]).abs() / allowed).max()))
    worst = sorted(elem, key=elem.get, reverse=True)
    return dict(elem=elem[worst[0]], worst=", ".join(f"{n} {elem[n]:.2e}" for n in worst[:3]),
                norm=max(norm.values()), param=param,
                bias=max(max(float(ga[n].abs().max()), float(gb[n].abs().max())) / scale
                         for n in zero), tensors=len(rest), biases=len(zero))


def training_card_vs_cpu(ckpt, note, mode="3D_only") -> None:
    """One training step in the freeze ``mode`` on the card against the same
    step on the CPU, float32, TF32 off, dropout and drop-connect off, at the tests' size
    (4 cameras of 320x256, 128^2 crops, a 48 mm cube at 4 mm), from the
    committed HybridNet checkpoint, with SGD (lr 1e-3).

    A ReLU whose input lies within round-off of zero can take the other
    branch on the other device and then passes, or stops, a whole element
    of the incoming gradient. So the CPU step runs twice: as it is, which
    is printed (information), and with each ReLU's mask set to the card's,
    which is held to the card's step: the loss within 1e-4 relative, each
    V2V gradient element within GRAD_TOL of its tensor's largest, the conv
    biases ahead of an InstanceNorm (zero but for round-off) within 1e-4 of
    the largest weight gradient, the updated parameters within what those
    gradients allow (``step_gap``). Every ReLU element whose mask was set is
    printed with its pre-activation on both devices, and each must lie
    within FLIP_TOL of zero on both (a normalized value: a round-off tie,
    not a different activation). In ``all`` the 2D net's gradients are held
    too (``_grad_gap``): each convolution's per element within EFF_GRAD_TOL
    of its tensor's largest, the fusion weights' within EFF_GRAD_TOL of the
    largest fusion-weight gradient, the conv biases ahead of an InstanceNorm
    within 1e-4 of the largest weight gradient. The control is the
    card's step with TF32 allowed, compared the same way: the gate must
    refuse it."""
    import tempfile

    import numpy as np

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d
    from jarvis_hybridnet_torch.training.trainer3d import BATCH_KEYS

    lr = 1e-3
    with tempfile.TemporaryDirectory() as parent:
        dataset = write_dataset3d(os.path.join(parent, "datasets", "Small"),
                                  synthetic_rig(4, 320, 256), 320, 256, 23,
                                  splits=(("val", 1),), extent_mm=40.0, seed=6)
        training_project(parent, dataset, 1, 128, 48, 4, 23, 4, workers=0)
        pm = ProjectManager(parent)
        pm.load("Train")
        cfg = pm.get_cfg()
        sample = Dataset3D(cfg, set="val", device_targets=True)[0]
        batch = {k: np.asarray(sample[k])[None] for k in BATCH_KEYS}
        step = functools.partial(training_step_on, cfg, batch, ckpt, lr=lr, mode=mode)
        card = step("cuda")
        cpu = step("cpu")
        matched = step("cpu", like=card["calls"])
        tf32 = step("cuda", tf32=True)
        tf32_matched = step("cpu", like=tf32["calls"])
    as_is, gap, control = (step_gap(card, cpu, lr), step_gap(card, matched, lr),
                           step_gap(tf32, tf32_matched, lr))
    eff = eff_control = None
    if mode != "3D_only":
        def eff_grads(st):
            return {n[len("effTrack."):]: g for n, g in st["grads"].items()
                    if n.startswith("effTrack.")}

        eff = _grad_gap(eff_grads(card), eff_grads(matched))
        eff_control = _grad_gap(eff_grads(tf32), eff_grads(tf32_matched))
    relus = sum(c[1].numel() for c in card["calls"])
    flips = matched["flips"]
    flip_pre = max((max(abs(f[3]), abs(f[4])) for f in flips), default=0.0)
    tf32_pre = max((max(abs(f[3]), abs(f[4])) for f in tf32_matched["flips"]), default=0.0)
    shown = "; ".join(f"call {i} ({act}) element {idx}: CPU {pc:.3e}, card {pg:.3e}"
                      for i, act, idx, pc, pg in flips[:8])
    note(f"training step {mode}, card vs CPU (4 cameras, 128^2 crops, G = 12, float32, TF32 off, "
         f"eval, SGD lr {lr}): loss {card['loss']:.6f} vs {cpu['loss']:.6f}; as it is (no "
         f"bound): V2V gradients within {as_is['elem']:.2e} of their tensor's max per element, "
         f"{as_is['norm']:.2e} in norm; ReLU elements on another branch on the CPU than on "
         f"the card: {len(flips)} of {relus} over {len(card['calls'])} K1 calls, largest "
         f"|pre-activation| among them {flip_pre:.3e} (tol {FLIP_TOL:g})"
         f"{': ' + shown if flips else ''}")
    note(f"training step {mode}, card vs CPU with the CPU's ReLU masks set to the card's: V2V "
         f"gradients of {gap['tensors']} tensors within {gap['elem']:.2e} of their tensor's max "
         f"per element (worst: {gap['worst']}; tol {GRAD_TOL:g}), {gap['norm']:.2e} in norm; the "
         f"{gap['biases']} biases ahead of an InstanceNorm within {gap['bias']:.2e} of the "
         f"largest weight gradient (tol 1e-4); parameters at {gap['param']:.3f} of their "
         f"bound (tol 1); loss {matched['loss']:.6f}")
    if eff is not None:
        note(f"training step {mode}, card vs CPU, masks set: the 2D net's convolutions' "
             f"gradients within {eff['elem']:.2e} of their tensor's max per element (tol "
             f"{EFF_GRAD_TOL:g}); the {eff['fusion']} fusion weights' within {eff['fused']:.2e} "
             f"of the largest fusion-weight gradient (tol {EFF_GRAD_TOL:g}); the biases ahead "
             f"of an InstanceNorm within {eff['ahead']:.2e} of the largest weight gradient "
             f"(tol 1e-4); largest per-tensor gaps (information): {eff['top']}")
        note(f"training step {mode} control, TF32: the 2D net's convolutions' gradients within "
             f"{eff_control['elem']:.2e} of their tensor's max, fusion weights "
             f"{eff_control['fused']:.2e} (largest: {eff_control['top']}): "
             f"{'refused' if eff_control['elem'] > EFF_GRAD_TOL else 'not refused'} by the 2D "
             f"net's gate")
    note(f"training step {mode} control, the card with TF32 allowed against the CPU with its "
         f"masks ({len(tf32_matched['flips'])} set, largest |pre-activation| {tf32_pre:.3e}): "
         f"gradients within {control['elem']:.2e} of their tensor's max per element (worst: "
         f"{control['worst']}), {control['norm']:.2e} in norm, "
         f"parameters at {control['param']:.3f} of their bound: "
         f"{'refused' if control['elem'] > GRAD_TOL else 'NOT refused'} by the gate")
    if (abs(card["loss"] - matched["loss"]) > 1e-4 * abs(matched["loss"])
            or abs(card["loss"] - cpu["loss"]) > 1e-4 * abs(cpu["loss"])
            or gap["elem"] > GRAD_TOL or gap["bias"] > 1e-4 or gap["param"] > 1.0
            or flip_pre > FLIP_TOL
            or (eff is not None and (eff["elem"] > EFF_GRAD_TOL or eff["fused"] > EFF_GRAD_TOL
                                     or eff["ahead"] > 1e-4))):
        fail(f"the {mode} training step on the card disagrees with the CPU step")
    if control["elem"] <= GRAD_TOL:
        fail(f"the card-vs-CPU {mode} training gate does not tell a TF32 step from a float32 one")


def train2d_phase(kernels, ckpt, recorder, smi, note):
    """``train_efficienttrack`` on the card for CenterDetect, then
    KeypointDetect, from the committed checkpoints, on the dataset of
    :func:`training_data` (48 train and 24 val images of 1280x1024: 256^2
    CenterDetect input, 256^2 crops, 23 joints), batch 4, float32, for
    TRAIN_EPOCHS epochs at the default ``TPU`` section (device color
    augmentation on): each run with the launch counts set to 0 before it and
    read after it (K1, K6, K8, K9, K10 and their arguments recorded), the
    loss finite, the weights changed, ``.ckpt`` and ``.pth`` reloaded equal
    to the trained state. Then each net's step alone with a batch of 4 train
    samples on the card: images/s, busy share, device time by kernel into
    ``chiprun_out/chip_smoke_train2d_profile.txt``, and one counted step
    (calls per step). Returns ({net: launch counts of its run}, {net: its
    step's numbers and launch counts})."""
    import torch

    from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
    from jarvis_hybridnet_torch.dataset.loader import _collate
    from jarvis_hybridnet_torch.models.weights import params_from_jax
    from jarvis_hybridnet_torch.training import checkpoints
    from jarvis_hybridnet_torch.training.train_interface import train_efficienttrack
    from jarvis_hybridnet_torch.training.trainer2d import host_batch
    from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
    from jarvis_hybridnet_torch.utils.transfer import HostToDevice

    parent = os.environ["JARVIS_PARENT_DIR"]
    prof_path = os.path.join(REPO, "chiprun_out", "chip_smoke_train2d_profile.txt")
    open(prof_path, "w").close()
    runs, steps = {}, {}
    for net in NETS_2D:
        start = params_from_jax(read_ckpt(ckpt[net]), "small")
        res = {}
        t0 = time.perf_counter()
        ok, counts = path_launches(
            lambda: train_efficienttrack(net, "Train", TRAIN_EPOCHS, ckpt[net], run_name="Run",
                                         device="cuda", results=res, graph=False),
            kernels, TRAIN2D_KERNELS, f"train2d_{net}", recorder)
        run_s = time.perf_counter() - t0
        if not ok:
            fail(f"train_efficienttrack {net} did not finish")
        runs[net] = counts
        trainer, hist = res["trainer"], res["history"]
        n_train = len(Dataset2D(trainer.main_cfg, set="train", mode=net))
        losses = hist["train_loss"] + hist["val_loss"]
        note(f"training 2D {net}: train_efficienttrack, {TRAIN_EPOCHS} epochs of "
             f"{n_train // 4} steps (batch 4 of {n_train} images) and a val pass each, "
             f"{run_s:.2f} s (data loading, decode, checkpoints included); history "
             f"{json.dumps(hist)}; launches {json.dumps(counts)}")
        if not all(math.isfinite(v) for v in losses + hist["train_acc"]):
            fail(f"non-finite 2D training loss or accuracy: {hist}")
        state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
        live = [n for n, p in trainer.model.named_parameters() if p.grad is not None]
        moved = [k for k in live if not torch.equal(state[k], start[k])]
        head = ("deconv1.weight", "final_conv1.weight")
        final = os.path.join(parent, "projects", "Train", "models", net, "Run",
                             "EfficientTrack-small_final")
        back = params_from_jax(read_ckpt(final + ".ckpt"), "small")
        pth = checkpoints.load_torch_state_dict(final + ".pth")
        same = (set(back) == set(state) == set(pth)
                and all(torch.equal(back[k], state[k]) and torch.equal(pth[k], state[k])
                        for k in state))
        note(f"training 2D {net}: trained weights changed: {len(moved)} of {len(live)} "
             f"(heads {'changed' if all(h in moved for h in head) else 'UNCHANGED'}); "
             f"{os.path.basename(final)}.ckpt and .pth ({len(state)} tensors) reload equal "
             f"to the trained state: {same}")
        if len(moved) < 0.9 * len(live) or not all(h in moved for h in head) or not same:
            fail(f"the {net} run did not train its weights or its checkpoints do not reload")

        ds = Dataset2D(trainer.main_cfg, set="train", mode=net, device_targets=True,
                       device_aug=True)
        arrays, _ = host_batch(_collate([ds[i] for i in range(4)]))
        b = HostToDevice("cuda")(arrays)
        opt = trainer.optimizer
        trainer.model.train()
        steps[net] = step_rate(
            lambda: trainer.train_step(b, opt, 1e-6), 4, prof_path, net, note,
            f"training 2D step {net} (batch 4 of 256^2, "
            f"{23 if net == 'KeypointDetect' else 1} joint(s), float32, AdamW, device color "
            f"augmentation; batch on the card; card: {smi})")
        _, steps[net]["counts"] = path_launches(
            lambda: trainer.train_step(b, opt, 1e-6), kernels, TRAIN2D_KERNELS,
            f"train2d_step_{net}", recorder)
        note(f"training 2D step {net}: launches in one step "
             f"{json.dumps(steps[net]['counts'])}")
    return runs, steps


def _grad_gap(a: dict, b: dict) -> dict:
    """How far gradients ``a`` lie from ``b``: ``elem``, the largest
    |difference| over its tensor's largest |element|, over the convolutions'
    tensors (the conv biases ahead of an InstanceNorm and the tensors below
    1e-6 of the largest weight gradient left out: zero but for round-off);
    ``ahead``, the largest |difference| of those over the largest weight
    gradient; ``fused``, the largest |difference| of the fusion weights'
    gradients (the BiFPN's ``*_w*`` and ``weights_cat``: each a sum over a
    whole feature map, where round-off cancels least) over the largest of
    them; ``top``, the five largest per-tensor gaps."""
    import re

    wmax = max(float(v.abs().max()) for k, v in b.items() if k.endswith("weight"))
    fusion = [k for k in b if re.search(r"_w\d$", k) or k == "weights_cat"]
    fmax = max(float(b[k].abs().max()) for k in fusion)
    elem, ahead, fused, gaps = 0.0, 0.0, 0.0, []
    for k, ref in b.items():
        diff = float((a[k] - ref).abs().max())
        gaps.append((diff / max(float(ref.abs().max()), 1e-30), k))
        if k in fusion:
            fused = max(fused, diff / fmax)
        elif (k.endswith("pointwise_conv.bias") or re.search(r"\.\d\.bias$", k)
                or float(ref.abs().max()) < 1e-6 * wmax):
            ahead = max(ahead, diff / wmax)
        else:
            elem = max(elem, gaps[-1][0])
    top = ", ".join(f"{k} {g:.2e}" for g, k in sorted(gaps, reverse=True)[:5])
    return dict(elem=elem, ahead=ahead, fused=fused, top=top, fusion=len(fusion))


def train2d_card_vs_cpu(ckpt, note) -> None:
    """One KeypointDetect train step on the card against the same step on the
    CPU, float32, TF32 off, drop-connect off (``eval()``), batch 1 of 128^2
    with its color record (blur, the noise at the config's upper bound,
    contrast, gains, a rotated ``minv``: K9's plain version draws the same
    noise), from the committed checkpoint: the loss within 1e-4 relative,
    every convolution's gradient element within GRAD_TOL of its tensor's
    largest, the fusion weights' within GRAD_TOL of the largest fusion-weight
    gradient, the conv biases ahead of an InstanceNorm within 1e-4 of the
    largest weight gradient (``_grad_gap``). The control is the card's step
    with TF32 allowed: the gate must refuse it."""
    import numpy as np
    import torch

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer, host_batch

    pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
    pm.load("Train")
    cfg = pm.get_cfg()
    cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE = 128
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (1, 128, 128, 3), dtype=np.uint8)
    kps = np.zeros((1, 1, 69), np.float32)
    kps[..., 0::3], kps[..., 1::3], kps[..., 2::3] = (rng.uniform(8, 120, (1, 1, 23)),
                                                      rng.uniform(8, 120, (1, 1, 23)), 1.0)
    a = 0.2
    rec = {"blur_sigma": np.array([0.4], np.float32),
           "noise_scale": np.array([cfg.AUGMENTATION.COLOR_MANIPULATION.GAUSSIAN_NOISE.SCALE[1]],
                                   np.float32),
           "noise_pc": np.ones(1, np.float32), "noise_seed": np.array([77], np.uint32),
           "contrast": np.array([1.1], np.float32), "mul": np.array([0.9], np.float32),
           "chan_mul": np.array([[1.05, 0.95, 1.0]], np.float32),
           "minv": np.array([[[np.cos(a), -np.sin(a), 14.0], [np.sin(a), np.cos(a), -11.0]]],
                            np.float32)}
    arrays, _ = host_batch((imgs, kps, rec))

    def step(device, tf32=False):
        trainer = EfficientTrackTrainer("KeypointDetect", cfg, weights=ckpt["KeypointDetect"],
                                        device=device, run_name=f"step2d_{device}")
        model = trainer.model.eval()
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            loss, _ = trainer.forward({k: torch.from_numpy(v).to(device)
                                       for k, v in arrays.items()})
            loss.backward()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        return float(loss.detach()), {n: p.grad.detach().cpu().clone()
                                      for n, p in model.named_parameters()
                                      if p.grad is not None}

    (lc, gc), (lp, gp), (lt, gt) = step("cuda"), step("cpu"), step("cuda", tf32=True)
    gap, control = _grad_gap(gc, gp), _grad_gap(gt, gp)
    note(f"training 2D step, card vs CPU (KeypointDetect, batch 1 of 128^2, float32, TF32 "
         f"off, eval, device color augmentation with noise): loss {lc:.6f} vs {lp:.6f}; the "
         f"convolutions' gradients within {gap['elem']:.2e} of their tensor's max per element "
         f"(tol {GRAD_TOL:g}); the {gap['fusion']} fusion weights' within {gap['fused']:.2e} of "
         f"the largest fusion-weight gradient (tol {GRAD_TOL:g}); the biases ahead of an "
         f"InstanceNorm within {gap['ahead']:.2e} of the largest weight gradient (tol 1e-4); "
         f"largest per-tensor gaps (information): {gap['top']}")
    note(f"training 2D step control, the card with TF32 allowed against the CPU: loss "
         f"{lt:.6f}, the convolutions' gradients within {control['elem']:.2e} of their "
         f"tensor's max (largest: {control['top']}): "
         f"{'refused' if control['elem'] > GRAD_TOL else 'NOT refused'} by the gate")
    if (abs(lc - lp) > 1e-4 * abs(lp) or gap["elem"] > GRAD_TOL or gap["fused"] > GRAD_TOL
            or gap["ahead"] > 1e-4):
        fail("the 2D training step on the card disagrees with the CPU step")
    if control["elem"] <= GRAD_TOL:
        fail("the card-vs-CPU 2D training gate does not tell a TF32 step from a float32 one")


def check_k8(kernels, recorder, runs, path_counts, note) -> list:
    """K8 at every (heads, input size, sigma, dtype) a driven path gave it,
    against its plain version: the loss within 1e-6 relative, both heads'
    gradients equal to the plain version's bit for bit (at bf16 heads: both
    compute the float32 gradient and round it once; stricter than the 1 bf16
    ulp of JAX's the tests hold the plain version to), two calls of each
    bit-equal; each key timed (forward and backward: device, wall, plain,
    bound). The kernels line: each net's training key, and its bf16 one."""
    import torch

    from jarvis_hybridnet_torch.kernels.heatmap2d_loss import walk_plan

    entries = []
    for key, (args, per) in recorder.k8.items():
        out4, out2, kps, size, base = args
        dl = torch.ones((), device=out4.device)
        kl, km = kernels.heatmap2d_loss_fwd(*args)
        kl2, km2 = kernels.heatmap2d_loss_fwd(*args)
        pl, pm = kernels.heatmap2d_loss_fwd_plain(*args)
        kg = kernels.heatmap2d_loss_bwd(*args, dl)
        kg2 = kernels.heatmap2d_loss_bwd(*args, dl)
        pg = kernels.heatmap2d_loss_bwd_plain(*args, dl)
        lrel = abs(float(kl) - float(pl)) / max(abs(float(pl)), 1e-30)
        grel = max(float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)
                   for k, p in zip(kg, pg))
        gsame = all(torch.equal(k, p) for k, p in zip(kg, pg))
        twice = (torch.equal(kl, kl2) and torch.equal(km, km2)
                 and all(torch.equal(a, b) for a, b in zip(kg, kg2)))
        fwd_bytes = (out4.numel() + out2.numel()) * out4.element_size()
        timing = {}
        for name, call, plain, nbytes in (
                ("fwd", lambda: kernels.heatmap2d_loss_fwd(*args),
                 lambda: kernels.heatmap2d_loss_fwd_plain(*args), fwd_bytes),
                ("bwd", lambda: kernels.heatmap2d_loss_bwd(*args, dl),
                 lambda: kernels.heatmap2d_loss_bwd_plain(*args, dl), 2 * fwd_bytes)):
            timing[name] = dict(ms=graph_ms(call), wall_ms=cuda_ms(call),
                                plain_ms=cuda_ms(plain, iters=5),
                                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        walks = walk_plan(
            out4.shape[0], out4.shape[1], tuple((*o.shape[2:], int(not o.is_contiguous()))
                                                for o in (out4, out2)))
        note(f"heatmap2d_loss out4 {key[0]} strides {key[1]}, out2 {key[2]}, {out4.dtype}, "
             f"input {size}, sigma base {base} (calls per path {json.dumps(per)}): loss "
             f"{float(kl):.6f} vs "
             f"plain {float(pl):.6f} ({lrel:.2e} relative, tol 1e-6), gradients "
             f"{'equal' if gsame else f'DIFFER ({grel:.2e} of max)'} (tol 0), two calls "
             f"{'bit-equal' if twice else 'DIFFER'}; forward device "
             f"{timing['fwd']['ms']:.4f} ms, wall {timing['fwd']['wall_ms']:.4f}, plain "
             f"{timing['fwd']['plain_ms']:.4f}, bound {timing['fwd']['bound_ms']:.4f}; backward "
             f"device {timing['bwd']['ms']:.4f}, wall {timing['bwd']['wall_ms']:.4f}, plain "
             f"{timing['bwd']['plain_ms']:.4f}, bound {timing['bwd']['bound_ms']:.4f}; "
             f"walks {walks}")
        if lrel > 1e-6 or not gsame or not twice:
            fail("heatmap2d_loss differs from its plain version, or between two calls")
        net = next((n for n in NETS_2D if f"train2d_{n}" in per), None)
        bnet = next((n for n in NETS_2D if bf16_path(n) in per), None)
        if net is None and bnet is None:
            continue
        for name, err in (("fwd", abs(float(kl) - float(pl))),
                          ("bwd", max(float((k - p).abs().max()) for k, p in zip(kg, pg)))):
            wrapper = f"heatmap2d_loss_{name}"
            if net is None:
                launches, label = path_counts[bf16_path(bnet)][wrapper], f"[bf16 {bnet}]"
            else:
                launches = runs[net][wrapper]
                label = "" if net == "KeypointDetect" else f"[{net}]"
            entries.append(dict(
                name=wrapper + label, route="cuda",
                kernels_per_call=1, source="jarvis_hybridnet_torch/kernels/csrc/heatmap2d_loss.cu",
                replaces="jarvis_hybridnet_tpu/training/trainer2d.py:31",
                launches=launches, max_abs_err=err, bound_by="bytes",
                library_ms=None, per="train2d step", dtype=str(out4.dtype).split(".")[-1],
                **timing[name]))
    return entries


# K9's edge keys: (label, lead, record, border, keyword arguments of k9_args)
K9_EDGE_KEYS = (
    ("radius 0 with a record", (2,), True, True, dict(h=64, w=64, radius=0)),
    ("radius 1", (2,), True, True, dict(h=64, w=64, radius=1)),
    ("radius 2", (2,), True, False, dict(h=64, w=64, radius=2)),
    ("radius 5", (2,), True, True, dict(h=64, w=64, radius=5)),
    ("radius 12", (2,), True, False, dict(h=64, w=64, radius=12)),
    ("N = 1, 37 x 53", (1,), True, True, dict(h=37, w=53, radius=2)),
    ("N = 1, 37 x 53, radius 12", (1,), True, False, dict(h=37, w=53, radius=12)),
    ("W * 3 = 60, not a multiple of 16", (3,), True, True, dict(h=24, w=20, radius=2)),
    ("H, W <= R", (2,), True, False, dict(h=3, w=2, radius=5)),
    ("unaligned lead view (images 1-2 of 3)", (2,), True, True, dict(h=37, w=53, view=True)),
    ("base 1 byte past a word, W % 4 == 0", (2,), True, False, dict(h=32, w=64, offset=1)),
    ("base 1 byte past a word, no record", (2,), False, False, dict(h=32, w=64, offset=1)),
    ("no record, 37 x 53 (bytes not a multiple of 4)", (1,), False, False, dict(h=37, w=53)),
    ("border without a record", (2,), False, True, dict(h=64, w=64)),
    ("noise_pc 0 / 1 mixed", (4,), True, False, dict(h=64, w=64, noise_pc=[0, 1, 0, 1])),
    ("blur_sigma <= 1e-3 (the delta taps)", (2,), True, False,
     dict(h=64, w=64, blur_sigma=[1e-3, 0.0])),
    ("contrast 1", (2,), True, False, dict(h=64, w=64, contrast=1.0)),
)


def k9_args(lead, record, border, dev, h=256, w=256, radius=2, seed=0, offset=0, view=False,
            **fixed):
    """Seeded arguments of K9 as a train step gives them: uint8 images
    ``lead + (h, w, 3)``, the default config's color record (or None) with
    every image blurred (sigma in (0.05, 0.5)) and ``noise_scale`` at the
    config's upper bound, a rotated and scaled ``minv`` whose source leaves
    the frame (or None), the dataset's mean and std; ``fixed`` sets record
    leaves (``noise_pc``, ``blur_sigma``, ``contrast``) to a value or one
    per image. ``offset``: the images start that many bytes past an aligned
    buffer's base; ``view``: they are images 1.. of one more (and the record
    and ``minv`` views of theirs). Returns the positional arguments of
    ``color_aug``."""
    import numpy as np
    import torch

    from jarvis_hybridnet_torch.config.defaults import get_default_cfg
    from jarvis_hybridnet_torch.ops.augment import record_arrays, sample_color_params

    cfg = get_default_cfg()
    cm = cfg.AUGMENTATION.COLOR_MANIPULATION
    rng = np.random.default_rng(seed)
    full = ((lead[0] + 1,) + lead[1:]) if view else lead
    n = math.prod(full)
    pix = rng.integers(0, 256, full + (h, w, 3), dtype=np.uint8)
    buf = torch.empty(pix.size + offset, dtype=torch.uint8, device=dev)
    imgs = buf[offset:].view(full + (h, w, 3))
    imgs.copy_(torch.from_numpy(pix))
    params = minv = None
    if record:
        rec = sample_color_params(cm, rng, n)
        rec["blur_sigma"] = rng.uniform(0.05, 0.5, n).astype(np.float32)
        rec["noise_scale"][:] = float(cm.GAUSSIAN_NOISE.SCALE[1])
        for k, v in fixed.items():
            rec[k][:] = np.resize(np.asarray(v, rec[k].dtype), n)
        params = {k[4:]: torch.from_numpy(v.reshape(full + v.shape[1:])).to(dev)
                  for k, v in record_arrays(rec).items()}
    if border:
        m = np.zeros((n, 2, 3), np.float32)
        for i, a in enumerate(rng.uniform(-0.6, 0.6, n)):
            s, cx, cy = rng.uniform(0.8, 1.2), (w - 1) / 2, (h - 1) / 2
            r = s * np.array([[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]])
            m[i, :, :2] = r
            m[i, :, 2] = np.array([cx, cy]) - r @ np.array([cx, cy]) + rng.uniform(-20, 20, 2)
        minv = torch.from_numpy(m.reshape(full + (2, 3))).to(dev)
    if view:
        imgs = imgs[1:]
        params = None if params is None else {k: v[1:] for k, v in params.items()}
        minv = None if minv is None else minv[1:]
    return (imgs, params, tuple(cfg.DATASET.MEAN), tuple(cfg.DATASET.STD), minv,
            radius if record else 0, record)


# The fewest SASS instructions that any input runs through each precise
# function of K9's noise, beyond the same loads and stores
# (``kernel_sweep.py --only k9ops``: nvcc 12.9, sm_90a, --fmad=false)
K9_PRECISE_OPS = {"logf": 27, "sqrtf": 7, "cosf": 24, "sincosf": 27}
# float32 instructions a second outside the tensor cores (H100 SXM data
# sheet: 67 TFLOP/s, an FMA counted as two)
FP32_OPS_PER_S = 67e12 / 2


def k9_ops(args) -> dict:
    """The instructions a pixel that K9's function needs at one call's
    arguments, by term, whatever the kernel's own layout: per channel a
    conversion and a division (3 fused operations after a reciprocal per
    call) for /255 and a subtraction and a division for the normalize; with
    a record the color (contrast's 3 where the image's contrast is not 1,
    the two gains, the clamp's 2), the blur's 2R + 1 products and 2R sums a
    pass, two passes, and the noise: Philox-4x32-10 (a counter and 10 rounds
    of 2 wide products and 2 three-input XORs), 3 a word for the uniforms,
    Box-Muller's products and precise functions (``K9_PRECISE_OPS``) and
    the noise's product and sums, for noise_pc 1 (four words, three normals)
    and 0 (two words, one normal), weighted by this call's images; the
    border: a conversion, two affine rows of a product and two sums, 4
    compares and 3 selects. Data-dependent shares are this call's."""
    imgs, params, _, _, minv, radius, noise = args
    pre = K9_PRECISE_OPS
    ops = {"/255 and normalize": 3 * (1 + 3) + 3 * (1 + 3)}
    if params is not None:
        con = float((params["contrast"] != 1).float().mean())
        ops["color"] = 3 * (3 * con + 2 + 2)
        if radius > 0:
            ops["blur"] = 3 * 2 * ((2 * radius + 1) + 2 * radius)
        if noise:
            pc = float((params["noise_pc"] != 0).float().mean())
            pc1 = 4 * 3 + 7 + 2 * pre["logf"] + 2 * pre["sqrtf"] + pre["sincosf"] + pre["cosf"] + 3 * 2
            pc0 = 2 * 3 + 3 + pre["logf"] + pre["sqrtf"] + pre["cosf"] + 1 + 3
            ops["noise"] = 1 + 10 * 4 + pc * pc1 + (1 - pc) * pc0
    if minv is not None:
        ops["border"] = 1 + 2 * 3 + 4 + 3
    return ops


def check_k9(kernels, recorder, cfg, runs, train_counts, baseline, base_log, note) -> list:
    """K9 at every (images, record, border, blur) a driven path gave it and at
    the edge keys of ``K9_EDGE_KEYS``, against its plain version, with the
    record's ``noise_scale`` at the config's upper bound on every image: the
    [0, 1] image (mean 0, std 1) within 2e-6, the normalized one within 2e-6
    / min(std), two calls bit-equal and, with a baseline, equal to the
    baseline's bit for bit. Each recorded key is timed (device, wall, plain;
    with a baseline in turns with it) beside its bound: the larger of the
    bytes (the uint8 read and the float32 written) and the function's
    operations (``k9_ops``) at the float32 rate. The kernels line: the 2D
    KeypointDetect train key and the 3D train key."""
    import importlib

    import torch

    k9 = importlib.import_module("jarvis_hybridnet_torch.kernels.color_aug")
    upper = float(cfg.AUGMENTATION.COLOR_MANIPULATION.GAUSSIAN_NOISE.SCALE[1])

    def held(full, label):
        """Both gates, two calls and the baseline; returns the gaps."""
        std = full[3]
        unit = full[:2] + ((0.0,) * 3, (1.0,) * 3) + full[4:]
        errs = []
        for a, tol in ((unit, 2e-6), (full, 2e-6 / min(std))):
            k, k2, p = kernels.color_aug(*a), kernels.color_aug(*a), kernels.color_aug_plain(*a)
            errs.append(float((k - p).abs().max()))
            if errs[-1] > tol or not torch.equal(k, k2):
                fail(f"color_aug {label} differs from its plain version by {errs[-1]} (tol "
                     f"{tol:.2e}) or between two calls")
            if baseline is not None and not torch.equal(k, baseline(*a)):
                fail(f"color_aug {label} differs from the baseline design")
        return errs

    entries = []
    for key, (args, per) in recorder.k9.items():
        imgs, params, mean, std, minv, radius, noise = args
        if params is not None:
            params = dict(params, noise_scale=torch.full_like(params["noise_scale"], upper))
        full = (imgs, params, mean, std, minv, radius, noise)
        errs = held(full, str(key))
        plan = k9.plan_of(full[0], full[1], full[4], full[5])
        bytes_ms = imgs.numel() * (1 + 4) / HBM_BYTES_PER_S * 1e3
        ops = k9_ops(full)
        ops_ms = imgs.numel() // 3 * sum(ops.values()) / FP32_OPS_PER_S * 1e3
        t = dict(ms=graph_ms(lambda: kernels.color_aug(*full)),
                 wall_ms=cuda_ms(lambda: kernels.color_aug(*full)),
                 plain_ms=cuda_ms(lambda: kernels.color_aug_plain(*full), iters=5),
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        base = ""
        if baseline is not None:
            cur, t["baseline_ms"] = against_baseline(
                lambda: kernels.color_aug(*full), lambda: baseline(*full),
                lambda new, old: None)
            base = f", baseline {t['baseline_ms']:.4f} (in turns: current {cur:.4f})"
            base_log.write(f"K9 color_aug {key[0]} record {key[1]} border {key[2]} radius "
                           f"{key[3]} (calls per path {json.dumps(per)}): current {cur:.4f} ms, "
                           f"baseline {t['baseline_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                           f"({t['bound_by']}); outputs equal\n")
        note(f"color_aug {key[0]} record {key[1]} border {key[2]} radius {key[3]} (calls per "
             f"path {json.dumps(per)}): [0, 1] image {errs[0]:.2e} from the plain version (tol "
             f"2e-6), normalized {errs[1]:.2e} (tol {2e-6 / min(std):.2e}), noise at "
             f"{upper:g} on every image, two calls bit-equal"
             + (", equal to the baseline" if baseline is not None else "")
             + f"; device {t['ms']:.4f} ms, wall {t['wall_ms']:.4f}, plain {t['plain_ms']:.4f},"
             f" bound {t['bound_ms']:.4f} ({t['bound_by']}: bytes {bytes_ms:.4f}, operations "
             f"{ops_ms:.4f} at {sum(ops.values()):.1f} instructions a pixel: "
             + ", ".join(f"{k} {v:.1f}" for k, v in ops.items()) + f"){base}; {plan}")
        if not key[1]:
            continue
        if "train2d_KeypointDetect" in per:
            name, launches = "color_aug", runs["KeypointDetect"]["color_aug"]
        elif "training" in per:
            name, launches = "color_aug[3d]", train_counts["color_aug"]
        else:
            continue
        entries.append(dict(
            name=name, route="cuda", kernels_per_call=1,
            source="jarvis_hybridnet_torch/kernels/csrc/color_aug.cu",
            replaces="jarvis_hybridnet_tpu/ops/augment.py:161", launches=launches,
            max_abs_err=errs[1], library_ms=None, input_shape=list(key[0]), **t))
    dev = torch.device("cuda")
    for label, lead, record, border, kw in K9_EDGE_KEYS:
        full = k9_args(lead, record, border, dev, **kw)
        errs = held(full, f"edge key {label}")
        note(f"color_aug edge key {label}: images {tuple(full[0].shape)} base "
             f"{full[0].data_ptr() % 16} past 16 bytes, record {record}, border {border}, radius "
             f"{full[5]}: [0, 1] image {errs[0]:.2e} from the plain version (tol 2e-6), "
             f"normalized {errs[1]:.2e}, two calls bit-equal"
             + (", equal to the baseline" if baseline is not None else "")
             + f"; {k9.plan_of(full[0], full[1], full[4], full[5])}")
    return entries


def same_argmax(a, b) -> bool:
    """Equal K10 outputs (xy, maxv): integers equal, maxima NaN where NaN and
    else the same bits (so -0.0 and +0.0 differ)."""
    import torch

    (ax, am), (bx, bm) = a, b
    nan = torch.isnan(am)
    return bool(torch.equal(ax, bx) and torch.equal(nan, torch.isnan(bm)) and torch.equal(
        am.view(torch.int32)[~nan], bm.view(torch.int32)[~nan]))


def k10_edge_batch(dtype, layout: str, dev):
    """Heads (N, H, W, C) of hand-made maps, as the callers pass them (a
    permuted view of channels-last or contiguous NCHW memory; "single": (12,
    24, 32, 1), else (4, 12, 16, 23)): ties, an
    all-zero map, -0.0 before +0.0 and the reverse, NaN (one; two; beside
    +inf), +-inf, a constant map, the maximum in the last pixel, all -inf;
    the rest seeded noise."""
    import torch

    h, w, c, n = (24, 32, 1, 12) if layout == "single" else (12, 16, 23, 4)
    g = torch.Generator().manual_seed(7)
    m = torch.randn((n * c, h, w), generator=g).to(dtype).float()
    nan, inf = float("nan"), float("inf")
    m[0] = 0.0
    m[1] = -1.0
    m[1, 1, 2] = m[1, h - 1, 0] = m[1, 0, w - 1] = 3.0
    m[2] = -5.0
    m[2, 0, 1], m[2, 1, 0] = -0.0, 0.0
    m[3] = -5.0
    m[3, 0, 1], m[3, 1, 0] = 0.0, -0.0
    m[4] = -inf
    m[4, h - 1, w - 1] = -0.0
    m[5, h // 2, 1], m[5, 0, 0] = nan, inf
    m[6, h - 1, w - 1] = m[6, 1, 1] = nan
    m[7] = 2.5
    m[8, h - 1, w - 1] = 100.0
    m[9, 2, 3] = m[9, h - 1, 1] = inf
    m[10] = -inf
    t = m.reshape(n, c, h, w).to(dtype).to(dev)
    if layout == "channels_last":
        t = t.contiguous(memory_format=torch.channels_last)
    return t.permute(0, 2, 3, 1)


def check_k10(kernels, recorder, path_counts, note) -> list:
    """K10 at every (heatmaps shape, dtype, strides) a driven path gave it,
    against its plain version: integers and maxima identical, two calls
    bit-equal, and the same under other plans that merge more shares
    (``argmax2d.launch``, which counts no launch); each
    key timed (device, wall, plain, bound: the heatmaps read once and 12
    bytes written a channel) beside ``torch.max`` over the flattened view
    (``library_ms``, the copy the layout needs included; ``library_max_ms``
    without it). Then the hand-made edge
    batches (``k10_edge_batch``) in both dtypes and layouts. The kernels
    line: the predict3D main path's key, predict2D's keypoint key and the 2D
    KeypointDetect train step's key."""
    import importlib

    import torch

    k10 = importlib.import_module("jarvis_hybridnet_torch.kernels.argmax2d")

    def held(hm, label):
        """The wrapper's call twice, and the other plans of ``others``,
        against the plain version."""
        k, k2, p = kernels.argmax2d(hm), kernels.argmax2d(hm), k10.argmax_2d_plain(hm)
        if not (same_argmax(k, p) and same_argmax(k, k2)):
            fail(f"argmax2d {label} differs from its plain version or between two calls "
                 f"({k10.plan_of(hm)})")
        alts = others(hm)
        for plan in alts:
            if not same_argmax(k10.launch(hm, plan), p):
                fail(f"argmax2d {label} differs from its plain version under {plan}")
        return k10.plan_of(hm), len(alts)

    def others(hm):
        """Plans besides the wrapper's that merge over shares: about 1056
        CTAs, and 32-thread CTAs of two vectors a thread (many shares)."""
        plans = {k10.plan_of(hm, ctas=c, threads=t) for c, t in ((1056, k10.THREADS),
                                                                (4096, 32))}
        return sorted((q for q in plans if q.shares > 1 and q != k10.plan_of(hm)), key=str)

    entries, done = [], set()
    for key, (args, per) in recorder.k10.items():
        (hm,) = args
        n, h, w, c = hm.shape
        plan, n_other = held(hm, str(key))
        flat = hm.permute(0, 3, 1, 2).reshape(n, c, h * w).contiguous()
        t = dict(ms=graph_ms(lambda: kernels.argmax2d(hm)),
                 wall_ms=cuda_ms(lambda: kernels.argmax2d(hm)),
                 plain_ms=cuda_ms(lambda: k10.argmax_2d_plain(hm), iters=5),
                 library_ms=graph_ms(lambda: torch.max(hm.permute(0, 3, 1, 2).reshape(
                     n, c, h * w), dim=-1)),
                 library_max_ms=graph_ms(lambda: torch.max(flat, dim=-1)),
                 bound_ms=(hm.numel() * hm.element_size() + n * c * 12) / HBM_BYTES_PER_S * 1e3)
        note(f"argmax2d {key[0]} {key[1]} strides {key[2]} (calls per path {json.dumps(per)}): "
             f"integers and maxima identical, two calls bit-equal, {n_other} other plans "
             f"identical; "
             f"device {t['ms']:.4f} ms, wall {t['wall_ms']:.4f}, plain {t['plain_ms']:.4f}, "
             f"torch.max {t['library_ms']:.4f} (without the layout's copy "
             f"{t['library_max_ms']:.4f}), bound {t['bound_ms']:.4f}; {plan}")
        for path, name in (("quarter_fused", "argmax2d"), ("predict2d", "argmax2d[predict2d]"),
                           ("train2d_step_KeypointDetect", "argmax2d[train2d]")):
            if path in per and name not in done and (path != "predict2d" or c > 1):
                done.add(name)
                entries.append(dict(
                    name=name, route="cuda", kernels_per_call=1,
                    source="jarvis_hybridnet_torch/kernels/csrc/argmax2d.cu",
                    replaces="jarvis_hybridnet_tpu/ops/heatmap.py:15",
                    launches=path_counts[path]["argmax2d"], max_abs_err=0.0, bound_by="bytes",
                    input_shape=list(key[0]), input_dtype=str(key[1]).replace("torch.", ""),
                    **t))
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ("channels_last", "contiguous", "single"):
            hm = k10_edge_batch(dtype, layout, dev)
            plan, n_other = held(hm, f"edge batch {tuple(hm.shape)} {dtype} {layout}")
            note(f"argmax2d edge batch {tuple(hm.shape)} {dtype} {layout} strides "
                 f"{hm.stride()}: identical to the plain version (maxima bit for bit, NaN "
                 f"where NaN), two calls and {n_other} other plans too; {plan}")
    return entries


# The train and eval steps as captured CUDA graphs (training/graphed.py):
# (label, net, freeze mode, repro mode) of each training path, every
# hand-written kernel a train step launches with its __global__ symbols as
# torch.profiler names them, and the learning rate of each compared step
TRAIN_GRAPH_PATHS = (("3D_only", "HybridNet", "3D_only", "quarter_fused"),
                     ("all", "HybridNet", "all", "quarter_fused"),
                     ("bifpn", "HybridNet", "bifpn", "quarter_fused"),
                     ("last_layers", "HybridNet", "last_layers", "quarter_fused"),
                     ("all exact", "HybridNet", "all", "exact"),
                     ("all half_fused", "HybridNet", "all", "half_fused"),
                     ("all half", "HybridNet", "all", "half"),
                     ("CenterDetect", "CenterDetect", None, None),
                     ("KeypointDetect", "KeypointDetect", None, None))
TRAIN_KERNEL_SYMBOLS = {
    "instance_norm_act": r"\bin_fused<", "instance_norm_act_backward": r"\bk6_backward<",
    "hybridnet_loss_fwd": r"\bk7_forward\b", "hybridnet_loss_bwd": r"\bk7_backward\b",
    "heatmap2d_loss_fwd": r"\bk8_forward\b", "heatmap2d_loss_bwd": r"\bk8_backward\b",
    "color_aug": r"\bk9_(bands|flat)\b", "argmax2d": r"\bk10<",
    "repro_quarter_gather": r"\brepro_tile<", "repro_grid_gather": r"\brepro_grid<",
    "repro_quarter_gather_backward": r"\bgather_backward\b",
    "repro_grid_gather_backward": r"\b(grid|point)_backward\b", "soft_argmax": r"\bsa_cluster<"}
TRAIN_GRAPH_LRS = (2e-4, 5e-5, 3e-4, 1e-4, 1.5e-4)  # 2 eager steps, a capture, 2 replays
# where two eager steps from the same state differ (K11 / K12 add with float
# atomics), a replay's distance to its eager twin and the eager twins' own
# distance are draws of one distribution, so a replay beyond one eager gap
# is no fault in itself: the replay is held within GAP_FACTOR times the
# largest eager gap (max and RMS), as K11 / K12 are held within twice the
# float32 plain version's error
GAP_FACTOR = 2.0


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block: two eager steps
    from one state then differ only where the port's own kernels add with
    atomics (K11, K12), and a replay can be held to its eager twin bit for
    bit everywhere else. The rates are measured outside it."""
    import torch

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def twin_state(out, trainer, opt) -> list:
    """A step's outputs, the model's state and the optimizer's moments and
    step counts, as one list of tensors."""
    import torch

    return [*out, *trainer.model.state_dict().values(),
            *(v for s in opt.state.values() for v in s.values() if isinstance(v, torch.Tensor))]


def sync_twin(dst, src) -> None:
    """``dst`` (trainer, optimizer) put in ``src``'s state, in place: the
    model's tensors, the optimizer's state and the generator's."""
    import torch

    (dt, dopt), (st, sopt) = dst, src
    with torch.no_grad():
        for a, b in zip(dt.model.state_dict().values(), st.model.state_dict().values()):
            a.copy_(b)
    for dp, sp in zip((p for g in dopt.param_groups for p in g["params"]),
                      (p for g in sopt.param_groups for p in g["params"])):
        for k, v in sopt.state.get(sp, {}).items():
            if k in dopt.state[dp]:
                dopt.state[dp][k].copy_(v)
            else:
                dopt.state[dp][k] = v.clone()
    dt.generator.set_state(st.generator.get_state())


def twin_gap(a: list, b: list) -> tuple:
    """(bit-equal, the largest |difference|, the RMS difference) over every
    element of two lists of tensors."""
    import torch

    if all(torch.equal(x, y) for x, y in zip(a, b)):
        return True, 0.0, 0.0
    sq, n, worst = 0.0, 0, 0.0
    for x, y in zip(a, b):
        d = (x.double() - y.double()).flatten()
        if d.numel():
            worst = max(worst, float(d.abs().max()))
            sq, n = sq + float(d.square().sum()), n + d.numel()
    return False, worst, math.sqrt(sq / max(n, 1))


def twin_verdict(eager: list, graphed: list) -> tuple:
    """The rule over the compared steps: where every pair of eager twins was
    bit-equal, every replay bit-equal to its eager twin; else each replay
    within GAP_FACTOR times the largest eager gap (max and RMS). Returns
    (held, 'bit-equal' or the gaps' words)."""
    if all(e[0] for e in eager):
        return all(g[0] for g in graphed), "bit-equal"
    emax, erms = max(e[1] for e in eager), max(e[2] for e in eager)
    gmax, grms = max(g[1] for g in graphed), max(g[2] for g in graphed)
    return (gmax <= GAP_FACTOR * emax and grms <= GAP_FACTOR * erms,
            f"within the eager gap: replay max {gmax:.3e} RMS {grms:.3e} against eager max "
            f"{emax:.3e} RMS {erms:.3e} (tol {GAP_FACTOR:g}x)")


# At bf16 rows the gather's backward (K11, K12) adds float32 sums with
# atomics and rounds them to bf16 once: another order of the adds moves a
# rounding now and then (two calls of K11 / K12 on the card differ in about
# 1e-4 of the rows' gradient elements, by one ulp). Two eager twins,
# launched alike, seldom show it; a replay may. Where such a replay is not
# bit-equal to its eager twin, the outputs and all the gather's backward
# does not reach (V2V's tensors and their AdamW state, the 2D net's buffers
# and AdamW step counts) are held bit-equal, and the 2D net tensor by
# tensor (``live_groups``): each AdamW moment's distance to the eager
# twin's over its RMS (exp_avg takes 0.1 of the step's gradient,
# exp_avg_sq 0.001 of its square), each parameter's over the step's own
# move of it, the median tensor of each within BF16_FLIP_MEDIAN and every
# tensor within BF16_FLIP_TENSOR. The bf16 backward through the 2D net
# spreads one flip over every tensor at bf16's own noise: on the CPU
# (``test_chip_smoke_flip_rule``, the small rig) a flip of 1e-4 to 1e-2 of
# the rows' gradient elements read medians 0.015-0.040 and tensors up to
# 0.155 (SE branches); a rows gradient zeroed, one step old (the other
# batch's) or halved read medians 0.26-1.02 and their largest tensor
# 0.71-2.71. A fault within bf16's noise passes (the rows' gradient 1% too
# small read as a flip)
BF16_FLIP_MEDIAN = 0.1
BF16_FLIP_TENSOR = 0.5


def live_groups(d: dict) -> list:
    """The tensors of ``d`` (the 2D net's names -> tensors) held one by one,
    as lists of names: the BiFPN fusion weights (2-3 values each, sums of
    whole feature maps that cancel) as one group; left out, the ones zero
    but for round-off (a conv bias ahead of an InstanceNorm; a tensor below
    1e-6 of the largest weight's largest element)."""
    import re

    wmax = max(float(v.abs().max()) for k, v in d.items() if k.endswith("weight"))
    fusion = [k for k in d if re.search(r"_w\d$", k) or k.endswith("weights_cat")]
    live = [[k] for k, v in d.items() if k not in fusion and not (
        k.endswith("pointwise_conv.bias") or re.search(r"\.\d\.bias$", k)
        or float(v.abs().max()) < 1e-6 * wmax)]
    return live + ([fusion] if fusion else [])


def group_gaps(a: dict, b: dict, groups: list, scale: dict | None = None) -> list:
    """(RMS(a - b) / RMS(scale, else b), the group's first name) for each
    group of ``live_groups``, every group's tensors as one vector."""
    import torch

    def cat(d, g):
        return torch.cat([d[k].double().flatten() for k in g])

    ref = b if scale is None else scale
    return [(float((cat(a, g) - cat(b, g)).square().mean().sqrt()
                   / cat(ref, g).square().mean().sqrt().clamp_min(1e-300)), g[0])
            for g in groups]


def split_state(out, trainer, opt, before: dict) -> tuple:
    """A copy of a step's state in two parts: a list of the tensors a bf16
    rounding flip in the gather's backward cannot reach (the outputs, V2V's
    tensors and their optimizer state, the 2D net's buffers and step
    counts), and for the 2D net (``effTrack.``) name -> tensor dicts of its
    parameters (``p``), their move in the step from ``before`` (``move``)
    and AdamW's moments (``m``, ``v``). Copies: the next step and
    ``sync_twin`` write the live tensors."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    params = dict(trainer.model.named_parameters())
    up = list(out)
    down = {"p": {}, "move": {}, "m": {}, "v": {}}
    for n, t in trainer.model.state_dict().items():
        if not n.startswith("effTrack."):
            up.append(t)
        elif n in params:
            down["p"][n] = t
            down["move"][n] = t - before[n]
        else:
            up.append(t)
    for p, st in opt.state.items():
        n = names[id(p)]
        if not n.startswith("effTrack."):
            up.extend(v for v in st.values() if hasattr(v, "dtype"))
            continue
        up.append(st["step"])
        down["m"][n], down["v"][n] = st["exp_avg"], st["exp_avg_sq"]
    return ([t.detach().clone() for t in up],
            {k: {n: t.detach().clone() for n, t in d.items()} for k, d in down.items()})


def flip_verdict(pairs: list) -> tuple:
    """(held, words) over (replay, eager twin) pairs of ``split_state``s:
    the first parts bit-equal; in the second, over the live groups
    (``live_groups`` of the eager twin's exp_avg), each of exp_avg,
    exp_avg_sq (over their RMS) and the parameters (over the step's move):
    the median group within BF16_FLIP_MEDIAN, every group within
    BF16_FLIP_TENSOR."""
    import statistics

    import torch

    same, median, worst = True, {}, {}
    for (ru, rd), (eu, ed) in pairs:
        same = same and all(torch.equal(a, b) for a, b in zip(ru, eu))
        groups = live_groups(ed["m"])
        for kind in ("m", "v", "p"):
            gaps = group_gaps(rd[kind], ed[kind], groups,
                              ed["move"] if kind == "p" else None)
            median[kind] = max(median.get(kind, 0.0), statistics.median(g for g, _ in gaps))
            worst[kind] = max([worst.get(kind, (0.0, "")), *gaps])
    held = same and all(median[k] <= BF16_FLIP_MEDIAN and worst[k][0] <= BF16_FLIP_TENSOR
                        for k in median)
    words = "; ".join(f"{what} median {median[k]:.3e}, largest {worst[k][0]:.3e} ({worst[k][1]})"
                      for k, what in (("m", "exp_avg"), ("v", "exp_avg_sq"),
                                      ("p", "parameters (of the step's move)")))
    return (held, f"a K11 / K12 rounding moved: outputs, V2V's tensors and AdamW state, the 2D "
                  f"net's step counts {'bit-equal' if same else 'DIFFER'}; the 2D net's tensors "
                  f"against the eager twin's: {words} (tol median {BF16_FLIP_MEDIAN:g}, each "
                  f"{BF16_FLIP_TENSOR:g})")


def seeded_set(ds, seed: int = 11):
    """``ds`` with its host augmentation's generators seeded: two runs over it
    with one loader thread draw the same batches."""
    from jarvis_hybridnet_torch.utils.rng import ThreadLocalGenerator

    for obj in (ds, getattr(ds, "augpipe", None)):
        if isinstance(getattr(obj, "rng", None), ThreadLocalGenerator):
            obj.rng = ThreadLocalGenerator(seed)
    return ds


@contextlib.contextmanager
def loop_clock(cls):
    """The host's clock at every ``train_step`` call of ``cls`` inside the
    block, as the trainer's loop reaches it."""
    times = []
    step = cls.train_step

    def timed(self, *args):
        times.append(time.perf_counter())
        return step(self, *args)

    cls.train_step = timed
    try:
        yield times
    finally:
        cls.train_step = step


def loop_rate(times, per_epoch: int, batch: int, skip: int) -> float:
    """Samples a second of a training loop from its steps' call times: the
    batch over the median interval between two calls of one epoch, the
    first ``skip`` calls (warm-up, capture) left out."""
    import statistics

    gaps = [times[i + 1] - times[i] for i in range(skip, len(times) - 1)
            if (i + 1) % per_epoch]
    return batch / statistics.median(gaps)


def train_graph_trainer(cfg, ckpt, net, mode, repro, graph, run_name, mesh=None,
                        optimizer="adamw", device="cuda"):
    """A trainer of ``net`` on the card (or ``device``) from the committed
    checkpoint (3D: in freeze ``mode`` and ``repro`` mode, on ``mesh`` where
    given) in ``train()``, and an ``optimizer`` over its trained
    parameters."""
    from jarvis_hybridnet_torch.training import optim
    from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer
    from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer

    if net == "HybridNet":
        cfg = cfg.clone()
        cfg.TPU.REPRO_MODE = repro
        trainer = HybridNetTrainer("train", cfg, weights=ckpt["HybridNet"], device=device,
                                   run_name=run_name, training_mode=mode, graph=graph,
                                   mesh=mesh)
        params = optim.apply_freeze(trainer.model,
                                    optim.hybridnet_freeze_labels(trainer.model, mode))
    else:
        trainer = EfficientTrackTrainer(net, cfg, weights=ckpt[net], device=device,
                                        run_name=run_name, graph=graph)
        params = list(trainer.model.parameters())
    trainer.model.train()
    return trainer, optim.make_optimizer(optimizer, params, TRAIN_GRAPH_LRS[0])


# (net, seed, the config's text) -> the host arrays of its two train batches
HOST_BATCHES: dict = {}


def train_graph_batches(cfg, net, seed: int = 11) -> list:
    """Two different train batches of ``net``'s step on the card, with their
    color records (3D: framesets 0 and 1; 2D: images 0-3 and 4-7), the host's
    draws seeded with ``seed``. The host arrays are drawn once for each
    (net, seed, config) and uploaded anew for every caller."""
    from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.dataset.loader import _collate
    from jarvis_hybridnet_torch.training import trainer2d, trainer3d
    from jarvis_hybridnet_torch.utils.transfer import HostToDevice

    key = (net, seed, str(cfg))
    if key not in HOST_BATCHES:
        if net == "HybridNet":
            ds = seeded_set(Dataset3D(cfg, set="train", device_targets=True, device_aug=True),
                            seed)
            HOST_BATCHES[key] = [trainer3d.host_batch(_collate([ds[i]])) for i in (0, 1)]
        else:
            ds = seeded_set(Dataset2D(cfg, set="train", mode=net, device_targets=True,
                                      device_aug=True), seed)
            HOST_BATCHES[key] = [
                trainer2d.host_batch(_collate([ds[i] for i in range(k, k + 4)]))[0]
                for k in (0, 4)]
    up = HostToDevice("cuda")
    return [dict(up(h)) for h in HOST_BATCHES[key]]


def train_graph_steps(kernels, cfg, ckpt, label, net, mode, repro, note, smi) -> dict:
    """One training path's steps, eager against graphed. With cuDNN's
    deterministic algorithms (``deterministic_cudnn``) a graphed trainer
    takes 5 train steps (AdamW, an lr that changes every step, two
    alternating batches: 2 eager steps (WARMUP), the capture and its
    replay, 2 more replays), and before each of them two eager trainers are
    put in its state (``sync_twin``) and take the same step, the first of
    them after its first step under ``torch.cuda.set_sync_debug_mode
    ("error")``; the three steps' outputs, parameters and AdamW state are
    compared (``twin_verdict``); then 5 eval steps the same way. Then, with
    cuDNN as a user runs it, the first eager twin and the graphed twin
    recaptured, at SHORT depth: rates (at lr 1e-6), the host's issue time, the
    eager run's launch counts, and a profiled graphed run (event span,
    kernel time, busy share) whose calls of the hand-written kernels equal
    them (``graphed_profile``); capture ms, pool bytes and the batch's copy
    into the static buffers."""
    import torch

    from jarvis_hybridnet_torch.training import graphed

    batch = 1 if net == "HybridNet" else 4
    unit = "framesets/s" if net == "HybridNet" else "images/s"
    batches = train_graph_batches(cfg, net)
    res = {"label": label}
    with deterministic_cudnn():
        twins = [train_graph_trainer(cfg, ckpt, net, mode, repro, g, f"Twin{i}_{label}")
                 for i, g in enumerate((False, False, True))]
        for kind in ("train", "eval"):
            eager_gaps, graph_gaps, splits, eager_splits = [], [], [], []
            flips = (kind == "train" and net == "HybridNet" and mode != "3D_only"
                     and str(cfg.TPU.get("TRAIN_DTYPE", "float32")) == "bfloat16")
            for n, lr in enumerate(TRAIN_GRAPH_LRS):
                b = batches[n % 2]
                outs = []
                before = ({k: p.detach().clone() for k, p in twins[2][0].model.named_parameters()
                           if k.startswith("effTrack.")} if flips else None)
                for i, (trainer, opt) in enumerate(twins):
                    if i < 2:
                        sync_twin(twins[i], twins[2])
                    if i == 0 and n:
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        outs.append(trainer.train_step(b, opt, lr) if kind == "train"
                                    else trainer.eval_step(b))
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                states = [twin_state(o, t, opt) for o, (t, opt) in zip(outs, twins)]
                eager_gaps.append(twin_gap(states[1], states[0]))
                if flips:
                    parts = [split_state(o, t, opt, before) for o, (t, opt) in zip(outs, twins)]
                    if not eager_gaps[-1][0]:
                        eager_splits.append((parts[1], parts[0]))
                if n >= graphed.WARMUP:  # the capture's replay and the replays after it
                    graph_gaps.append(twin_gap(states[2], states[0]))
                    if flips and not graph_gaps[-1][0]:
                        splits.append((parts[2], parts[0]))
            held, words = twin_verdict(eager_gaps, graph_gaps)
            if flips and not held:
                held, words = flip_verdict(splits)
            if flips and (splits or eager_splits):
                note(f"train graph {label} {kind}: the flip rule's readings (information where "
                     f"the rule above is not it): the replays that differ: "
                     f"{flip_verdict(splits)[1] if splits else 'none'}; the eager twins that "
                     f"differ: {flip_verdict(eager_splits)[1] if eager_splits else 'none'}")
            step = twins[2][0].graphs.steps[kind][1]
            res[kind] = dict(held=held, words=words, captures=len(step.graphs))
            gaps = ", ".join("equal" if g[0] else f"{g[1]:.2e} / {g[2]:.2e}" for g in graph_gaps)
            egaps = ", ".join("equal" if e[0] else f"{e[1]:.2e} / {e[2]:.2e}"
                              for e in eager_gaps)
            note(f"train graph {label} {kind}: {len(graph_gaps)} consecutive replays against "
                 f"their eager twins, each from the replay's state (deterministic cuDNN): "
                 f"{words}; eager twins (max / RMS) {egaps}; replays {gaps}; eager steps "
                 f"2-{len(TRAIN_GRAPH_LRS)} under sync debug 'error'; graphs {len(step.graphs)}")
            if not held or len(step.graphs) != 1:
                fail(f"train graph {label} {kind}: the replays do not hold to their eager "
                     f"twins ({words}) or {len(step.graphs)} graphs were captured")
    # the rates with cuDNN as a user runs it: the first eager twin (an eager
    # trainer keeps no algorithm choice across calls) and the graphed twin
    # with its graphs dropped (a capture keeps the algorithms it was
    # captured with), which captures anew as a fresh trainer does
    (eager, eopt), (gtrain, gopt) = twins[0], twins[2]
    gtrain.graphs.reset()
    del twins
    fns = {"eager": lambda i: eager.train_step(batches[i % 2], eopt, 1e-6),
           "graphed": lambda i: gtrain.train_step(batches[i % 2], gopt, 1e-6)}
    repeats, iters = SHORT
    for name, fn in fns.items():
        for i in range(graphed.WARMUP + 1):
            fn(i)
        if name == "eager":
            rates, prof = timed_launches(kernels, fn, batch, SHORT, False)
        else:
            rates = run_rates(fn, batch, SHORT)
            prof = graphed_profile(kernels, fn, res["eager"]["launches"], TRAIN_KERNEL_SYMBOLS,
                                   f"train graph {label}", n=iters)
        res[name] = dict(rate=sorted(rates)[repeats // 2], rates=rates,
                         issue_ms=issue_ms(fn, iters), **prof)
    e, g = res["eager"], res["graphed"]
    per = {w: n // iters for w, n in e["launches"].items() if n}
    step = gtrain.graphs.steps["train"][1]
    (_, static, _), = step.graphs.values()
    src = batches[1]
    res.update(per_step=per, pool_bytes=pool_bytes(step.pool),
               capture_ms=list(step.captures.values()),
               copy_ms=graph_ms(lambda: [buf.copy_(src[k]) for k, buf in static.items()]))
    note(f"train graph {label}: kernels per step (eager launches = graphed profile, profiled "
         f"{g['attempts']} time(s)) {json.dumps(per)}; profiled kernels over {iters} steps, "
         f"graphed {sum(g['kernels'].values())}")
    for name in ("eager", "graphed"):
        r = res[name]
        note(f"train graph {label} {name}: {r['rate']:.2f} {unit} (median of {repeats} runs of "
             f"{iters} steps: {', '.join(f'{x:.2f}' for x in r['rates'])}), "
             f"{batch * 1e3 / r['rate']:.3f} ms a step; host issue {r['issue_ms']:.3f} ms; "
             f"{profiled_words(r, iters)}; card: {smi}")
    note(f"train graph {label}: capture (capture and first replay) "
         f"{', '.join(f'{x:.1f}' for x in res['capture_ms'])} ms; pool {res['pool_bytes']} "
         f"bytes (the train step's); the batch's copy into the static buffers "
         f"({sum(t.nbytes for t in src.values())} bytes in {len(static)} tensors) "
         f"{res['copy_ms']:.4f} ms, {res['copy_ms'] / g['event_ms']:.4f} of the graphed step's "
         f"CUDA-event span; graphed / eager rate {g['rate'] / e['rate']:.3f}")
    del eager, gtrain
    return res


# where the eager runs of a path's train() are not bit-equal (K11 / K12 add
# with float atomics), this many eager runs give the spread that the graphed
# run is held to (``run_verdict``)
TRAIN_RUN_EAGER = 8


def train_run(cfg, ckpt, label, net, mode, repro, graph, i) -> tuple:
    """One ``train()`` of ``net`` for TRAIN_EPOCHS epochs (graphed or eager)
    on the train split with its host draws seeded (one loader thread, so
    every run sees the same batches), the val split evaluated every epoch:
    (its history, the model's state and the generator's, the graphs it
    captured by kind)."""
    from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D

    cfg = cfg.clone()
    cfg.DATALOADER_NUM_WORKERS = 0
    if net == "HybridNet":
        cfg.TPU.REPRO_MODE = repro
        sets = seeded_set(Dataset3D(cfg, set="train")), Dataset3D(cfg, set="val")
    else:
        sets = (seeded_set(Dataset2D(cfg, set="train", mode=net)),
                Dataset2D(cfg, set="val", mode=net))
    trainer, _ = train_graph_trainer(cfg, ckpt, net, mode, repro, graph, f"Run{i}_{label}")
    hist = trainer.train(*sets, TRAIN_EPOCHS)["history"]
    state = [*trainer.model.state_dict().values(), trainer.generator.get_state()]
    graphs = {k: len(s.graphs) for k, (_, s) in trainer.graphs.steps.items()}
    return hist, state, graphs


def history_gap(a: dict, b: dict) -> float:
    """The largest |difference| between two ``train()`` histories' entries."""
    return max(abs(x - y) for k in a for x, y in zip(a[k], b[k]))


def run_verdict(to_eager: list, between: list) -> tuple:
    """The rule for a graphed ``train()`` against eager runs that are not
    bit-equal, from the gaps alone: ``to_eager`` holds (``twin_gap`` of the
    states, ``history_gap``) from the graphed run to each eager run,
    ``between`` the same for every pair of eager runs. The graphed run's
    state against the eager run nearest to it (by the largest difference),
    as the eager runs lie against each other (``twin_verdict``), and its
    history's distance to the nearest eager run's within GAP_FACTOR times
    the eager runs' largest history difference. Returns (held, words)."""
    gap = min((s for s, _ in to_eager), key=lambda x: x[1])
    held, words = twin_verdict([s for s, _ in between], [gap])
    hgap = min(h for _, h in to_eager)
    ehgap = max(h for _, h in between)
    return (held and hgap <= GAP_FACTOR * ehgap,
            f"{words}; history {hgap:.3e} from the nearest eager run, the {len(to_eager)} eager "
            f"runs {ehgap:.3e} apart (tol {GAP_FACTOR:g}x)")


def train_graph_run(cfg, ckpt, label, net, mode, repro, note, smi) -> dict:
    """One training path's ``train()`` (``train_run``) with cuDNN's
    deterministic algorithms, graphed against eager, the generator reseeded
    at each epoch between replays: bit-equal (the per-epoch losses and
    accuracies, the final parameters and the generator's state), or where
    it is not, TRAIN_RUN_EAGER - 1 more eager runs and ``run_verdict`` on
    all of them. Eight, not four: with four, the rule refused an eager run
    in the graphed run's place 0.03-2.9% of the time on each of five paths
    measured on an H100 (``train_run_spread.py``; PERF.md), 4.8% over the
    five, and this script holds twelve such paths; with eight 0-0.09%.
    Eight still refuse every run at 1.01 times the lr at float32."""
    import itertools

    import torch

    t0 = time.perf_counter()
    with deterministic_cudnn():
        g_hist, g_state, graphs = train_run(cfg, ckpt, label, net, mode, repro, True, 0)
        e_hist, e_state, _ = train_run(cfg, ckpt, label, net, mode, repro, False, 1)
        if twin_gap(g_state, e_state)[0] and g_hist == e_hist:
            held, words = True, "bit-equal, the same history"
        else:
            eager = [(e_hist, e_state)] + [
                train_run(cfg, ckpt, label, net, mode, repro, False, i)[:2]
                for i in range(2, TRAIN_RUN_EAGER + 1)]
            held, words = run_verdict(
                [(twin_gap(g_state, st), history_gap(g_hist, h)) for h, st in eager],
                [(twin_gap(a[1], b[1]), history_gap(a[0], b[0]))
                 for a, b in itertools.combinations(eager, 2)])
            words += f"; eager history {json.dumps(e_hist)}"
    note(f"train graph {label} train(): {TRAIN_EPOCHS} epochs graphed against eager "
         f"(deterministic cuDNN, seeded host draws, one loader thread): {words}; graphs "
         f"(train, eval) {json.dumps(graphs)}; history {json.dumps(g_hist)}; "
         f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    if not held or graphs.get("train") != 1 or graphs.get("eval") != 1:
        fail(f"train graph {label}: the graphed train() differs from the eager one ({words}) "
             f"or captured {graphs}")
    torch.cuda.empty_cache()
    return dict(held=held, words=words)


# the loaders phase: the user's loops of these paths, in each of these kinds
LOOP_PATHS = (("3D_only", "HybridNet", "3D_only"), ("all", "HybridNet", "all"),
              ("CenterDetect", "CenterDetect", None), ("KeypointDetect", "KeypointDetect", None))
# kind: (project, DATALOADER_WORKER_MODE, TPU.TRAIN_DTYPE, graphed); each
# loop has 4 loader workers. training_data writes the projects beside
# ``Train`` (process workers at float32, the default)
LOOP_KINDS = {"eager": ("LoopThread", "thread", "float32", False),
              "thread": ("LoopThread", "thread", "float32", True),
              "process": ("Train", "process", "float32", True),
              "process bf16": ("LoopBf16", "process", "bfloat16", True)}


@contextlib.contextmanager
def epoch_clock():
    """Each shuffled (training) loader's epoch inside the block, as (the
    seconds from its iterator's start to its first batch: in the process
    modes a fresh pool of workers forked and its first batch built; the
    seconds from that start to the loop's request past its last batch: the
    epoch's training as a user waits for it)."""
    from jarvis_hybridnet_torch.dataset import loader

    epochs = []
    iterate = loader.DataLoader.__iter__

    def timed(self):
        t0 = time.perf_counter()
        it = iterate(self)
        first = None
        try:
            for b in it:
                if first is None:
                    first = time.perf_counter() - t0
                yield b
            if self.shuffle:
                epochs.append((first, time.perf_counter() - t0))
        finally:
            it.close()

    loader.DataLoader.__iter__ = timed
    try:
        yield epochs
    finally:
        loader.DataLoader.__iter__ = iterate


def loop_kernels(net: str, mode) -> tuple:
    """The hand-written kernels a training loop of ``net`` in ``mode`` launches."""
    if net != "HybridNet":
        return TRAIN2D_KERNELS
    return TRAINING_KERNELS if mode == "3D_only" else TRAINING_ALL_KERNELS


def train_graph_loop(kernels, ckpt, label, net, mode, kind, note, smi, widgets=None) -> dict:
    """``train_hybridnet`` / ``train_efficienttrack`` as a user runs them on
    the project of ``kind`` (``LOOP_KINDS``: 4 loader threads or 4 process
    workers, float32 or bf16, eager or graphed; TRAIN_EPOCHS epochs, host
    augmentation and decode included), ``widgets`` passed to the monitor:
    the launch counts (set to 0 just before, read just after; every kernel
    of the path launched), the loop's rate from its steps' call times
    (``loop_rate``; the warm-up and capture left out), the set-up (the call
    to its first step), the first step (its first to its second step call),
    each training epoch's start and whole wall time (``epoch_clock``), this
    process's resident set and gc-tracked objects (what a forked worker
    shares with it copy-on-write), and the run's history."""
    import gc

    import torch

    from jarvis_hybridnet_torch.training import graphed
    from jarvis_hybridnet_torch.training.train_interface import (
        train_efficienttrack,
        train_hybridnet,
    )
    from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer
    from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer

    project, worker_mode, dtype, graph = LOOP_KINDS[kind]
    words = (f"{'graphed' if graph else 'eager'} (4 "
             f"{'loader threads' if worker_mode == 'thread' else 'process workers'}"
             f"{', bf16' if dtype == 'bfloat16' else ''})")
    res = {}
    run = f"Loop_{label}_{kind.replace(' ', '_')}"
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with epoch_clock() as epochs:
        if net == "HybridNet":
            with loop_clock(HybridNetTrainer) as times:
                ok = train_hybridnet(project, TRAIN_EPOCHS, None, ckpt["HybridNet"], mode=mode,
                                     run_name=run, device="cuda", results=res, graph=graph,
                                     streamlit_widgets=widgets)
            per_epoch, batch = TRAIN_SPLITS[0][1], 1
        else:
            with loop_clock(EfficientTrackTrainer) as times:
                ok = train_efficienttrack(net, project, TRAIN_EPOCHS, ckpt[net], run_name=run,
                                          device="cuda", results=res, graph=graph,
                                          streamlit_widgets=widgets)
            per_epoch, batch = len(times) // TRAIN_EPOCHS, 4
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if not ok:
        fail(f"the {kind} {label} training loop did not finish")
    for name in loop_kernels(net, mode):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched in the {kind} {label} training loop")
    out = dict(rate=loop_rate(times, per_epoch, batch, graphed.WARMUP + 1 if graph else 2),
               setup_s=times[0] - t0, first_step_s=times[1] - times[0],
               epoch_start_s=[e[0] for e in epochs], epoch_s=[e[1] for e in epochs],
               steps=len(times), per_epoch=per_epoch, seconds=seconds, counts=counts,
               history=res["history"], rss_gb=host_rss_gb(), objects=len(gc.get_objects()))
    unit = "framesets/s" if net == "HybridNet" else "images/s"
    note(f"train graph {label} loop {words}: {out['rate']:.2f} {unit} (the median interval "
         f"between two steps of an epoch, {len(times)} steps, host augmentation and JPEG decode "
         f"included); set-up {out['setup_s']:.3f} s, first step {out['first_step_s']:.3f} s, "
         f"epoch starts {', '.join(f'{x:.3f}' for x in out['epoch_start_s'])} s, epochs "
         f"{', '.join(f'{x:.3f}' for x in out['epoch_s'])} s; the loop {seconds:.1f} s; this "
         f"process's resident set {out['rss_gb']:.2f} GB, {out['objects']} gc-tracked objects; "
         f"card: {smi}")
    return out


def host_rss_gb() -> float:
    """This process's resident set (``VmRSS``), GB: what a forked worker
    shares copy-on-write with it."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    return float("nan")


class RecordingWidget:
    """A stand-in for one Streamlit widget: every call the monitor makes on
    it goes into the shared ``log``."""

    def __init__(self, index: int, log: list):
        self.index, self.log = index, log

    def _record(self, method, *args):
        self.log.append((self.index, method) + tuple(
            {k: list(v) for k, v in a.items()} if isinstance(a, dict) else a for a in args))

    def markdown(self, text):
        self._record("markdown", text)

    def progress(self, fraction):
        self._record("progress", fraction)

    def line_chart(self, data):
        self._record("line_chart", data)


def monitor_expected(mode: str, unit: str, epochs: int, steps: int, history: dict) -> list:
    """The calls the JAX package's trainers make on five widgets over a run
    of ``history``: ``start``, one ``step`` a step, one ``epoch`` an epoch
    with the history so far, through the port's monitor (the CPU tests hold
    it to JAX's call for call)."""
    from jarvis_hybridnet_torch.utils.st_monitor import StreamlitTrainingMonitor

    log: list = []
    monitor = StreamlitTrainingMonitor([RecordingWidget(i, log) for i in range(5)], mode,
                                       acc_unit=unit)
    monitor.start(epochs)
    for epoch in range(epochs):
        for count in range(steps):
            monitor.step(count, steps)
        monitor.epoch(epoch, epochs, {k: v[:epoch + 1] for k, v in history.items()})
    return log


def batch_bytes(b) -> list:
    """A collated batch as (dtype, shape, bytes) of its leaves in order."""
    import numpy as np

    if isinstance(b, dict):
        return [x for k in b for x in [k] + batch_bytes(b[k])]
    if isinstance(b, (list, tuple)):
        return [x for v in b for x in batch_bytes(v)]
    a = np.asarray(b)
    return [(a.dtype.str, a.shape, a.tobytes())]


def loader_batches_equal(note) -> None:
    """The training dataset's batches through 4 loader threads and through
    4 process workers, byte for byte over two shuffled epochs, as the
    trainers load them (device targets), with host augmentation off (each
    thread and each process worker draws from its own stream): both 2D nets'
    train split (batch 4) with the mirror and affine probabilities at 0 and
    the color augmentation off, so that no draw changes a sample, and the
    3D val split (batch 1: the 3D train split always jitters its crops and
    cube)."""
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.dataset.loader import DataLoader

    pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
    pm.load("Train")
    cfg = pm.get_cfg().clone()
    aug = cfg.AUGMENTATION
    aug.MIRROR.PROBABILITY = aug.AFFINE_TRANSFORM.PROBABILITY = 0.0
    aug.COLOR_MANIPULATION.ENABLED = False
    sets = {"HybridNet val": (functools.partial(Dataset3D, cfg, set="val",
                                                device_targets=True), 1)}
    for net in NETS_2D:
        sets[f"{net} train"] = (functools.partial(Dataset2D, cfg, set="train", mode=net,
                                                  device_targets=True), 4)
    for name, (make, batch) in sets.items():
        t0 = time.perf_counter()
        got = {}
        for mode in ("thread", "process"):
            dl = DataLoader(make(), batch_size=batch, shuffle=True, seed=3, num_workers=4,
                            worker_mode=mode)
            got[mode] = []
            for epoch in range(2):
                dl.set_epoch(epoch)
                got[mode] += [batch_bytes(b) for b in dl]
        equal = got["thread"] == got["process"] and len(got["thread"]) == 2 * len(dl)
        note(f"loaders {name}: batches (host augmentation off) through 4 loader threads and 4 "
             f"process workers, 2 shuffled epochs of {len(dl)} batches of {batch}: "
             f"{'byte for byte equal' if equal else 'DIFFERENT'} "
             f"({time.perf_counter() - t0:.1f} s)")
        if not equal:
            fail(f"loaders {name}: process workers' batches differ from the threads'")


def fork_after_device(ckpt, note, smi) -> None:
    """The fork-after-device stress (the port's counterpart of
    ``tests/test_dataset.py:494``): after this process's graph captures,
    with a graphed KeypointDetect trainer's eval graph live, two epochs of
    the 3D training split (host augmentation on) through 4 process workers
    under ``PreemptionGuard``: every batch arrives, no worker is left once
    the epochs end, and the eval graph's replay afterwards is bit-equal to
    its replay before."""
    import multiprocessing as mp

    import torch

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.dataset.loader import DataLoader
    from jarvis_hybridnet_torch.training import graphed
    from jarvis_hybridnet_torch.utils.preemption import PreemptionGuard

    pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
    pm.load("Train")
    cfg = pm.get_cfg()
    trainer, _ = train_graph_trainer(cfg, ckpt, "KeypointDetect", None, None, True, "Fork")
    b = train_graph_batches(cfg, "KeypointDetect")[0]
    for _ in range(graphed.WARMUP + 1):  # the eager warm-ups, the capture
        trainer.eval_step(b)
    before = [t.clone() for t in trainer.eval_step(b)]
    children = {p.pid for p in mp.active_children()}
    t0 = time.perf_counter()
    arrived = []
    with PreemptionGuard():
        ds = Dataset3D(cfg, set="train", device_targets=True, device_aug=True)
        dl = DataLoader(ds, batch_size=1, shuffle=True, seed=5, num_workers=4,
                        worker_mode="process")
        for epoch in range(2):
            dl.set_epoch(epoch)
            arrived.append(sum(1 for _ in dl))
    epochs_s = time.perf_counter() - t0
    deadline = time.monotonic() + 20.0
    while True:
        left = {p.pid for p in mp.active_children()} - children
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    after = trainer.eval_step(b)
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(before, after))
    note(f"loaders fork after device: 2 epochs of the 3D training split through 4 process "
         f"workers forked after the graph captures, under PreemptionGuard: batches {arrived} of "
         f"{len(dl)} an epoch ({epochs_s:.1f} s), workers left {len(left)}, the KeypointDetect "
         f"eval graph's replay after them {'bit-equal to' if equal else 'DIFFERENT from'} the "
         f"one before; card: {smi}")
    if arrived != [len(dl)] * 2 or left or not equal:
        fail("loaders: the process workers forked after the device work lost a batch, left a "
             "worker or changed a replay")
    del trainer
    torch.cuda.empty_cache()


def resume_check(ckpt, note, smi) -> None:
    """KeypointDetect's graphed trainer as a user runs it (4 process
    workers) with deterministic cuDNN on the val split as its training set
    (no host draws; the CPU tests' rule): TRAIN_EPOCHS epochs in one run,
    and one epoch stopped at its end (the preemption path writes
    ``train_state.ckpt`` in the JAX package's layout) then resumed for the
    rest. The final parameters, AdamW's state and the history bit-equal,
    or else the resumed run held to TRAIN_RUN_EAGER eager uninterrupted runs
    by ``run_verdict`` (C.11)."""
    import itertools

    import torch

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
    from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer
    from jarvis_hybridnet_torch.utils import preemption

    pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
    pm.load("Train")
    cfg = pm.get_cfg()
    net = "KeypointDetect"

    def run(name, graph=True, resume=None, stop=False):
        trainer = EfficientTrackTrainer(net, cfg, weights=ckpt[net], device="cuda",
                                        run_name=name, graph=graph)
        sets = [Dataset2D(cfg, set="val", mode=net) for _ in range(2)]
        guard = preemption.PreemptionGuard.should_stop_global
        if stop:  # a stop request seen at the end of the first epoch
            preemption.PreemptionGuard.should_stop_global = (
                lambda self, stride=None: stride is None)
        try:
            out = trainer.train(*sets, TRAIN_EPOCHS, resume_from=resume)
        finally:
            preemption.PreemptionGuard.should_stop_global = guard
        opt = trainer.optimizer
        state = [*trainer.model.state_dict().values()] + [
            opt.state[p][k] for p in opt.param_groups[0]["params"] for k in sorted(opt.state[p])]
        return out, state, trainer.model_savepath

    t0 = time.perf_counter()
    with deterministic_cudnn():
        whole, w_state, _ = run("ResumeWhole")
        first, _, path = run("ResumeFirst", stop=True)
        if not first.get("preempted"):
            fail("loaders resume: the run was not stopped at its first epoch's end")
        resumed, r_state, _ = run("ResumeRest", resume=os.path.join(path, "train_state.ckpt"))
        hist = {k: first["history"][k] + resumed["history"][k] for k in whole["history"]}
        if twin_gap(r_state, w_state)[0] and hist == whole["history"]:
            held, words = True, "bit-equal, the same history"
        else:
            eager = [run(f"ResumeEager{i}", graph=False)
                     for i in range(TRAIN_RUN_EAGER)]
            eager = [(o["history"], st) for o, st, _ in eager]
            held, words = run_verdict(
                [(twin_gap(r_state, st), history_gap(hist, h)) for h, st in eager],
                [(twin_gap(a[1], b[1]), history_gap(a[0], b[0]))
                 for a, b in itertools.combinations(eager, 2)])
    note(f"loaders resume: {net} graphed, 4 process workers, {TRAIN_EPOCHS} epochs in one run "
         f"against 1 epoch, train_state.ckpt (the JAX package's layout) and a resumed run: "
         f"{words}; history {json.dumps(hist)}; {time.perf_counter() - t0:.1f} s; card: {smi}")
    if not held:
        fail(f"loaders resume: the resumed run differs from the uninterrupted one ({words})")
    torch.cuda.empty_cache()


def loaders_phase(kernels, ckpt, note, smi, f32: list, bf16: list) -> dict:
    """The user's training loops (``train_graph_loop``) of 3D_only, ``all``
    and both 2D nets in every ``LOOP_KINDS`` kind: eager and graphed with 4
    loader threads, and graphed with 4 process workers at float32 and at
    bf16, each loop's rate beside the rate of the same step (eager or
    graphed, float32 or bf16) in this run (``train_graph_phase``'s ``f32`` /
    ``bf16`` results, where given); the graphed process loops' launch counts
    equal to the graphed thread loops'; the float32 process
    KeypointDetect loop with five recording widgets, whose calls must be
    ``monitor_expected``'s. Then ``loader_batches_equal``,
    ``fork_after_device`` and ``resume_check``. Returns each loop's launch
    counts by path (``loop_<kind>_<label>``)."""
    import gc

    import torch

    step_rates = {(g, r["label"]): r[g]["rate"] for r in f32 + bf16 for g in ("eager", "graphed")}
    counts, rows = {}, []
    for label, net, mode in LOOP_PATHS:
        for kind in LOOP_KINDS:
            log = [] if (kind, label) == ("process", "KeypointDetect") else None
            widgets = None if log is None else [RecordingWidget(i, log) for i in range(5)]
            r = train_graph_loop(kernels, ckpt, label, net, mode, kind, note, smi, widgets)
            counts[f"loop_{kind.replace(' ', '_')}_{label}"] = r["counts"]
            _, _, dtype, graph = LOOP_KINDS[kind]
            step = ("graphed" if graph else "eager",
                    ("bf16 " if dtype == "bfloat16" else "") + label)
            rows.append((label, kind, r, step[0], step_rates.get(step)))
            if log is not None:
                want = monitor_expected(net, "px", TRAIN_EPOCHS, r["per_epoch"], r["history"])
                steps = sum(1 for c in log if c[:2] == (1, "progress"))
                note(f"loaders monitor: the {kind} {label} loop with five recording widgets: "
                     f"{len(log)} calls ({steps} step progress calls over {r['steps']} steps), "
                     f"{'equal' if log == want else 'NOT EQUAL'} call for call to the "
                     f"{len(want)} of the JAX trainers' protocol")
                if log != want or steps != r["steps"]:
                    fail("loaders: the trainer's monitor calls differ from the JAX trainer's")
            gc.collect()
            torch.cuda.empty_cache()
        thread, process = (counts[f"loop_{k}_{label}"] for k in ("thread", "process"))
        if thread != process:
            fail(f"loaders {label}: the process loop's launch counts {json.dumps(process)} "
                 f"differ from the thread loop's {json.dumps(thread)}")
    for label, kind, r, name, step in rows:
        against = (f"the {name} step not measured in this run" if step is None else
                   f"against the {name} step's {step:.2f} (this run), ratio "
                   f"{r['rate'] / step:.3f}")
        note(f"loaders {label} {kind}: loop {r['rate']:.2f} {against}; set-up "
             f"{r['setup_s']:.3f} s, first step {r['first_step_s']:.3f} s, epoch start "
             f"{', '.join(f'{x:.3f}' for x in r['epoch_start_s'])} s, epoch "
             f"{', '.join(f'{x:.3f}' for x in r['epoch_s'])} s; resident set "
             f"{r['rss_gb']:.2f} GB, {r['objects']} gc-tracked objects; card: {smi}")
    loader_batches_equal(note)
    fork_after_device(ckpt, note, smi)
    resume_check(ckpt, note, smi)
    return counts


def train_graph_phase(kernels, ckpt, note, smi, dtype: str = "float32") -> list:
    """Every training path at ``TPU.TRAIN_DTYPE`` ``dtype`` eager against
    graphed (``train_graph_steps``) and its ``train()`` graphed against
    eager (``train_graph_run``), labelled ``<path>`` at float32 and ``bf16
    <path>`` at bf16 (the user's loops: ``loaders_phase``).
    ``chiprun_out/chip_smoke_train_graphs.txt`` (float32) or
    ``chip_smoke_train_graphs_bf16.txt`` lists the kernels of each graphed
    step by name and count."""
    import gc

    import torch

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager

    pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
    pm.load("Train")
    cfg = pm.get_cfg()
    bf16 = dtype == "bfloat16"
    if bf16:
        cfg = bf16_cfg(cfg)
    prefix = "bf16 " if bf16 else ""
    results = []
    for label, net, mode, repro in TRAIN_GRAPH_PATHS:
        res = train_graph_steps(kernels, cfg, ckpt, prefix + label, net, mode, repro, note, smi)
        res["run"] = train_graph_run(cfg, ckpt, prefix + label, net, mode, repro, note, smi)
        results.append(res)
        gc.collect()
        torch.cuda.empty_cache()
    name = f"chip_smoke_train_graphs{'_bf16' if bf16 else ''}.txt"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as log:
        log.write(f"card: {smi}\nkernels a step of each graphed {prefix}training step "
                  f"(torch.profiler, {SHORT[1]} replays)\n")
        for r in results:
            log.write(f"{r['label']}:\n")
            for key, count in r["graphed"]["kernels"].most_common():
                log.write(f"  {count / SHORT[1]:8.1f}  {key[:160]}\n")
    return results


# bf16 mixed-precision training (TPU.TRAIN_DTYPE bfloat16): the paths of
# TRAIN_GRAPH_PATHS at bf16 compute with float32 masters
# the card's bf16-vs-float32 gap of a step within this many times the CPU's
BF16_GAP_FACTOR = 1.5
# each tensor's (``live_groups``) card gap, pooled over BF16_SEEDS (the RMS
# of its relative gaps), within this many times the CPU's: one seed's
# largest tensor read 1.27-3.14 over four seeds and both steps on an H100
# (SE reduce tensors, in steps whose convolutions all rounded once there:
# bf16 noise carried along the backward, not a rounding), and the pooled
# reading is at most the largest of its seeds'
BF16_TENSOR_FACTOR = 4.0
# (the 3D set's seed, the 2D images' seed) of the card-vs-CPU steps
BF16_SEEDS = ((6, 9), (8, 10))


def bf16_path(label: str) -> str:
    """The launch-count path of a bf16 training path's counted step."""
    return f"bf16_{label.replace(' ', '_')}_step"


def bf16_cfg(cfg):
    """``cfg`` at ``TPU.TRAIN_DTYPE: bfloat16``."""
    cfg = cfg.clone()
    cfg.TPU.TRAIN_DTYPE = "bfloat16"
    return cfg


def bf16_steps(kernels, ckpt, recorder, note, smi) -> dict:
    """Every training path at bf16, eager, at full width: one warm-up step,
    then one step counted (``path_launches`` under ``bf16_<label>_step``,
    every hand-written kernel of the path launched, the arguments of K1, K2,
    K6, K8, K9 and K10 recorded: the bf16 keys the checks hold to the plain
    versions); the loss finite, the parameters, their gradients and AdamW's
    state float32. Returns {path: launch counts}."""
    import torch

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager

    pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
    pm.load("Train")
    cfg = bf16_cfg(pm.get_cfg())
    out = {}
    for label, net, mode, repro in TRAIN_GRAPH_PATHS:
        names = (TRAIN2D_KERNELS if net != "HybridNet" else TRAINING_KERNELS
                 if mode == "3D_only" else TRAINING_ALL_KERNELS if repro == "quarter_fused"
                 else K12_STEP_KERNELS)
        trainer, opt = train_graph_trainer(cfg, ckpt, net, mode, repro, False,
                                           f"Bf16Count_{label}")
        batches = train_graph_batches(cfg, net)
        trainer.train_step(batches[0], opt, 1e-6)
        path = bf16_path(label)
        (loss, _), out[path] = path_launches(lambda: trainer.train_step(batches[1], opt, 1e-6),
                                             kernels, names, path, recorder)
        masters = all(p.dtype == torch.float32 for p in trainer.model.parameters())
        grads = all(p.grad is None or p.grad.dtype == torch.float32
                    for p in trainer.model.parameters())
        moments = all(v.dtype == torch.float32 for s in opt.state.values()
                      for k, v in s.items() if k.startswith("exp_avg"))
        note(f"training bf16 {label} step (full width, eager, compute {trainer.dtype}): loss "
             f"{float(loss):.4f}; parameters, gradients and AdamW moments float32: "
             f"{masters and grads and moments}; launches {json.dumps(out[path])}; card: {smi}")
        if not (math.isfinite(float(loss)) and masters and grads and moments):
            fail(f"training bf16 {label}: loss {float(loss)}, float32 masters {masters}, "
                 f"gradients {grads}, moments {moments}")
        del trainer, opt, batches
        torch.cuda.empty_cache()
    return out


def bf16_grad_gap(a: dict, b: dict) -> list:
    """(RMS(a - b) / RMS(b), name) for each group of ``live_groups(b)``:
    every tensor alone but the BiFPN fusion weights (one group), the ones
    zero but for round-off left out."""
    return group_gaps(a, b, live_groups(b))


def mean_gap(gaps: list) -> float:
    return sum(g for g, _ in gaps) / len(gaps)


# a convolution's RMS error over that of its float64 value rounded once to
# bf16, from the same bf16 operands: float32 accumulation rounded once
# reads 1.0 (the CPU's convolutions read 1.0000,
# ``test_bf16_step_convs_round_once``), float32 partial sums rounded to
# bf16 before their last add 1.37-1.50, a sum in bf16 pairwise 2.65-3.83
# and one in bf16 term by term 6.1-56 (``test_conv_rounding_reads_accumulation``).
# On an H100 cuDNN's bf16 weight gradient of V2V's 1x1x1 output conv read
# 1.27-1.49 (rounded partial sums), its bf16 input gradients of the SE
# gates 1.55-2.30 (hence ``layers._apply``'s float32 path for them), so the
# bound tells float32 accumulation with rounded partials from accumulation
# in bf16
CONV_ROUND_TOL = 2.0
CONV_ONE_ROUNDING = 1.1  # convolutions above it are counted


@contextlib.contextmanager
def conv_witness():
    """Every convolution ``models.layers.conv`` runs below float32 inside
    the block, recorded (at ``layers._apply``): its operands in the compute
    dtype, its output, and the gradients of its output, input and weight as
    autograd hands them over (the bf16 results of the convolution's
    backward as the port computes it). Yields the list of records."""
    import torch

    from jarvis_hybridnet_torch.models import layers

    calls, apply = [], layers._apply

    def recorded(fn, x, w, b, args):
        if x.dtype == torch.float32:
            return apply(fn, x, w, b, args)
        rec = dict(fn=fn, args=args, x=x.detach(), w=w.detach())
        x, w = x.view_as(x), w.view_as(w)  # their own gradients: this call's
        for name, t in (("dx", x), ("dw", w)):
            if t.requires_grad:
                t.register_hook(functools.partial(rec.__setitem__, name))
        y = apply(fn, x, w, b, args)
        rec["y"] = y.detach()
        if y.requires_grad:
            y.register_hook(functools.partial(rec.__setitem__, "dy"))
        calls.append(rec)
        return y

    layers._apply = recorded
    try:
        yield calls
    finally:
        layers._apply = apply


def conv_rounding(calls: list) -> dict:
    """For each record of ``conv_witness`` whose output got a gradient, the
    convolution and its input and weight gradients recomputed in float64
    from the same bf16 operands, on their device; each result's RMS error
    over that of the float64 value rounded once to bf16. Returns {kind:
    (the worst ratio, its weight's shape, the least share of elements equal
    to the rounded float64 value, the count of convolutions above
    CONV_ONE_ROUNDING)} for kind in y, dx, dw, and the count of
    convolutions under ``calls``."""
    import torch

    out = {}
    for rec in calls:
        if "dy" not in rec:
            continue
        x = rec["x"].double().requires_grad_("dx" in rec)
        w = rec["w"].double().requires_grad_("dw" in rec)
        with torch.enable_grad():
            y = rec["fn"](x, w, None, *rec["args"])
            if y.requires_grad:
                y.backward(rec["dy"].double())
        for kind, got, ref in (("y", rec["y"], y.detach()), ("dx", rec.get("dx"), x.grad),
                               ("dw", rec.get("dw"), w.grad)):
            if got is None:
                continue
            rounded = ref.to(got.dtype).double()
            ratio = float((got.double() - ref).square().mean().sqrt()
                          / (rounded - ref).square().mean().sqrt().clamp_min(1e-300))
            share = float((got.double() == rounded).double().mean())
            worst, shape, least, over = out.get(kind, (0.0, None, 1.0, 0))
            if ratio > worst:
                worst, shape = ratio, tuple(rec["w"].shape)
            out[kind] = (worst, shape, min(least, share), over + (ratio > CONV_ONE_ROUNDING))
    out["calls"] = sum("dy" in rec for rec in calls)
    return out


def rounding_words(r: dict) -> str:
    return "; ".join(f"{k} worst {r[k][0]:.4f} (weight {r[k][1]}), least share equal "
                     f"{r[k][2]:.4f}, {r[k][3]} over {CONV_ONE_ROUNDING:g}"
                     for k in ("y", "dx", "dw"))


def bf16_card_vs_cpu(ckpt, note, smi) -> None:
    """The bf16 ``all`` step (4 framesets of 4 cameras, 128^2 crops, G = 12,
    quarter_fused) and the bf16 KeypointDetect step (4 images of 128^2), in
    ``eval()``, from the committed checkpoints, at bf16 and at float32 on the
    card and on the CPU (TF32 off), on the inputs of each of BF16_SEEDS:
    bf16 round-off moves a gradient by far more than the two devices'
    float32 steps differ, and the two devices' bf16 convolutions sum in
    other orders, so the card's bf16 step is held to the CPU's through their
    gaps to float32 (``bf16_grad_gap``): the mean over the tensors within
    BF16_GAP_FACTOR times the CPU's for each seed, each tensor's over the
    seeds pooled within BF16_TENSOR_FACTOR times the CPU's. Every bf16
    convolution of both steps on the card
    (``conv_witness``) within CONV_ROUND_TOL of its float64 value rounded
    once, from the same bf16 operands (``conv_rounding``; the CPU's printed
    beside): the card's convolutions accumulate in float32, not in bf16.
    The loss gaps and the card's bf16 gradients against the CPU's are
    printed (information)."""
    import tempfile

    import numpy as np
    import torch

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d
    from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer, host_batch
    from jarvis_hybridnet_torch.training.trainer3d import BATCH_KEYS, HybridNetTrainer

    def grads_of(trainer, batch, device):
        model = trainer.model.eval()
        with conv_witness() as calls:
            loss, _ = trainer.forward({k: torch.from_numpy(v).to(device)
                                       for k, v in batch.items()})
            loss.backward()
        return (float(loss.detach()), {n: p.grad.detach().cpu().clone()
                                       for n, p in model.named_parameters()
                                       if p.grad is not None},
                conv_rounding(calls) if calls else None)

    pooled = {}
    for seed3d, seed2d in BF16_SEEDS:
        with tempfile.TemporaryDirectory() as parent:
            dataset = write_dataset3d(os.path.join(parent, "datasets", "Small"),
                                      synthetic_rig(4, 320, 256), 320, 256, 23,
                                      splits=(("val", 4),), extent_mm=40.0, seed=seed3d)
            training_project(parent, dataset, 1, 128, 48, 4, 23, 4, workers=0)
            pm = ProjectManager(parent)
            pm.load("Train")
            cfg = pm.get_cfg()
            ds = Dataset3D(cfg, set="val", device_targets=True)
            samples = [ds[i] for i in range(4)]
            batch3d = {k: np.stack([np.asarray(s[k]) for s in samples]) for k in BATCH_KEYS}
            rng = np.random.default_rng(seed2d)
            imgs = rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
            kps = np.zeros((4, 1, 69), np.float32)
            kps[..., 0::3], kps[..., 1::3], kps[..., 2::3] = (
                rng.uniform(8, 120, (4, 1, 23)), rng.uniform(8, 120, (4, 1, 23)), 1.0)
            batch2d, _ = host_batch((imgs, kps))
            cfg2d = cfg.clone()
            cfg2d.KEYPOINTDETECT.BOUNDING_BOX_SIZE = 128
            steps = {}
            for device in ("cuda", "cpu"):
                for dtype in ("float32", "bfloat16"):
                    c3, c2 = cfg.clone(), cfg2d.clone()
                    c3.TPU.TRAIN_DTYPE = c2.TPU.TRAIN_DTYPE = dtype
                    t3 = HybridNetTrainer("train", c3, weights=ckpt["HybridNet"], device=device,
                                          run_name=f"bf16gap_{device}_{dtype}",
                                          training_mode="all")
                    t2 = EfficientTrackTrainer("KeypointDetect", c2,
                                               weights=ckpt["KeypointDetect"], device=device,
                                               run_name=f"bf16gap_{device}_{dtype}")
                    steps[device, dtype] = (grads_of(t3, batch3d, device),
                                            grads_of(t2, batch2d, device))
                    del t3, t2
        for i, what in enumerate(("all step (4 framesets, G = 12)",
                                  "KeypointDetect step (4 images of 128^2)")):
            what = f"{what}, seeds {seed3d} / {seed2d}"
            (lc16, gc16, rc), (lc32, gc32, _) = (steps["cuda", d][i]
                                                 for d in ("bfloat16", "float32"))
            (lp16, gp16, rp), (lp32, gp32, _) = (steps["cpu", d][i]
                                                 for d in ("bfloat16", "float32"))
            card, cpu = bf16_grad_gap(gc16, gc32), bf16_grad_gap(gp16, gp32)
            ratios = sorted(((c / max(p, 1e-300), n) for (c, n), (p, _) in zip(card, cpu)),
                            reverse=True)
            mc, mp = mean_gap(card), mean_gap(cpu)
            note(f"training bf16 {what}, card vs CPU: gradients' relative RMS gap bf16 to "
                 f"float32, mean over {len(card)} tensors on the card {mc:.4e}, on the CPU "
                 f"{mp:.4e} (card / CPU {mc / mp:.3f}, tol {BF16_GAP_FACTOR:g}); each tensor's "
                 f"card / CPU: largest {', '.join(f'{r:.3f} ({n})' for r, n in ratios[:4])}, "
                 f"median {ratios[len(ratios) // 2][0]:.3f}, least {ratios[-1][0]:.3f} "
                 f"(information: the seeds pooled are held below); float32 card vs CPU "
                 f"{mean_gap(bf16_grad_gap(gc32, gp32)):.4e}; bf16 card vs CPU "
                 f"{mean_gap(bf16_grad_gap(gc16, gp16)):.4e} (information); loss bf16 "
                 f"{lc16:.6f} / {lp16:.6f}, float32 {lc32:.6f} / {lp32:.6f} (card / CPU; gaps to "
                 f"float32 {abs(lc16 - lc32) / lc32:.3e} / {abs(lp16 - lp32) / lp32:.3e} "
                 f"relative, information); card: {smi}")
            note(f"training bf16 {what}: each bf16 convolution's RMS error over its float64 "
                 f"value rounded once, from the same bf16 operands ({rc['calls']} convolutions "
                 f"with a gradient): card {rounding_words(rc)} (tol {CONV_ROUND_TOL:g}); CPU "
                 f"{rounding_words(rp)} (information)")
            pooled.setdefault(i, []).append((dict((n, g) for g, n in card),
                                             dict((n, g) for g, n in cpu)))
            if not (mc <= BF16_GAP_FACTOR * mp and math.isfinite(lc16)):
                fail(f"training bf16 {what}: the card's bf16 gap to float32 {mc} against the "
                     f"CPU's {mp} (tol {BF16_GAP_FACTOR})")
            if any(rc[k][0] > CONV_ROUND_TOL for k in ("y", "dx", "dw")):
                fail(f"training bf16 {what}: a convolution on the card is off its float64 "
                     f"value rounded once by more than {CONV_ROUND_TOL}x: {rounding_words(rc)}")
    for i, what in enumerate(("all step", "KeypointDetect step")):
        runs = pooled[i]
        names = set.intersection(*(set(c) for c, _ in runs))
        ratios = sorted(((math.sqrt(sum(c[n] ** 2 for c, _ in runs)
                                    / max(sum(p[n] ** 2 for _, p in runs), 1e-300)), n)
                         for n in names), reverse=True)
        note(f"training bf16 {what}, card vs CPU, the {len(runs)} seeds pooled: each tensor's "
             f"relative gap bf16 to float32 (RMS over the seeds) on the card over the CPU's: "
             f"largest {', '.join(f'{r:.3f} ({n})' for r, n in ratios[:4])}, median "
             f"{ratios[len(ratios) // 2][0]:.3f} over {len(ratios)} tensors (tol "
             f"{BF16_TENSOR_FACTOR:g})")
        if ratios[0][0] > BF16_TENSOR_FACTOR:
            fail(f"training bf16 {what}: a tensor's card gap to float32 is {ratios[0][0]} x the "
                 f"CPU's over the seeds ({ratios[0][1]}; tol {BF16_TENSOR_FACTOR})")


def check_k11_k12_bf16(kernels, recorder, path_counts, note, smi) -> list:
    """K11 at the bf16 ``all`` step's key (its bf16 rows, g4 = 18) and K12 in
    each mode at G = 72 on the same rows, at bf16 rows: the rows' gradient
    bf16 in 16-byte rows; against the plain version in float64, each element
    within half a bf16 ulp of its float64 value (the one rounding) plus twice
    the float32 plain version's largest error before rounding (the float32
    sums' own); the share of elements off the float64 value's rounding
    printed. Timed at that key: device, wall and plain ms, the bytes bound
    (the upstream gradient and indices read, the bf16 rows written once) and
    ``index_add_`` into bf16 rows (JAX's VJP adds rounded cotangents into a
    bf16 table) where ``index_add_`` is the float32 library call too (exact,
    half_fused). Returns the kernels line's entries."""
    import torch

    (args,) = [a for a, per in recorder.k2.values() if bf16_path("all") in per]
    rows, c3d, chm, P, K, D, g4, step = args
    if rows.dtype != torch.bfloat16:
        fail(f"the bf16 all step gathered {rows.dtype} rows")
    hs2, J = rows.shape[2], rows.shape[3]
    bf16 = torch.bfloat16
    cases = [("repro_quarter_gather_backward[bf16]", "quarter_fused",
              lambda: kernels.repro_quarter_gather(rows, c3d, chm, P, K, D, g4, step, True),
              lambda grad, idx: kernels.repro_quarter_gather_backward(grad, idx, hs2, J, bf16),
              lambda grad, idx: kernels.repro_quarter_gather_backward_plain(grad, idx, hs2, J))]
    G, sp = 4 * g4, step / 4.0
    for mode in OTHER_MODES:
        cases.append((f"repro_grid_gather_backward[bf16 {mode}]", mode,
                      functools.partial(kernels.repro_grid_gather, rows, c3d, chm, P, K, D, G,
                                        sp, mode, True),
                      functools.partial(lambda m, grad, idx: kernels.repro_grid_gather_backward(
                          grad, idx, hs2, J, m, bf16), mode),
                      functools.partial(lambda m, grad, idx:
                                        kernels.repro_grid_gather_backward_plain(
                                            grad, idx, hs2, J, m), mode)))
    entries = []
    for name, mode, forward, call, plain in cases:
        _, idx = forward()
        shape = (1, 2 * g4, 2 * g4, 2 * g4, J) if mode == "quarter_fused" else (
            (1, G // 2, G // 2, G // 2, J) if mode == "half_fused" else (1, G, G, G, J))
        g = torch.Generator(device=rows.device).manual_seed(7)
        grad = torch.randn(shape, device=rows.device, generator=g)
        k, k2 = call(grad, idx), call(grad, idx)
        p64 = plain(grad.double(), idx)
        p32 = plain(grad, idx)
        err32 = float((p32.double() - p64).abs().max())
        ulp = torch.exp2(torch.floor(torch.log2(p64.abs().clamp_min(1e-30))) - 7)
        excess = float(((k.double() - p64).abs() - 0.5 * ulp).max())
        off = float((k.float() != p64.to(bf16).float()).double().mean())
        twice = float((k.double() - k2.double()).abs().max())
        tol = 2 * err32
        held = (k.dtype == bf16 and k.stride(2) * 2 % 16 == 0 and excess <= tol
                and twice <= ulp.max() and torch.isfinite(k.float()).all())
        note(f"{name} at the bf16 all step's rows: rows' gradient {tuple(k.shape)} {k.dtype}, "
             f"rows {k.stride(2)} apart; beyond half a bf16 ulp of the float64 plain value "
             f"{excess:.3e} (tol {tol:.3e}, twice the float32 plain version's largest error); "
             f"{off:.3e} of the elements off the float64 value's rounding; two calls "
             f"{twice:.3e} apart")
        if not held:
            fail(f"{name}: {excess} beyond half an ulp (tol {tol}), dtype {k.dtype}")
        path = bf16_path("all" if mode == "quarter_fused" else f"all {mode}")
        count = path_counts[path][name.split("[")[0]]
        e = backward_entry(name, mode, call, lambda grad, idx: plain(grad, idx).to(bf16), grad,
                           idx, float((k.double() - p64).abs().max()), count, count, note, smi)
        e.update(path=path, dtype="bfloat16")
        entries.append(e)
        del grad, idx, k, k2, p64, p32
    torch.cuda.empty_cache()
    return entries


# ROADMAP.md C.9: one pair of bf16 eager twins of ``all`` exact read a
# parameter median of 0.071 (PR 15), far above any other pair. The trace
# reruns those twins on C9_SEEDS (the host draws of the two batches)
C9_SEEDS = (11, 12, 13, 14)


def c9_trace(kernels, ckpt, note, smi) -> None:
    """The bf16 ``all`` exact eager twins (``deterministic_cudnn``), the
    steps of TRAIN_GRAPH_LRS on each seed's two batches, the second twin put
    in the first one's state before every step (``sync_twin``), K12's calls
    recorded. Where a pair parts: the first tensor of ``twin_state`` that
    differs, whether K12's inputs were equal, ``flip_verdict``'s readings,
    and both twins' K12 bf16 rows held to the float64 plain version (half a
    bf16 ulp plus twice the float32 plain version's largest error) and
    ``repro_rows_to_bf16`` to the plain rounding of the same float32 sums,
    bit for bit."""
    import torch

    import importlib

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.kernels.repro_gather import pad_rows, round_rows

    k5mod = importlib.import_module("jarvis_hybridnet_torch.kernels.repro_grid_gather")

    pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
    pm.load("Train")
    cfg = bf16_cfg(pm.get_cfg())
    calls = []
    backward = k5mod.repro_grid_gather_backward

    def recorded(grad, idx, hs2, J, mode, dtype=torch.float32, c_total=None):
        out = backward(grad, idx, hs2, J, mode, dtype, c_total)
        calls.append((grad.clone(), idx.clone(), hs2, J, mode, dtype, out.clone()))
        return out

    recorded.launches = backward.launches  # the original counts through the module's name
    k5mod.repro_grid_gather_backward = recorded
    parted = 0
    try:
        for seed in C9_SEEDS:
            batches = train_graph_batches(cfg, "HybridNet", seed)
            with deterministic_cudnn():
                twins = [train_graph_trainer(cfg, ckpt, "HybridNet", "all", "exact", False,
                                             f"C9_{seed}_{i}") for i in range(2)]
                for n, lr in enumerate(TRAIN_GRAPH_LRS):
                    sync_twin(twins[1], twins[0])
                    before = {k: p.detach().clone() for k, p in
                              twins[0][0].model.named_parameters() if k.startswith("effTrack.")}
                    calls.clear()
                    outs = [t.train_step(batches[n % 2], opt, lr) for t, opt in twins]
                    states = [twin_state(o, t, opt) for o, (t, opt) in zip(outs, twins)]
                    gap = twin_gap(states[1], states[0])
                    if gap[0]:
                        continue
                    parted += 1
                    names = (["loss", "points"] + list(twins[0][0].model.state_dict())
                             + ["optimizer state"] * len(states[0]))
                    first = next(names[i] for i, (a, b) in enumerate(zip(*states))
                                 if not torch.equal(a, b))
                    parts = [split_state(o, t, opt, before) for o, (t, opt) in zip(outs, twins)]
                    _, words = flip_verdict([(parts[1], parts[0])])
                    (g0, i0, hs2, J, mode, dtype, o0), (g1, i1, *_, o1) = calls
                    same_in = torch.equal(g0, g1) and torch.equal(i0, i1)
                    checks = []
                    for grad, idx, out in ((g0, i0, o0), (g1, i1, o1)):
                        p64 = kernels.repro_grid_gather_backward_plain(grad.double(), idx, hs2,
                                                                       J, mode)
                        p32 = kernels.repro_grid_gather_backward_plain(grad, idx, hs2, J, mode)
                        ulp = torch.exp2(torch.floor(torch.log2(p64.abs().clamp_min(1e-30))) - 7)
                        excess = float(((out.double() - p64).abs() - 0.5 * ulp).max())
                        tol = 2 * float((p32.double() - p64).abs().max())
                        n_pts = grad.shape[1] // 2 if mode == "half" else grad.shape[1]
                        buf = k5mod.run_backward(k5mod.backward_plan(idx.shape[1], J, n_pts,
                                                                     mode), grad, idx, hs2)
                        rounded = torch.equal(round_rows(buf, dtype).cpu(),
                                              pad_rows(buf.cpu().to(dtype)))
                        checks.append((excess, tol, rounded))
                    note(f"C.9 bf16 all exact eager twins, seed {seed}, step {n}: part (max "
                         f"{gap[1]:.3e}, RMS {gap[2]:.3e}); first tensor that differs: {first}; "
                         f"K12's inputs {'equal' if same_in else 'DIFFER'} between the twins, "
                         f"its bf16 rows {'equal' if torch.equal(o0, o1) else 'differ'}; "
                         + "; ".join(f"twin {i}: K12 {e:.3e} beyond half an ulp (tol {t:.3e}), "
                                     f"repro_rows_to_bf16 {'=' if r else '!='} the plain "
                                     f"rounding" for i, (e, t, r) in enumerate(checks))
                         + f"; {words}")
                    if any(e > t or not r for e, t, r in checks):
                        fail("C.9: K12's bf16 rows or repro_rows_to_bf16 disagree with their "
                             "plain versions")
                del twins
    finally:
        backward.launches = recorded.launches
        k5mod.repro_grid_gather_backward = backward
    note(f"C.9 trace: {parted} of {len(C9_SEEDS) * len(TRAIN_GRAPH_LRS)} bf16 all exact eager "
         f"twin steps parted over seeds {C9_SEEDS}; card: {smi}")


# The multi-device phase (``parallel/``). A card run sees one device, so it
# holds the sharded paths two ways: NCCL in a world of one rank in this
# process (the collectives of the graphed train step, captured), and two
# gloo ranks spawned on the one card (every sharded path at full width:
# two ranks share its SMs, so their rates are information only). The
# sharded steps are held to the single-process step as the CPU tests hold
# them (tests/test_torch_parallel.py: two SGD steps, the loss within
# MULTI_LOSS_TOL relative, each tensor's first-step gradient and update
# within MULTI_STEP_TOL of its largest, a tensor whose gradient is round-off
# (under MULTI_ROUND_OFF of the largest) within that of the largest over
# all, the ranks bit-equal; on the card besides: the BiFPN fusion weights
# as one group, and each bound at least GAP_FACTOR times the gap between
# two single-process runs of the step), the sharded predict3D at the production
# configuration by the V2V volume, in bf16 ulps of its range, on the
# framesets whose crop centers and gate agree (MULTI_VOLUME_ULPS: the
# fixed-crop cascade's bound of ROADMAP.md section C)
MULTI_RANKS = 2
MULTI_LOSS_TOL = (1e-6, 1e-4)  # the first step's loss, the second's (after the first update)
# the CPU tests' 5e-4 at G = 12; at full width the card's sharded step reads
# 1.1e-3 to 1.3e-3 (its float32 convolutions take other algorithms at
# another batch size; one process that sums the two halves' gradients
# itself, ``multi_split_control``, reads as much)
MULTI_STEP_TOL = 5e-3
MULTI_ROUND_OFF = 1e-4
MULTI_VOLUME_ULPS = 48.0
MULTI_TIMEOUT_S = 420
MULTI_LRS = (1e-3, 1e-3)  # the sharded steps' two SGD steps
MULTI_TRAIN = ((1, 2, "quarter_fused"), (2, 1, "quarter_fused"), (1, 2, "exact"))
MULTI_PREDICT = ((2, 1), (1, 2))
C_TOTAL = 12  # the gathers' c_total keys: 6 cameras of a rig of 12


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def multi_gaps(got: dict, want: dict, before: dict) -> tuple:
    """(gradients, updates, the tensors of each, the 4 largest readings of
    a tensor over its own largest) of one step: the largest gap of a tensor
    over its ``want`` largest (round-off tensors over the largest of all;
    the BiFPN fusion weights, 2-3 sums of whole feature maps that cancel,
    over the largest fusion-weight gradient, as the card-vs-CPU 2D step
    holds them), the updates beyond two float32 ulps of each parameter."""
    import torch

    import re

    grads, params = want["grads"], want["params"]
    top = max(float(g.abs().max()) for g in grads.values())
    noise = {n for n, g in grads.items() if float(g.abs().max()) < MULTI_ROUND_OFF * top}
    fusion = {n for n in grads if re.search(r"_w\d$", n) or n.endswith("weights_cat")}
    moves = {n: params[n] - before[n] for n in before}
    mtop = max(float(m.abs().max()) for m in moves.values())
    ftop = max([float(grads[n].abs().max()) for n in fusion] or [0.0])
    fmtop = max([float(moves[n].abs().max()) for n in fusion] or [0.0])
    gworst, uworst, readings = (0.0, ""), (0.0, ""), []
    for n, g in grads.items():
        own = float(g.abs().max())
        scale = top if n in noise else (ftop if n in fusion else own)
        gap = float((got["grads"][n] - g).abs().max())
        gworst = max(gworst, (gap / max(scale, 1e-30), n))
        readings.append((gap / max(own, 1e-30), own / top, n))
        w = params[n]
        ulp = torch.nextafter(w.abs(), torch.full_like(w, float("inf"))) - w.abs()
        excess = ((got["params"][n] - w).abs() - 2 * ulp).clamp(min=0)
        scale = mtop if n in noise else (fmtop if n in fusion else float(moves[n].abs().max()))
        uworst = max(uworst, (float(excess.max()) / max(scale, 1e-30), n))
    return gworst[0], uworst[0], gworst[1], uworst[1], sorted(readings, reverse=True)[:4]


def multi_train_steps(kernels, cfg, ckpt, batch: dict, mesh, repro: str, label: str,
                      timed: bool = True) -> dict:
    """Two SGD steps (``MULTI_LRS``) of an eager ``all`` HybridNetTrainer in
    ``train()`` from the committed checkpoint on ``batch`` (host arrays,
    the global batch; this rank's part of it under ``mesh``), with cuDNN's
    deterministic algorithms: per step the loss and every trained tensor's
    gradient and value, on the host; the launch counts of the two steps;
    with ``timed``, the step's rate (SHORT depth) and a profiled run's busy
    share."""
    import torch

    from jarvis_hybridnet_torch.parallel.train_step import shard_batch

    with deterministic_cudnn():
        trainer, opt = train_graph_trainer(cfg, ckpt, "HybridNet", "all", repro, False,
                                           label, mesh=mesh, optimizer="sgd")
        B, C = batch["imgs"].shape[:2]
        rows = slice(None) if mesh is None else mesh.batch(B)
        b = shard_batch({k: torch.from_numpy(v[rows]).cuda() for k, v in batch.items()},
                        mesh, C)
        params = dict(trainer.model.named_parameters())
        names = [n for n, p in params.items() if p.requires_grad]
        out = {"before": {n: params[n].detach().cpu() for n in names}, "steps": []}
        kernels.reset_launch_counts()
        for lr in MULTI_LRS:
            loss, _ = trainer.train_step(b, opt, lr)
            out["steps"].append({"loss": float(loss),
                                 "grads": {n: params[n].grad.detach().cpu() for n in names},
                                 "params": {n: params[n].detach().cpu() for n in names}})
        torch.cuda.synchronize()
        out["launches"] = kernels.launch_counts()
    if timed:
        def fn(i):
            trainer.train_step(b, opt, 1e-6)

        rates = run_rates(fn, b["imgs"].shape[0], SHORT)
        out["rate"] = sorted(rates)[SHORT[0] // 2]
        out["busy"] = profiled_steps(kernels, fn, SHORT[1])["busy"]
    return out


def multi_split_control(kernels, cfg, ckpt, batch: dict, repro: str) -> dict:
    """The 2 x 1 data split without ``torch.distributed``: one process runs
    the ``all`` step of ``multi_train_steps`` on each half of ``batch``
    with the part of the global dropout draws that rank would keep
    (``set_mesh`` with a one-camera stand-in mesh: no collective runs) and
    sums the two halves' gradients itself. Returns the first step's summed
    gradients."""
    import types

    import torch

    from jarvis_hybridnet_torch.training import optim

    total = None
    for d in range(2):
        with deterministic_cudnn():
            trainer, opt = train_graph_trainer(cfg, ckpt, "HybridNet", "all", repro, False,
                                               f"Split{d}_{repro}", optimizer="sgd")
            half = types.SimpleNamespace(n_data=2, data_index=d, n_cameras=1, camera_index=0,
                                         cameras=lambda c: slice(0, c))
            trainer.model.set_mesh(half, batch["imgs"].shape[1])
            b = {k: torch.from_numpy(v[d:d + 1]).cuda() for k, v in batch.items()}
            params = dict(trainer.model.named_parameters())
            loss, _ = trainer.forward(b)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            optim.fill_missing_grads(opt)
            grads = {n: p.grad.detach().cpu() for n, p in params.items() if p.requires_grad}
        total = grads if total is None else {n: total[n] + g for n, g in grads.items()}
        del trainer, opt
    return total


def multi_frames():
    """predict3D's frames of the main path (seed 1), made anew on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    return torch.randint(0, 256, (T, CAMS, H, W, 3), dtype=torch.uint8, device="cuda",
                         generator=g)


def multi_predict(kernels, predictor, frames, timed: bool = True) -> dict:
    """One bf16 predict3D step of ``predictor`` (sharded or not) on its
    part of ``frames``: the crop centers, DLT centers and gate of its
    framesets, the V2V volume, points and confidences, on the host; the
    step's launch counts; with ``timed``, its rate and busy share."""
    import torch

    mesh = predictor.hybrid_model.mesh
    mine = frames if mesh is None else frames[:, predictor.cams]
    hybrid = predictor.hybrid_model
    out = {}
    with torch.no_grad():
        kernels.reset_launch_counts()
        points, conf, valid = predictor(mine)
        torch.cuda.synchronize()
        out["launches"] = kernels.launch_counts()
        center_hm, center3d, gate = predictor.centers(mine)
        local = center_hm[:, predictor.cams]
        rows = hybrid.heatmap_rows(predictor.crops(mine, local))
        t = mine.shape[0]
        vol = hybrid.v2v_output(rows, local, center3d.to(torch.int32).contiguous(),
                                *(a.expand(t, *a.shape) for a in (predictor.local_P,
                                                                   predictor.local_K,
                                                                   predictor.local_D)))
    out.update(center_hm=center_hm.cpu(), center3d=center3d.cpu(), gate=gate.cpu(),
               volume=vol.cpu(), points=points.cpu(), conf=conf.cpu(), valid=valid.cpu())
    if timed:
        def fn(i):
            predictor(mine)

        rates = run_rates(fn, mine.shape[0], SHORT)
        out["rate"] = sorted(rates)[SHORT[0] // 2]
        out["busy"] = profiled_steps(kernels, fn, SHORT[1])["busy"]
    return out


def multi_rank(rank: int, store: str, out: str, parent: str, ckpt: dict, batch: dict) -> None:
    """One of MULTI_RANKS gloo ranks sharing the card: the sharded ``all``
    train steps of MULTI_TRAIN and the sharded bf16 predict3D of
    MULTI_PREDICT at the production configuration; its results to
    ``out/rank<r>.pt``, a failure's traceback to ``out/error<r>.txt``."""
    import datetime
    import traceback

    try:
        sys.path.insert(0, REPO)
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0)
        from jarvis_hybridnet_torch import kernels
        from jarvis_hybridnet_torch.config.project_manager import ProjectManager
        from jarvis_hybridnet_torch.parallel import multihost
        from jarvis_hybridnet_torch.parallel.mesh import make_mesh
        from jarvis_hybridnet_torch.parallel.predict_step import build_sharded_predict3d
        from jarvis_hybridnet_torch.testing import monkeyhand_cfg, synthetic_rig

        timeout = datetime.timedelta(seconds=MULTI_TIMEOUT_S)
        multihost.initialize_distributed("gloo", store, MULTI_RANKS, rank, timeout)
        os.environ["JARVIS_PARENT_DIR"] = parent
        pm = ProjectManager(parent)
        pm.load("Train")
        cfg = pm.get_cfg()
        res = {}
        for n_data, n_cam, repro in MULTI_TRAIN:
            mesh = make_mesh(n_data, n_cam, timeout=timeout)
            b = batch if n_data > 1 else {k: v[:1] for k, v in batch.items()}
            res[("train", n_data, n_cam, repro)] = multi_train_steps(
                kernels, cfg, ckpt, b, mesh, repro, f"Multi{rank}_{n_data}x{n_cam}_{repro}",
                timed=repro == "quarter_fused")
        pcfg, rig, frames = monkeyhand_cfg(), synthetic_rig(CAMS, W, H), multi_frames()
        for n_data, n_cam in MULTI_PREDICT:
            mesh = make_mesh(n_data, n_cam, timeout=timeout)
            predictor = build_sharded_predict3d(pcfg, rig, ckpt["CenterDetect"],
                                                ckpt["HybridNet"], mesh=mesh,
                                                dtype="bfloat16", shard_cameras=n_cam > 1,
                                                device="cuda", graph=False)
            predictor(frames[mesh.batch(T)][:, predictor.cams])  # warm-up
            res[("predict", n_data, n_cam)] = multi_predict(kernels, predictor,
                                                            frames[mesh.batch(T)])
            del predictor
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"error{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def multi_nccl_phase(kernels, ckpt, note, smi) -> dict:
    """NCCL, one rank, in this process: the graphed ``all`` quarter_fused
    float32 train step at full width (12 cameras, 256^2 crops, G = 72,
    batch 1, AdamW) through ``HybridNetTrainer`` on a 1 x 1 mesh, its
    gradient all-reduce captured with the step, against the non-distributed
    graphed step: with cuDNN's deterministic algorithms two eager trainers,
    the graphed one and the distributed graphed one take the 5 steps of
    TRAIN_GRAPH_LRS from one state (``sync_twin``), and the distributed
    replays hold to the graphed ones by ``twin_verdict`` (bit-equal where
    the eager twins are, else within GAP_FACTOR times their gap: K11 adds
    with atomics); the graph's kernels and copies in a profiled replay, the
    all-reduce's calls from Python (eager, under capture, in the replays)
    and both steps' rates."""
    import torch
    import torch.distributed as dist

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.parallel import multihost
    from jarvis_hybridnet_torch.parallel.mesh import make_mesh
    from jarvis_hybridnet_torch.training import graphed

    multihost.initialize_distributed("nccl", f"tcp://localhost:{free_port()}", 1, 0)
    all_reduce, issued = dist.all_reduce, []

    def counted(tensor, *args, **kwargs):  # the collectives issued from Python, by kind
        issued.append("capture" if torch.cuda.is_current_stream_capturing() else "eager")
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = counted
    try:
        mesh = make_mesh(1, 1)
        pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
        pm.load("Train")
        cfg = pm.get_cfg()
        batches = train_graph_batches(cfg, "HybridNet")
        with deterministic_cudnn():
            twins = [train_graph_trainer(cfg, ckpt, "HybridNet", "all", "quarter_fused", g,
                                         f"Nccl{i}", mesh=m)
                     for i, (g, m) in enumerate(((False, None), (False, None), (True, None),
                                                 (True, mesh)))]
            eager_gaps, graph_gaps = [], []
            for n, lr in enumerate(TRAIN_GRAPH_LRS):
                for i in range(3):
                    sync_twin(twins[i], twins[3])
                outs = [t.train_step(batches[n % 2], opt, lr) for t, opt in twins]
                if n == len(TRAIN_GRAPH_LRS) - 1:
                    kinds = {k: issued.count(k) for k in ("eager", "capture")}
                states = [twin_state(o, t, opt) for o, (t, opt) in zip(outs, twins)]
                eager_gaps.append(twin_gap(states[1], states[0]))
                if n >= 2:  # the replays
                    graph_gaps.append(twin_gap(states[3], states[2]))
            held, words = twin_verdict(eager_gaps, graph_gaps)
        step = twins[3][0].graphs.steps["train"][1]
        res = {}
        issued.clear()
        for name, (trainer, opt) in (("distributed", twins[3]), ("non-distributed", twins[2])):
            def fn(i, trainer=trainer, opt=opt):
                trainer.train_step(batches[i % 2], opt, 1e-6)

            repeats, iters = SHORT
            rates = run_rates(fn, 1, SHORT)
            prof = profiled_steps(kernels, fn, iters)
            res[name] = dict(rate=sorted(rates)[repeats // 2],
                             ms=1e3 / sorted(rates)[repeats // 2], busy=prof["busy"],
                             device_ms=prof["device_ms"],
                             records=sum(prof["kernels"].values()) / iters,
                             copies=sum(prof["copies"].values()) / iters)
        d, p = res["distributed"], res["non-distributed"]
        replayed = len(issued)
        note(f"multi NCCL one rank: the graphed all quarter_fused float32 step (full width, "
             f"batch 1) on a 1 x 1 NCCL mesh against the non-distributed graphed step, "
             f"{len(graph_gaps)} replays from one state: {words}; the graph's nodes as the "
             f"profile sees a replay: kernels {d['records']:.1f} against {p['records']:.1f}, "
             f"copies {d['copies']:.1f} against "
             f"{p['copies']:.1f}; the gradient all-reduce ({dist.get_backend()}) issued from "
             f"Python {kinds['eager']} times in the {graphed.WARMUP} eager steps, "
             f"{kinds['capture']} in the capture and {replayed} times in "
             f"{SHORT[0] * SHORT[1] + SHORT[1]} replays (a world of one rank: NCCL copies nothing "
             f"and launches no kernel); step {d['ms']:.3f} ms "
             f"({d['rate']:.2f} framesets/s, busy {d['busy']:.3f}, kernels {d['device_ms']:.3f} "
             f"ms) against {p['ms']:.3f} ms ({p['rate']:.2f}, busy {p['busy']:.3f}, kernels "
             f"{p['device_ms']:.3f} ms); card: {smi}")
        if (not held or len(step.graphs) != 1 or kinds["capture"] != 1
                or kinds["eager"] != graphed.WARMUP or replayed):
            fail(f"multi NCCL: the distributed replays do not hold ({words}), "
                 f"{len(step.graphs)} graphs were captured, or the all-reduce was issued "
                 f"{kinds} before and {replayed} times in the replays (want {graphed.WARMUP} "
                 f"eager, 1 in the capture, 0 in the replays)")
        del twins
        return res
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()


def multi_gloo_phase(kernels, ckpt, predictor, note, smi) -> dict:
    """MULTI_RANKS gloo ranks spawned on the one card (``multi_rank``),
    each its own process started with ``spawn`` (this process holds a CUDA
    context already), sharing the kernels' build directory; their sharded
    ``all`` train steps against the single-process step of this process on
    the same global batch (framesets 0 and 1 of the training set, without
    color augmentation), their sharded predict3D against ``predictor`` on
    the main path's frames. Returns each configuration's launch counts on
    rank 0 for the kernels line."""
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np
    import torch

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.training.trainer3d import BATCH_KEYS

    parent = os.environ["JARVIS_PARENT_DIR"]
    pm = ProjectManager(parent)
    pm.load("Train")
    cfg = pm.get_cfg()
    ds = Dataset3D(cfg, set="val", device_targets=True)
    samples = [ds[i] for i in range(2)]
    batch = {k: np.stack([np.asarray(x[k]) for x in samples]) for k in BATCH_KEYS}
    out = tempfile.mkdtemp()  # the ranks' results: about 90 MB each
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=multi_rank, args=(r, f"file://{out}/store", out, parent, ckpt,
                                                  batch)) for r in range(MULTI_RANKS)]
    for proc in procs:
        proc.start()
    # meanwhile, the single-process references on this process's share of the card,
    # twice: the card's own gap between two runs of one step (K11 / K12 add
    # with atomics)
    want = {key: [multi_train_steps(kernels, cfg, ckpt,
                                    batch if key[0] > 1 else {k: v[:1] for k, v in batch.items()},
                                    None, key[2], f"Single{i}_{key[0]}x{key[1]}_{key[2]}",
                                    timed=False) for i in range(2)]
            for key in MULTI_TRAIN}
    frames = multi_frames()
    single = multi_predict(kernels, predictor, frames, timed=False)
    end = time.perf_counter() + MULTI_TIMEOUT_S
    for proc in procs:
        proc.join(max(0.0, end - time.perf_counter()))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    errors = [open(os.path.join(out, f"error{r}.txt")).read() for r in range(MULTI_RANKS)
              if os.path.exists(os.path.join(out, f"error{r}.txt"))]
    if errors or any(proc.exitcode != 0 for proc in procs):
        fail("multi gloo: a rank failed or hung (exit codes "
             f"{[proc.exitcode for proc in procs]}):\n" + "\n".join(errors))
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(MULTI_RANKS)]
    shutil.rmtree(out, ignore_errors=True)
    note(f"multi gloo: {MULTI_RANKS} ranks spawned on the one card ran in "
         f"{time.perf_counter() - t0:.1f} s (two ranks share one card: {smi}; their rates are "
         f"information, not a scaling claim)")
    counts, problems = {}, []

    def losses(a, b):
        return [abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(a["steps"],
                                                                            b["steps"])]

    for n_data, n_cam, repro in MULTI_TRAIN:
        key = ("train", n_data, n_cam, repro)
        ref, twin = want[(n_data, n_cam, repro)]
        r0 = got[0][key]
        loss, twin_loss = losses(r0, ref), losses(twin, ref)
        gaps = multi_gaps(r0["steps"][0], ref["steps"][0], ref["before"])
        tgaps = multi_gaps(twin["steps"][0], ref["steps"][0], ref["before"])
        loss_tol = [max(tol, GAP_FACTOR * t) for tol, t in zip(MULTI_LOSS_TOL, twin_loss)]
        step_tol = [max(MULTI_STEP_TOL, GAP_FACTOR * t) for t in tgaps[:2]]
        same = all(torch.equal(p, got[r][key]["steps"][-1]["params"][n])
                   for r in range(1, MULTI_RANKS) for n, p in r0["steps"][-1]["params"].items())
        control = ""
        if n_data == 2:
            split = {"grads": multi_split_control(kernels, cfg, ckpt, batch, repro),
                     "params": ref["steps"][0]["params"]}
            cgap = multi_gaps(split, ref["steps"][0], ref["before"])
            sgap = multi_gaps(r0["steps"][0], split, ref["before"])
            control = (f"; one process summing the two halves' gradients itself differs from "
                       f"the single-process step by {cgap[0]:.2e} ({cgap[2]}) in the first "
                       f"step's gradients, and the sharded step from it by {sgap[0]:.2e}")
        rates = "; ".join(f"rank {r} {got[r][key]['rate']:.2f} framesets/s, busy "
                          f"{got[r][key]['busy']:.3f}" for r in range(MULTI_RANKS)
                          if "rate" in got[r][key])
        note(f"multi gloo train all {repro} {n_data} x {n_cam} (batch {n_data}, "
             f"{CAMS // n_cam} cameras a rank) against the single-process step (two runs of it "
             f"differ by {', '.join(f'{x:.2e}' for x in twin_loss)} in the loss, "
             f"{tgaps[0]:.2e} ({tgaps[2]}) in the first step's gradients, {tgaps[1]:.2e} "
             f"({tgaps[3]}) in its updates): loss {', '.join(f'{x:.2e}' for x in loss)} "
             f"relative (tol {', '.join(f'{x:.2e}' for x in loss_tol)}); first step's gradients "
             f"{gaps[0]:.2e} ({gaps[2]}), updates {gaps[1]:.2e} ({gaps[3]}) of each tensor's "
             f"largest (tol {step_tol[0]:.2e}, {step_tol[1]:.2e}: MULTI_STEP_TOL "
             f"{MULTI_STEP_TOL:g}, or {GAP_FACTOR:g}x the two runs' gap); ranks' parameters "
             f"after 2 steps {'bit-equal' if same else 'DIFFER'}{control}; the largest "
             f"gradient gaps "
             f"over their own tensor's largest: "
             + ", ".join(f"{g:.2e} ({n}, {o:.1e} of the largest)" for g, o, n in gaps[4])
             + f"; {rates}")
        if (any(x > t for x, t in zip(loss, loss_tol)) or gaps[0] > step_tol[0]
                or gaps[1] > step_tol[1] or not same):
            problems.append(f"train {repro} {n_data} x {n_cam}: the sharded step does not "
                            f"hold to the single-process step")
        counts[f"multi_train_{n_data}x{n_cam}_{repro}"] = r0["launches"]
    vulp = 2.0 ** (math.floor(math.log2(float(single["volume"].float().abs().max()))) - 7)
    for n_data, n_cam in MULTI_PREDICT:
        key = ("predict", n_data, n_cam)
        groups = [g[key] for r, g in enumerate(got) if r % n_cam == 0]
        cat = {k: torch.cat([g[k] for g in groups]) for k in ("center_hm", "gate", "volume",
                                                               "points", "center3d")}
        centers = int((cat["center_hm"] != single["center_hm"]).any(-1).sum())
        gates = int((cat["gate"] != single["gate"]).sum())
        agree = ((cat["center_hm"] == single["center_hm"]).all(-1).all(-1)
                 & (cat["gate"] == single["gate"]) & (cat["center3d"] == single["center3d"]).all(-1))
        ulps = (float((cat["volume"][agree].float() - single["volume"][agree].float()).abs().max())
                / vulp if agree.any() else float("nan"))
        pts = float((cat["points"][agree] - single["points"][agree]).abs().max()) \
            if agree.any() else float("nan")
        rates = "; ".join(f"rank {r} {g[key]['rate']:.2f} poses/s, busy {g[key]['busy']:.3f}"
                          for r, g in enumerate(got))
        note(f"multi gloo predict3D bf16 quarter_fused T={T} {n_data} x {n_cam}: crop centers "
             f"differing {centers} of {T * CAMS}, gates {gates} of {T}; over the {int(agree.sum())}"
             f" framesets whose centers and gate agree the V2V volume {ulps:.1f} bf16 ulps of "
             f"its range (tol {MULTI_VOLUME_ULPS:g}), points {pts:.4f} mm (information); "
             f"{rates}")
        if not agree.any() or not ulps <= MULTI_VOLUME_ULPS:
            problems.append(f"predict3D {n_data} x {n_cam}: the sharded volume does not hold")
        counts[f"multi_predict_{n_data}x{n_cam}"] = groups[0]["launches"]
    if problems:
        fail("multi gloo: " + "; ".join(problems))
    return counts


def check_c_total(kernels, recorder, counts, note, smi) -> list:
    """K2, K5 (exact, half, half_fused), K11 and K12 at ``c_total`` =
    C_TOTAL on the first 6 cameras of the ``all`` training step's float32
    rows (g4 = 18, G = 72): each against its plain version at its existing
    tolerance (the forwards' indices equal and volumes within 1e-5
    relative; the backwards by ``check_gather_backward``), and the c_total
    keys of the kernels line, their launches those of the sharded paths on
    rank 0 (``multi_gloo_phase``)."""
    import torch

    from jarvis_hybridnet_torch.kernels.repro_gather import pad_rows

    (args,) = [a for a, per in recorder.k2.values() if "training_all_step" in per]
    rows, c3d, chm, P, K, D, g4, step = args
    half = CAMS // 2
    rows6 = pad_rows(rows[:, :half])
    chm6, cams = chm[:, :half].contiguous(), [a[:, :half].contiguous() for a in (P, K, D)]
    hs2, J = rows6.shape[2], rows6.shape[3]
    entries = []
    k2_args = (rows6, c3d, chm6, *cams, g4, step)
    k_vol, k_idx = kernels.repro_quarter_gather(*k2_args, True, c_total=C_TOTAL)
    p_vol, p_idx = kernels.repro_quarter_gather_plain(*k2_args, c_total=C_TOTAL)
    rel = float((k_vol - p_vol).abs().max() / p_vol.abs().max().clamp_min(1e-30))
    note(f"repro_quarter_gather c_total={C_TOTAL} on {half} cameras: indices "
         f"{'equal' if torch.equal(k_idx, p_idx) else 'DIFFER'}, volume {rel:.2e} relative to "
         f"the plain version (tol 1e-5)")
    if rel > 1e-5 or not torch.equal(k_idx, p_idx):
        fail("repro_quarter_gather at c_total differs from its plain version")
    nbytes = rows_touched(p_idx, hs2) * J * rows6.element_size() + k_vol.numel() * 4
    entries.append(kernel_entry(
        f"repro_quarter_gather[c_total={C_TOTAL}]", "repro_quarter_gather.cu",
        "jarvis_hybridnet_tpu/models/repro.py:280",
        counts["multi_train_1x2_quarter_fused"]["repro_quarter_gather"],
        float((k_vol - p_vol).abs().max()),
        lambda: kernels.repro_quarter_gather(*k2_args, c_total=C_TOTAL),
        lambda: kernels.repro_quarter_gather_plain(*k2_args, c_total=C_TOTAL),
        nbytes / HBM_BYTES_PER_S * 1e3, path="multi_train_1x2_quarter_fused"))
    fwd = lambda: kernels.repro_quarter_gather(*k2_args, True, c_total=C_TOTAL)  # noqa: E731
    call = lambda g, i: kernels.repro_quarter_gather_backward(  # noqa: E731
        g, i, hs2, J, c_total=C_TOTAL)
    plain = lambda g, i: kernels.repro_quarter_gather_backward_plain(  # noqa: E731
        g, i, hs2, J, C_TOTAL)
    grad, idx, err = check_gather_backward("repro_quarter_gather_backward", fwd, call, plain,
                                           f"c_total={C_TOTAL} on {half} cameras", note)
    e = backward_entry(f"repro_quarter_gather_backward[c_total={C_TOTAL}]", "quarter_fused",
                       call, plain, grad, idx, err,
                       counts["multi_train_1x2_quarter_fused"]["repro_quarter_gather_backward"],
                       1, note, smi)
    e["path"] = "multi_train_1x2_quarter_fused"
    entries.append(e)
    G, sp = 4 * g4, step / 4.0
    for mode in OTHER_MODES:
        a = (rows6, c3d, chm6, *cams, G, sp, mode)
        k_vol, k_idx = kernels.repro_grid_gather(*a, True, c_total=C_TOTAL)
        p_vol, p_idx = kernels.repro_grid_gather_plain(*a, c_total=C_TOTAL)
        rel = float((k_vol - p_vol).abs().max() / p_vol.abs().max().clamp_min(1e-30))
        note(f"repro_grid_gather[{mode}] c_total={C_TOTAL} on {half} cameras: indices "
             f"{'equal' if torch.equal(k_idx, p_idx) else 'DIFFER'}, volume {rel:.2e} relative "
             f"(tol 1e-5)")
        if rel > 1e-5 or not torch.equal(k_idx, p_idx):
            fail(f"repro_grid_gather {mode} at c_total differs from its plain version")
        fwd = lambda a=a: kernels.repro_grid_gather(*a, True, c_total=C_TOTAL)  # noqa: E731
        call = lambda g, i, m=mode: kernels.repro_grid_gather_backward(  # noqa: E731
            g, i, hs2, J, m, c_total=C_TOTAL)
        plain = lambda g, i, m=mode: kernels.repro_grid_gather_backward_plain(  # noqa: E731
            g, i, hs2, J, m, C_TOTAL)
        grad, idx, err = check_gather_backward(f"repro_grid_gather_backward[{mode}]", fwd,
                                               call, plain,
                                               f"c_total={C_TOTAL} on {half} cameras", note)
        if mode != "exact":
            continue
        nbytes = rows_touched(p_idx, hs2) * J * rows6.element_size() + k_vol.numel() * 4
        entries.append(kernel_entry(
            f"repro_grid_gather[exact,c_total={C_TOTAL}]", "repro_grid_gather.cu",
            "jarvis_hybridnet_tpu/models/repro.py:266",
            counts["multi_train_1x2_exact"]["repro_grid_gather"],
            float((k_vol - p_vol).abs().max()),
            lambda a=a: kernels.repro_grid_gather(*a, c_total=C_TOTAL),
            lambda a=a: kernels.repro_grid_gather_plain(*a, c_total=C_TOTAL),
            nbytes / HBM_BYTES_PER_S * 1e3, mode=mode, path="multi_train_1x2_exact"))
        e = backward_entry(f"repro_grid_gather_backward[exact,c_total={C_TOTAL}]", mode, call,
                           plain, grad, idx, err,
                           counts["multi_train_1x2_exact"]["repro_grid_gather_backward"], 1,
                           note, smi)
        e["path"] = "multi_train_1x2_exact"
        entries.append(e)
    del grad, idx, k_vol, p_vol
    torch.cuda.empty_cache()
    return entries

CLI_FRAMES = 16  # frames of the cli phase's recording
# the cli phase's commands: train hybridNet (3D_only), predict predict3D and
# analyze analyze-validation-data
CLI_KERNELS = TRAINING_KERNELS + ("resize_normalize", "argmax2d")
# the production values the cli phase sets in the created project's config.yaml,
# as training_project writes them (G = 72)
CLI_CONFIG = {
    "CENTERDETECT": {"IMAGE_SIZE": 256, "BATCH_SIZE": 4},
    "KEYPOINTDETECT": {"BOUNDING_BOX_SIZE": 256, "BATCH_SIZE": 4},
    "HYBRIDNET": {"ROI_CUBE_SIZE": 144, "GRID_SPACING": 2, "BATCH_SIZE": 1},
    "TPU": {"INFERENCE_DTYPE": "bfloat16", "REPRO_MODE": "quarter_fused", "FRAME_BATCH": T,
            "TRAIN_DTYPE": "float32"},
}


def cli_recording(parent: str, dataset: str, frames: int = CLI_FRAMES,
                  name: str = "recording") -> str:
    """A ``frames``-frame MJPG recording of the dataset's cameras in
    ``parent/name``: frame t of camera c is camera c's JPEG of the dataset's
    frameset t mod the framesets (train, then val); the cameras are written
    on threads of their own."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    rec = os.path.join(parent, name)
    os.makedirs(rec)
    sets = [(split, f) for split, n in TRAIN_SPLITS for f in range(n)]

    def camera(c):
        imgs = [cv2.imread(os.path.join(dataset, split, "Session", f"Frame_{f}", f"Cam{c}.jpg"))
                for split, f in sets]
        w = cv2.VideoWriter(os.path.join(rec, f"Cam{c}.avi"), cv2.VideoWriter_fourcc(*"MJPG"),
                            30, (W, H))
        for t in range(frames):
            w.write(imgs[t % len(imgs)])
        w.release()

    with ThreadPoolExecutor(min(CAMS, os.cpu_count() or 1)) as pool:
        list(pool.map(camera, range(CAMS)))
    return rec


def cli_phase(kernels, ckpt, note, smi, driver_rate: float, then=None) -> dict:
    """``jarvis-torch`` (``jarvis_hybridnet_torch/ui/cli.py``) on the card,
    in this process through click's ``CliRunner``, at full width, in a
    temporary parent directory under chiprun_out/: ``create-project
    --dataset3d`` on the synthetic 12-camera 1280x1024 dataset of
    :func:`training_data` (NUM_CAMERAS, NUM_JOINTS, the bounding box a
    multiple of 64 and the cube of 4 x spacing checked), the production
    values of CLI_CONFIG set in its config.yaml (bbox 256, cube 144 at 2 mm:
    G = 72, bf16 inference, quarter_fused, FRAME_BATCH 8), ``train hybridNet
    --num_epochs 1`` from the committed checkpoint (3D_only, graphed),
    ``predict predict3D`` on a CLI_FRAMES-frame 12-camera MJPG recording,
    ``analyze analyze-validation-data`` and ``visualize create-videos3D``,
    with CenterDetect's stride-2 head scaled by 8 (as the CPU tests scale it)
    so that framesets pass the gate. The launches are counted over the
    commands alone: eager calls, graph warm-ups and captures, not the
    replays of captured graphs. Then the checks against direct calls: data3D.csv equal
    row for row to ``predict3D()`` on the same recording with the same
    weights, points_HybridNet.csv and frame_names.csv equal to the project's
    predictor on the same val framesets (padded to FRAME_BATCH, read as the
    analysis reads them), 12 videos of CLI_FRAMES frames. Each command's
    wall seconds and predict3D's poses/s through the CLI are printed.
    ``then(ctx)``, where given, runs before the parent directory goes, on
    the project, the recording, the weights and the direct call's rows,
    launches and clock (``chip_smoke_export``'s phases). Returns the launch
    counts."""
    import csv
    import shutil
    import tempfile

    import cv2
    import numpy as np
    import torch
    import yaml
    from click.testing import CliRunner

    import chip_smoke_export

    from jarvis_hybridnet_torch.analysis.analyze import _native_frameset_stream
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
    from jarvis_hybridnet_torch.models.weights import params_from_jax
    from jarvis_hybridnet_torch.prediction.loaders import make_predictor3d
    from jarvis_hybridnet_torch.prediction.predict3d import predict3D
    from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d
    from jarvis_hybridnet_torch.training.train_interface import get_latest_weights_path
    from jarvis_hybridnet_torch.ui.cli import cli
    from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt, write_ckpt
    from jarvis_hybridnet_torch.utils.param_classes import Predict3DParams
    from jarvis_hybridnet_torch.utils.utils import latest_run_dir

    t_phase = time.perf_counter()
    parent = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(REPO, "chiprun_out"))
    os.environ["JARVIS_PARENT_DIR"] = parent
    proj = os.path.join(parent, "projects", "Cli")
    try:
        dataset = write_dataset3d(os.path.join(parent, "datasets", "Synth"),
                                  synthetic_rig(CAMS, W, H), W, H, 23, splits=TRAIN_SPLITS,
                                  extent_mm=100.0, seed=5)
        rec = cli_recording(parent, dataset)
        tree = read_ckpt(ckpt["CenterDetect"])
        tree["deconv1"]["kernel"] = np.asarray(tree["deconv1"]["kernel"]) * 8.0
        center = os.path.join(parent, "weights", "CenterDetect_x8.ckpt")
        write_ckpt(center, tree)
        note(f"cli: dataset, {CLI_FRAMES}-frame recording of {CAMS} cameras and weights "
             f"written in {time.perf_counter() - t_phase:.2f} s")
        walls = {}

        def command(*args):
            t0 = time.perf_counter()
            res = CliRunner().invoke(cli, ["--device", "cuda", *args], catch_exceptions=False)
            torch.cuda.synchronize()
            walls[" ".join(args[:2])] = time.perf_counter() - t0
            if res.exit_code != 0:
                fail(f"jarvis-torch {' '.join(args)} exited {res.exit_code}: "
                     f"{res.output[-2000:]}")
            return res.output

        def commands():
            command("create-project", "--dataset3d", "Synth", "Cli")
            with open(os.path.join(proj, "config.yaml")) as f:
                made = yaml.safe_load(f)
            derived = (made["HYBRIDNET"]["NUM_CAMERAS"], made["KEYPOINTDETECT"]["NUM_JOINTS"],
                       made["KEYPOINTDETECT"]["BOUNDING_BOX_SIZE"],
                       made["HYBRIDNET"]["ROI_CUBE_SIZE"], made["HYBRIDNET"]["GRID_SPACING"])
            note(f"cli create-project: NUM_CAMERAS {derived[0]}, NUM_JOINTS {derived[1]}, "
                 f"BOUNDING_BOX_SIZE {derived[2]}, ROI_CUBE_SIZE {derived[3]}, GRID_SPACING "
                 f"{derived[4]}")
            if (derived[:2] != (CAMS, 23) or derived[2] % 64
                    or derived[3] % (4 * derived[4])):
                fail(f"create-project derived {derived}")
            for section, values in CLI_CONFIG.items():
                made.setdefault(section, {}).update(values)
            with open(os.path.join(proj, "config.yaml"), "w") as f:
                yaml.safe_dump(made, f)
            out = command("train", "hybridNet", "--num_epochs", "1", "--weights_hybridnet",
                          ckpt["HybridNet"], "Cli")
            if "Successfully finished training" not in out:
                fail(f"train hybridNet did not finish: {out[-2000:]}")
            command("predict", "predict3D", "--weights_center_detect", center, "Cli", rec)
            command("analyze", "analyze-validation-data", "--weights_center_detect", center,
                    "Cli")
            command("visualize", "create-videos3D", "Cli")

        _, counts = path_launches(commands, kernels, CLI_KERNELS, "cli", ShapeRecorder())
        note(f"cli launches over the commands (eager calls, graph warm-ups and captures; "
             f"graph replays not counted): {json.dumps(counts)}")

        # train: the run's final weights, found as 'latest' finds them
        trained = get_latest_weights_path("Cli", "HybridNet")
        start = params_from_jax(read_ckpt(ckpt["HybridNet"]), "small")
        back = params_from_jax(read_ckpt(trained), "small")
        moved = [k for k in back if k.startswith("v2vNet.") and k.endswith(".weight")
                 and not torch.equal(back[k], start[k])]
        frozen = all(torch.equal(back[k], start[k]) for k in back if k.startswith("effTrack."))
        note(f"cli train hybridNet: {os.path.relpath(trained, parent)}; V2V weights changed "
             f"{len(moved)}, 2D net unchanged {frozen}")
        if not moved or not frozen:
            fail("train hybridNet (3D_only) did not train V2V alone")

        # predict3D: the command's rows against predict3D() called directly
        run = latest_run_dir(os.path.join(proj, "predictions", "predictions3D"))
        direct_dir = os.path.join(parent, "direct3D")
        t0 = time.perf_counter()
        with chip_smoke_export.driver_clock() as off_clock:
            _, off_counts = chip_smoke_export.counted(kernels, lambda: predict3D(Predict3DParams(
                "Cli", rec, weights_center_detect=center, weights_hybridnet=trained,
                output_dir=direct_dir), device="cuda"))
        direct_s = time.perf_counter() - t0
        with open(os.path.join(run, "data3D.csv"), newline="") as f, \
                open(os.path.join(direct_dir, "data3D.csv"), newline="") as g:
            rows, direct = list(csv.reader(f)), list(csv.reader(g))
        valid_rows = sum(not r[0].lower().startswith("nan") for r in rows[2:])
        note(f"cli predict predict3D: data3D.csv {len(rows)} rows ({valid_rows} of "
             f"{CLI_FRAMES} framesets through the gate), equal row for row to predict3D() "
             f"called directly: {rows == direct}")
        if rows != direct or len(rows) != CLI_FRAMES + 2:
            fail("the predict3D command's data3D.csv differs from the direct call's")

        # analysis: the command's CSVs against the project's predictor on the
        # same val framesets, read and padded as the analysis reads them
        pm = ProjectManager()
        pm.load("Cli")
        cfg = pm.get_cfg()
        ds = Dataset3D(cfg, set="val", analysisMode=True)
        pipe = _native_frameset_stream(ds, cfg)
        if pipe is not None:
            imgs = [a for _, a in pipe]
            pipe.close()
        else:
            imgs = [ds[i]["imgs"] for i in range(len(ds))]
        batch = np.stack(imgs + [imgs[-1]] * (T - len(imgs)))
        pred = make_predictor3d(cfg, ds.rigs["Session"], center, trained, device="cuda")
        pts, _, valid = (a[:len(imgs)].cpu().numpy() for a in pred(batch))
        adir = latest_run_dir(os.path.join(proj, "analysis"))
        names = open(os.path.join(adir, "frame_names.csv")).read().split()
        got = np.loadtxt(os.path.join(adir, "points_HybridNet.csv"), delimiter=",",
                         ndmin=2).reshape(-1, 23, 3)
        want_names = [ds.imgs[ds.dataset["framesets"][k]["frames"][0]]["file_name"]
                      for k, v in zip(ds.frameset_keys, valid) if v]
        same = names == want_names and np.array_equal(got, pts[valid].astype(np.float64))
        note(f"cli analyze analyze-validation-data: {len(names)} of {len(imgs)} val framesets "
             f"through the gate ({'uint8 frames, native pipeline' if pipe is not None else 'float32 frames through cv2'}); "
             f"frame names and points equal to the project's predictor: {same}")
        if not same:
            fail("analyze-validation-data's CSVs differ from the project's predictor")

        # videos: one a camera, CLI_FRAMES frames each
        vdir = latest_run_dir(os.path.join(proj, "visualization"))
        lengths = {}
        for name in sorted(os.listdir(vdir)):
            cap = cv2.VideoCapture(os.path.join(vdir, name))
            n = 0
            while cap.read()[0]:
                n += 1
            cap.release()
            lengths[name] = n
        note(f"cli visualize create-videos3D: {len(lengths)} videos, frames {sorted(set(lengths.values()))}")
        if len(lengths) != CAMS or set(lengths.values()) != {CLI_FRAMES}:
            fail(f"create-videos3D wrote {lengths}")

        predict_s = walls["predict predict3D"]
        note(f"cli wall seconds per command: {json.dumps({k: round(v, 2) for k, v in walls.items()})}; "
             f"predict3D through the CLI {CLI_FRAMES / predict_s:.2f} poses/s ({CLI_FRAMES} "
             f"frames, weights, graph capture and video decode included; the direct call "
             f"{CLI_FRAMES / direct_s:.2f} poses/s), beside the driver phase's streaming loop "
             f"{driver_rate:.2f} poses/s; card: {smi}")
        note(f"cli phase: {time.perf_counter() - t_phase:.1f} s")
        if then is not None:
            then(dict(parent=parent, dataset=dataset, rec=rec, center=center, hybrid=trained,
                      keypoint=ckpt["KeypointDetect"], direct_dir=direct_dir,
                      off_counts=off_counts,
                      off_first_s=off_clock["steps"][0] - off_clock["start"]))
    finally:
        os.environ.pop("JARVIS_PARENT_DIR", None)
        shutil.rmtree(parent, ignore_errors=True)
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="time the kernel of --baseline-kernel built from DIR beside the "
                         "current one")
    ap.add_argument("--baseline-kernel", choices=("k9", "k12"), default="k9",
                    help="the kernel --baseline-csrc holds: K9 (BASELINE_SIGNATURE) or K12 "
                         "(BASELINE_K12_SIGNATURE)")
    args = ap.parse_args()
    faulthandler.enable()  # a crash in a library prints the Python stack
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build
    from jarvis_hybridnet_torch.models.efficienttrack import EfficientTrackBackbone
    from jarvis_hybridnet_torch.models.weights import params_from_jax
    from jarvis_hybridnet_torch.prediction.loaders import make_predictor3d
    from jarvis_hybridnet_torch.testing import monkeyhand_cfg, synthetic_rig
    from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    log = open(os.path.join(out_dir, "chip_smoke.txt"), "w")

    def note(msg: str) -> None:
        print(msg)
        log.write(msg + "\n")
        log.flush()

    starts = []  # (phase, its start in s into the run)

    def phase(name: str) -> None:
        starts.append((name, time.perf_counter() - t_start))
        note(f"phase {name}: starts {starts[-1][1]:.1f} s into the run")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    log.write(f"card: {smi}\n")
    dev = torch.device("cuda")

    phase("build")
    # 2. kernels, one nvcc per source, all at once
    t0 = time.perf_counter()
    build.build_all()
    note(f"build: {time.perf_counter() - t0:.1f} s for {len(build.SOURCES)} kernels")
    for name, label in (("repro_grid_gather", "K5"), ("instance_norm_act_backward", "K6"),
                        ("hybridnet_loss", "K7"), ("heatmap2d_loss", "K8"),
                        ("color_aug", "K9"), ("argmax2d", "K10"),
                        ("repro_gather_backward", "K11"), ("repro_grid_gather_backward", "K12")):
        log.write(f"ptxas for {name}.cu ({label}):\n")
        for line in ptxas_lines(name):
            log.write(f"  {line}\n")
    baseline = k12_baseline = None
    if args.baseline_csrc and args.baseline_kernel == "k9":
        baseline = build_baseline(os.path.abspath(args.baseline_csrc))
    elif args.baseline_csrc:
        k12_baseline = build_k12_baseline(os.path.abspath(args.baseline_csrc))
    base_log = (open(os.path.join(out_dir, "chip_smoke_baseline.txt"), "w")
                if args.baseline_csrc else None)

    phase("load")
    # 3-5. checkpoints, rig, predictor at the production configuration
    cfg = monkeyhand_cfg()
    rig = synthetic_rig(CAMS, W, H)
    ckpt = {n: os.path.join(REPO, "trained", "MonkeyHand", f"{n}_final.ckpt")
            for n in ("CenterDetect", "KeypointDetect", "HybridNet")}
    t0 = time.perf_counter()
    keypoint = EfficientTrackBackbone("small", 23)
    keypoint.load_state_dict(params_from_jax(read_ckpt(ckpt["KeypointDetect"]), "small"),
                             strict=True)
    predictor = make_predictor3d(cfg, rig, ckpt["CenterDetect"], ckpt["HybridNet"],
                                 dtype="bfloat16", device="cuda", graph=False)
    n_params = sum(p.numel() for m in (predictor.center_model, predictor.hybrid_model)
                   for p in m.parameters())
    note(f"load: {time.perf_counter() - t0:.2f} s for the 3 MonkeyHand checkpoints "
         f"(KeypointDetect loads strictly; the predictor holds {n_params} parameters)")
    gens = [torch.Generator(device=dev).manual_seed(s) for s in (1, 2)]
    frames = [torch.randint(0, 256, (T, CAMS, H, W, 3), dtype=torch.uint8, device=dev,
                            generator=g) for g in gens]

    t0 = time.perf_counter()
    predictor(frames[0])
    torch.cuda.synchronize()
    note(f"warm-up step: {time.perf_counter() - t0:.2f} s")

    recorder = ShapeRecorder()
    (points, conf, valid), launches = path_launches(lambda: predictor(frames[0]), kernels,
                                                    MAIN_PATH_KERNELS, "quarter_fused",
                                                    recorder)
    note(f"launches in one main-path step: {json.dumps(launches)}")

    rate(lambda i: predictor(frames[i % 2]), T, note,
         f"predict3D (T={T}, two alternating seeded batches)", "poses/s")

    # 6. outputs
    for name, t, shape in (("points3D", points, (T, 23, 3)), ("confidences", conf, (T, 23)),
                           ("valid", valid, (T,))):
        if tuple(t.shape) != shape:
            fail(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    finite = bool(torch.isfinite(points).all() and torch.isfinite(conf).all()
                  and torch.isfinite(predictor(frames[1])[0]).all())
    note(f"outputs: points3D {tuple(points.shape)}, confidences {tuple(conf.shape)}, "
         f"valid {tuple(valid.shape)}; finite={finite}; framesets through the gate: "
         f"{int(valid.sum())}/{T}")
    if not finite:
        fail("non-finite outputs")

    phase("main path stages")
    hybrid = predictor.hybrid_model
    stage_breakdown(predictor, frames[0], note)
    phase("main path profile")
    profile_steps(predictor, frames, out_dir, note)

    phase("other repro modes")
    # 7. the same cascade in the other repro modes, on the same frames: each
    # path's launches are counted over one step
    mode_launches, mode_points = {}, {"quarter_fused": points}
    for mode in OTHER_MODES:
        mcfg = cfg.clone()
        mcfg.TPU.REPRO_MODE = mode
        pred = make_predictor3d(mcfg, rig, ckpt["CenterDetect"], ckpt["HybridNet"],
                                dtype="bfloat16", device="cuda", graph=False)
        pred(frames[0])
        (mode_points[mode], _, _), mode_launches[mode] = path_launches(
            lambda: pred(frames[0]), kernels, MODE_PATH_KERNELS, mode, recorder)
        if not torch.isfinite(mode_points[mode]).all():
            fail(f"non-finite points on the {mode} path")
        rate(lambda i: pred(frames[i % 2]), T, note, f"predict3D {mode}", "poses/s", SHORT)
        note(f"predict3D {mode} launches in one step: {json.dumps(mode_launches[mode])}")
        stage_breakdown(pred, frames[0], note, iters=3)
        del pred
    for mode in ("quarter_fused", "half_fused", "half"):
        dist = (mode_points[mode] - mode_points["exact"]).norm(dim=-1)
        gated = dist[valid]
        note(f"points {mode} vs exact, bf16, frames of seed 1 (noise; information, not a "
             f"bound): max {float(dist.max()):.4f} mm, RMS "
             f"{float(dist.square().mean().sqrt()):.4f} mm over {T} framesets; over the "
             f"{int(valid.sum())} through the gate: max "
             f"{float(gated.max()) if gated.numel() else float('nan'):.4f} mm")

    phase("float frames")
    # 8. the production cascade on the same frames as float32 in [0, 1]
    float_frames = frames[0].float() / 255.0
    predictor(float_frames)
    out, float_launches = path_launches(lambda: predictor(float_frames), kernels,
                                        MAIN_PATH_KERNELS, "float_frames", recorder)
    if not torch.isfinite(out[0]).all():
        fail("non-finite points on the float-frame path")
    dist = (out[0] - points).norm(dim=-1)
    note(f"float frames (frames/255 as float32): launches in one step "
         f"{json.dumps(float_launches)}; points float vs uint8, bf16 (information, not a "
         f"bound): max {float(dist.max()):.4f} mm, RMS {float(dist.square().mean().sqrt()):.4f} "
         f"mm; gate {'equal' if torch.equal(out[2], valid) else 'differs'}")

    # 9-11. predict2D, the two-phase cascade and the driver's streaming loop
    path_counts = {"quarter_fused": launches, **mode_launches, "float_frames": float_launches}
    phase("predict2D")
    path_counts["predict2d"] = predict2d_phase(kernels, cfg, ckpt, frames, recorder, note)
    phase("two-phase")
    path_counts["twophase"] = twophase_phase(kernels, cfg, rig, ckpt, frames, points, recorder,
                                             note)
    phase("driver")
    path_counts["driver"], driver_rate = driver_phase(kernels, cfg, predictor, frames, out_dir,
                                                      recorder,
                                         note)
    phase("graphs")
    graph_phase(kernels, cfg, rig, ckpt, frames, predictor, note, smi)

    # 12. training on one synthetic dataset: train_hybridnet in 3D_only and in
    # all (with a step in bifpn, in last_layers and in all in each other repro
    # mode), then train_efficienttrack for both 2D nets, from the committed
    # checkpoints, each kind's step card vs CPU; K6 (every key of the 3D and
    # 2D steps), K7-K12 against their plain versions
    import tempfile

    with tempfile.TemporaryDirectory() as parent:
        phase("training")
        training_data(parent, note)
        run3d = training_phase(kernels, ckpt, recorder, smi, note)
        path_counts["training"], path_counts["training_step"] = run3d["counts"], run3d["step"]
        train_entries = k7_check(kernels, run3d, note)
        del run3d
        phase("training all")
        run_all = training_phase(kernels, ckpt, recorder, smi, note, mode="all")
        path_counts["training_all"], path_counts["training_all_step"] = (run_all["counts"],
                                                                         run_all["step"])
        phase("training bifpn, last_layers steps")
        for mode, counts in freeze_steps(kernels, run_all, ckpt, recorder, smi, note).items():
            path_counts[f"training_{mode}_step"] = counts
        phase("training all steps in the other repro modes")
        for mode, counts in k12_steps(kernels, run_all, ckpt, recorder, smi, note).items():
            path_counts[f"training_all_step_{mode}"] = counts
        del run_all
        phase("training 2D")
        runs2d, steps2d = train2d_phase(kernels, ckpt, recorder, smi, note)
        for net in NETS_2D:
            path_counts[f"train2d_{net}"] = runs2d[net]
            path_counts[f"train2d_step_{net}"] = steps2d[net]["counts"]
        phase("training 2D step card vs CPU")
        train2d_card_vs_cpu(ckpt, note)
        phase("training graphs")
        graphs_f32 = train_graph_phase(kernels, ckpt, note, smi)
        phase("training bf16 steps")
        path_counts.update(bf16_steps(kernels, ckpt, recorder, note, smi))
        phase("training bf16 graphs")
        graphs_bf16 = train_graph_phase(kernels, ckpt, note, smi, "bfloat16")
        phase("loaders")
        path_counts.update(loaders_phase(kernels, ckpt, note, smi, graphs_f32, graphs_bf16))
        del graphs_f32, graphs_bf16
        phase("C.9 trace")
        c9_trace(kernels, ckpt, note, smi)
        phase("multi NCCL one rank")
        multi_nccl_phase(kernels, ckpt, note, smi)
        phase("multi gloo ranks")
        path_counts.update(multi_gloo_phase(kernels, ckpt, predictor, note, smi))
        os.environ.pop("JARVIS_PARENT_DIR", None)
    phase("training step card vs CPU")
    training_card_vs_cpu(ckpt, note)
    phase("training all step card vs CPU")
    training_card_vs_cpu(ckpt, note, mode="all")
    phase("training bf16 steps card vs CPU")
    bf16_card_vs_cpu(ckpt, note, smi)
    phase("K6 checks")
    train_entries.insert(0, check_k6(kernels, recorder.k6,
                                     path_counts["training"]["instance_norm_act_backward"],
                                     note, step_paths=["training_all_step"]
                                     + [f"train2d_step_{n}" for n in NETS_2D]
                                     + [bf16_path(label) for label, *_ in TRAIN_GRAPH_PATHS]))
    phase("K11, K12 checks")
    train_entries += check_k11_k12(kernels, recorder, path_counts, note, smi, k12_baseline,
                                   base_log)
    train_entries += check_k11_k12_bf16(kernels, recorder, path_counts, note, smi)
    phase("c_total checks")
    train_entries += check_c_total(kernels, recorder, path_counts, note, smi)
    phase("K8, K9, K10 checks")
    train_entries += check_k8(kernels, recorder, runs2d, path_counts, note)
    train_entries += check_k9(kernels, recorder, cfg, runs2d, path_counts["training"], baseline,
                              base_log, note)
    train_entries += check_k10(kernels, recorder, path_counts, note)
    if base_log is not None:
        base_log.close()
    recorder.k8.clear()  # the heads and images they hold
    recorder.k9.clear()
    recorder.k10.clear()
    for net in NETS_2D:
        st = steps2d[net]
        note(f"training 2D {net} step: {st['images_s']:.2f} images/s, {st['step_ms']:.2f} ms, "
             f"device busy {st['busy']:.3f}, {st['device_ms']:.2f} ms of device time a step; "
             f"card: {smi}")

    # 13. each kernel against its plain version at the main path's shapes.
    # ``launches`` counts wrapper calls; ``kernels_per_call`` is how many
    # __global__ kernels one call launches
    report = []

    phase("K4 checks")
    # K4 resize_normalize at every (input shape, dtype, output size) a driven
    # path gave it, on the arguments of its first call there: the step's
    # uint8 and float32 frames, predict2D's one camera, phase A's low-res
    # frames (ratios 1 and 1.25). One rounding to bf16 in the kernel and in
    # the plain version
    k4_out = {}
    for key, (a, per) in recorder.k4.items():
        k_out = kernels.resize_normalize(*a)
        p_out = kernels.resize_normalize_plain(*a)
        ulps = bf16_ulps(k_out, p_out)
        shape, in_dtype, height, width, out_dtype = key
        note(f"resize_normalize {shape} {in_dtype} -> {height}x{width} {out_dtype} (calls per "
             f"path {json.dumps(per)}): {ulps:.1f} bf16 ulps from the plain version "
             f"(tolerance 1)")
        if ulps > 1.0:
            fail(f"resize_normalize {shape} {in_dtype} differs by {ulps} bf16 ulps (tolerance 1)")
        k4_out[key] = k_out, float((k_out.float() - p_out.float()).abs().max())
        del p_out
    # the kernels line: the production cascade's uint8 and float32 frames
    for path, name in (("quarter_fused", "resize_normalize"),
                       ("float_frames", "resize_normalize[float32]")):
        (key,) = (k for k, (_, per) in recorder.k4.items() if path in per)
        args, (k_out, err) = recorder.k4[key][0], k4_out[key]
        report.append(kernel_entry(
            name, "resize_normalize.cu", "jarvis_hybridnet_tpu/ops/image.py:101",
            path_counts[path]["resize_normalize"], err,
            lambda a=args: kernels.resize_normalize(*a),
            lambda a=args: kernels.resize_normalize_plain(*a),
            k4_bytes(args[0], k_out, args[1]) / HBM_BYTES_PER_S * 1e3,
            input_dtype=str(args[0].dtype).replace("torch.", "")))
    del float_frames, k4_out
    recorder.k4.clear()  # the frames it holds

    phase("K2, K5, K3 checks")
    # inputs of K2 and K3 captured from the step's frames
    with torch.no_grad():
        center_hm, center3d, _ = predictor.centers(frames[0])
        crops = predictor.crops(frames[0], center_hm)
        rows = hybrid.heatmap_rows(crops)
        c3d = center3d.to(torch.int32).contiguous()
        cams = [a.expand(T, *a.shape).contiguous() for a in (predictor.P, predictor.K, predictor.D)]
        g4, step = hybrid.grid_size // 4, float(hybrid.grid_spacing) * 4.0
        k2_args = (rows, c3d, center_hm.contiguous(), *cams, g4, step)
        # K2 at every (rows shape, dtype, g4, step) a driven path gave it, on
        # the arguments of its first call there (the serving paths' bf16 rows,
        # the training step's float32 rows), and at the test grid (g4 = 9, a
        # partial tile at the top edge) on the main path's rows
        k2_checks = [(f"{key[0]} {key[1]} g4={key[2]} (calls per path {json.dumps(per)})", a)
                     for key, (a, per) in recorder.k2.items()]
        k2_checks.append((f"{tuple(rows.shape)} {rows.dtype} g4=9 (off the paths)",
                          (*k2_args[:6], 9, step * g4 / 9)))
        for label, a in k2_checks + [("main path", k2_args)]:
            k_vol, k_idx = kernels.repro_quarter_gather(*a, return_indices=True)
            p_vol, p_idx = kernels.repro_quarter_gather_plain(*a)
            if not torch.equal(k_idx, p_idx):
                fail(f"repro_quarter_gather {label}: indices differ at "
                     f"{int((k_idx != p_idx).sum())} places")
            rel = float((k_vol - p_vol).abs().max() / p_vol.abs().max().clamp_min(1e-30))
            if rel > 1e-5:
                fail(f"repro_quarter_gather {label}: volume differs by {rel} relative "
                     f"(tolerance 1e-5)")
            if label != "main path":
                note(f"repro_quarter_gather {label}: indices equal, volume {rel:.2e} relative "
                     f"to the plain version (tol 1e-5)")
        recorder.k2.clear()  # the rows it holds
        J, hs2 = rows.shape[-1], rows.shape[2]
        k2_bytes = rows_touched(p_idx, hs2) * J * rows.element_size() + k_vol.numel() * 4
        k2_ms = graph_ms(lambda: kernels.repro_quarter_gather(*k2_args))
        report.append(dict(
            name="repro_quarter_gather", route="cuda", kernels_per_call=1,
            source="jarvis_hybridnet_torch/kernels/csrc/repro_quarter_gather.cu",
            replaces="jarvis_hybridnet_tpu/models/repro.py:280",
            launches=launches["repro_quarter_gather"],
            max_abs_err=float((k_vol - p_vol).abs().max()), ms=k2_ms,
            wall_ms=cuda_ms(lambda: kernels.repro_quarter_gather(*k2_args)),
            plain_ms=cuda_ms(lambda: kernels.repro_quarter_gather_plain(*k2_args), iters=5),
            bound_ms=k2_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None))

        report.extend(check_k5(kernels, rows, c3d, center_hm.contiguous(), cams,
                               hybrid.grid_size, float(hybrid.grid_spacing), mode_launches,
                               note))

        vout = hybrid.v2v_output(rows, center_hm, c3d, *cams).contiguous()
        report.append(check_k3(kernels, vout, c3d, float(hybrid.grid_spacing),
                               float(hybrid.roi_cube_size), launches["soft_argmax"], note))

    phase("K1 checks")
    # K1: every (shape, dtype, act) a driven path gave it, checked against
    # the plain version and its statistics output against the plain
    # statistics; the main path's shapes are timed too, and the line reports the sum over
    # one main-path step's launches
    from jarvis_hybridnet_torch.kernels.instance_norm import (
        launch_plan,
        max_active_clusters,
        stats_plain,
    )

    acts = {"none": lambda y, s: y, "silu": lambda y, s: F.silu(y),
            "relu": lambda y, s: F.relu(y), "add_relu": lambda y, s: F.relu(y + s)}
    k1 = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0)
    worst_ulps = worst_f32 = worst_stats = 0.0
    log.write("K1 instance_norm_act per shape: shape dtype act count ms wall_ms plain_ms "
              "library_ms bound_ms error (bf16 ulps; float32 abs) | cluster threads span "
              "resident ring_rows smem max_active_clusters | calls per path (count: calls on "
              "the main path; shapes off it are checked, not timed)\n")
    off_main = 0
    for (shape, dtype, act), per in sorted(recorder.k1.items(),
                                           key=lambda kv: -math.prod(kv[0][0])):
        count = per.get("quarter_fused", 0)
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(shape, device=dev, dtype=torch.float32, generator=g).mul(2).add(0.5)
        x = x.to(dtype)
        skip = torch.randn(shape, device=dev, generator=g).to(dtype) if act == "add_relu" else None
        ko = kernels.instance_norm_act(x, act, skip)
        po = kernels.instance_norm_act_plain(x, act, skip)
        so, stats = kernels.instance_norm_act(x, act, skip, return_stats=True)
        ref = stats_plain(x)
        srel = max(float((stats[..., i] - ref[..., i]).abs().max()
                         / ref[..., i].abs().max().clamp_min(1e-30)) for i in (0, 1))
        worst_stats = max(worst_stats, srel)
        if srel > 1e-6 or not torch.equal(so, ko):
            fail(f"instance_norm_act {shape} {dtype} {act}: stats {srel} relative from the "
                 f"plain ones (tolerance 1e-6), output with stats equal: {torch.equal(so, ko)}")
        err = float((ko.float() - po.float()).abs().max())
        if dtype == torch.float32:
            # the float32 path's bound, as in the f32 spot checks below
            ulps = f"{err:.2e} abs"
            worst_f32 = max(worst_f32, err)
            if err > 1e-5:
                fail(f"instance_norm_act {shape} {dtype} {act} differs by {err} (tolerance "
                     f"1e-5); calls per path {json.dumps(per)}")
        else:
            # the kernel merges per-span statistics (Chan) where the plain version
            # sums once, so the normalized value may round to the neighbouring bf16
            # value; SiLU's three further bf16 roundings can grow that to 3 ulps
            u = bf16_ulps(ko, po)
            ulps = f"{u:.1f}"
            worst_ulps = max(worst_ulps, u)
            if u > 3.0:
                fail(f"instance_norm_act {shape} {dtype} {act} differs by {u} bf16 ulps "
                     f"(tolerance 3); calls per path {json.dumps(per)}")
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        plan = launch_plan(*shape, x.element_size())
        plan_cols = (f"{plan.cluster} {plan.threads} {plan.span} {plan.resident} "
                     f"{plan.ring_rows} {plan.smem} {max_active_clusters(plan, dtype)}")
        if not count:
            off_main += 1
            log.write(f"  {shape} {dtype} {act} x0 - - - - - {ulps} | {plan_cols} | "
                      f"{json.dumps(per)}\n")
            continue
        xn = x.permute(0, 2, 1)  # (N, C, S) for the library call
        sn = None if skip is None else skip.permute(0, 2, 1)
        times = dict(
            ms=graph_ms(lambda: kernels.instance_norm_act(x, act, skip)),
            wall_ms=cuda_ms(lambda: kernels.instance_norm_act(x, act, skip)),
            plain_ms=cuda_ms(lambda: kernels.instance_norm_act_plain(x, act, skip)),
            # F.instance_norm refuses a single spatial element
            library_ms=(graph_ms(lambda: acts[act](F.instance_norm(xn), sn))
                        if shape[1] > 1 else 0.0))
        nbytes = x.numel() * x.element_size() * (3 if skip is not None else 2)
        times["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        for k, v in times.items():
            k1[k] += v * count
        log.write(f"  {shape} {dtype} {act} x{count} {times['ms']:.4f} {times['wall_ms']:.4f} "
                  f"{times['plain_ms']:.4f} {times['library_ms']:.4f} {times['bound_ms']:.4f} "
                  f"{ulps} | {plan_cols} | {json.dumps(per)}\n")
    note(f"instance_norm_act: {len(recorder.k1)} (shape, dtype, act) over the driven paths, "
         f"{off_main} of them off the main path; worst {worst_ulps:.1f} bf16 ulps vs plain "
         f"(tolerance 3) over the bf16 ones, {worst_f32:.2e} abs (tolerance 1e-5) over the "
         f"float32 ones; statistics output within {worst_stats:.2e} relative of the plain "
         f"statistics (tolerance 1e-6)")
    report.insert(0, dict(
        name="instance_norm_act", route="cuda", kernels_per_call=1,
        source="jarvis_hybridnet_torch/kernels/csrc/instance_norm_act.cu",
        replaces="tools/fused_norm_bench.py:58", launches=launches["instance_norm_act"],
        bound_by="bytes", **k1))

    phase("cascade card vs CPU")
    # the whole cascade on the card against the same cascade on the CPU (the
    # plain versions, which the CPU tests hold to the JAX package), float32,
    # at the small size of tests/test_torch_predictor3d.py, in the
    # production mode and in exact mode
    small = torch.randint(0, 256, (2, 4, 256, 320, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(4))
    for mode, scale in (("quarter_fused", None), ("exact", None), ("quarter_fused", 255.0)):
        small_cfg = monkeyhand_cfg(center_size=64, bbox=128, cube=144, spacing=4, num_cameras=4)
        small_cfg.TPU.REPRO_MODE = mode
        small_rig = synthetic_rig(4, 320, 256)
        got, ref = ({}, {})
        if scale is not None:
            mode = f"{mode}, float frames"
        for device, res in (("cuda", got), ("cpu", ref)):
            pred = make_predictor3d(small_cfg, small_rig, ckpt["CenterDetect"],
                                    ckpt["HybridNet"], dtype="float32", device=device)
            frames_d = small.to(device) if scale is None else small.to(device).float() / scale
            res["centers"] = pred.centers(frames_d)[0].cpu()
            res["points"], res["conf"], res["valid"] = (a.cpu() for a in pred(frames_d))
        perr = float((got["points"] - ref["points"]).abs().max())
        cerr = float((got["conf"] - ref["conf"]).abs().max())
        note(f"cascade f32 {mode}, card vs CPU (T=2, 4 cameras, 256x320): points "
             f"{perr:.2e} mm (tol 2e-2), confidences {cerr:.2e} (tol 1e-4), crop centers and "
             f"gate {'equal' if torch.equal(got['centers'], ref['centers']) else 'DIFFER'}")
        if (perr > 2e-2 or cerr > 1e-4 or not torch.equal(got["centers"], ref["centers"])
                or not torch.equal(got["valid"], ref["valid"])):
            fail(f"the {mode} cascade on the card disagrees with the CPU cascade")

    phase("K1 spot checks")
    # f32 spot check of K1 at the largest V2V shape (the f32 path's tolerance),
    # and shapes off the main path: a sample that does not start on 16 bytes
    # (no bulk copies), a ragged tail, a single row, a cluster of one
    for shape, dtype, act in (((8, 36 ** 3, 46), torch.float32, "add_relu"),
                              ((3, 1001, 46), torch.bfloat16, "silu"),
                              ((5, 4099, 24), torch.float32, "relu"),
                              ((4, 1, 16), torch.float32, "none"),
                              ((2, 300, 12), torch.bfloat16, "add_relu")):
        x = torch.randn(shape, device=dev).to(dtype)
        s = torch.randn_like(x) if act == "add_relu" else None
        ko, po = kernels.instance_norm_act(x, act, s), kernels.instance_norm_act_plain(x, act, s)
        if dtype == torch.float32:
            err = float((ko - po).abs().max())
            note(f"instance_norm_act f32 {shape} {act}: max abs err {err:.2e} (tol 1e-5)")
            if err > 1e-5:
                fail(f"instance_norm_act f32 check {shape}")
        else:
            ulps = bf16_ulps(ko, po)
            note(f"instance_norm_act bf16 {shape} {act}: {ulps:.1f} bf16 ulps (tol 3)")
            if ulps > 3.0:
                fail(f"instance_norm_act bf16 check {shape}")

    phase("cli")
    import chip_smoke_export

    path_counts["cli"] = cli_phase(
        kernels, ckpt, note, smi, driver_rate,
        then=lambda ctx: path_counts.update(chip_smoke_export.run_phases(
            sys.modules[__name__], kernels, ctx, note, smi, phase)))

    phase("end")
    note("phase seconds: " + json.dumps(
        {a: round(tb - ta, 1) for (a, ta), (_, tb) in zip(starts, starts[1:])}))
    report.extend(train_entries)
    # every kernel's launches on each path (one step; the driver: two batches;
    # training: the whole run)
    for r in report:
        wrapper, paths = r["name"].split("[")[0], path_counts
        if wrapper == "resize_normalize":  # K4's float32 input instantiation
            float_input = r["input_dtype"] == "float32"
            paths = {p: c for p, c in paths.items() if (p == "float_frames") == float_input}
        if "mode" in r:  # K5 and K12 count their launches in every mode together
            paths = {r.get("path", r["mode"]): paths[r.get("path", r["mode"])]}
        r["paths"] = {p: c[wrapper] for p, c in paths.items() if c[wrapper]}
    for r in report:
        log.write(json.dumps(r) + "\n")
    log.close()
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
