#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --baseline-csrc DIR

Builds the seven CUDA kernel sources from ``jarvis_hybridnet_torch/kernels/csrc``,
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
batches, each path with the launch counts set to 0 before one step and read
after it; the arguments of K1, K2 and K4 are recorded over each path's
step. Last, the training phase: ``train_hybridnet`` in 3D_only from the
committed HybridNet checkpoint, for two epochs on a synthetic COCO-style
dataset it writes to a temporary directory (12 cameras of 1280x1024 JPEG
frames, 23 keypoints, 4 train and 2 val framesets; float32, quarter_fused,
G = 72), with the launch counts set to 0 before the run and read after it
and the arguments of K1, K2 and K6 recorded; the 2D net must be bit-equal
after it, V2V's weights changed and the written ``.ckpt`` / ``.pth``
reload; the step's framesets/s, ms and device busy share; one small step
on the card against the same step on the CPU (float32, TF32 off, dropout
off, the CPU's ReLU masks set to the card's; a TF32 step as the control
the comparison must refuse); K6 and K7 against their plain versions at the
training step's shapes. It then checks every kernel against its plain
PyTorch version on the card: K1, K2 and K4 at every shape a driven path
gave them, K3 and K5 at the main path's, and times kernel, plain version
and library call. A kernel's ``ms`` is device time: a
CUDA graph of ``GRAPH_CALLS`` captured calls is replayed, so host launch
gaps do not count; ``wall_ms`` is the event time of calls launched one by
one from Python. Prints the card, the predict3D rates, one
``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.
Exits non-zero on any failure, or when
no CUDA device is present. Per-shape details go to
``chiprun_out/chip_smoke.txt``.

With ``--baseline-csrc DIR``, DIR holds an earlier version of the kernel
sources with the C interfaces of ``BASELINE_SIGNATURES`` (K1, K2, the
one-kernel K3 and K5 with unpadded rows); it builds them too and times them
beside the current kernels at the same shapes, in the order baseline,
current, current, baseline, into ``chiprun_out/chip_smoke_baseline.txt``;
K5's volumes and indices must equal the baseline's bit for bit in every
mode at G = 72 and 44, and K2's volume too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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


# The C interfaces of the earlier designs that --baseline-csrc builds: K1
# as the current one takes it (launch plan), K2 and K5 with contiguous
# (unpadded) rows, K5 with a block per tile of BASELINE_K5_TILE's edges,
# K3 as the current one takes it (launch plan).
BASELINE_SIGNATURES = {
    "instance_norm_act": "x, skip, out, N, S, C, V, cluster, threads, span, resident, "
                         "ring_rows, q, data_off, ring_off, smem, eps, act, dtype, stream",
    "repro_quarter_gather": "rows, center3d, center_hm, P, K, D, out, idx_out, B, C, J, hs, "
                            "g4, tile, step, dtype, stream",
    "soft_argmax": "vol, center3d, points, conf, heat, B, g, J, cluster, threads, span, run, "
                   "smem, aligned, spacing, cube, dtype, stream",
    "repro_grid_gather": "rows, center3d, center_hm, P, K, D, out, idx_out, B, C, J, hs, n2, "
                         "tile, step, mode, dtype, stream",
}
BASELINE_K5_TILE = {"exact": 4, "half": 6, "half_fused": 6}


class Baseline:
    """K1, K2, K3 and K5 of an earlier design, built from the sources in
    ``csrc`` (each against that directory's own headers). K2 and K5 take
    contiguous rows, J apart."""

    def __init__(self, csrc: str):
        from jarvis_hybridnet_torch.kernels import build

        self.build = build
        out_dir = os.path.join(csrc, "build")
        os.makedirs(out_dir, exist_ok=True)
        jobs = {}
        for name in BASELINE_SIGNATURES:
            lib = os.path.join(out_dir, f"lib{name}.so")
            cmd = [build._nvcc(), *build._flags(name), "-o", lib, os.path.join(csrc, f"{name}.cu")]
            jobs[name] = lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)
        fns = {}
        for name, (lib, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                fail(f"nvcc failed for the baseline {name}.cu:\n{log}")
            fns[name] = getattr(ctypes.CDLL(lib), name)
            fns[name].restype = ctypes.c_int
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fns["instance_norm_act"].argtypes = [p] * 3 + [i] * 13 + [f, i, i, p]
        fns["repro_quarter_gather"].argtypes = [p] * 8 + [i] * 6 + [f, i, p]
        fns["soft_argmax"].argtypes = [p] * 5 + [i] * 9 + [f, f, i, p]
        fns["repro_grid_gather"].argtypes = [p] * 8 + [i] * 6 + [f, i, i, p]
        self.fns = fns

    def instance_norm_act(self, x, act, skip):
        import torch

        from jarvis_hybridnet_torch.kernels.instance_norm import ACTS, EPS, launch_plan

        n, s, c = x.shape
        plan = launch_plan(n, s, c, x.element_size())
        out = torch.empty_like(x)
        b = self.build
        b.check(self.fns["instance_norm_act"](
            b.ptr(x), b.ptr(skip), b.ptr(out), n, s, c, plan.vec, plan.cluster, plan.threads,
            plan.span, plan.resident, plan.ring_rows, plan.q, plan.data_off, plan.ring_off,
            plan.smem, EPS, ACTS[act], int(x.dtype == torch.bfloat16), b.stream()), "baseline K1")
        return out

    def repro_quarter_gather(self, rows, center3d, center_hm, P, K, D, g4, step):
        import torch

        from jarvis_hybridnet_torch.kernels.repro_gather import TILE

        B, C, hs2, J = rows.shape
        out = torch.empty((B, 2 * g4, 2 * g4, 2 * g4, J), dtype=torch.float32, device=rows.device)
        b = self.build
        b.check(self.fns["repro_quarter_gather"](
            *(b.ptr(t) for t in (rows, center3d, center_hm, P, K, D, out)), b.ptr(None),
            B, C, J, math.isqrt(hs2), g4, TILE, step, int(rows.dtype == torch.bfloat16),
            b.stream()), "baseline K2")
        return out

    def soft_argmax(self, vol, center3d, spacing, cube):
        import torch

        from jarvis_hybridnet_torch.kernels.soft_argmax import launch_plan

        B, g, J = vol.shape[0], vol.shape[1], vol.shape[-1]
        plan = launch_plan(B, g, J, vol.element_size())
        dev = vol.device
        points = torch.empty((B, J, 3), dtype=torch.float32, device=dev)
        conf = torch.empty((B, J), dtype=torch.float32, device=dev)
        aligned = vol.data_ptr() % 16 == 0 and (g ** 3 * J * vol.element_size()) % 16 == 0
        b = self.build
        b.check(self.fns["soft_argmax"](
            *(b.ptr(t) for t in (vol, center3d, points, conf)), None, B, g, J, plan.cluster,
            plan.threads, plan.span, plan.run, plan.smem, int(aligned), spacing, cube,
            int(vol.dtype == torch.bfloat16), b.stream()), "baseline K3")
        return points, conf

    def repro_grid_gather(self, rows, center3d, center_hm, P, K, D, grid_size, spacing, mode,
                          return_indices=False):
        import torch

        from jarvis_hybridnet_torch.kernels.repro_grid_gather import MODES

        B, C, hs2, J = rows.shape
        n = grid_size // 2 if mode == "half_fused" else grid_size
        dev = rows.device
        out = torch.empty((B, n, n, n, J), dtype=torch.float32, device=dev)
        n_idx = grid_size ** 3 if mode == "exact" else (grid_size // 2) ** 3
        idx = (torch.empty((B, C, n_idx), dtype=torch.int32, device=dev)
               if return_indices else None)
        b = self.build
        b.check(self.fns["repro_grid_gather"](
            *(b.ptr(t) for t in (rows, center3d, center_hm, P, K, D, out, idx)), B, C, J,
            math.isqrt(hs2), grid_size // 2, BASELINE_K5_TILE[mode], float(spacing) * 2.0,
            MODES[mode], int(rows.dtype == torch.bfloat16), b.stream()), "baseline K5")
        return (out, idx) if return_indices else out


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
                     "resize_normalize")
OTHER_MODES = ("exact", "half_fused", "half")
MODE_PATH_KERNELS = ("instance_norm_act", "repro_grid_gather", "soft_argmax", "resize_normalize")


def rows_touched(idx, hs2: int) -> int:
    """Distinct heatmap rows a gather reads: a pixel index names a different
    row in every frameset, so (frameset, index) pairs, counted per camera."""
    import torch

    frameset = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64)[:, None] * hs2
    return sum(int(torch.unique(idx[:, c].long() + frameset).numel())
               for c in range(idx.shape[1]))


def check_k5(kernels, rows, c3d, center_hm, cams, grid_size, spacing, mode_launches, baseline,
             base_log, note):
    """K5 in each mode against its plain version: indices equal and volumes
    within 1e-5 relative at the production grid and at G = 44 (a partial
    tile at the top edge in every mode), then timed at the production grid;
    with a baseline, volumes and indices bit-equal to the earlier design's
    at both grids and both timed in turns."""
    import importlib

    import torch

    k5 = importlib.import_module("jarvis_hybridnet_torch.kernels.repro_grid_gather")
    out = []
    J, hs2 = rows.shape[-1], rows.shape[2]
    rows_c = rows.contiguous() if baseline is not None else None  # the earlier layout
    for mode in OTHER_MODES:
        base_ms = {}
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
            if baseline is not None:
                b_args = (rows_c, *a[1:])
                b_vol, b_idx = baseline.repro_grid_gather(*b_args, return_indices=True)
                if not (torch.equal(k_vol, b_vol) and torch.equal(k_idx, b_idx)):
                    fail(f"repro_grid_gather {mode} G={G}: differs from the baseline design "
                         f"(volume {float((k_vol - b_vol).abs().max())}, indices at "
                         f"{int((k_idx != b_idx).sum())} places)")
                del b_vol, b_idx

                def same(new, old):
                    if not torch.equal(new, old):
                        fail(f"repro_grid_gather {mode}: the baseline design's volume differs")
                cur, base_ms[G] = against_baseline(
                    lambda: kernels.repro_grid_gather(*a),
                    lambda: baseline.repro_grid_gather(*b_args), same)
                base_log.write(f"K5 repro_grid_gather {mode} {tuple(rows.shape)} G={G}: current "
                               f"{cur:.4f} ms, baseline {base_ms[G]:.4f} ms "
                               f"({base_ms[G] / cur:.2f}x); volumes and indices equal\n")
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
        if baseline is not None:
            entry["baseline_ms"] = base_ms[grid_size]
        out.append(entry)
        del k_vol, p_vol, k_idx, p_idx
    return out


def ptxas_lines(name: str) -> list[str]:
    """The register, shared memory and spill lines ``nvcc -Xptxas -v`` wrote
    for a kernel library (``build.py`` keeps the log beside it)."""
    from jarvis_hybridnet_torch.kernels import build

    log = build.log_path(name)
    if not log.is_file():
        return [f"no build log for {name}"]
    keep = ("Compiling entry", "registers", "spill")
    return [ln.strip() for ln in log.read_text().splitlines() if any(k in ln for k in keep)]


def check_k3(kernels, vout, c3d, spacing, cube, launches, baseline, base_log, note):
    """K3 against its plain version (points and confidences with the fast
    softplus of the predict path and with the accurate one of the volume
    output, and the double-softplus volume), timed with and without the
    volume output, and beside the baseline's design."""
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
    if baseline is not None:
        def near(new, old):
            if (new[0] - old[0]).abs().max() > 1e-3 or (new[1] - old[1]).abs().max() > 1e-6:
                fail("soft_argmax: the baseline design differs")
        cur, base = against_baseline(lambda: kernels.soft_argmax(*args),
                                     lambda: baseline.soft_argmax(*args), near)
        base_log.write(f"K3 soft_argmax {tuple(vout.shape)}: current {cur:.4f} ms, baseline "
                       f"{base:.4f} ms, bound {entry['bound_ms']:.4f} ms\n")
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


def rate(step, count: int, note, label: str, unit: str) -> float:
    """Median over REPEATS runs of ITERS calls of ``step`` of ``count`` items
    per call, per second (host clock around ``torch.cuda.synchronize``)."""
    import torch

    rates = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            step(i)
        torch.cuda.synchronize()
        rates.append(count * ITERS / (time.perf_counter() - t0))
    r = sorted(rates)[len(rates) // 2]
    note(f"{label}: {r:.2f} {unit}, median of {REPEATS} runs of {ITERS} steps: "
         f"{', '.join(f'{x:.2f}' for x in rates)}; {count / r * 1e3:.2f} ms per step")
    return r


class ShapeRecorder:
    """What K1, K2, K4 and K6 are called with on each driven path: the
    (shape, dtype, act) of every K1 and K6 call, the (rows shape, rows
    dtype, g4, step) of every K2 call and the (input shape, input dtype,
    height, width, output dtype) of every K4 call, each with its calls per
    path; K2 and K4 keep their first call's arguments. It wraps the names by
    which the models and the predictors call the wrappers, and the training
    step's autograd Function's own (``InstanceNormAct.k1``, ``.k6``)."""

    def __init__(self):
        self.k1: dict = {}  # key -> {path: calls}
        self.k2: dict = {}  # key -> (arguments, {path: calls})
        self.k4: dict = {}  # key -> (arguments, {path: calls})
        self.k6: dict = {}  # key -> {path: calls}

    @contextlib.contextmanager
    def on(self, path: str):
        from jarvis_hybridnet_torch.kernels import instance_norm
        from jarvis_hybridnet_torch.models import layers, repro
        from jarvis_hybridnet_torch.prediction import predictor2d, predictor3d

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

        def rec_k1(x, act="none", skip=None):
            count(self.k1, (tuple(x.shape), x.dtype, act))
            return k1(x, act, skip)

        def rec_k2(rows, center3d, center_hm, P, K, D, g4, step, return_indices=False):
            count(self.k2, (tuple(rows.shape), rows.dtype, g4, step),
                  (rows, center3d, center_hm, P, K, D, g4, step))
            return k2(rows, center3d, center_hm, P, K, D, g4, step, return_indices)

        def rec_k4(x, height, width, mean, std, dtype):
            count(self.k4, (tuple(x.shape), x.dtype, height, width, dtype),
                  (x, height, width, mean, std, dtype))
            return k4(x, height, width, mean, std, dtype)

        def rec_k6(x, dy, out, act="none"):
            count(self.k6, (tuple(x.shape), x.dtype, act))
            return k6(x, dy, out, act)

        layers.instance_norm_act = rec_k1
        repro.repro_quarter_gather = rec_k2
        fn.k1, fn.k6 = staticmethod(rec_k1), staticmethod(rec_k6)
        predictor2d.resize_normalize = predictor3d.resize_normalize = rec_k4
        try:
            yield
        finally:
            layers.instance_norm_act = k1
            repro.repro_quarter_gather = k2
            fn.k1, fn.k6 = staticmethod(k1), staticmethod(k6)
            predictor2d.resize_normalize = predictor3d.resize_normalize = k4

    def calls(self, name: str, path: str) -> int:
        table = {"instance_norm_act": self.k1, "instance_norm_act_backward": self.k6,
                 "repro_quarter_gather": {k: per for k, (_, per) in self.k2.items()},
                 "resize_normalize": {k: per for k, (_, per) in self.k4.items()}}[name]
        return sum(per.get(path, 0) for per in table.values())


def path_launches(run, kernels, names, path, recorder):
    """Launch counts of one call of ``run`` (counts set to 0 just before,
    read just after); fails unless every kernel of ``names`` launched, and
    unless ``recorder``, which records the arguments of K1, K2, K4 and K6
    over the call under ``path``, saw as many calls of each as were
    counted."""
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
                 "instance_norm_act_backward"):
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
                            dtype="bfloat16", device="cuda")
    pred(imgs[0])
    out, counts = path_launches(lambda: pred(imgs[0]), kernels,
                                ("instance_norm_act", "resize_normalize"), "predict2d", recorder)
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
        dtype="bfloat16", device="cuda")

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
    rate(step, T, note, f"predict3D two-phase (f={f}, frames on the host)", "poses/s")
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
        runs = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream_predict3d(cfg, predictor, BatchReader(host, ITERS), tmp)
            torch.cuda.synchronize()
            runs.append(T * ITERS / (time.perf_counter() - t0))
    r = sorted(runs)[len(runs) // 2]
    note(f"driver predict3D: {r:.2f} poses/s through the streaming loop (host batches, "
         f"host-to-device copy of {host[0].nbytes} bytes a batch, CSV rows), median of "
         f"{REPEATS} runs of {ITERS} batches: {', '.join(f'{x:.2f}' for x in runs)}")
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
    return counts


TRAIN_EPOCHS = 2
TRAIN_SPLITS = (("train", 4), ("val", 2))
TRAINING_KERNELS = ("instance_norm_act", "repro_quarter_gather", "soft_argmax",
                    "instance_norm_act_backward", "hybridnet_loss_fwd", "hybridnet_loss_bwd")


def training_project(parent: str, dataset: str, epochs: int, bbox: int, cube: int,
                     spacing: int, joints: int, workers: int = 4) -> None:
    """The synthetic project ``Train`` whose ``train_hybridnet`` run the
    training phase drives: MonkeyHand's networks, 3D_only in float32,
    quarter_fused, host color augmentation (``TPU.DEVICE_AUG`` false)."""
    from jarvis_hybridnet_torch.testing import write_project

    write_project(parent, "Train", {
        "DATASET": {"DATASET_3D": dataset},
        "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": joints,
                           "BOUNDING_BOX_SIZE": bbox},
        "HYBRIDNET": {"ROI_CUBE_SIZE": cube, "GRID_SPACING": spacing, "BATCH_SIZE": 1,
                      "NUM_EPOCHS": epochs},
        "TPU": {"DEVICE_AUG": False, "REPRO_MODE": "quarter_fused", "TRAIN_DTYPE": "float32"},
        "DATALOADER_NUM_WORKERS": workers,
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


def training_phase(kernels, ckpt, recorder, smi, note):
    """``train_hybridnet`` in 3D_only on the card, from the committed
    checkpoints, on a synthetic COCO-style dataset written to a temporary
    directory (12 cameras of 1280x1024 JPEG frames on the synthetic rig, 23
    seeded keypoints spanning under 144 mm, 4 train and 2 val framesets),
    for TRAIN_EPOCHS epochs; the launches of the run; the 2D net bitwise
    frozen, V2V (front conv included) updated, ``.ckpt`` and ``.pth``
    written and reloaded; then the step's framesets/s, ms and busy share;
    one step on the card against the same step on the CPU; K6 at every
    (shape, dtype, act) the run gave it and K7 at its shape against their
    plain versions. Returns (launch counts of the run, kernels line
    entries)."""
    import statistics
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jarvis_hybridnet_torch.models.weights import params_from_jax
    from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d
    from jarvis_hybridnet_torch.training import checkpoints
    from jarvis_hybridnet_torch.training.train_interface import train_hybridnet
    from jarvis_hybridnet_torch.training.trainer3d import BATCH_KEYS
    from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt

    t_phase = time.perf_counter()
    start = {k: v.clone() for k, v in params_from_jax(read_ckpt(ckpt["HybridNet"]),
                                                      "small").items()}
    with tempfile.TemporaryDirectory() as parent:
        t0 = time.perf_counter()
        dataset = write_dataset3d(os.path.join(parent, "datasets", "Synth"),
                                  synthetic_rig(CAMS, W, H), W, H, 23, splits=TRAIN_SPLITS,
                                  extent_mm=100.0, seed=5)
        training_project(parent, dataset, TRAIN_EPOCHS, 256, 144, 2, 23)
        note(f"training: synthetic dataset of {sum(n for _, n in TRAIN_SPLITS)} framesets "
             f"x {CAMS} cameras of {W}x{H} JPEG written in {time.perf_counter() - t0:.2f} s")
        os.environ["JARVIS_PARENT_DIR"] = parent
        res = {}
        t0 = time.perf_counter()
        ok, counts = path_launches(
            lambda: train_hybridnet("Train", TRAIN_EPOCHS, None, ckpt["HybridNet"],
                                    mode="3D_only", run_name="Run", device="cuda",
                                    results=res),
            kernels, TRAINING_KERNELS, "training", recorder)
        run_s = time.perf_counter() - t0
        if not ok:
            fail("train_hybridnet did not finish")
        trainer, hist = res["trainer"], res["history"]
        n_steps = TRAIN_EPOCHS * TRAIN_SPLITS[0][1]
        note(f"training: train_hybridnet 3D_only, {TRAIN_EPOCHS} epochs of "
             f"{TRAIN_SPLITS[0][1]} steps (batch 1) and {TRAIN_SPLITS[1][1]} val framesets, "
             f"{run_s:.2f} s (data loading, JPEG decode and checkpoints included: "
             f"{n_steps / run_s:.2f} framesets/s); history {json.dumps(hist)}; launches "
             f"{json.dumps(counts)}")
        losses = hist["train_loss"] + hist["val_loss"]
        if not all(math.isfinite(v) for v in losses):
            fail(f"non-finite training loss: {losses}")
        state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
        moved_2d = [k for k in state if k.startswith("effTrack.") and
                    not torch.equal(state[k], start[k].to(state[k].dtype))]
        v2v_w = [k for k in state if k.startswith("v2vNet.") and k.endswith(".weight")]
        still = [k for k in v2v_w if torch.equal(state[k], start[k])]
        front = "v2vNet.front_layers.0.block.0.weight"
        note(f"training: 2D net {'bit-equal' if not moved_2d else 'CHANGED'} after training "
             f"({sum(k.startswith('effTrack.') for k in state)} tensors); V2V weights changed: "
             f"{len(v2v_w) - len(still)} of {len(v2v_w)} (front conv "
             f"{'changed' if front not in still else 'UNCHANGED'}, max |delta| "
             f"{float((state[front] - start[front]).abs().max()):.3e})")
        if moved_2d or still:
            fail(f"the 2D net moved ({moved_2d[:3]}) or V2V weights did not ({still[:3]})")
        run_dir = os.path.join(parent, "projects", "Train", "models", "HybridNet", "Run")
        final = os.path.join(run_dir, "HybridNet-small_final")
        back = params_from_jax(read_ckpt(final + ".ckpt"), "small")
        pth = checkpoints.load_torch_state_dict(final + ".pth")
        same_ckpt = set(back) <= set(state) and all(torch.equal(back[k], state[k])
                                                     for k in back)
        same_pth = set(pth) == set(state) and all(torch.equal(pth[k], state[k]) for k in pth)
        note(f"training: {os.path.basename(final)}.ckpt ({len(back)} tensors) and .pth "
             f"({len(pth)}) reload in the port equal to the trained state: "
             f"{same_ckpt and same_pth}")
        if not (same_ckpt and same_pth):
            fail("the written checkpoints do not reload to the trained state")

        note(f"training phase: {time.perf_counter() - t_phase:.1f} s so far")
        # the step alone: one batch of the run's data, on the card
        from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
        from jarvis_hybridnet_torch.utils.transfer import HostToDevice

        ds = Dataset3D(trainer.cfg, set="train", device_targets=True)
        batch = {k: np.stack([np.asarray(ds[i][k]) for i in range(1)]) for k in BATCH_KEYS}
        b = HostToDevice("cuda")(batch)
        opt, model = trainer.optimizer, trainer.model
        model.train()
        for _ in range(2):
            trainer.train_step(b, opt, 1e-6)
        times = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(b, opt, 1e-6)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(times)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                trainer.train_step(b, opt, 1e-6)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        note(f"training step (batch 1 frameset of {CAMS} crops of 256^2, G = 72, 3D_only, "
             f"float32, AdamW; batch on the card): {1e3 / step_ms:.2f} framesets/s, "
             f"{step_ms:.2f} ms a step (median of 8 after 2 warm-up: "
             f"{', '.join(f'{t:.2f}' for t in times)}); device busy "
             f"{dev_us / wall_us:.3f} of two profiled steps ({dev_us / 1e3:.2f} ms of device "
             f"time in {wall_us / 1e3:.2f} ms); card: {smi}")
        with open(os.path.join(REPO, "chiprun_out", "chip_smoke_train_profile.txt"), "w") as f:
            rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
            f.write(f"two training steps, wall {wall_us:.0f} us, device {dev_us:.0f} us\n")
            for us, count, key in rows[:40]:
                f.write(f"{us:12.0f} us {count:6d}x  {key[:110]}\n")

        note(f"training phase: {time.perf_counter() - t_phase:.1f} s so far")
        # K6 and K7 at the training step's calls of them, against their plain versions
        per_step = {}
        path_launches(lambda: trainer.train_step(b, opt, 1e-6), kernels, TRAINING_KERNELS,
                      "training_step", recorder)
        for key, per in recorder.k6.items():
            per_step[key] = per.get("training_step", 0)
        entries = []
        k6 = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                  max_abs_err=0.0)
        dev = torch.device("cuda")
        for (shape, dtype, act), per in sorted(recorder.k6.items(), key=lambda kv: str(kv[0])):
            g = torch.Generator(device=dev).manual_seed(11)
            x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.5).to(dtype)
            skip = torch.randn(shape, device=dev, generator=g).to(dtype) if act == "add_relu" \
                else None
            out = kernels.instance_norm_act(x, act, skip)
            dy = torch.randn(shape, device=dev, generator=g).to(dtype)
            kd, ks = kernels.instance_norm_act_backward(x, dy, out, act)
            pd, ps = kernels.instance_norm_act_backward_plain(x, dy, out, act)
            err = float((kd - pd).abs().max())
            rel = err / max(float(pd.abs().max()), 1e-30)
            serr = 0.0 if ks is None else float((ks - ps).abs().max())
            note(f"instance_norm_act_backward {shape} {dtype} {act} (calls per path "
                 f"{json.dumps(per)}): dx {err:.2e} abs, {rel:.2e} of max|dx| (tol 1e-5), "
                 f"dskip {serr:.2e} (tol 0)")
            if rel > 1e-5 or serr > 0:
                fail(f"instance_norm_act_backward {shape} {act} differs: dx {rel}, dskip {serr}")
            k6["max_abs_err"] = max(k6["max_abs_err"], err)
            count = per_step[(shape, dtype, act)]
            if not count:
                continue
            # the function reads x and dy (and, for add_relu, y or the skip:
            # the mask needs one of them) and writes dx (and dskip); relu's
            # mask is xhat > 0, which x gives
            tensors = 3 if act != "add_relu" else 5
            nbytes = x.numel() * x.element_size() * tensors
            times = dict(
                ms=graph_ms(lambda: kernels.instance_norm_act_backward(x, dy, out, act)),
                wall_ms=cuda_ms(lambda: kernels.instance_norm_act_backward(x, dy, out, act)),
                plain_ms=cuda_ms(lambda: kernels.instance_norm_act_backward_plain(x, dy, out,
                                                                                  act)),
                library_ms=cuda_ms(k6_library(x, dy, act, skip)),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            note(f"  timed x{count} per step: device {times['ms']:.4f} ms, wall "
                 f"{times['wall_ms']:.4f}, plain {times['plain_ms']:.4f}, library (autograd's "
                 f"backward of F.instance_norm + act) {times['library_ms']:.4f}, bound "
                 f"{times['bound_ms']:.4f}")
            for k, v in times.items():
                k6[k] += v * count
        entries.append(dict(
            name="instance_norm_act_backward", route="cuda", kernels_per_call=3,
            source="jarvis_hybridnet_torch/kernels/csrc/instance_norm_act_backward.cu",
            replaces="tools/fused_norm_bench.py:58", launches=counts["instance_norm_act_backward"],
            bound_by="bytes", per="training step", **k6))

        with torch.no_grad():
            out, _ = model.train_outputs(trainer.prepare(b), b["center_hm"], b["center3d"],
                                         b["camera_matrices"], b["intrinsics"],
                                         b["distortions"])
        kv, kw = b["kp_vox"].float().contiguous(), b["keypoints3D"].float().contiguous()
        kl, kvalid, kvol = kernels.hybridnet_loss_fwd(out, kv, kw, True)
        pl, pvalid, pvol = kernels.hybridnet_loss_fwd_plain(out, kv, kw, True)
        dl = torch.ones((), device=dev)
        kg = kernels.hybridnet_loss_bwd(out, kv, kw, kvalid, dl)
        pg = kernels.hybridnet_loss_bwd_plain(out, kv, kw, pvalid, dl)
        lrel = abs(float(kl) - float(pl)) / max(abs(float(pl)), 1e-30)
        grel = float((kg - pg).abs().max()) / max(float(pg.abs().max()), 1e-30)
        vrel = float((kvol - pvol).abs().max()) / max(float(pvol.abs().max()), 1e-30)
        same_valid = torch.equal(kvalid, pvalid)
        note(f"hybridnet_loss {tuple(out.shape)}: loss {float(kl):.6f} vs plain {float(pl):.6f} "
             f"({lrel:.2e} relative, tol 1e-5), valid joints {int(kvalid.sum())}/"
             f"{kvalid.numel()} {'equal' if same_valid else 'DIFFER'}, gradient {grel:.2e} of "
             f"max (tol 1e-5), double-softplus volume {vrel:.2e} of max (tol 1e-6)")
        if lrel > 1e-5 or grel > 1e-5 or vrel > 1e-6 or not same_valid:
            fail("hybridnet_loss differs from its plain version")
        o_bytes = out.numel() * 4
        for name, call, plain, nbytes, launches in (
                ("hybridnet_loss_fwd", lambda: kernels.hybridnet_loss_fwd(out, kv, kw),
                 lambda: kernels.hybridnet_loss_fwd_plain(out, kv, kw), o_bytes,
                 counts["hybridnet_loss_fwd"]),
                ("hybridnet_loss_bwd", lambda: kernels.hybridnet_loss_bwd(out, kv, kw, kvalid, dl),
                 lambda: kernels.hybridnet_loss_bwd_plain(out, kv, kw, kvalid, dl), 2 * o_bytes,
                 counts["hybridnet_loss_bwd"])):
            e = kernel_entry(name, "hybridnet_loss.cu",
                             "jarvis_hybridnet_tpu/training/trainer3d.py:171", launches,
                             float((kl - pl).abs()) if name.endswith("fwd")
                             else float((kg - pg).abs().max()), call, plain,
                             nbytes / HBM_BYTES_PER_S * 1e3, per="training step")
            e["kernels_per_call"] = 2 if name.endswith("fwd") else 1
            note(f"{name}: device {e['ms']:.4f} ms, wall {e['wall_ms']:.4f}, plain "
                 f"{e['plain_ms']:.4f}, bound {e['bound_ms']:.4f} (no single library call)")
            entries.append(e)
    os.environ.pop("JARVIS_PARENT_DIR", None)
    return counts, entries


GRAD_TOL = 1e-3  # card vs CPU training step, ReLU masks matched: per element of the tensor's max
FLIP_TOL = 1e-3  # |pre-activation| of a ReLU element on another branch on the card than on the CPU


def training_step_on(cfg, batch, ckpt, device, lr, tf32=False, like=None) -> dict:
    """One 3D_only SGD step (Nesterov momentum 0.9, ``lr``) of a
    ``HybridNetTrainer`` from the committed HybridNet checkpoint on
    ``device``, float32, in ``eval()`` (dropout and drop-connect off), TF32
    as ``tf32`` says. Returns the loss, V2V's gradients and updated
    parameters (on the CPU) and, for each ReLU of the step's K1 calls in
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
                               run_name=f"step_{device}")
    model = trainer.model
    trained = optim.apply_freeze(model, optim.hybridnet_freeze_labels(model, "3D_only"))
    opt = torch.optim.SGD(trained, lr=lr, momentum=0.9, nesterov=True)
    model.eval()
    k1 = InstanceNormAct.k1
    calls, flips = [], []

    def relu_k1(x, act="none", skip=None):
        out = k1(x, act, skip)
        if act not in ("relu", "add_relu"):
            return out
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
        return out

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    InstanceNormAct.k1 = staticmethod(relu_k1)
    try:
        loss, _ = trainer.forward(HostToDevice(device)(batch))
        opt.zero_grad()
        loss.backward()
        live = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
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
    zero = [n for n in gb if n.endswith(".bias") and "output_layer" not in n]
    rest = [n for n in gb if n not in zero]
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


def training_card_vs_cpu(ckpt, note) -> None:
    """One 3D_only training step on the card against the same step on the
    CPU, float32, TF32 off, dropout and drop-connect off, at the tests' size
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
    not a different activation). The control is the
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
        training_project(parent, dataset, 1, 128, 48, 4, 23, workers=0)
        pm = ProjectManager(parent)
        pm.load("Train")
        cfg = pm.get_cfg()
        sample = Dataset3D(cfg, set="val", device_targets=True)[0]
        batch = {k: np.asarray(sample[k])[None] for k in BATCH_KEYS}
        card = training_step_on(cfg, batch, ckpt, "cuda", lr)
        cpu = training_step_on(cfg, batch, ckpt, "cpu", lr)
        matched = training_step_on(cfg, batch, ckpt, "cpu", lr, like=card["calls"])
        tf32 = training_step_on(cfg, batch, ckpt, "cuda", lr, tf32=True)
        tf32_matched = training_step_on(cfg, batch, ckpt, "cpu", lr, like=tf32["calls"])
    as_is, gap, control = (step_gap(card, cpu, lr), step_gap(card, matched, lr),
                           step_gap(tf32, tf32_matched, lr))
    relus = sum(c[1].numel() for c in card["calls"])
    flips = matched["flips"]
    flip_pre = max((max(abs(f[3]), abs(f[4])) for f in flips), default=0.0)
    tf32_pre = max((max(abs(f[3]), abs(f[4])) for f in tf32_matched["flips"]), default=0.0)
    shown = "; ".join(f"call {i} ({act}) element {idx}: CPU {pc:.3e}, card {pg:.3e}"
                      for i, act, idx, pc, pg in flips[:8])
    note(f"training step, card vs CPU (4 cameras, 128^2 crops, G = 12, float32, TF32 off, "
         f"eval, SGD lr {lr}): loss {card['loss']:.6f} vs {cpu['loss']:.6f}; as it is (no "
         f"bound): V2V gradients within {as_is['elem']:.2e} of their tensor's max per element, "
         f"{as_is['norm']:.2e} in norm; ReLU elements on another branch on the CPU than on "
         f"the card: {len(flips)} of {relus} over {len(card['calls'])} K1 calls, largest "
         f"|pre-activation| among them {flip_pre:.3e} (tol {FLIP_TOL:g})"
         f"{': ' + shown if flips else ''}")
    note(f"training step, card vs CPU with the CPU's ReLU masks set to the card's: V2V "
         f"gradients of {gap['tensors']} tensors within {gap['elem']:.2e} of their tensor's max "
         f"per element (worst: {gap['worst']}; tol {GRAD_TOL:g}), {gap['norm']:.2e} in norm; the "
         f"{gap['biases']} biases ahead of an InstanceNorm within {gap['bias']:.2e} of the "
         f"largest weight gradient (tol 1e-4); parameters at {gap['param']:.3f} of their "
         f"bound (tol 1); loss {matched['loss']:.6f}")
    note(f"training step control, the card with TF32 allowed against the CPU with its "
         f"masks ({len(tf32_matched['flips'])} set, largest |pre-activation| {tf32_pre:.3e}): "
         f"gradients within {control['elem']:.2e} of their tensor's max per element (worst: "
         f"{control['worst']}), {control['norm']:.2e} in norm, "
         f"parameters at {control['param']:.3f} of their bound: "
         f"{'refused' if control['elem'] > GRAD_TOL else 'NOT refused'} by the gate")
    if (abs(card["loss"] - matched["loss"]) > 1e-4 * abs(matched["loss"])
            or abs(card["loss"] - cpu["loss"]) > 1e-4 * abs(cpu["loss"])
            or gap["elem"] > GRAD_TOL or gap["bias"] > 1e-4 or gap["param"] > 1.0
            or flip_pre > FLIP_TOL):
        fail("the training step on the card disagrees with the CPU step")
    if control["elem"] <= GRAD_TOL:
        fail("the card-vs-CPU training gate does not tell a TF32 step from a float32 one")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="time K1, K2, K3 and K5 built from DIR beside the current ones")
    args = ap.parse_args()
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

    def phase(name: str) -> None:
        note(f"phase {name}: starts {time.perf_counter() - t_start:.1f} s into the run")

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
    log.write("ptxas for repro_grid_gather.cu (K5):\n")
    for line in ptxas_lines("repro_grid_gather"):
        log.write(f"  {line}\n")
    baseline = Baseline(os.path.abspath(args.baseline_csrc)) if args.baseline_csrc else None
    base_log = open(os.path.join(out_dir, "chip_smoke_baseline.txt"), "w") if baseline else None

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
                                 dtype="bfloat16", device="cuda")
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
                                dtype="bfloat16", device="cuda")
        pred(frames[0])
        (mode_points[mode], _, _), mode_launches[mode] = path_launches(
            lambda: pred(frames[0]), kernels, MODE_PATH_KERNELS, mode, recorder)
        if not torch.isfinite(mode_points[mode]).all():
            fail(f"non-finite points on the {mode} path")
        rate(lambda i: pred(frames[i % 2]), T, note, f"predict3D {mode}", "poses/s")
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
    path_counts["driver"] = driver_phase(kernels, cfg, predictor, frames, out_dir, recorder,
                                         note)

    # 12. training: train_hybridnet in 3D_only from the committed checkpoints,
    # K6 and K7 against their plain versions, one step card vs CPU
    phase("training")
    path_counts["training"], train_entries = training_phase(kernels, ckpt, recorder, smi, note)
    phase("training step card vs CPU")
    training_card_vs_cpu(ckpt, note)

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
        if baseline is not None:
            def same(new, old):
                if not torch.equal(new, old):
                    fail("repro_quarter_gather: the baseline design's volume differs")
            b_args = (rows.contiguous(), *k2_args[1:])  # the earlier layout
            cur, base = against_baseline(lambda: kernels.repro_quarter_gather(*k2_args),
                                         lambda: baseline.repro_quarter_gather(*b_args), same)
            base_log.write(f"K2 repro_quarter_gather {tuple(rows.shape)} g4={g4}: current "
                           f"{cur:.4f} ms, baseline {base:.4f} ms, bound "
                           f"{k2_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; volumes equal\n")

        report.extend(check_k5(kernels, rows, c3d, center_hm.contiguous(), cams,
                               hybrid.grid_size, float(hybrid.grid_spacing), mode_launches,
                               baseline, base_log, note))

        vout = hybrid.v2v_output(rows, center_hm, c3d, *cams).contiguous()
        report.append(check_k3(kernels, vout, c3d, float(hybrid.grid_spacing),
                               float(hybrid.roi_cube_size), launches["soft_argmax"], baseline,
                               base_log, note))

    phase("K1 checks")
    # K1: every (shape, dtype, act) a driven path gave it, checked against
    # the plain version; the main path's shapes are timed too, and the line
    # reports the sum over one main-path step's launches
    from jarvis_hybridnet_torch.kernels.instance_norm import launch_plan, max_active_clusters

    acts = {"none": lambda y, s: y, "silu": lambda y, s: F.silu(y),
            "relu": lambda y, s: F.relu(y), "add_relu": lambda y, s: F.relu(y + s)}
    k1 = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0)
    worst_ulps = worst_f32 = 0.0
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
        if baseline is not None:
            def near(new, old, shape=shape, act=act):
                u = bf16_ulps(new, old)
                if u > 3.0:
                    fail(f"instance_norm_act {shape} {act}: the baseline design differs by "
                         f"{u} bf16 ulps")
            cur, base = against_baseline(
                lambda: kernels.instance_norm_act(x, act, skip),
                lambda: baseline.instance_norm_act(x, act, skip), near)
            base_log.write(f"K1 instance_norm_act {shape} {act} x{count}: current {cur:.4f} ms, "
                           f"baseline {base:.4f} ms, bound {times['bound_ms']:.4f} ms\n")
    note(f"instance_norm_act: {len(recorder.k1)} (shape, dtype, act) over the driven paths, "
         f"{off_main} of them off the main path; worst {worst_ulps:.1f} bf16 ulps vs plain "
         f"(tolerance 3) over the bf16 ones, {worst_f32:.2e} abs (tolerance 1e-5) over the "
         f"float32 ones")
    report.insert(0, dict(
        name="instance_norm_act", route="cuda", kernels_per_call=1,
        source="jarvis_hybridnet_torch/kernels/csrc/instance_norm_act.cu",
        replaces="tools/fused_norm_bench.py:58", launches=launches["instance_norm_act"],
        bound_by="bytes", **k1))
    if base_log is not None:
        base_log.close()

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

    phase("end")
    report.extend(train_entries)
    # every kernel's launches on each path (one step; the driver: two batches;
    # training: the whole run)
    for r in report:
        wrapper, paths = r["name"].split("[")[0], path_counts
        if wrapper == "resize_normalize":  # K4's float32 input instantiation
            float_input = r["input_dtype"] == "float32"
            paths = {p: c for p, c in paths.items() if (p == "float_frames") == float_input}
        if "mode" in r:  # K5 counts its launches in every mode together
            paths = {r["mode"]: paths[r["mode"]]}
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
