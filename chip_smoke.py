#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --baseline-csrc DIR

Builds the five CUDA kernels from ``jarvis_hybridnet_torch/kernels/csrc``,
loads the committed MonkeyHand checkpoints through the port's own reader,
and drives ``make_predictor3d`` at the production configuration (bf16,
quarter_fused, 12 cameras of 1280x1024 on the synthetic rig, 23 joints,
256^2 crops and CenterDetect input, 144 mm cube at 2 mm, T = 8 framesets of
seeded uint8 frames), then the same cascade in the exact, half_fused and
half repro modes on the same frames, each with the launch counts set to 0
before one step and read after it. It then checks every kernel against its
plain PyTorch version on the card at the main path's shapes and times
kernel, plain version and library call. A kernel's ``ms`` is device time: a
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
ITERS = 10
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


def stage_breakdown(predictor, frames, note) -> None:
    """Device time of each stage of one step, timed alone (CUDA events)."""
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
            note(f"stage {name}: {cuda_ms(fn, iters=5, warmup=1):.3f} ms")


def profile_steps(predictor, frames, out_dir, note) -> None:
    """torch.profiler over two steps: device time by kernel and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="time K1, K2, K3 and K5 built from DIR beside the current ones")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build
    from jarvis_hybridnet_torch.models import layers
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

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    log.write(f"card: {smi}\n")
    dev = torch.device("cuda")

    # 2. kernels, one nvcc per source, all at once
    t0 = time.perf_counter()
    build.build_all()
    note(f"build: {time.perf_counter() - t0:.1f} s for {len(build.SOURCES)} kernels")
    log.write("ptxas for repro_grid_gather.cu (K5):\n")
    for line in ptxas_lines("repro_grid_gather"):
        log.write(f"  {line}\n")
    baseline = Baseline(os.path.abspath(args.baseline_csrc)) if args.baseline_csrc else None
    base_log = open(os.path.join(out_dir, "chip_smoke_baseline.txt"), "w") if baseline else None

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

    kernels.reset_launch_counts()
    points, conf, valid = predictor(frames[0])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    note(f"launches in one main-path step: {json.dumps(launches)}")

    rates = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            out = predictor(frames[i % 2])
        torch.cuda.synchronize()
        rates.append(T * ITERS / (time.perf_counter() - t0))
    rate = sorted(rates)[len(rates) // 2]
    note(f"predict3D: {rate:.2f} poses/s, median of {REPEATS} runs of {ITERS} steps "
         f"(T={T}, two alternating seeded batches): "
         f"{', '.join(f'{r:.2f}' for r in rates)}; {T / rate * 1e3:.2f} ms per step")

    # 6. outputs
    for name, t, shape in (("points3D", points, (T, 23, 3)), ("confidences", conf, (T, 23)),
                           ("valid", valid, (T,))):
        if tuple(t.shape) != shape:
            fail(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    finite = bool(torch.isfinite(points).all() and torch.isfinite(conf).all()
                  and torch.isfinite(out[0]).all())
    note(f"outputs: points3D {tuple(points.shape)}, confidences {tuple(conf.shape)}, "
         f"valid {tuple(valid.shape)}; finite={finite}; framesets through the gate: "
         f"{int(valid.sum())}/{T}")
    if not finite:
        fail("non-finite outputs")

    # 7. every kernel of the main path ran on it
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")

    hybrid = predictor.hybrid_model
    stage_breakdown(predictor, frames[0], note)
    profile_steps(predictor, frames, out_dir, note)

    # 7b. the same cascade in the other repro modes, on the same frames: each
    # path's launches are counted over one step
    mode_launches, mode_points = {}, {"quarter_fused": points}
    for mode in OTHER_MODES:
        mcfg = cfg.clone()
        mcfg.TPU.REPRO_MODE = mode
        pred = make_predictor3d(mcfg, rig, ckpt["CenterDetect"], ckpt["HybridNet"],
                                dtype="bfloat16", device="cuda")
        pred(frames[0])
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        mode_points[mode], _, _ = pred(frames[0])
        torch.cuda.synchronize()
        mode_launches[mode] = kernels.launch_counts()
        for name in MODE_PATH_KERNELS:
            if mode_launches[mode][name] <= 0:
                fail(f"kernel {name} was not launched on the {mode} path")
        if not torch.isfinite(mode_points[mode]).all():
            fail(f"non-finite points on the {mode} path")
        mrates = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(ITERS):
                pred(frames[i % 2])
            torch.cuda.synchronize()
            mrates.append(T * ITERS / (time.perf_counter() - t0))
        mrate = sorted(mrates)[len(mrates) // 2]
        note(f"predict3D {mode}: {mrate:.2f} poses/s, median of {REPEATS} runs of {ITERS} steps: "
             f"{', '.join(f'{r:.2f}' for r in mrates)}; {T / mrate * 1e3:.2f} ms per step; "
             f"launches in one step: {json.dumps(mode_launches[mode])}")
        stage_breakdown(pred, frames[0], note)
        del pred
    for mode in ("quarter_fused", "half_fused", "half"):
        dist = (mode_points[mode] - mode_points["exact"]).norm(dim=-1)
        gated = dist[valid]
        note(f"points {mode} vs exact, bf16, frames of seed 1 (noise; information, not a "
             f"bound): max {float(dist.max()):.4f} mm, RMS "
             f"{float(dist.square().mean().sqrt()):.4f} mm over {T} framesets; over the "
             f"{int(valid.sum())} through the gate: max "
             f"{float(gated.max()) if gated.numel() else float('nan'):.4f} mm")

    # 8-9. each kernel against its plain version at the main path's shapes.
    # ``launches`` counts wrapper calls; ``kernels_per_call`` is how many
    # __global__ kernels one call launches
    report = []

    # K4 resize_normalize on the step's frames
    flat = frames[0].reshape(T * CAMS, H, W, 3)
    cs = predictor.center_size
    args = (flat, cs, cs, predictor.mean, predictor.std, torch.bfloat16)
    k_out = kernels.resize_normalize(*args)
    p_out = kernels.resize_normalize_plain(*args)
    ulps = bf16_ulps(k_out, p_out)
    if ulps > 1.0:
        fail(f"resize_normalize differs by {ulps} bf16 ulps (tolerance 1)")
    from jarvis_hybridnet_torch.kernels.resize_normalize import linear_tables
    h_rows = len(set(linear_tables(cs, H)[0]) | set(linear_tables(cs, H)[1]))
    k4_bytes = T * CAMS * h_rows * W * 3 + k_out.numel() * k_out.element_size()
    report.append(dict(
        name="resize_normalize", route="cuda", kernels_per_call=1,
        source="jarvis_hybridnet_torch/kernels/csrc/resize_normalize.cu",
        replaces="jarvis_hybridnet_tpu/ops/image.py:101", launches=launches["resize_normalize"],
        max_abs_err=float((k_out.float() - p_out.float()).abs().max()),
        ms=graph_ms(lambda: kernels.resize_normalize(*args)),
        wall_ms=cuda_ms(lambda: kernels.resize_normalize(*args)),
        plain_ms=cuda_ms(lambda: kernels.resize_normalize_plain(*args), iters=5),
        bound_ms=k4_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None))

    # inputs of K2 and K3 captured from the step's frames
    with torch.no_grad():
        center_hm, center3d, _ = predictor.centers(frames[0])
        crops = predictor.crops(frames[0], center_hm)
        rows = hybrid.heatmap_rows(crops)
        c3d = center3d.to(torch.int32).contiguous()
        cams = [a.expand(T, *a.shape).contiguous() for a in (predictor.P, predictor.K, predictor.D)]
        g4, step = hybrid.grid_size // 4, float(hybrid.grid_spacing) * 4.0
        k2_args = (rows, c3d, center_hm.contiguous(), *cams, g4, step)
        # the production grid (g4 = 18, whole tiles) and the test grid (g4 = 9, a
        # partial tile at the top edge) on the same heatmap rows
        for g4_check in (9, g4):
            a = (rows, c3d, center_hm.contiguous(), *cams, g4_check, step * g4 / g4_check)
            k_vol, k_idx = kernels.repro_quarter_gather(*a, return_indices=True)
            p_vol, p_idx = kernels.repro_quarter_gather_plain(*a)
            if not torch.equal(k_idx, p_idx):
                fail(f"repro_quarter_gather g4={g4_check}: indices differ at "
                     f"{int((k_idx != p_idx).sum())} places")
            rel = float((k_vol - p_vol).abs().max() / p_vol.abs().max().clamp_min(1e-30))
            note(f"repro_quarter_gather g4={g4_check}: indices equal, volume {rel:.2e} "
                 f"relative to the plain version (tol 1e-5)")
            if rel > 1e-5:
                fail(f"repro_quarter_gather volume differs by {rel} relative (tolerance 1e-5)")
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

    # K1: record every (shape, act) the main path gives it, then check and
    # time each; the line reports the sum over one step's launches
    seen: dict = {}
    real = layers.instance_norm_act

    def recorder(x, act="none", skip=None):
        key = (tuple(x.shape), x.dtype, act)
        seen[key] = seen.get(key, 0) + 1
        return real(x, act, skip)

    layers.instance_norm_act = recorder
    try:
        with torch.no_grad():
            predictor(frames[0])
    finally:
        layers.instance_norm_act = real
    if sum(seen.values()) != launches["instance_norm_act"]:
        fail(f"recorded {sum(seen.values())} InstanceNorm calls, counted "
             f"{launches['instance_norm_act']}")
    from jarvis_hybridnet_torch.kernels.instance_norm import launch_plan, max_active_clusters

    acts = {"none": lambda y, s: y, "silu": lambda y, s: F.silu(y),
            "relu": lambda y, s: F.relu(y), "add_relu": lambda y, s: F.relu(y + s)}
    k1 = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0)
    worst_ulps = 0.0
    log.write("K1 instance_norm_act per shape: shape dtype act count ms wall_ms plain_ms "
              "library_ms bound_ms ulps | cluster threads span resident ring_rows smem "
              "max_active_clusters\n")
    for (shape, dtype, act), count in sorted(seen.items(), key=lambda kv: -math.prod(kv[0][0])):
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(shape, device=dev, dtype=torch.float32, generator=g).mul(2).add(0.5)
        x = x.to(dtype)
        skip = torch.randn(shape, device=dev, generator=g).to(dtype) if act == "add_relu" else None
        ko = kernels.instance_norm_act(x, act, skip)
        po = kernels.instance_norm_act_plain(x, act, skip)
        ulps = bf16_ulps(ko, po)
        worst_ulps = max(worst_ulps, ulps)
        # the kernel merges per-span statistics (Chan) where the plain version
        # sums once, so the normalized value may round to the neighbouring bf16
        # value; SiLU's three further bf16 roundings can grow that to 3 ulps
        if ulps > 3.0:
            fail(f"instance_norm_act {shape} {act} differs by {ulps} bf16 ulps (tolerance 3)")
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
        k1["max_abs_err"] = max(k1["max_abs_err"], float((ko.float() - po.float()).abs().max()))
        plan = launch_plan(*shape, x.element_size())
        log.write(f"  {shape} {dtype} {act} x{count} {times['ms']:.4f} {times['wall_ms']:.4f} "
                  f"{times['plain_ms']:.4f} {times['library_ms']:.4f} {times['bound_ms']:.4f} "
                  f"{ulps:.1f} | {plan.cluster} {plan.threads} {plan.span} {plan.resident} "
                  f"{plan.ring_rows} {plan.smem} {max_active_clusters(plan, dtype)}\n")
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
    note(f"instance_norm_act: {len(seen)} shapes, worst {worst_ulps:.1f} bf16 ulps vs plain")
    report.insert(0, dict(
        name="instance_norm_act", route="cuda", kernels_per_call=1,
        source="jarvis_hybridnet_torch/kernels/csrc/instance_norm_act.cu",
        replaces="tools/fused_norm_bench.py:58", launches=launches["instance_norm_act"],
        bound_by="bytes", **k1))
    if base_log is not None:
        base_log.close()

    # the whole cascade on the card against the same cascade on the CPU (the
    # plain versions, which the CPU tests hold to the JAX package), float32,
    # at the small size of tests/test_torch_predictor3d.py, in the
    # production mode and in exact mode
    small = torch.randint(0, 256, (2, 4, 256, 320, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(4))
    for mode in ("quarter_fused", "exact"):
        small_cfg = monkeyhand_cfg(center_size=64, bbox=128, cube=144, spacing=4, num_cameras=4)
        small_cfg.TPU.REPRO_MODE = mode
        small_rig = synthetic_rig(4, 320, 256)
        got, ref = ({}, {})
        for device, res in (("cuda", got), ("cpu", ref)):
            pred = make_predictor3d(small_cfg, small_rig, ckpt["CenterDetect"],
                                    ckpt["HybridNet"], dtype="float32", device=device)
            frames_d = small.to(device)
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
