#!/usr/bin/env python3
"""Launch-plan sweep of the K1, K2, K3, K5, K6, K8-K12 kernels on one CUDA card.

    python3 kernel_sweep.py [--only k1,k2,k3,k3probe,k5,k5probe,k6,k6probe,k7probe,k8,k9,k9ops,k10,k11,k12]
    python3 kernel_sweep.py --only k9,k9ops,k9probe --baseline-csrc DIR

K1 instance_norm_act: for V2V's and the 2D networks' largest main-path
shapes (bf16), times the kernel under every cluster size (1, 2, 4, 8, 16),
block size (256, 512, 1024) and ring stage size that fits, beside the plan
that ``launch_plan`` picks, and prints how many clusters the card holds at
once (``cudaOccupancyMaxActiveClusters``) for V2V's largest shape at each
cluster size 1-16. K2 repro_quarter_gather: times tile edges 4, 5 and 6 on
the production grid (g4 = 18, 12 cameras, 23 joints, 130^2 padded maps,
bf16 rows padded to 24 joints). K5 repro_grid_gather: times every compiled
tile edge per mode on the production grid (G = 72) of the same maps, beside the plan that
``launch_plan`` picks. ``k5probe`` splits K5's time per mode at its launch
plan by variants of ``csrc/repro_grid_gather.cu`` made by textual
substitution: the row loads replaced by a constant (index work, sums,
writes), the index work replaced by a copy of a precomputed index map
(loads, sums, writes), no gather (index work and writes) and neither
(writes alone). K3 soft_argmax: times cluster sizes 8, 9 and
16, blocks of 256, 512 and 1024 threads and runs of 8, 16, 24 and 32 voxels
per lane on the main path's (8, 36, 36, 36, 23) bf16 volume, beside the plan
that ``launch_plan`` picks. ``k3probe`` splits K3's time at its launch plan:
it builds variants of ``csrc/soft_argmax.cu`` made by textual substitution
(no tiles: launch, reductions and cluster barriers; loads only; the loop
without loads or copies; the loop without softplus; without ``-ftz``) and
times each beside the kernel itself. K6 instance_norm_act_backward
(``k6``): times float32 grids of 16-128 blocks (``backward_plan`` at a
smaller capacity) beside its launch plan's at the training step's four
keys; ``k6probe`` splits its time at its launch plan by variants of
``csrc/instance_norm_act_backward.cu`` cut off after each step (the
ranks' sums in rank 0, the grid barrier, the sample's sums; no dx; the
loads and sums alone; the bulk loads alone; an empty kernel), without the
cooperative attribute and without the barrier wait. ``k7probe`` times
K7's forward and backward at the training step's (1, 36, 36, 36, 23) under
variants of ``csrc/hybridnet_loss.cu``: the precise expf / log1pf /
division, no tables, the backward's loads and stores alone, no target, no
softplus. K8 heatmap2d_loss (``k8``): forward and backward at both 2D nets'
train-step heads under walks of 128-512 threads and 264-2112 target blocks;
K10 argmax2d (``k10``): its keys under plans of 132-1056 CTAs of 128-512
threads, beside ``torch.max``. K9 color_aug (``k9``): its four training
keys under bands of 1-16 rows, the no-record keys also under flat walks
of 264 CTAs to one unit a thread; ``k9ops`` counts the fewest SASS
instructions of each precise function in K9's noise (the constants of
``chip_smoke.k9_ops``' bound); ``k9probe`` splits
the time of the earlier design in ``--baseline-csrc DIR`` (b3d34a0's K9:
returns after the launch, the taps, the tile load and the column pass; no
row pass, no Philox, no Box-Muller, no noise, no border, no stores) and of
the current one (returns after the launch, the staging and the column
pass; no blur passes, no Philox, no Box-Muller, no noise, no stores).
K11, the quarter_fused gather's backward (``k11``): blocks of 64-1024
threads at the production key (seeded float32 rows of 12 cameras, 130^2
padded maps, 23 joints, g4 = 18), beside the wrapper's
``BACKWARD_THREADS``, held to the plain version in float64. K12, the other
modes' (``k12``), at G = 72 on the same rows: tile edges, windows and
blocks in each mode, the windowed / overflow (tile, camera) counts, the
time of each phase at the wrapper's plan (``K12_PROBES``) and the key where
every point clamps to one pixel.

Times are device times of CUDA-graph replays (``chip_smoke.graph_ms``);
every configuration is also checked against the plain version (bf16 ulps
for K1, equal volumes for K2, points and confidences for K3) or, for K5,
against the volume of its launch plan (bit for bit).
Output goes to stdout and
``chiprun_out/kernel_sweep.txt``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import heapq
import importlib
import itertools
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = [((8, 46656, 46), "relu"), ((8, 46656, 46), "add_relu"), ((8, 5832, 92), "relu"),
          ((96, 16384, 16), "silu"), ((96, 4096, 48), "silu"), ((96, 4096, 56), "none"),
          ((96, 1024, 96), "silu"), ((96, 1024, 56), "none"), ((96, 256, 336), "silu"),
          ((96, 256, 56), "none")]


def sweep_k1(say, dev) -> None:
    import torch

    import chip_smoke
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build
    from jarvis_hybridnet_torch.kernels import instance_norm as k1

    fn = k1._fn()
    say("K1 (8, 46656, 46) bf16, 1024 threads: clusters the card holds at once, "
        "by cluster size")
    for cs in range(1, 17):
        plan = k1.make_plan(8, 46656, 46, 2, cs, 1024)
        say(f"  cluster {cs:2d}: {k1.max_active_clusters(plan, torch.bfloat16)}")

    for shape, act in SHAPES:
        n, s, c = shape
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(shape, device=dev, generator=g).mul(2).add(0.5).to(torch.bfloat16)
        skip = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                if act == "add_relu" else None)
        ref = kernels.instance_norm_act_plain(x, act, skip)
        nbytes = x.numel() * 2 * (3 if skip is not None else 2)
        bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        chosen = k1.launch_plan(n, s, c, 2)
        say(f"K1 {shape} {act}: bound {bound:.4f} ms; launch_plan {chosen}")
        for cs, threads, ring in itertools.product((1, 2, 4, 8, 16), (256, 512, 1024),
                                                   (k1.RING_BYTES // 2, k1.RING_BYTES)):
            try:
                plan = k1.make_plan(n, s, c, 2, cs, threads, ring)
            except ValueError:
                continue
            if ring != k1.RING_BYTES and not plan.ring_rows:
                continue
            active = k1.max_active_clusters(plan, torch.bfloat16)
            if active < 1:
                continue

            def run(plan=plan):
                out = torch.empty_like(x)
                build.check(fn(build.ptr(x), build.ptr(skip), build.ptr(out), build.ptr(None),
                               n, s, c, plan.vec, plan.cluster, plan.threads, plan.span,
                               plan.resident, plan.ring_rows, plan.q, plan.data_off,
                               plan.ring_off, plan.smem, k1.EPS, k1.ACTS[act], 1,
                               build.stream()), "instance_norm_act")
                return out

            ulps = chip_smoke.bf16_ulps(run(), ref)
            ms = chip_smoke.graph_ms(run)
            mark = " <- launch_plan" if plan == chosen else ""
            say(f"  cluster {cs:2d} threads {threads:4d} ring_rows {plan.ring_rows:4d} "
                f"resident {plan.resident:5d} smem {plan.smem:6d} "
                f"clusters at once {active:3d}: {ms:.4f} ms ({ms / bound:.2f}x bound), "
                f"{ulps:.1f} ulps{mark}")


def _k2_tiles(say, call, plain, tiles) -> None:
    """Time K2's ``call()`` at each tile edge set on ``repro_gather.TILE``,
    against ``plain``."""
    import chip_smoke
    from jarvis_hybridnet_torch.kernels import repro_gather as k2

    chosen = k2.TILE
    try:
        for tile in tiles:
            k2.TILE = tile
            rel = float((call() - plain).abs().max() / plain.abs().max())
            ms = chip_smoke.graph_ms(call)
            say(f"K2 tile {tile}: {ms:.4f} ms, volume {rel:.1e} relative to the plain "
                "version" + (" <- TILE" if tile == chosen else ""))
    finally:
        k2.TILE = chosen


def repro_inputs(dev):
    """The production shapes of K2 and K5: bf16 rows (B 8, C 12, hs 130,
    J 23 padded to 24) of seeded noise, the synthetic 12-camera rig."""
    import torch

    from jarvis_hybridnet_torch.kernels.repro_gather import pad_rows
    from jarvis_hybridnet_torch.testing import synthetic_rig

    B, C, J, hs = 8, 12, 23, 130
    g = torch.Generator(device=dev).manual_seed(5)
    rows = pad_rows((torch.rand((B, C, hs * hs, J), device=dev, generator=g) * 255)
                    .to(torch.bfloat16))
    rig = synthetic_rig(C, 1280, 1024)
    cams = [torch.tensor(a, device=dev).expand(B, *a.shape).contiguous()
            for a in (rig.camera_matrices, rig.intrinsics, rig.distortions)]
    c3d = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    chm = torch.full((B, C, 2), 600, dtype=torch.int32, device=dev)
    return rows, c3d, chm, cams


def sweep_repro(say, dev, only) -> None:
    import torch

    import chip_smoke
    from jarvis_hybridnet_torch import kernels

    k5 = importlib.import_module("jarvis_hybridnet_torch.kernels.repro_grid_gather")
    rows, c3d, chm, cams = repro_inputs(dev)
    B, C, _, J = rows.shape
    if "k2" in only:
        a2 = (rows, c3d, chm, *cams, 18, 8.0)
        _k2_tiles(say, lambda: kernels.repro_quarter_gather(*a2),
                  kernels.repro_quarter_gather_plain(*a2)[0], (4, 5, 6))
    if "k5" not in only:
        return
    for mode, tiles in k5.TILES.items():
        a5 = (rows, c3d, chm, *cams, 72, 2.0)
        ref = kernels.repro_grid_gather(*a5, mode)
        chosen = k5.launch_plan(B, C, J, 130, 72, mode, 2)
        for tile in tiles:
            try:
                plan = k5.make_plan(B, C, J, 72, mode, 2, tile)
            except ValueError as e:
                say(f"K5 {mode} tile {tile}: {e}")
                continue
            same = torch.equal(k5.run_plan(plan, *a5), ref)
            ms = chip_smoke.graph_ms(lambda plan=plan: k5.run_plan(plan, *a5))
            mark = " <- launch_plan" if plan == chosen else ""
            say(f"K5 {mode} tile {tile}: {ms:.4f} ms, {plan.work} blocks, smem {plan.smem}, "
                f"{k5.occupancy(plan, torch.bfloat16)} blocks per SM, volume "
                f"{'equal to' if same else 'DIFFERS from'} the launch plan's{mark}")
            if not same:
                raise SystemExit(f"kernel_sweep: K5 {mode} tile {tile} gives another volume")


# K5 probe variants: substitutions in csrc/repro_grid_gather.cu
_K5_LOAD = "__ldg(reinterpret_cast<const uint4*>(rc + ic[pt[k]] * S + lane[k]))"
# a row of ones (bf16 0x3f80, float 0x3f800000) keeps the sums off zero
_K5_ONES = ("(sizeof(T) == 2 ? make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u) "
            ": make_uint4(0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u))")
_K5_STORES = [("o[i] = s[i];", "__stcs(o + i, s[i]);"),
              ("reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(s)[i];",
               "__stcs(reinterpret_cast<float4*>(o) + i, reinterpret_cast<const float4*>(s)[i]);"),
              ("o[r] = up2(y[cc * J + j], y[(cc + 1) * J + j], fk & 1);",
               "__stcs(o + r, up2(y[cc * J + j], y[(cc + 1) * J + j], fk & 1));")]
_K5_INDEX = ("  tile_indices<MODE, TILE>(smem, lay, center3d, idx_out, b, C, hs, n2, step, t0x, "
             "t0y, t0z);\n")
_K5_CAMERAS = "  for (int c = 0; c < C; ++c) {\n    const T* rc"
_K5_KERNEL = "template <typename T, int MODE, int TILE>\n__global__"
# the index tile copied from a precomputed (B, C, n^3) index map passed as idx_out
_K5_COPY = """template <int MODE, int TILE>
__device__ void probe_copy_indices(float* smem, Layout lay, const int* idx_in, int b, int C,
                                   int n2, int t0x, int t0y, int t0z) {
  using G = Tile<MODE, TILE>;
  constexpr int E = MODE == MODE_EXACT ? G::F : G::e;
  int* idx = reinterpret_cast<int*>(smem + (MODE == MODE_EXACT ? lay.b : lay.a));
  const int n = MODE == MODE_EXACT ? 2 * n2 : n2;
  const int x0 = MODE == MODE_EXACT ? 2 * t0x : t0x - G::halo;
  const int y0 = MODE == MODE_EXACT ? 2 * t0y : t0y - G::halo;
  const int z0 = MODE == MODE_EXACT ? 2 * t0z : t0z - G::halo;
  for (int w = threadIdx.x; w < C * G::np; w += kThreads) {
    const int c = w / G::np, v = w % G::np;
    const int i = min(max(x0 + v / (E * E), 0), n - 1), j = min(max(y0 + v / E % E, 0), n - 1),
              k = min(max(z0 + v % E, 0), n - 1);
    idx[w] = idx_in[(size_t)(b * C + c) * n * n * n + (i * n + j) * n + k];
  }
}

"""
K5_PROBES = {
    "kernel": [],
    "no row loads (index, sums, writes)": [(_K5_LOAD, _K5_ONES)],
    "precomputed indices (loads, sums, writes)": [
        (_K5_INDEX, "  probe_copy_indices<MODE, TILE>(smem, lay, idx_out, b, C, n2, t0x, t0y, "
                    "t0z);\n"),
        (_K5_KERNEL, _K5_COPY + _K5_KERNEL)],
    "writes alone (no index, no row loads)": [(_K5_INDEX, ""), (_K5_LOAD, _K5_ONES)],
    "streaming stores": _K5_STORES,
    "cameras unrolled by 2": [(_K5_CAMERAS, "#pragma unroll 2\n" + _K5_CAMERAS)],
}


def sweep_k5probe(say, dev) -> None:
    import ctypes

    import torch

    import chip_smoke
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build

    k5 = importlib.import_module("jarvis_hybridnet_torch.kernels.repro_grid_gather")
    src = (build.CSRC / "repro_grid_gather.cu").read_text()
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, subs) in enumerate(K5_PROBES.items()):
        text = src
        for a, b in subs:
            if text.count(a) != 1:
                raise SystemExit(f"kernel_sweep: probe {name!r} no longer applies to the source")
            text = text.replace(a, b)
        cu, lib = out_dir / f"k5probe{i}.cu", out_dir / f"libk5probe{i}.so"
        cu.write_text(text)
        jobs[name] = lib, subprocess.Popen(
            [build._nvcc(), *build._flags("repro_grid_gather"), f"-I{build.CSRC}", "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"kernel_sweep: nvcc failed for probe {name!r}:\n{log}")
        fn = ctypes.CDLL(str(lib)).repro_grid_gather
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    rows, c3d, chm, cams = repro_inputs(dev)
    B, C, hs2, J = rows.shape
    for mode in k5.MODES:
        plan = k5.launch_plan(B, C, J, 130, 72, mode, 2)
        _, idx = kernels.repro_grid_gather(rows, c3d, chm, *cams, 72, 2.0, mode,
                                           return_indices=True)
        n = 36 if mode == "half_fused" else 72
        out = torch.empty((B, n, n, n, J), device=dev)
        say(f"K5 probe {mode} at {plan}")
        for name, fn in fns.items():
            def call(fn=fn):
                b = build.ptr
                build.check(fn(b(rows), b(c3d), b(chm), *(b(t) for t in cams), b(out),
                               b(idx) if name.startswith("precomputed") else None, B, C, J,
                               rows.stride(2), 130, 36, plan.tile, 4.0, k5.MODES[mode],
                               plan.smem, 1, C, build.stream()), "K5 probe")
            say(f"  {name:42s}: {chip_smoke.graph_ms(call):.4f} ms")
        say(f"  {'zero_() of the volume (the write alone)':42s}: "
            f"{chip_smoke.graph_ms(out.zero_):.4f} ms")


def sweep_k3(say, dev) -> None:
    import torch

    import chip_smoke
    from jarvis_hybridnet_torch import kernels

    k3 = importlib.import_module("jarvis_hybridnet_torch.kernels.soft_argmax")
    g3 = torch.Generator(device=dev).manual_seed(7)
    vol = (torch.randn((8, 36, 36, 36, 23), device=dev, generator=g3) * 4 - 2).to(torch.bfloat16)
    c3 = torch.zeros((8, 3), dtype=torch.int32, device=dev)
    rp, rc = kernels.soft_argmax_plain(vol, c3, 2.0, 144.0)
    bound = vol.numel() * 2 / chip_smoke.HBM_BYTES_PER_S * 1e3
    chosen = k3.launch_plan(8, 36, 23, 2)
    say(f"K3 (8, 36, 36, 36, 23) bf16: bound {bound:.4f} ms; launch_plan {chosen}")
    for cs, threads, run_len in itertools.product((8, 9, 16), (256, 512, 1024), (8, 16, 24, 32)):
        try:
            plan = k3.make_plan(36, 23, 2, cs, threads, run_len)
        except ValueError:
            continue
        active = k3.max_active_clusters(plan, torch.bfloat16)
        if active < 1:
            say(f"  cluster {cs:2d} threads {threads:4d} run {plan.run}: not schedulable")
            continue
        kp, kc = k3.run_plan(plan, vol, c3, 2.0, 144.0)
        err = max(float((kp - rp).abs().max()), float((kc - rc).abs().max()))
        ms = chip_smoke.graph_ms(lambda: k3.run_plan(plan, vol, c3, 2.0, 144.0))
        mark = " <- launch_plan" if plan == chosen else ""
        say(f"  cluster {cs:2d} threads {threads:4d} run {plan.run:2d} tile {plan.tile:4d} "
            f"smem {plan.smem:6d} clusters at once {active:3d}: {ms:.4f} ms "
            f"({ms / bound:.2f}x bound), max abs err {err:.1e}{mark}")


# K3 probe variants: (substitutions in csrc/soft_argmax.cu, drop -ftz=true)
K3_PROBES = {
    "kernel": ([], False),
    "no tiles": ([("const int ntiles = (hi - lo + tile - 1) / tile;", "const int ntiles = 0;")],
                 False),
    "loads only": ([("    if (on) {\n      const int cnt", "    if (on && t < 0) {\n      const int cnt")],
                   False),
    "loop, no loads": ([("const float in = to_f(tb[k * J]);", "const float in = 0.01f * (k + jj);"),
                        ("    if (t < ntiles) {\n      const int a = lo",
                         "    if (false) {\n      const int a = lo")], False),
    "no softplus": ([("const float sp = kVolume ? softplus_f(in) : softplus_fast(in);",
                      "const float sp = in;")], False),
    "no -ftz": ([], True),
}


def sweep_k3probe(say, dev) -> None:
    import ctypes

    import torch

    import chip_smoke
    from jarvis_hybridnet_torch.kernels import build

    k3 = importlib.import_module("jarvis_hybridnet_torch.kernels.soft_argmax")
    src = (build.CSRC / "soft_argmax.cu").read_text()
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (subs, no_ftz)) in enumerate(K3_PROBES.items()):
        text = src
        for a, b in subs:
            if text.count(a) != 1:
                raise SystemExit(f"kernel_sweep: probe {name!r} no longer applies to the source")
            text = text.replace(a, b)
        cu, lib = out_dir / f"probe{i}.cu", out_dir / f"libprobe{i}.so"
        cu.write_text(text)
        flags = [f for f in build._flags("soft_argmax") if not (no_ftz and f == "-ftz=true")]
        jobs[name] = lib, subprocess.Popen([build._nvcc(), *flags, f"-I{build.CSRC}", "-o", str(lib),
                                            str(cu)], stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
    g3 = torch.Generator(device=dev).manual_seed(7)
    vol = (torch.randn((8, 36, 36, 36, 23), device=dev, generator=g3) * 4 - 2).to(torch.bfloat16)
    c3 = torch.zeros((8, 3), dtype=torch.int32, device=dev)
    plan = k3.launch_plan(8, 36, 23, 2)
    say(f"K3 probe at {plan}")
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"kernel_sweep: nvcc failed for probe {name!r}:\n{log}")
        fn = ctypes.CDLL(str(lib)).soft_argmax
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes, fn.restype = [p] * 5 + [i] * 9 + [f, f, i, p], ctypes.c_int

        def call(fn=fn):
            pts = torch.empty((8, 23, 3), device=dev)
            conf = torch.empty((8, 23), device=dev)
            b = build.ptr
            build.check(fn(b(vol), b(c3), b(pts), b(conf), None, 8, 36, 23, plan.cluster,
                           plan.threads, plan.span, plan.run, plan.smem, 1, 2.0, 144.0, 1,
                           build.stream()), "soft_argmax probe")

        say(f"  {name:15s}: {chip_smoke.graph_ms(call):.4f} ms")


def build_variants(source: str, probes: dict, tag: str, flags: list[str], csrc=None) -> dict:
    """Each probe's variant of ``<csrc>/<source>.cu`` (the package's sources
    by default; its textual substitutions applied, each of which must match
    once), built at once against that directory's headers: {name: loaded
    library}."""
    import ctypes
    import pathlib

    from jarvis_hybridnet_torch.kernels import build

    csrc = pathlib.Path(csrc or build.CSRC)
    src = (csrc / f"{source}.cu").read_text()
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, subs) in enumerate(probes.items()):
        text = src
        for a, b in subs:
            if text.count(a) != 1:
                raise SystemExit(f"kernel_sweep: probe {name!r} no longer applies to the source")
            text = text.replace(a, b)
        cu, lib = out_dir / f"{tag}{i}.cu", out_dir / f"lib{tag}{i}.so"
        cu.write_text(text)
        jobs[name] = lib, subprocess.Popen(
            [build._nvcc(), *flags, f"-I{csrc}", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"kernel_sweep: nvcc failed for probe {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def sweep_k6(say, dev) -> None:
    """K6 (float32) at the training step's keys under grids of fewer blocks
    than its plan's (``backward_plan`` at a smaller capacity), each checked
    against the plain version and timed beside the plan's."""
    import torch

    import chip_smoke
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build
    from jarvis_hybridnet_torch.kernels import instance_norm as k1

    fn = k1._bwd_fn()
    bar = build.sync_words(dev, "instance_norm_act_backward")
    for shape, act in K6_PROBE_KEYS[:4]:
        n, s, c = shape
        x, skip, dy, out, stats = chip_smoke.k6_inputs(shape, torch.float32, act)
        ref, _ = kernels.instance_norm_act_backward_plain(x, dy, out, act, stats)
        chosen = k1.backward_launch_plan(n, s, c, torch.float32, act)
        say(f"K6 {shape} float32 {act}: launch plan {chosen}")
        for capacity in (16, 32, 64, 128, chosen.blocks):
            plan = k1.backward_plan(n, s, c, 4, act, capacity)
            if k1.backward_max_clusters(plan, torch.float32) * plan.cluster < plan.blocks:
                continue
            dx = torch.empty_like(x)
            ds = torch.empty_like(x) if act == "add_relu" else None
            clsum = torch.empty(max(1, n * plan.parts * 2 * c), device=dev)

            def call(plan=plan, dx=dx, ds=ds, clsum=clsum):
                b = build.ptr
                build.check(fn(b(x), b(dy), b(out), b(stats), b(dx), b(ds), b(clsum), b(bar),
                               n, s, c, plan.vec, plan.w, plan.q, plan.parts, plan.cluster,
                               plan.span, plan.resident, plan.stage_rows, plan.blocks,
                               plan.threads, plan.red_off, plan.part_off, plan.tot_off,
                               plan.data_off, plan.smem, k1.ACTS[act], 0, build.stream()),
                            "K6 sweep")
            call()
            err = float((dx - ref).abs().max() / ref.abs().max())
            say(f"  blocks {plan.blocks:4d} (clusters of {plan.cluster}, span {plan.span:5d}, "
                f"resident {plan.resident:5d}): {chip_smoke.graph_ms(call):.4f} ms, dx {err:.1e} "
                f"of max from the plain version")


_K6_BODY = "  const int items = p.N * p.parts;\n"
_K6_BARRIER = "      if (threadIdx.x == 0) barrier_wait(bar, before);\n"
_K6_APPLY = "    float mg[V], mgx[V];\n"
_K6_SUMS = ("    me.sums(x + base, dy + base, yy == nullptr ? nullptr : yy + base, resg, ng, act, "
            "sg, sgx);\n")
_K6_STAGE_SUMS = "      me.sums(data, data + region, data + 2 * region, a, b, act, sg, sgx);\n"
_K6_KEEP = ("    if (me.on && sg[0] + sgx[0] == 1.2345f) dx[base] = from_f<T>(0.f);\n"
            "    continue;\n")
_K6_PART = "      if (p.cluster > 1) cluster.sync();  // every rank's sums are in rank 0\n"
_K6_CLUSTER = _K6_BARRIER + "      __syncthreads();\n"
_K6_TOT = "      sums = tot;\n"


def _k6_stop(at: str, value: str) -> list:
    """Stop the item right after ``at``, keeping what came before live."""
    return [(at, at + f"    if ({value} == 1.2345f) dx[base] = from_f<T>(0.f);\n    continue;\n")]


K6_PROBES = {
    "kernel": [],
    "to the blocks' sums in rank 0": _k6_stop(_K6_PART, "part[0]"),
    "to the grid barrier": _k6_stop(_K6_CLUSTER, "part[0]"),
    "to the sample's sums": _k6_stop(_K6_TOT, "tot[0]"),
    "not cooperative (the cluster attribute alone)": [
        ("  attr[0].val.cooperative = 1;", "  attr[0].val.cooperative = 0;")],
    "no grid barrier (wrong sums)": [(_K6_BARRIER, "")],
    "no phase 3 (dx not written)": [(_K6_APPLY, "    continue;\n" + _K6_APPLY)],
    "phase 1 alone (loads and sums)": [(_K6_SUMS, _K6_SUMS + _K6_KEEP)],
    "bulk loads alone": [(_K6_SUMS, _K6_SUMS + _K6_KEEP), (_K6_STAGE_SUMS, "")],
    "an empty kernel (launch and block start)": [(_K6_BODY, _K6_BODY + "  return;\n")],
}
K6_PROBE_KEYS = [((1, 46656, 46), "relu"), ((1, 46656, 46), "add_relu"), ((1, 5832, 92), "relu"),
                 ((1, 5832, 92), "add_relu"), ((96, 16, 56), "silu")]


def sweep_k6probe(say, dev) -> None:
    """K6's float32 time at its launch plan split by source variants, at the
    training step's keys and one many-sample key (no barrier)."""
    import ctypes

    import torch

    import chip_smoke
    from jarvis_hybridnet_torch.kernels import build
    from jarvis_hybridnet_torch.kernels import instance_norm as k1

    libs = build_variants("instance_norm_act_backward", K6_PROBES, "k6probe",
                          build._flags("instance_norm_act_backward"))
    p, i = ctypes.c_void_p, ctypes.c_int
    for shape, act in K6_PROBE_KEYS:
        x, skip, dy, out, stats = chip_smoke.k6_inputs(shape, torch.float32, act)
        n, s, c = shape
        plan = k1.backward_launch_plan(n, s, c, torch.float32, act)
        dx, ds = torch.empty_like(x), torch.empty_like(x) if act == "add_relu" else None
        clsum = torch.empty(max(1, n * plan.parts * 2 * c), device=dev)
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        nbytes = x.numel() * 4 * (5 if act == "add_relu" else 3)
        say(f"K6 probe {shape} float32 {act}: bound "
            f"{nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3:.4f} ms; {plan}")
        for name, lib in libs.items():
            fn = lib.instance_norm_act_backward
            fn.argtypes, fn.restype = [p] * 8 + [i] * 20 + [p], ctypes.c_int

            def call(fn=fn):
                b = build.ptr
                build.check(fn(b(x), b(dy), b(out), b(stats), b(dx), b(ds), b(clsum), b(bar),
                               n, s, c, plan.vec, plan.w, plan.q, plan.parts, plan.cluster,
                               plan.span, plan.resident, plan.stage_rows, plan.blocks,
                               plan.threads, plan.red_off, plan.part_off, plan.tot_off,
                               plan.data_off, plan.smem, k1.ACTS[act], 0, build.stream()),
                            "K6 probe")
            say(f"  {name:46s}: {chip_smoke.graph_ms(call):.4f} ms")


K7_PROBES = {
    "kernel": [],
    "precise functions (expf, log1pf, division)": [
        ("  return fmaxf(v, 0.f) + __logf(1.f + e);", "  return fmaxf(v, 0.f) + log1pf(e);"),
        ("  return v >= 0.f ? __fdividef(1.f, 1.f + e) : __fdividef(e, 1.f + e);",
         "  return v >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);"),
        ("#include \"common.cuh\"\n", "#include \"common.cuh\"\n#define __expf expf\n")],
    "no tables (left unset)": [
        ("    for (; ar < 3 * g; ar += step) {", "    for (; ar < 0; ar += step) {")],
    "backward: loads and stores alone": [
        ("      d.v[k] = scale[k] == 0.f ? 0.f\n"
         "                               : scale[k] * (sp2 - t[k]) * sigmoid(sp1, e1) * "
         "sigmoid(v, e0);",
         "      d.v[k] = v;")],
    "no target (t = 0)": [
        ("      t[k] = lab[j] == 0.f ? 0.f : 255.f * __expf(-0.5f * d2);",
         "      t[k] = 0.f * d2;")],
    "no softplus (sp2 = out)": [
        ("      const float sp1 = softplus(v, __expf(-fabsf(v)));\n"
         "      const float sp2 = softplus(sp1, __expf(-sp1));",
         "      const float sp2 = v;"),
        ("      const float e0 = __expf(-fabsf(v));\n"
         "      const float sp1 = softplus(v, e0);\n"
         "      const float e1 = __expf(-sp1);  // sp1 > 0\n"
         "      const float sp2 = softplus(sp1, e1);",
         "      const float e0 = 0.f, sp1 = v, e1 = 0.f, sp2 = v;")],
}


def sweep_k7probe(say, dev) -> None:
    """K7's forward and backward time at the training step's shape split by
    source variants."""
    import ctypes

    import torch

    import chip_smoke
    from jarvis_hybridnet_torch.kernels import build

    k7 = importlib.import_module("jarvis_hybridnet_torch.kernels.hybridnet_loss")
    libs = build_variants("hybridnet_loss", K7_PROBES, "k7probe", build._flags("hybridnet_loss"))
    B, g, J = 1, 36, 23
    gen = torch.Generator(device=dev).manual_seed(1)
    out = torch.randn((B, g, g, g, J), device=dev, generator=gen) * 3
    kv = torch.rand((B, J, 3), device=dev, generator=gen) * (g - 4) + 2
    kw = torch.randn((B, J, 3), device=dev, generator=gen)
    plan = k7.loss_plan(B, g, J)
    args = (B, g, J, plan.vec, plan.w, plan.groups, plan.parts, plan.per_part, plan.threads,
            plan.tab_off, plan.red_off, plan.fin_off, plan.smem)
    part = torch.empty(B * plan.parts * 2 * J, device=dev)
    ticket = torch.zeros(2, dtype=torch.int32, device=dev)
    loss, valid = torch.empty((), device=dev), torch.ones((B, J), device=dev)
    dl, dout = torch.ones(1, device=dev), torch.empty_like(out)
    ref, ref_valid, ref_vol = k7.hybridnet_loss_fwd_plain(out, kv, kw, return_volume=True)
    ref_grad = k7.hybridnet_loss_bwd_plain(out, kv, kw, ref_valid, dl)
    vol = torch.empty_like(out)
    say(f"K7 probe {tuple(out.shape)}: {plan}")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        fwd, bwd = lib.hybridnet_loss_forward, lib.hybridnet_loss_backward
        fwd.argtypes, bwd.argtypes = [p] * 8 + [i] * 13 + [p], [p] * 6 + [i] * 13 + [p]
        fwd.restype = bwd.restype = ctypes.c_int
        b = build.ptr

        def f(fwd=fwd):
            build.check(fwd(b(out), b(kv), b(kw), None, b(part), b(ticket), b(loss), b(valid),
                            *args, build.stream()), "K7 probe forward")

        def g_(bwd=bwd):
            build.check(bwd(b(out), b(kv), b(kw), b(valid), b(dl), b(dout), *args,
                            build.stream()), "K7 probe backward")
        build.check(fwd(b(out), b(kv), b(kw), b(vol), b(part), b(ticket), b(loss), b(valid),
                        *args, build.stream()), "K7 probe forward")
        g_()
        rel = abs(float(loss) - float(ref)) / abs(float(ref))
        vrel = float((vol - ref_vol).abs().max() / ref_vol.abs().max())
        grel = float((dout - ref_grad).abs().max() / ref_grad.abs().max())
        say(f"  {name:46s}: forward {chip_smoke.graph_ms(f):.4f} ms, backward "
            f"{chip_smoke.graph_ms(g_):.4f} ms; from the plain version: loss {rel:.2e}, "
            f"volume {vrel:.2e}, gradient {grel:.2e} relative")


# The K10 keys the driven paths give it: predict3D's CenterDetect heads,
# predict2D's CenterDetect and KeypointDetect heads, the train steps' stride-2
# heads (each a channels-last (N, C, H, W) tensor as (N, H, W, C))
K10_KEYS = [((96, 1, 128, 128), "bfloat16"), ((8, 1, 128, 128), "float32"),
            ((8, 23, 128, 128), "float32"), ((4, 23, 128, 128), "float32"),
            ((4, 1, 128, 128), "float32")]


def k10_heads(shape, dtype: str, dev):
    """Seeded heads at ``shape`` (N, C, H, W), coarse values so that maxima
    tie, as the callers pass them."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(0, 64, shape, device=dev, generator=g).to(getattr(torch, dtype))
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def sweep_k10(say, dev) -> None:
    """K10 at its keys under plans of about 132-1056 CTAs of 128-512
    threads, each checked against the plain version, beside torch.max."""
    import torch

    import chip_smoke

    k10 = importlib.import_module("jarvis_hybridnet_torch.kernels.argmax2d")
    for shape, dtype in K10_KEYS:
        hm = k10_heads(shape, dtype, dev)
        n, h, w, c = hm.shape
        ref = k10.argmax_2d_plain(hm)
        flat = hm.permute(0, 3, 1, 2).reshape(n, c, h * w).contiguous()
        bound = (hm.numel() * hm.element_size() + n * c * 12) / chip_smoke.HBM_BYTES_PER_S * 1e3
        lib = chip_smoke.graph_ms(lambda: torch.max(flat, dim=-1))
        copy = chip_smoke.graph_ms(
            lambda: torch.max(hm.permute(0, 3, 1, 2).reshape(n, c, h * w), dim=-1))
        say(f"K10 {tuple(hm.shape)} {dtype}: bound {bound:.4f} ms, torch.max {lib:.4f} ms (with "
            f"the layout's copy {copy:.4f})")
        default = k10.plan_of(hm)
        plans = {k10.plan_of(hm, ctas=ct, threads=t)
                 for ct in (132, 264, 528, 1056) for t in (128, 256, 512)}
        for plan in sorted(plans, key=lambda q: (q.shares, q.threads)):
            ok = chip_smoke.same_argmax(k10.launch(hm, plan), ref)
            ms = chip_smoke.graph_ms(lambda plan=plan: k10.launch(hm, plan))
            say(f"  shares {plan.shares:3d} threads {plan.threads:3d}: {ms:.4f} ms, "
                f"{'identical' if ok else 'DIFFERS'}"
                + (" <- plan_of" if plan == default else ""))


def k8_inputs(j: int, dev):
    """A 2D train step's K8 arguments at batch 4 of 256^2: channels-last
    heads (4, j, 64, 64) and (4, j, 128, 128) of seeded noise in [0, 255),
    keypoints in the image with one unlabeled, and the net's sigma base."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4)
    heads = [(torch.rand((4, j, s, s), device=dev, generator=g) * 255).contiguous(
        memory_format=torch.channels_last) for s in (64, 128)]
    kps = torch.rand((4, j, 2), device=dev, generator=g) * 256
    kps[0, 0] = 0.0
    return (*heads, kps, 256, 1.5 if j > 1 else 1.0)


def sweep_k8(say, dev) -> None:
    """K8 forward and backward at both nets' train-step heads under walks of
    about 264-2112 blocks of 128-512 threads, each checked against the plain
    version (loss 1e-6 relative, gradients equal)."""
    import torch

    import chip_smoke
    from jarvis_hybridnet_torch.kernels import build

    k8 = importlib.import_module("jarvis_hybridnet_torch.kernels.heatmap2d_loss")
    for j in (23, 1):
        args = k8_inputs(j, dev)
        out4, out2 = args[:2]
        nbytes = (out4.numel() + out2.numel()) * 4
        pl, _ = k8.heatmap2d_loss_fwd_plain(*args)
        dl = torch.ones(1, device=dev)
        pg = k8.heatmap2d_loss_bwd_plain(*args, dl)
        say(f"K8 heads {tuple(out4.shape)} + {tuple(out2.shape)} float32: bound forward "
            f"{nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3:.4f} ms, backward "
            f"{2 * nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3:.4f} ms")
        for threads in (128, 256, 512):
            for blocks in (264, 528, 1056, 2112):
                plan = dict(threads=threads, blocks=blocks)
                nblk = k8._args(*args, **plan)[1]
                part = torch.empty(nblk, device=dev)
                loss, means = torch.empty((), device=dev), torch.empty(2, device=dev)
                ticket = build.sync_words(dev, "heatmap2d_loss_fwd")
                d4, d2 = torch.empty_like(out4), torch.empty_like(out2)
                p = build.ptr

                # the arguments end with the current stream: taken at each call
                def fwd(plan=plan, part=part, loss=loss, means=means):
                    build.check(k8._fwd_fn()(p(out4), p(out2), p(args[2]), p(part), p(ticket),
                                             p(loss), p(means), *k8._args(*args, **plan)[0]),
                                "K8 sweep forward")

                def bwd(plan=plan, d4=d4, d2=d2):
                    build.check(k8._bwd_fn()(p(out4), p(out2), p(args[2]), p(dl), p(d4), p(d2),
                                             *k8._args(*args, **plan)[0]), "K8 sweep backward")
                fwd()
                bwd()
                rel = abs(float(loss) - float(pl)) / abs(float(pl))
                same = torch.equal(d4, pg[0]) and torch.equal(d2, pg[1])
                say(f"  threads {threads:3d} target blocks {blocks:4d} ({nblk} blocks): forward "
                    f"{chip_smoke.graph_ms(fwd):.4f} ms, backward {chip_smoke.graph_ms(bwd):.4f}"
                    f" ms; loss {rel:.1e} relative, gradients {'equal' if same else 'DIFFER'}"
                    + (" <- walk_plan" if (threads, blocks) == (k8.THREADS, k8._TARGET_BLOCKS)
                       else ""))


# K9's keys on the training paths at 256^2 (the blur's radius 2 of the
# default config): (lead, record, border)
K9_KEYS = (((1, 12), True, False), ((1, 12), False, False), ((4,), True, True),
           ((4,), False, False))

# Variants of b3d34a0's K9 (csrc/color_aug.cu, given by --baseline-csrc;
# they go when a later design replaces that baseline): where its time goes. "stop after ..." returns (H > 0 always holds) at the
# end of a step; "no ..." removes one step and keeps the rest.
_K9_STOP = "  if (H > 0) return;\n"
_K9_BM = ("      const float r01 = sqrtf(-2.f * logf(uniform(wd.x)));\n"
          "      const float t01 = kTwoPi * uniform(wd.y);\n"
          "      const float n0 = r01 * cosf(t01);")
_K9_BM2 = ("        const float r2 = sqrtf(-2.f * logf(uniform(wd.z)));\n"
           "        nz[1] = r01 * sinf(t01);\n"
           "        nz[2] = r2 * cosf(kTwoPi * uniform(wd.w));")
_K9_ROW = ("        float acc = taps[0] * cols[(r * HW + tx) * 3 + ch];\n"
           "        for (int k = 1; k < K; ++k) acc = acc + taps[k] * cols[(r * HW + tx + k) * 3"
           " + ch];\n"
           "        v[ch] = acc;")
K9_PROBES = {
    "kernel": [],
    "stop at the start (launch)": [
        ("  const int n = blockIdx.z;\n", "  const int n = blockIdx.z;\n" + _K9_STOP)],
    "stop after the taps": [
        ("  // the tile and its halo, reflected", "  __syncthreads();\n" + _K9_STOP
         + "  // the tile and its halo, reflected")],
    "stop after the tile load": [
        ("  __syncthreads();\n  // rows first", "  __syncthreads();\n" + _K9_STOP
         + "  // rows first")],
    "stop after the column pass": [
        ("  }\n  const int x = x0 + tx;", "  }\n" + _K9_STOP + "  const int x = x0 + tx;")],
    "no row pass (its first column)": [(_K9_ROW, "        v[ch] = cols[(r * HW + tx) * 3 + ch];")],
    "no Philox (a hash of the counter)": [
        ("      const uint4 wd = philox((uint32_t)(y * W + x), seed);",
         "      const uint32_t h = (uint32_t)(y * W + x) * 2654435761u ^ seed;\n"
         "      const uint4 wd = make_uint4(h, h * 3u, h * 5u, h * 7u);")],
    "no Box-Muller (uniforms)": [
        (_K9_BM, "      const float r01 = uniform(wd.x);\n      const float t01 = uniform(wd.y);\n"
                 "      const float n0 = r01 * t01;"),
        (_K9_BM2, "        const float r2 = uniform(wd.z);\n        nz[1] = r01 - t01;\n"
                  "        nz[2] = r2 * uniform(wd.w);")],
    "no noise": [("    if (noise && params) {", "    if (false) {")],
    "no border": [
        ("      inside = sx >= 0.f && sx <= (float)W - 1.f && sy >= 0.f && sy <= (float)H - 1.f;",
         "      inside = true;")],
    "no stores (one in a million)": [
        ("      o[ch] = (t - mean[ch]) / stdv[ch];",
         "      const float q = (t - mean[ch]) / stdv[ch];\n      if (q == 1234.5f) o[ch] = q;")],
}


# ... and of the current design (csrc/color_aug.cu): the same steps
_K9_STAGED = "    __syncthreads();\n    if constexpr (RT > 0) {\n#pragma unroll"
_K9_STOP_STAGED = (_K9_STAGED, _K9_STAGED.replace("\n", "\n" + _K9_STOP, 1))
K9_NEW_PROBES = {
    "kernel": [],
    "stop at the start (launch)": [
        ("tid = threadIdx.x;\n  const Normalize nm(norm);",
         "tid = threadIdx.x;\n" + _K9_STOP + "  const Normalize nm(norm);")],
    "stop after the staging": [_K9_STOP_STAGED],
    "  ... without the record's loads": [
        _K9_STOP_STAGED, ("  const Record im = load_record<BORDER>(p, n, rec);",
                          "  const Record im = load_record<BORDER>(p, n, false);")],
    "  ... with constant taps": [_K9_STOP_STAGED,
                                 ("      taps[t] = tap;", "      taps[t] = 0.2f;")],
    "  ... without the image's loads": [
        _K9_STOP_STAGED,
        ("        const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(img + (size_t)gy"
         " * 3 * W) + w.c);", "        const uint32_t u = (uint32_t)(gy * 2654435761u + w.c);")],
    "stop after the column pass": [
        ("  for (Walk w(G); w.r < nr; w.next(G)) {\n    const int y = y0 + w.r, x0 = 4 * w.c;",
         _K9_STOP + "  for (Walk w(G); w.r < nr; w.next(G)) {\n    const int y = y0 + w.r, x0 = 4 * w.c;")],
    "no blur passes (the run reads constants)": [
        ("  if constexpr (RT != 0) {\n    // the taps",
         "  if constexpr (RT == 99) {\n    // the taps"),
        ("    } else if constexpr (RT > 0) {\n      // the row pass",
         "    } else if constexpr (RT > 0) {\n      for (int j = 0; j < 12; ++j) v[j] = 0.5f;\n"
         "    } else if constexpr (RT == 98) {\n      // the row pass")],
    "no Philox (a hash of the counter)": [
        ("      const uint4 wd = philox((uint32_t)(y * W + x), im.key);",
         "      const uint32_t h = (uint32_t)(y * W + x) * 2654435761u ^ im.key[0];\n"
         "      const uint4 wd = make_uint4(h, h * 3u, h * 5u, h * 7u);")],
    "no Box-Muller (uniforms)": [
        ("      const float r01 = sqrtf(-2.f * logf(uniform(wd.x)));",
         "      const float r01 = uniform(wd.x);"),
        ("        sincosf(t01, &s, &c);", "        s = t01, c = t01 * 0.5f;"),
        ("        n2 = sqrtf(-2.f * logf(uniform(wd.z))) * cosf(kTwoPi * uniform(wd.w));",
         "        n2 = uniform(wd.z) * uniform(wd.w);"),
        ("        n0 = n1 = n2 = r01 * cosf(t01);", "        n0 = n1 = n2 = r01 * t01;")],
    "no noise": [("  const bool nz = noise != 0, border", "  const bool nz = false, border")],
    "no stores (one in a million)": [
        (f"    o4[{i}] = make_float4(v[{4 * i}], v[{4 * i + 1}], v[{4 * i + 2}], v[{4 * i + 3}]);",
         f"    if (v[{4 * i}] == 1234.5f) o4[{i}] = make_float4(v[{4 * i}], v[{4 * i + 1}], "
         f"v[{4 * i + 2}], v[{4 * i + 3}]);") for i in range(3)],
}


def sweep_k9probe(say, dev, csrc) -> None:
    """K9 at its four training keys (``K9_KEYS``) under the variants
    of ``K9_PROBES`` (b3d34a0's design, in ``csrc``) and of
    ``K9_NEW_PROBES`` (the current one, at its plan), each timed; a
    variant's distance from the plain version is information (most
    compute other functions)."""
    import chip_smoke
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build

    k9 = importlib.import_module("jarvis_hybridnet_torch.kernels.color_aug")
    keys = [(key, chip_smoke.k9_args(*key, dev)) for key in K9_KEYS]
    plain = [kernels.color_aug_plain(*a) for _, a in keys]
    for design, probes, src in (("b3d34a0's design", K9_PROBES, csrc),
                                ("current design", K9_NEW_PROBES, None)):
        libs = build_variants("color_aug", probes, "k9probe" if src else "k9newprobe",
                              build._flags("color_aug"), src)
        for name, lib in libs.items():
            if src:
                call = functools.partial(chip_smoke.call_baseline, chip_smoke.bind_baseline(lib))
            else:
                fn = k9.bind(lib)

                def call(*a, fn=fn):
                    return k9.launch(*a, k9.plan_of(a[0], a[1], a[4], a[5]), fn=fn)
            cells = []
            for ((lead, record, border), a), p in zip(keys, plain):
                err = float((call(*a) - p).abs().max())
                ms = chip_smoke.graph_ms(lambda a=a: call(*a))
                cells.append(f"{lead}{' record' if record else ''}{' border' if border else ''} "
                             f"{ms:.4f} ms (err {err:.1e})")
            say(f"K9 probe ({design}) {name:42s}: " + "; ".join(cells))


def sweep_k9(say, dev) -> None:
    """K9 at its four training keys (``K9_KEYS``) under bands of 1-16 rows in
    CTAs of 128, 256 and 512 threads, the no-record keys also under flat
    walks of 264 CTAs to one unit a thread, each held to the plain version
    (2e-6 / min(std)) and timed beside the wrapper's plan."""
    import chip_smoke
    from jarvis_hybridnet_torch import kernels

    k9 = importlib.import_module("jarvis_hybridnet_torch.kernels.color_aug")
    for key in K9_KEYS:
        a = chip_smoke.k9_args(*key, dev)
        imgs, params, mean, std, minv, radius, noise = a
        n, (h, w) = imgs.numel() // (imgs.shape[-3] * imgs.shape[-2] * 3), imgs.shape[-3:-1]
        aligned = imgs.data_ptr() % 4 == 0
        plain = kernels.color_aug_plain(*a)
        base = k9.plan_of(imgs, params, minv, radius)
        plans = [k9.launch_plan(n, h, w, radius, False, aligned, rows=r, threads=t)
                 for r in (1, 2, 4, 8, 16) for t in (128, 256, 512)]
        if base.rows == 0:
            plans += [k9.launch_plan(n, h, w, 0, True, aligned, flat_blocks=b, threads=t)
                      for b in (264, 528, 1056, 2112, 1 << 20) for t in (128, 256, 512)]
        cells = []
        for plan in dict.fromkeys(plans):
            err = float((k9.launch(*a, plan) - plain).abs().max())
            ms = chip_smoke.graph_ms(lambda plan=plan: k9.launch(*a, plan))
            cells.append(f"rows {plan.rows} blocks {plan.blocks} threads {plan.threads} smem "
                         f"{plan.smem}: {ms:.4f} ms"
                         f"{' (differs %.1e)' % err if err > 2e-6 / min(std) else ''}"
                         f"{' <- plan' if plan == base else ''}")
        say(f"K9 {key[0]} record {key[1]} border {key[2]}: " + "; ".join(cells))


# Each precise function of K9's noise between the same load and two stores
# (no index arithmetic, which the compiler lays out differently in each)
K9_OPS_SOURCE = r"""
#define OP(name, body)                                                     \
  extern "C" __global__ void op_##name(const float* x, float* y) {         \
    const float v = *x;                                                    \
    float a = v, b = v;                                                    \
    body;                                                                  \
    y[0] = a;                                                              \
    y[1] = b;                                                              \
  }
OP(none, )
OP(logf, a = logf(v))
OP(sqrtf, a = sqrtf(v))
OP(cosf, a = cosf(v))
OP(sincosf, sincosf(v, &a, &b))
"""
# SASS opcodes of control flow: not counted as the function's instructions
_CONTROL = {"BRA", "BRX", "JMP", "BSSY", "BSYNC", "BREAK", "NOP", "EXIT", "RET", "CALL",
            "WARPSYNC", "BMOV", "YIELD"}
_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*)")


def fewest_instructions(sass: str) -> int:
    """The fewest instructions other than control flow that any path runs
    through one function of ``cuobjdump -sass`` from its first instruction
    to an EXIT: a shortest path over its branches (a predicated branch or
    EXIT may go either way), a CALL costing its callee's fewest to a RET."""
    ins = [(int(m.group(1), 16), bool(m.group(2)), m.group(3).split(".")[0], m.group(4))
           for m in map(_SASS_LINE.match, sass.splitlines()) if m]
    at = {addr: i for i, (addr, *_) in enumerate(ins)}

    def target(arg: str) -> int:
        return at[int(re.search(r"0x([0-9a-f]+)", arg).group(1), 16)]

    @functools.cache
    def fewest(start: int, end: str) -> int:
        dist, heap = {start: 0}, [(0, start)]
        while heap:
            d, i = heapq.heappop(heap)
            if d > dist[i]:
                continue
            _, pred, op, arg = ins[i]
            if op == end:
                return d
            w = 0 if op in _CONTROL else 1
            if op == "CALL":
                nxt, w = [i + 1], fewest(target(arg), "RET")
            elif op in ("BRA", "JMP"):
                nxt = [target(arg)] + ([i + 1] if pred else [])
            else:
                nxt = [i + 1]
            for j in nxt:
                if j < len(ins) and d + w < dist.get(j, 1 << 30):
                    dist[j] = d + w
                    heapq.heappush(heap, (d + w, j))
        raise ValueError(f"no path to {end}")

    return fewest(0, "EXIT")


def sweep_k9ops(say) -> None:
    """The fewest SASS instructions that any input runs through each precise
    function of K9's noise (``logf``, ``sqrtf``, ``cosf``, ``sincosf``),
    built as color_aug.cu is (``--fmad=false``, sm_90a): each microkernel's
    fewest (``fewest_instructions``) less that of the same load and stores
    alone; the listings go to ``chiprun_out/k9_ops_sass.txt``. These are
    ``chip_smoke.K9_PRECISE_OPS``."""
    from jarvis_hybridnet_torch.kernels import build

    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, cubin = out_dir / "k9ops.cu", out_dir / "k9ops.cubin"
    cu.write_text(K9_OPS_SOURCE)
    flags = [f for f in build._flags("color_aug")
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", str(cubin), str(cu)], check=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    with open(os.path.join(REPO, "chiprun_out", "k9_ops_sass.txt"), "w") as f:
        f.write(sass)
    fewest = {chunk.split(None, 1)[0][3:]: fewest_instructions(chunk)
              for chunk in sass.split("Function : ")[1:]}
    say("K9 precise functions, fewest SASS instructions beyond the load and stores: "
        + json.dumps({k: v - fewest["none"] for k, v in fewest.items() if k != "none"}))


def sweep_k11(say, dev) -> None:
    """K11 under every block size at the production key."""
    import torch

    import chip_smoke
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import repro_gather as k2

    del dev
    rows, c3d, chm, cams = chip_smoke.backward_inputs(1, 12, 23, 24, 130)
    B, C, hs2, J = rows.shape
    _, idx = kernels.repro_quarter_gather(rows, c3d, chm, *cams, 18, 8.0, True)
    grad = torch.randn((B, 36, 36, 36, J), device=rows.device,
                       generator=torch.Generator(device=rows.device).manual_seed(7))
    ref = kernels.repro_quarter_gather_backward_plain(grad.double(), idx, hs2, J)
    for threads in (64, 128, 256, 512, 1024):
        def call(t=threads):
            return k2.launch_backward(grad, idx, B, C, J, hs2, 18, threads=t)

        err = float((call().double() - ref).abs().max() / ref.abs().max())
        say(f"K11 block {threads}: {chip_smoke.graph_ms(call):.4f} ms, "
            f"{err:.1e} of the largest element from the float64 plain version"
            + (" <- BACKWARD_THREADS" if threads == k2.BACKWARD_THREADS else ""))


# Variants of K12 (csrc/repro_grid_gather_backward.cu) that cut its phases
# (each substitution must match the source once): where its time goes
_K12_STAGED = "  copies_landed();\n  __syncthreads();\n"
_K12_SCATTER = "  __syncthreads();\n\n  // 4. the scatter,"
_K12_ADD = "  // add: a (pixel, 4 joints) item"
K12_PROBES = {
    "memset and staging": [(_K12_STAGED, _K12_STAGED + "  if (C > 0) return;\n")],
    "+ values, pixels and boxes": [(_K12_SCATTER, "  if (C > 0) return;\n" + _K12_SCATTER)],
    "+ the window's sort (no adds)": [(_K12_ADD, "  if (C > 0) return;\n" + _K12_ADD)],
    "whole kernel": [],
}


def k12_inputs(clamp: bool = False):
    """K12's production key (seeded float32 rows of 12 cameras, 130^2 padded
    maps, 23 joints, G = 72 at 2 mm), in each mode: {mode: (grad, idx, n)}."""
    import torch

    import chip_smoke
    from jarvis_hybridnet_torch import kernels

    rows, c3d, chm, cams = chip_smoke.backward_inputs(1, 12, 23, 24, 130, clamp=clamp)
    out = {}
    for mode in ("exact", "half", "half_fused"):
        vol, idx = kernels.repro_grid_gather(rows, c3d, chm, *cams, 72, 2.0, mode, True)
        grad = torch.randn(vol.shape, device=vol.device,
                           generator=torch.Generator(device=vol.device).manual_seed(7))
        out[mode] = grad, idx, 72 if mode == "exact" else 36
    return out, rows.shape[2]


def sweep_k12(say, dev) -> None:
    """K12 in each mode at the production key under tile edges, windows and
    blocks (each plan held to the float64 plain version: 1e-5 of the largest
    element), with the windowed / overflow (tile, camera) counts and the
    blocks an SM holds; at the wrapper's plan and the fastest the time of
    each phase (the source cut after it, ``K12_PROBES``) and of zeroing the
    buffer; the same at the key where every point clamps to one pixel."""
    import ctypes

    import torch

    import chip_smoke
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build

    del dev
    k5 = importlib.import_module("jarvis_hybridnet_torch.kernels.repro_grid_gather")
    wins = {"exact": (0, 128, 192, 256, 320), "half": (0, 128, 256), "half_fused": (0, 128, 256, 512)}
    libs = build_variants("repro_grid_gather_backward", K12_PROBES, "k12probe",
                          build._flags("repro_grid_gather_backward"))
    for clamp in (False, True):
        keys, hs2 = k12_inputs(clamp)
        for mode, (grad, idx, n) in keys.items():
            J = grad.shape[-1]
            ref = kernels.repro_grid_gather_backward_plain(grad.double(), idx, hs2, J, mode)
            m = float(ref.abs().max())
            C = idx.shape[1]
            best = k5.backward_plan(C, J, n, mode)
            plans = [best] if clamp else [
                k5.make_backward_plan(C, J, n, mode, t, w, th) for t in k5.BACKWARD_TILES[mode]
                for w in wins[mode] for th in (256, 512) if t == 0 and w == 0 or t and (
                    4 * k5.backward_layout(mode, C, t, J, k5.padded_width(J, 4), w)["total"]
                    <= k5.SMEM_MAX)]
            say(f"K12 {mode}{' all points clamped to one pixel' if clamp else ''}: "
                f"grad {tuple(grad.shape)}, indices {tuple(idx.shape)}")
            times = {}
            for plan in plans:
                def call(plan=plan):
                    return k5.run_backward(plan, grad, idx, hs2)

                err = float((call().double() - ref).abs().max()) / m
                if err > (1e-4 if clamp else 1e-5):
                    raise SystemExit(f"kernel_sweep: K12 {plan} is {err} of the largest element "
                                     "from the float64 plain version")
                wnd, ovf = k5.window_choice(idx, hs2, plan)
                times[plan] = chip_smoke.graph_ms(call)
                say(f"  tile {plan.tile} win {plan.win:3d} block {plan.threads:4d}: "
                    f"{times[plan]:.4f} ms, {err:.1e} of the largest element, "
                    f"{wnd} windowed / {ovf} overflow (tile, camera), "
                    f"{k5.backward_occupancy(plan)} blocks per SM"
                    + (" <- the wrapper's plan" if plan == best else ""))
            S = best.S
            buf = torch.empty((1, 12, hs2, S), device=grad.device)
            fastest = min(times, key=times.get) if times else best
            for plan in dict.fromkeys((best, fastest)):
                for name, lib in libs.items():
                    fn = lib.repro_grid_gather_backward
                    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int

                    def call(fn=fn, plan=plan):
                        b = build.ptr
                        build.check(fn(b(grad), b(idx), b(buf), 1, 12, J, S, hs2, n,
                                       k5.MODES[mode], plan.tile, plan.win, plan.smem,
                                       plan.threads, 12, build.stream()), "K12 probe")
                    say(f"  tile {plan.tile} win {plan.win} block {plan.threads}, phase "
                        f"{name:28s}: {chip_smoke.graph_ms(call):.4f} ms")
            say(f"  phase {'zeroing the buffer alone':38s}: "
                f"{chip_smoke.graph_ms(buf.zero_):.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="k1,k2,k3,k5",
                    help="comma-separated kernels to sweep (default: all)")
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="the earlier design's csrc, for k9probe")
    opts = ap.parse_args()
    only = set(opts.only.split(","))
    if "k9probe" in only and not opts.baseline_csrc:
        ap.error("k9probe probes the design in --baseline-csrc DIR")
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from jarvis_hybridnet_torch.kernels import build

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "kernel_sweep.txt"), "w") as log:
        def say(msg: str) -> None:
            print(msg, flush=True)
            log.write(msg + "\n")

        say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip())
        build.build_all()
        dev = torch.device("cuda")
        if "k1" in only:
            sweep_k1(say, dev)
        if only & {"k2", "k5"}:
            sweep_repro(say, dev, only)
        if "k3" in only:
            sweep_k3(say, dev)
        if "k3probe" in only:
            sweep_k3probe(say, dev)
        if "k5probe" in only:
            sweep_k5probe(say, dev)
        if "k6" in only:
            sweep_k6(say, dev)
        if "k6probe" in only:
            sweep_k6probe(say, dev)
        if "k7probe" in only:
            sweep_k7probe(say, dev)
        if "k9probe" in only:
            sweep_k9probe(say, dev, opts.baseline_csrc)
        if "k9" in only:
            sweep_k9(say, dev)
        if "k9ops" in only:
            sweep_k9ops(say)
        if "k8" in only:
            sweep_k8(say, dev)
        if "k10" in only:
            sweep_k10(say, dev)
        if "k11" in only:
            sweep_k11(say, dev)
        if "k12" in only:
            sweep_k12(say, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
