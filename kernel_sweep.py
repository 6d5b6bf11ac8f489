#!/usr/bin/env python3
"""Launch-plan sweep of the K1 and K2 kernels on one CUDA card.

    python3 kernel_sweep.py

K1 instance_norm_act: for V2V's and the 2D networks' largest main-path
shapes (bf16), times the kernel under every cluster size (1, 2, 4, 8, 16),
block size (256, 512, 1024) and ring stage size that fits, beside the plan
that ``launch_plan`` picks, and prints how many clusters the card holds at
once (``cudaOccupancyMaxActiveClusters``) for V2V's largest shape at each
cluster size 1-16. K2 repro_quarter_gather: times tile edges 4, 5 and 6 on
the production grid (g4 = 18, 12 cameras, 23 joints, 130^2 padded maps).

Times are device times of CUDA-graph replays (``chip_smoke.graph_ms``);
every configuration is also checked against the plain version (bf16 ulps
for K1, equal volumes for K2). Output goes to stdout and
``chiprun_out/kernel_sweep.txt``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = [((8, 46656, 46), "relu"), ((8, 46656, 46), "add_relu"), ((8, 5832, 92), "relu"),
          ((96, 16384, 16), "silu"), ((96, 4096, 48), "silu"), ((96, 4096, 56), "none"),
          ((96, 1024, 96), "silu"), ((96, 1024, 56), "none"), ((96, 256, 336), "silu"),
          ((96, 256, 56), "none")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build
    from jarvis_hybridnet_torch.kernels import instance_norm as k1
    from jarvis_hybridnet_torch.kernels import repro_gather as k2
    from jarvis_hybridnet_torch.testing import synthetic_rig

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "kernel_sweep.txt"), "w") as log:
        def say(msg: str) -> None:
            print(msg, flush=True)
            log.write(msg + "\n")

        say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip())
        build.build_all()
        dev = torch.device("cuda")
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
                    build.check(fn(build.ptr(x), build.ptr(skip), build.ptr(out), n, s, c, plan.vec,
                                   plan.cluster, plan.threads, plan.span, plan.resident,
                                   plan.ring_rows, plan.q, plan.data_off, plan.ring_off, plan.smem,
                                   k1.EPS, k1.ACTS[act], 1, build.stream()), "instance_norm_act")
                    return out

                ulps = chip_smoke.bf16_ulps(run(), ref)
                ms = chip_smoke.graph_ms(run)
                mark = " <- launch_plan" if plan == chosen else ""
                say(f"  cluster {cs:2d} threads {threads:4d} ring_rows {plan.ring_rows:4d} "
                    f"resident {plan.resident:5d} smem {plan.smem:6d} "
                    f"clusters at once {active:3d}: {ms:.4f} ms ({ms / bound:.2f}x bound), "
                    f"{ulps:.1f} ulps{mark}")

        B, C, J, hs = 8, 12, 23, 130
        g = torch.Generator(device=dev).manual_seed(5)
        rows = (torch.rand((B, C, hs * hs, J), device=dev, generator=g) * 255).to(torch.bfloat16)
        rig = synthetic_rig(C, 1280, 1024)
        cams = [torch.tensor(a, device=dev).expand(B, *a.shape).contiguous()
                for a in (rig.camera_matrices, rig.intrinsics, rig.distortions)]
        c3d = torch.zeros((B, 3), dtype=torch.int32, device=dev)
        chm = torch.full((B, C, 2), 600, dtype=torch.int32, device=dev)
        args = (rows, c3d, chm, *cams, 18, 8.0)
        ref = kernels.repro_quarter_gather_plain(*args)[0]
        chosen = k2.TILE
        try:
            for tile in (4, 5, 6):
                k2.TILE = tile
                out = kernels.repro_quarter_gather(*args)
                rel = float((out - ref).abs().max() / ref.abs().max())
                ms = chip_smoke.graph_ms(lambda: kernels.repro_quarter_gather(*args))
                say(f"K2 tile {tile}: {ms:.4f} ms, volume {rel:.1e} relative to the plain version"
                    + (" <- TILE" if tile == chosen else ""))
        finally:
            k2.TILE = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
