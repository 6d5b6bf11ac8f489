#!/usr/bin/env python3
"""The cost of predict2D's graphed serving step on one CUDA card, for the
port under ``--root`` (this checkout by default, or an unpacked earlier
commit), optionally with one of three variants of the current
``models/layers.py`` patched in.

    python3 graph_cost.py [--root DIR] [--variant NAME] [--label TEXT]

``make_predictor2d`` (bf16, the committed MonkeyHand checkpoints, graph=True)
on T = 8 seeded uint8 frames of one 1280x1024 camera, the step chip_smoke.py
times as "predict2D": after the capture, the median rate of 3 runs of 5
replays over two alternating batches, then 5 replays under torch.profiler:
the kernels a replay (the graph's kernel nodes as the tracer sees them),
their device ms a replay, the replays' wall ms and the busy share (kernel
time over wall time). Prints the card's name and power limit, then one JSON
line.

The variants undo one of three changes to ``layers.conv`` / ``_apply``,
each a suspect of the graphed predict2D step's slow-down between two
commits (ROADMAP.md C.10):

- ``bias-in-conv``: a bf16 convolution's bias passed to the convolution
  (one rounding, the older order) instead of added after its rounding;
- ``no-fp32-pixel``: a convolution of one pixel in bf16, not in float32;
- ``no-casts``: the weight and bias of each convolution used as they are,
  without the call's ``.to(dtype)`` casts (serving casts them once).

Each variant changes numerics or drops a correctness repair; they are run
here to cost those repairs, never used in the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T, H, W = 8, 1024, 1280
ITERS, REPEATS = 5, 3


def patch(variant: str) -> None:
    import torch

    from jarvis_hybridnet_torch.models import layers

    if variant == "no-fp32-pixel":
        layers._apply = lambda fn, x, w, b, args: fn(x, w, b, *args)
    elif variant == "bias-in-conv":
        conv = layers.conv

        def folded(m, x):
            dt = layers.compute_dtype(m)
            if m.bias is None or dt == torch.float32:
                return conv(m, x)
            fn = layers._FUNCTIONS[type(m)]
            if isinstance(m, (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)):
                args = (m.stride, m.padding, m.output_padding, m.groups, m.dilation)
            else:
                args = (m.stride, m.padding, m.dilation, m.groups)
            return layers._apply(fn, x.to(dt), m.weight.to(dt), m.bias.to(dt), args)

        layers.conv = folded
    elif variant == "no-casts":
        conv = layers.conv

        def uncast(m, x):
            if m.weight.dtype == x.dtype:
                fn = layers._FUNCTIONS[type(m)]
                if isinstance(m, (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)):
                    args = (m.stride, m.padding, m.output_padding, m.groups, m.dilation)
                else:
                    args = (m.stride, m.padding, m.dilation, m.groups)
                if m.bias is None or x.dtype == torch.float32:
                    return layers._apply(fn, x, m.weight, m.bias, args)
                y = layers._apply(fn, x, m.weight, None, args)
                return y + m.bias.reshape(-1, *(1,) * (y.dim() - 2))
            return conv(m, x)

        layers.conv = uncast
    elif variant != "none":
        raise SystemExit(f"unknown variant {variant!r}")
    # the modules bound conv at import: point them at the patched one
    for name in ("efficientnet", "bifpn", "efficienttrack", "v2v"):
        mod = sys.modules.get(f"jarvis_hybridnet_torch.models.{name}")
        if mod is not None and hasattr(mod, "conv"):
            mod.conv = layers.conv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose jarvis_hybridnet_torch is measured")
    ap.add_argument("--variant", default="none",
                    choices=("none", "bias-in-conv", "no-fp32-pixel", "no-casts"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("graph_cost: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from jarvis_hybridnet_torch.models import efficientnet, bifpn, efficienttrack  # noqa: F401
    from jarvis_hybridnet_torch.prediction.loaders import make_predictor2d
    from jarvis_hybridnet_torch.testing import monkeyhand_cfg
    from torch.profiler import ProfilerActivity, profile

    patch(args.variant)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = {n: os.path.join(here, "trained", "MonkeyHand", f"{n}_final.ckpt")
            for n in ("CenterDetect", "KeypointDetect")}
    pred = make_predictor2d(monkeyhand_cfg(), ckpt["CenterDetect"], ckpt["KeypointDetect"],
                            dtype="bfloat16", device="cuda", graph=True)
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in (1, 2)]
    imgs = [torch.randint(0, 256, (T, H, W, 3), dtype=torch.uint8, device="cuda", generator=g)
            for g in gens]
    t0 = time.perf_counter()
    for i in range(4):  # 2 warm-up calls, the capture, a replay
        pred(imgs[i % 2])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    rates = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            pred(imgs[i % 2])
        torch.cuda.synchronize()
        rates.append(T * ITERS / (time.perf_counter() - t0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            pred(imgs[i % 2])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / ITERS
    cuda = torch.autograd.DeviceType.CUDA
    recs = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == cuda and "spin_kernel" not in e.key]
    kernels = [(k, c, us) for k, c, us in recs
               if "memcpy" not in k.lower() and "memset" not in k.lower()]
    device_ms = sum(us for _, _, us in recs) / 1e3 / ITERS
    print(json.dumps({
        "label": args.label or args.root, "variant": args.variant,
        "rate_frames_s": sorted(rates)[REPEATS // 2], "rates": rates,
        "kernels_per_replay": sum(c for _, c, _ in kernels) / ITERS,
        "copies_per_replay": (sum(c for _, c, _ in recs) - sum(c for _, c, _ in kernels)) / ITERS,
        "device_ms": device_ms, "wall_ms": wall, "busy": device_ms / wall,
        "warmup_capture_s": capture_s, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
