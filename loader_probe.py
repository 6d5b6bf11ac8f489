#!/usr/bin/env python3
"""The user's training loops on one CUDA card with 4 loader threads and
with 4 process workers, in a fresh process and after the process has grown
(more resident memory, more gc-tracked objects): each loop's rate beside
the graphed step's rate measured in the same process and state, each
training epoch's start and whole wall time, and whether freezing the
garbage collector's objects before the workers fork (``gc.freeze``) changes
the process loops.

    python3 loader_probe.py [--paths 3D_only,all,CenterDetect,KeypointDetect]
                            [--kinds thread,process,process_frozen]
                            [--states 0:0,8:0,8:10] [--rounds 2] [--out loader_probe.json]

On chip_smoke.py's synthetic 12-camera training set (``training_data``),
for each state of ``--states`` (``GB:M``: the process grown to hold GB
gigabytes of written numpy memory and M million small lists more than when
it started, before that state's loops; ``0:0`` is the fresh process; the
states rising): each path's graphed train step rate (``step_rate``), then
``--rounds`` rounds of its loops
(``chip_smoke.train_graph_loop``, graphed, TRAIN_EPOCHS epochs), the kinds
in ``--kinds`` order and in reverse order in every other round: ``thread``
(the ``LoopThread`` project), ``process`` (``Train``: the default forked
workers) and ``process_frozen`` (``Train`` with ``gc.freeze()`` just
before the epoch's pool forks and ``gc.unfreeze()`` just after). The
readings go to ``chiprun_out/<--out>``; the card's name and power limit,
one line per loop and one JSON line of the medians to the standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def frozen_fork():
    """Every process-mode epoch inside the block forks its pool with the
    parent's gc-tracked objects frozen (``gc.freeze``), so that a worker's
    collections leave the inherited objects, and their pages, alone."""
    import gc

    from jarvis_hybridnet_torch.dataset import loader

    producer = loader.DataLoader._process_producer

    def frozen(self, *args):
        gc.freeze()
        try:
            return producer(self, *args)
        finally:
            gc.unfreeze()

    loader.DataLoader._process_producer = frozen
    try:
        yield
    finally:
        loader.DataLoader._process_producer = producer


def step_rate(cfg, ckpt, net: str, mode) -> float:
    """The graphed train step's samples a second on two alternating batches
    (median of REPEATS runs of ITERS steps after the warm-up and capture),
    as ``chip_smoke.train_graph_steps`` measures it."""
    import torch

    import chip_smoke as cs
    from jarvis_hybridnet_torch.training import graphed

    repro = "quarter_fused" if net == "HybridNet" else None
    trainer, opt = cs.train_graph_trainer(cfg, ckpt, net, mode, repro, True, f"Rate_{net}")
    batches = cs.train_graph_batches(cfg, net)
    for i in range(graphed.WARMUP + 1):
        trainer.train_step(batches[i % 2], opt, 1e-6)
    rates = []
    for _ in range(cs.REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(cs.ITERS):
            trainer.train_step(batches[i % 2], opt, 1e-6)
        torch.cuda.synchronize()
        rates.append((1 if net == "HybridNet" else 4) * cs.ITERS / (time.perf_counter() - t0))
    del trainer, opt, batches
    torch.cuda.empty_cache()
    return statistics.median(rates)


def measure(args) -> dict:
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    ckpt = {n: os.path.join(REPO, "trained", "MonkeyHand", f"{n}_final.ckpt")
            for n in ("CenterDetect", "KeypointDetect", "HybridNet")}
    paths = {p[0]: p for p in cs.LOOP_PATHS}
    record = {"card": smi, "loops": [], "steps": {}}
    ballast, arrays = [], []
    with tempfile.TemporaryDirectory() as parent:
        cs.training_data(parent, print)
        pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
        pm.load("Train")
        cfg = pm.get_cfg()
        for gb, millions in args.states:
            t0 = time.perf_counter()
            grown = sum(a.nbytes for a in arrays)
            if gb * 1e9 > grown:
                arrays.append(np.ones(int((gb * 1e9 - grown) // 8)))
            ballast += [[i] for i in range(int(millions * 1e6) - len(ballast))]
            gc.collect()
            state = f"{gb:g} GB {millions:g}M objects"
            print(f"{state}: {len(gc.get_objects())} gc-tracked objects, resident set "
                  f"{cs.host_rss_gb():.2f} GB ({time.perf_counter() - t0:.1f} s)", flush=True)
            for label in args.paths:
                _, net, mode = paths[label]
                step = step_rate(cfg, ckpt, net, mode)
                record["steps"][f"{state} {label}"] = step
                print(f"{state} {label}: graphed step {step:.2f}", flush=True)
                for r in range(args.rounds):
                    for kind in (args.kinds if r % 2 == 0 else args.kinds[::-1]):
                        frozen = kind == "process_frozen"
                        with frozen_fork() if frozen else contextlib.nullcontext():
                            out = cs.train_graph_loop(
                                kernels, ckpt, label, net, mode,
                                "process" if frozen else kind, print, smi)
                        row = {k: out[k] for k in ("rate", "setup_s", "first_step_s",
                                                   "epoch_start_s", "epoch_s", "seconds",
                                                   "rss_gb", "objects")}
                        row.update(state=state, path=label, kind=kind, round=r,
                                   step_rate=step, ratio=out["rate"] / step)
                        record["loops"].append(row)
                        print(f"{state} {label} {kind} round {r}: loop {out['rate']:.2f}, "
                              f"ratio {row['ratio']:.3f}, epoch starts "
                              f"{', '.join(f'{x:.3f}' for x in out['epoch_start_s'])} s, "
                              f"epochs {', '.join(f'{x:.3f}' for x in out['epoch_s'])} s; "
                              f"card: {smi}", flush=True)
                        gc.collect()
                        torch.cuda.empty_cache()
    return record


def medians(record: dict) -> dict:
    """Per (state, path, kind): the median ratio, epoch start and epoch."""
    out = {}
    for row in record["loops"]:
        key = f"{row['state']} {row['path']} {row['kind']}"
        out.setdefault(key, []).append(row)
    return {k: {"ratio": statistics.median(r["ratio"] for r in rows),
                "epoch_start_s": statistics.median(x for r in rows for x in r["epoch_start_s"]),
                "epoch_s": statistics.median(x for r in rows for x in r["epoch_s"])}
            for k, rows in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default="3D_only,all,CenterDetect,KeypointDetect",
                    type=lambda s: s.split(","))
    ap.add_argument("--kinds", default="thread,process,process_frozen",
                    type=lambda s: s.split(","))
    ap.add_argument("--states", default="0:0,8:0,8:10",
                    type=lambda s: [tuple(float(v) for v in x.split(":")) for x in s.split(",")],
                    help="GB:M, the process grown by GB of memory and M million gc-tracked "
                         "objects, one state each, rising")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="loader_probe.json",
                    help="the record's file name under chiprun_out/")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("loader_probe: no CUDA device available", file=sys.stderr)
        return 2
    record = measure(args)
    record["medians"] = medians(record)
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, args.out), "w") as f:
        json.dump(record, f)
    print(json.dumps({"card": record["card"], "medians": record["medians"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
