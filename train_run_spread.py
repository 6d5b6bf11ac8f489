#!/usr/bin/env python3
"""How far apart the eager runs of a training path's ``train()`` lie on one
CUDA card, and how often chip_smoke.py's rule for a graphed ``train()``
(``chip_smoke.run_verdict``) refuses a run drawn from that same spread.

    python3 train_run_spread.py [--paths "all half,all"] [--dtypes float32,bfloat16]
                                [--eager 16] [--graphed 4] [--lr-scales 1e-3,1e-2]
                                [--rules 4,6,8] [--out train_run_spread.json]
    python3 train_run_spread.py --analyse chiprun_out/train_run_spread.json

For each path of ``chip_smoke.TRAIN_GRAPH_PATHS`` named in ``--paths``, at
each ``TPU.TRAIN_DTYPE`` of ``--dtypes``, on chip_smoke.py's synthetic
12-camera training set with cuDNN's deterministic algorithms: ``--eager``
eager runs of ``chip_smoke.train_run``, ``--graphed`` graphed runs, and two
graphed runs at each learning rate of ``--lr-scales`` (the path's
MAX_LEARNING_RATE times 1 + the scale: a fault the rule must find). Every
pair of runs gets its ``twin_gap`` of the final states and its
``history_gap``. Then, for each count n of eager runs in ``--rules``, over
every set of n eager runs: how often the rule refuses an eager run left out
of the set (a false refusal: it is drawn from the eager runs' own spread), a
graphed run, and a run at each scaled learning rate. The gaps, histories
and fractions go to ``chiprun_out/<--out>``; the card's name
and power limit, one line per path and rule, and the fractions as one JSON
line to the standard output. ``--analyse`` recomputes the fractions from a
saved file on any machine.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def verdicts(gaps: dict, held_out: list, eager: list, n: int) -> float:
    """The fraction of (run of ``held_out``, set of n runs of ``eager``
    without it) that ``run_verdict`` refuses; ``gaps[(i, j)]`` holds
    (state gap, history gap) of runs i < j."""
    from chip_smoke import run_verdict

    def gap(i, j):
        s, h = gaps[(min(i, j), max(i, j))]
        return tuple(s), h

    refused = total = 0
    for g in held_out:
        for ref in itertools.combinations([e for e in eager if e != g], n):
            held, _ = run_verdict([gap(g, e) for e in ref],
                                  [gap(a, b) for a, b in itertools.combinations(ref, 2)])
            refused += not held
            total += 1
    return refused / total if total else float("nan")


def analyse(record: dict, rules: list) -> dict:
    """Every path's refusal fractions per rule (see the module's doc)."""
    out = {}
    for key, path in record["paths"].items():
        gaps = {tuple(map(int, k.split(","))): v for k, v in path["gaps"].items()}
        kinds = path["kinds"]
        eager = [i for i, k in enumerate(kinds) if k == "eager"]
        res = {}
        for n in rules:
            res[n] = {"eager_left_out": verdicts(gaps, eager, eager, n)}
            for kind in sorted(set(kinds) - {"eager"}):
                res[n][kind] = verdicts(gaps, [i for i, k in enumerate(kinds) if k == kind],
                                        eager, n)
        out[key] = res
    return out


def measure(args) -> dict:
    import torch

    import chip_smoke as cs
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    paths = {p[0]: p for p in cs.TRAIN_GRAPH_PATHS}
    record = {"card": smi, "paths": {}}
    with tempfile.TemporaryDirectory() as parent:
        cs.training_data(parent, print)
        pm = ProjectManager(os.environ["JARVIS_PARENT_DIR"])
        pm.load("Train")
        base = pm.get_cfg()
        for dtype in args.dtypes:
            for label in args.paths:
                _, net, mode, repro = paths[label]
                if net != "HybridNet":
                    raise SystemExit(f"{label}: only HybridNet paths scale their lr here")
                cfg = cs.bf16_cfg(base) if dtype == "bfloat16" else base.clone()
                runs, kinds = [], []
                t0 = time.perf_counter()
                with cs.deterministic_cudnn():
                    plan = ([("eager", False, 0.0)] * args.eager
                            + [("graphed", True, 0.0)] * args.graphed
                            + [(f"lr x (1 + {s:g})", True, s) for s in args.lr_scales
                               for _ in range(2)])
                    for i, (kind, graph, scale) in enumerate(plan):
                        c = cfg.clone()
                        c.HYBRIDNET.MAX_LEARNING_RATE = (float(cfg.HYBRIDNET.MAX_LEARNING_RATE)
                                                         * (1.0 + scale))
                        hist, state, _ = cs.train_run(c, ckpt_paths(), label, net, mode, repro,
                                                      graph, i)
                        runs.append((hist, state))
                        kinds.append(kind)
                seconds = time.perf_counter() - t0
                gaps = {}
                for i, j in itertools.combinations(range(len(runs)), 2):
                    s = cs.twin_gap(runs[i][1], runs[j][1])
                    gaps[f"{i},{j}"] = [list(s), cs.history_gap(runs[i][0], runs[j][0])]
                key = f"{dtype} {label}"
                record["paths"][key] = {"kinds": kinds, "gaps": gaps, "seconds": seconds,
                                        "histories": [h for h, _ in runs]}
                print(f"{key}: {len(runs)} runs in {seconds:.1f} s", flush=True)
                del runs
                torch.cuda.empty_cache()
    return record


def ckpt_paths() -> dict:
    return {n: os.path.join(REPO, "trained", "MonkeyHand", f"{n}_final.ckpt")
            for n in ("CenterDetect", "KeypointDetect", "HybridNet")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default="all half", type=lambda s: s.split(","))
    ap.add_argument("--dtypes", default="float32", type=lambda s: s.split(","))
    ap.add_argument("--eager", type=int, default=16)
    ap.add_argument("--graphed", type=int, default=4)
    ap.add_argument("--lr-scales", default="1e-3,1e-2",
                    type=lambda s: [float(x) for x in s.split(",") if x])
    ap.add_argument("--rules", default="4,6,8",
                    type=lambda s: [int(x) for x in s.split(",") if x],
                    help="eager-run counts to analyse; empty to only measure")
    ap.add_argument("--out", default="train_run_spread.json",
                    help="the record's file name under chiprun_out/")
    ap.add_argument("--analyse", metavar="FILE", help="recompute the fractions of a saved run")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.analyse:
        with open(args.analyse) as f:
            record = json.load(f)
    else:
        import torch

        if not torch.cuda.is_available():
            print("train_run_spread: no CUDA device available", file=sys.stderr)
            return 2
        record = measure(args)
    record["refused"] = analyse(record, args.rules)
    for key, res in record["refused"].items():
        for n, fr in res.items():
            print(f"{key}, {n} eager runs: refused " + ", ".join(
                f"{kind} {v:.5f}" for kind, v in fr.items()))
    if not args.analyse:
        out = os.path.join(REPO, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, args.out), "w") as f:
            json.dump(record, f)
    print(json.dumps({"card": record["card"], "refused": record["refused"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
