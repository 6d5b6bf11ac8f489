"""chip_smoke.py's phases of the compiled predictors, the drivers' trace and
the interactive CLI, on one H100: ``export`` (with the trace) and
``launch-cli``.

They run on the project that ``chip_smoke.cli_phase`` creates (12 cameras of
1280x1024, the production config: bf16, quarter_fused, bbox 256, G = 72,
FRAME_BATCH 8), its 16-frame recording and its weights (CenterDetect's head
scaled by 8, the HybridNet the ``train`` command wrote), after that phase's
direct ``predict3D()`` call, whose rows and launches the ``launch-cli``
session is held to:

- ``export``: on a 64-frame recording of the same cameras (eight batches),
  ``predict3D`` 'off', then with ``trt_mode`` 'new' (the live predictor,
  exported to ``projects/Cli/compiled-models/``, predicts the rows) and
  ``TPU.PROFILE_DIR`` set: the trace files name K1-K4's and K10's
  ``__global__`` symbols as often as the loop replayed them (the first
  replay's few records the tracer misses apart), and the loop's poses/s
  over its last seven batches stands beside the untraced 'off' run's; then
  ``predict2D`` on camera 0's 16-frame video 'off', 'new' and 'previous';
  every CSV equal to 'off''s row for row (the same text, so the same
  float32 values); the export and load seconds, each run's first batch;
- ``launch-cli``: one scripted ``jarvis-torch launch-cli`` session
  (``ui/interactive_cli.py`` with ``input`` answered by the script) that
  predicts 3D with the compiled mode 'previous': its rows equal the direct
  call's. The loaded artifacts launch K1-K4 and K10 (K2: quarter_fused) as
  often as the live predictors (two eager warm-ups and a capture of one
  graph; the replays count nothing), counted on the kernels line's paths
  ``export_predict3d`` and ``export_predict2d``; an artifact of another
  repro mode and one of another dtype lie beside them, and neither is
  listed (``export.list_artifacts``) nor loaded.

Each phase's failure exits non-zero (``chip_smoke.fail``). To run them
alone (with the ``cli`` phase that makes their project; builds the kernels
first)::

    python3 chip_smoke_export.py
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SERVING = ("instance_norm_act", "repro_quarter_gather", "soft_argmax", "resize_normalize",
           "argmax2d")
# framesets of the traced predict3D loop and of the untraced run it is
# timed against: eight batches of the production FRAME_BATCH
TRACE_FRAMES = 64


@contextlib.contextmanager
def driver_clock():
    """The clock of the drivers' runs inside the block: ``clock["steps"]``
    the time each graphed step returned (synchronized), ``clock["end"]`` the
    time the last CSV was written; and the seconds of each export and load
    (``clock["export"]``, ``clock["load"]``, the paths loaded in
    ``clock["loaded"]``)."""
    import torch

    from jarvis_hybridnet_torch.prediction import export, predict2d, predict3d

    clock = {"steps": [], "export": [], "load": [], "loaded": []}
    call, stream, exp, load = (export.GraphedStep.__call__, predict2d.stream_rows,
                               export.export_predictor, export.load_predictor)

    def step(self, *args):
        out = call(self, *args)
        torch.cuda.synchronize()
        clock["steps"].append(time.perf_counter())
        return out

    def rows(*a, **k):
        stream(*a, **k)
        clock["end"] = time.perf_counter()

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[key].append(time.perf_counter() - t0)
            if key == "load":
                clock["loaded"].append(a[0])
            return out
        return run

    export.GraphedStep.__call__ = step
    predict2d.stream_rows = predict3d.stream_rows = rows
    export.export_predictor, export.load_predictor = timed(exp, "export"), timed(load, "load")
    clock["start"] = time.perf_counter()
    try:
        yield clock
    finally:
        export.GraphedStep.__call__ = call
        predict2d.stream_rows = predict3d.stream_rows = stream
        export.export_predictor, export.load_predictor = exp, load


def counted(kernels, fn):
    """(fn's result, the launch counts over it)."""
    import torch

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def rows_of(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.reader(f))


def loop_rate(clock, frames: int, batch: int) -> float:
    """Frames a second of the driver's loop after its first batch."""
    return (frames - batch) / (clock["end"] - clock["steps"][0])


def serving(counts: dict) -> dict:
    return {k: counts[k] for k in SERVING}


@contextlib.contextmanager
def traced_project(parent: str, trace_dir: str):
    """The ``Cli`` project's config.yaml with ``TPU.PROFILE_DIR`` set to
    ``trace_dir`` inside the block."""
    import yaml

    config = os.path.join(parent, "projects", "Cli", "config.yaml")
    with open(config) as f:
        made = yaml.safe_load(f)
    made.setdefault("TPU", {})["PROFILE_DIR"] = trace_dir
    with open(config, "w") as f:
        yaml.safe_dump(made, f)
    try:
        yield
    finally:
        del made["TPU"]["PROFILE_DIR"]
        with open(config, "w") as f:
            yaml.safe_dump(made, f)


def check_trace(cs, trace_dir, counts, clock, off_clock, note, smi) -> None:
    """The trace of a predict3D run of TRACE_FRAMES framesets under
    ``TPU.PROFILE_DIR`` (its launch ``counts`` and ``clock``): each serving
    kernel of the loop named, no kernel recorded more often than the loop
    replayed it, and every replay after the first one whole (the tracer
    misses a few kernel records of a graph's first replay after it starts:
    ``chip_smoke.graphed_profile``); the loop's poses/s after its first
    batch beside the untraced run's on the same recording (``off_clock``)."""
    from jarvis_hybridnet_torch.prediction import export

    files = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
    names = []
    for path in files:
        with open(path) as f:
            names += [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    batches = TRACE_FRAMES // cs.T
    # the graph is captured before the trace starts: its warm-ups and the
    # capture launch each kernel (counted), and every batch of the loop is
    # a replay in the trace
    per_step = {k: v // (export.WARMUP + 1) for k, v in serving(counts).items()}
    seen = {w: sum(1 for n in names if re.search(cs.KERNEL_SYMBOLS[w], n)) for w in SERVING}
    traced, untraced = (loop_rate(c, TRACE_FRAMES, cs.T) for c in (clock, off_clock))
    note(f"trace: predict3D with TPU.PROFILE_DIR on {TRACE_FRAMES} framesets: {len(files)} "
         f"trace file(s) ({sum(os.path.getsize(p) for p in files)} bytes); kernel records "
         f"{json.dumps(seen)} for the {batches} replayed batches ({json.dumps(per_step)} a "
         f"step); the loop's last {batches - 1} batches {traced:.2f} poses/s traced against "
         f"{untraced:.2f} untraced; card: {smi}")
    if not files or any(not per_step[w] or not (batches - 1) * per_step[w] <= seen[w]
                        <= batches * per_step[w] for w in SERVING):
        cs.fail("trace: the trace does not name every serving kernel of the loop, or records "
                "other counts than the loop's replays")


def export_phase(cs, kernels, ctx, note, smi) -> dict:
    """``export``: on a TRACE_FRAMES-frame recording predict3D 'off', then
    'new' under ``TPU.PROFILE_DIR`` (its trace: :func:`check_trace`); then
    predict2D 'off', 'new', 'previous' on camera 0's 16-frame video. Returns
    the path counts."""
    from jarvis_hybridnet_torch.prediction.predict2d import predict2D
    from jarvis_hybridnet_torch.prediction.predict3d import predict3D
    from jarvis_hybridnet_torch.utils.param_classes import Predict2DParams, Predict3DParams

    t_phase = time.perf_counter()
    parent = ctx["parent"]
    rec = cs.cli_recording(parent, ctx["dataset"], TRACE_FRAMES, "recording_trace")
    note(f"export: {TRACE_FRAMES}-frame recording of {cs.CAMS} cameras written in "
         f"{time.perf_counter() - t_phase:.2f} s")

    def run3d(mode, out):
        return counted(kernels, lambda: predict3D(Predict3DParams(
            "Cli", rec, weights_center_detect=ctx["center"], weights_hybridnet=ctx["hybrid"],
            output_dir=os.path.join(parent, out), trt_mode=mode), device="cuda"))[1]

    with driver_clock() as off_clock:
        off_counts = run3d("off", "off3D")
    trace_dir = os.path.join(parent, "trace")
    with traced_project(parent, trace_dir), driver_clock() as clock:
        counts = run3d("new", "new3D")
    off3d, new3d = (rows_of(os.path.join(parent, d, "data3D.csv")) for d in ("off3D", "new3D"))
    export_s = clock["export"]
    note(f"export predict3D new: {export_s[0]:.2f} s to export and save the cascade "
         f"(torch.export, weights inside), first batch {clock['steps'][0] - clock['start']:.2f} "
         f"s into the run against 'off''s {off_clock['steps'][0] - off_clock['start']:.2f} s; "
         f"rows equal to 'off''s: {new3d == off3d} ({len(off3d) - 2} framesets); launches "
         f"{json.dumps(serving(counts))}")
    if (new3d != off3d or len(off3d) != TRACE_FRAMES + 2 or len(export_s) != 1
            or not serving(counts) == serving(off_counts) == serving(ctx["off_counts"])):
        cs.fail("predict3D trt_mode new: rows or launches differ from 'off''s, or no export")
    check_trace(cs, trace_dir, counts, clock, off_clock, note, smi)

    video = os.path.join(ctx["rec"], sorted(os.listdir(ctx["rec"]))[0])
    runs = {}
    for mode in ("off", "new", "previous"):
        with driver_clock() as clock:
            _, counts = counted(kernels, lambda: predict2D(Predict2DParams(
                "Cli", video, weights_center_detect=ctx["center"],
                weights_keypoint_detect=ctx["keypoint"],
                output_dir=os.path.join(parent, f"{mode}2D"), trt_mode=mode), device="cuda"))
        runs[mode] = dict(rows=rows_of(os.path.join(parent, f"{mode}2D", "data2D.csv")),
                          counts=serving(counts), all=counts, clock=clock,
                          first=clock["steps"][0] - clock["start"])
    off = runs["off"]
    note(f"export predict2D: new exported in {runs['new']['clock']['export'][0]:.2f} s, previous "
         f"loaded in {runs['previous']['clock']['load'][0]:.2f} s; first batch off / new / "
         f"previous {off['first']:.2f} / {runs['new']['first']:.2f} / "
         f"{runs['previous']['first']:.2f} s; rows equal to off's: new "
         f"{runs['new']['rows'] == off['rows']}, previous {runs['previous']['rows'] == off['rows']}"
         f" ({len(off['rows']) - 2} frames); launches off {json.dumps(off['counts'])}, previous "
         f"{json.dumps(runs['previous']['counts'])}; card: {smi}")
    if (any(runs[m]["rows"] != off["rows"] for m in ("new", "previous"))
            or runs["previous"]["counts"] != off["counts"]
            or len(runs["previous"]["clock"]["loaded"]) != 1):
        cs.fail("predict2D trt_mode new / previous: rows or launches differ from 'off''s")
    note(f"export phase: {time.perf_counter() - t_phase:.1f} s")
    return {"export_predict2d": runs["previous"]["all"]}


def launch_cli_phase(cs, kernels, ctx, note, smi) -> dict:
    """``launch-cli``: a scripted interactive session predicting 3D with the
    compiled mode 'previous', beside artifacts of another repro mode and
    dtype. Returns the path counts."""
    import builtins

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.prediction import export
    from jarvis_hybridnet_torch.ui import interactive_cli
    from jarvis_hybridnet_torch.utils.utils import latest_run_dir

    t_phase = time.perf_counter()
    pm = ProjectManager()
    pm.load("Cli")
    cfg = pm.get_cfg()
    mine = export.list_artifacts(cfg, "predict3D")
    shape = (cs.T, cs.CAMS, cs.H, cs.W, 3)
    current = export.artifact_path(cfg, "predict3D", shape)
    mode, dtype = cfg.TPU.REPRO_MODE, cfg.TPU.INFERENCE_DTYPE
    for key, value in (("REPRO_MODE", "exact" if mode != "exact" else "half"),
                       ("INFERENCE_DTYPE", "float32" if dtype != "float32" else "bfloat16")):
        other = cfg.clone()
        setattr(other.TPU, key, value)
        shutil.copyfile(current, export.artifact_path(other, "predict3D", shape))
    listed = export.list_artifacts(cfg, "predict3D")
    answers = iter(["3", str(pm.get_projects().index("Cli") + 1), "1", ctx["rec"], "1", "1",
                    "1", "q"])
    ask = builtins.input
    builtins.input = lambda *a: next(answers)
    try:
        with driver_clock() as clock:
            _, counts = counted(kernels, lambda: interactive_cli.launch_interactive_prompt("cuda"))
    finally:
        builtins.input = ask
    run = latest_run_dir(os.path.join(ctx["parent"], "projects", "Cli", "predictions",
                                      "predictions3D"))
    got = rows_of(os.path.join(run, "data3D.csv"))
    off3d = rows_of(os.path.join(ctx["direct_dir"], "data3D.csv"))
    note(f"launch-cli: a scripted session (Predict, predict3D, the whole recording, the saved "
         f"compiled model 'previous'): loaded {[os.path.basename(p) for p in clock['loaded']]} "
         f"in {clock['load'][0] if clock['load'] else float('nan'):.2f} s, first batch "
         f"{clock['steps'][0] - clock['start']:.2f} s into the session against 'off''s "
         f"{ctx['off_first_s']:.2f} s; rows equal to the direct call's: {got == off3d}; "
         f"launches of the loaded artifact {json.dumps(serving(counts))} against the live "
         f"predictor's {json.dumps(serving(ctx['off_counts']))}; artifacts listed {listed} of "
         f"{sorted(os.listdir(os.path.dirname(current)))}; card: {smi}")
    if (got != off3d or clock["loaded"] != [current] or listed != mine
            or listed != [os.path.basename(current)]
            or serving(counts) != serving(ctx["off_counts"])):
        cs.fail("launch-cli predict3D previous: rows, the artifact loaded or listed, or the "
                "launches differ from the direct call's")
    note(f"launch-cli phase: {time.perf_counter() - t_phase:.1f} s")
    return {"export_predict3d": counts}


def run_phases(cs, kernels, ctx, note, smi, phase) -> dict:
    """The two phases in order; returns the kernels line's path counts."""
    counts = {}
    phase("export")
    counts.update(export_phase(cs, kernels, ctx, note, smi))
    phase("launch-cli")
    counts.update(launch_cli_phase(cs, kernels, ctx, note, smi))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_export: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from jarvis_hybridnet_torch import kernels
    from jarvis_hybridnet_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}\nbuild: {time.perf_counter() - t0:.1f} s")
    ckpt = {n: os.path.join(REPO, "trained", "MonkeyHand", f"{n}_final.ckpt")
            for n in ("CenterDetect", "KeypointDetect", "HybridNet")}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)

    def phase(name):
        print(f"phase {name}: starts {time.perf_counter() - t0:.1f} s into the run")

    counts = {}
    cs.cli_phase(kernels, ckpt, print, smi, float("nan"),
                 then=lambda ctx: counts.update(run_phases(cs, kernels, ctx, print, smi, phase)))
    print(json.dumps({"paths": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
