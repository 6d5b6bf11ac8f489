"""Video -> 2D keypoint CSV driver (port of
``jarvis_hybridnet_tpu/prediction/predict2d.py``), on one device.

Equivalent of the reference predict2D (jarvis/prediction/predict2D.py:30-117)
with identical output layout: writes
``projects/<p>/predictions/predictions2D/Predictions_2D_<ts>/`` containing
``info.yaml`` and ``data2D.csv`` (two-row header of joint names /
x,y,confidence when KEYPOINT_NAMES matches; NaN rows for undetected frames).
Frames are decoded ahead by the reader and processed in ``FRAME_BATCH``
batches, one batch in flight on the device while the previous one's rows
are written (:func:`stream_rows`). Each batch goes to the device through a
pinned staging pair on a side stream (``utils/transfer.HostToDevice``): the
copy of batch k + 1 overlaps the device's work on batch k. The helper copies
a batch into its staging buffer before it returns, so the reader's ring
buffer goes back to the reader as soon as the batch's work is dispatched.
On the card the predictors replay one CUDA graph a batch (the loaders'
``graph=True``, ``export.wrap_predictor``); the reader yields full batches
of ``FRAME_BATCH`` frames, so a driver captures one graph. A replay's
outputs are clones, so batch k's pending outputs keep their values while
batch k + 1 runs.

The CSV writers and :func:`stream_rows` are shared with the 3D driver and
need neither yaml, cv2 nor tqdm; the drivers import those where they read
a project, decode video or show progress.
"""

from __future__ import annotations

import csv
import os
import time


from ..config.project_manager import ProjectManager
from ..utils import clp
from ..utils.param_classes import Predict2DParams
from ..utils.transfer import HostToDevice
from .loaders import make_predictor2d
from .video_io import open_single_video_reader


def check_params(params) -> None:
    """The port's drivers run the predictors as they are, on one device."""
    if params.trt_mode != "off":
        raise ValueError(f"trt_mode {params.trt_mode!r}: exporting or loading a compiled "
                         "predictor is not ported yet (ROADMAP.md A.13); use 'off'")
    if params.process_count not in (None, 1):
        raise ValueError("pod streaming (process_count > 1) is not ported yet "
                         "(ROADMAP.md A.12)")


def stream_rows(cfg, steps, csv_path: str, per_joint, progress=None) -> None:
    """Write each batch's rows to ``csv_path``, keeping a one-deep pending
    slot: ``steps`` yields ``(outputs, n)`` and dispatches the device work
    of batch k + 1 before batch k's rows are written here, so writing
    overlaps the device call in flight. ``per_joint`` names the CSV columns
    of a joint (``x, y, confidence`` or ``x, y, z, confidence``);
    ``progress(n)`` is called after each batch."""
    num_joints = int(cfg.KEYPOINTDETECT.NUM_JOINTS)
    with open(csv_path, "w", newline="") as csvfile:
        writer = csv.writer(csvfile, delimiter=",", quotechar='"',
                            quoting=csv.QUOTE_MINIMAL)
        if len(cfg.KEYPOINT_NAMES) == num_joints:
            _write_header(writer, cfg, per_joint=per_joint)
        pending = None  # (outputs, n)
        for item in steps:
            if pending is not None:
                _drain(writer, pending, num_joints, len(per_joint) == 4, progress)
            pending = item
        if pending is not None:
            _drain(writer, pending, num_joints, len(per_joint) == 4, progress)


def _drain(writer, pending, num_joints, with_z, progress):
    (points, conf, valid), n = pending
    points, conf, valid = (a.cpu().numpy() for a in (points, conf, valid))
    for t in range(n):
        _write_row(writer, points[t], conf[t], valid[t], num_joints, with_z=with_z)
    if progress is not None:
        progress(n)


def _fused_steps(predictor, reader):
    """``(outputs, n)`` per batch of ``reader``: the frames copied to the
    predictor's device, the predictor dispatched, then the ring buffer back
    to the reader (the device copy reads the staging buffer; on the CPU the
    predictor has run)."""
    upload = HostToDevice(predictor.device)
    for frames, n in reader:
        out = predictor(upload(frames))
        reader.recycle(frames)
        yield out, n


def progress_callback(params, total):
    """A tqdm bar over ``total`` frames, and the caller's progress bar when
    ``params.progress_bar`` is set: ``(update(n), close())``."""
    from tqdm import tqdm

    bar = tqdm(total=total)
    done = [0]

    def update(n):
        bar.update(n)
        done[0] += n
        if params.progress_bar is not None and total:
            params.progress_bar.progress(min(1.0, done[0] / total))

    return update, bar.close


def output_dir(project, cfg, params, kind: str) -> str:
    """``params.output_dir``, or a new time-stamped run directory under
    ``projects/<p>/predictions/predictions<kind>/``."""
    if not params.output_dir:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        params.output_dir = os.path.join(
            project.parent_dir, cfg.PROJECTS_ROOT_PATH, params.project_name,
            "predictions", f"predictions{kind}", f"Predictions_{kind}_{stamp}",
        )
    os.makedirs(params.output_dir, exist_ok=True)
    return params.output_dir


def predict2D(params: Predict2DParams, device="cuda") -> str | None:
    check_params(params)
    project = ProjectManager()
    if not project.load(params.project_name):
        clp.error(f"Could not load project: {params.project_name}! Aborting...")
        return None
    cfg = project.cfg
    output_dir(project, cfg, params, "2D")
    _write_info(params)

    recording_paths = []
    multiple_videos = False
    if os.path.isfile(params.recording_path):
        recording_paths.append(params.recording_path)
    elif os.path.exists(params.recording_path):
        multiple_videos = True
        recording_paths = [
            os.path.join(params.recording_path, f)
            for f in sorted(os.listdir(params.recording_path))
        ]

    batch = int(cfg.get("TPU", {}).get("FRAME_BATCH", 8))
    predictor = None
    for recording_path in recording_paths:
        csv_name = "data2D.csv"
        if multiple_videos:
            stem = os.path.basename(recording_path).split(".")[0]
            csv_name = f"{stem}_{csv_name}"
        reader = open_single_video_reader(
            recording_path,
            backend=cfg.get("TPU", {}).get("DECODE_BACKEND"),
            frame_start=params.frame_start,
            number_frames=params.number_frames,
            batch_size=batch,
        )
        if predictor is None:
            predictor = make_predictor2d(cfg, params.weights_center_detect,
                                         params.weights_keypoint_detect, device=device)
        steps = _fused_steps(predictor, reader)
        update, close = progress_callback(params, reader.number_frames)
        try:
            stream_rows(cfg, steps, os.path.join(params.output_dir, csv_name),
                        ("x", "y", "confidence"), update)
        finally:
            close()
            reader.release()
    return params.output_dir


def _write_row(writer, points, conf, valid, num_joints, with_z=False):
    if not valid:
        writer.writerow(["NaN"] * (num_joints * (4 if with_z else 3)))
        return
    row = []
    for j in range(num_joints):
        row += [float(x) for x in points[j]] + [float(conf[j])]
    writer.writerow(row)


def _write_header(writer, cfg, per_joint):
    joints = [name for name in cfg.KEYPOINT_NAMES for _ in per_joint]
    coords = list(per_joint) * len(cfg.KEYPOINT_NAMES)
    writer.writerow(joints)
    writer.writerow(coords)


def _write_info(params, dataset_name=None):
    import yaml

    info = {
        "recording_path": params.recording_path,
        "frame_start": params.frame_start,
        "number_frames": params.number_frames,
    }
    if dataset_name is not None or hasattr(params, "dataset_name"):
        info["dataset_name"] = getattr(params, "dataset_name", dataset_name)
    with open(os.path.join(params.output_dir, "info.yaml"), "w") as f:
        yaml.safe_dump(info, f, sort_keys=False)
