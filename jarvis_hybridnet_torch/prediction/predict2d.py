"""Video -> 2D keypoint CSV driver (port of
``jarvis_hybridnet_tpu/prediction/predict2d.py``), on one device or
several processes.

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

``params.trt_mode`` (:func:`compiled_predictor`): 'new' exports the
predictor to ``projects/<p>/compiled-models/`` (``export.export_predictor``),
'previous' loads it from there instead of building it, 'off' neither.
``TPU.PROFILE_DIR`` traces the loop (:func:`profile_trace`).

Pod streaming, as the JAX drivers do it on a pod (``predict3d.py:35-92``,
``predict2d.py:30-52``), with one process per GPU (``torchrun``): with
``WORLD_SIZE`` > 1 the drivers join the world and mesh it
(:func:`inference_mesh`: ``TPU.MESH_DATA_AXIS`` caps the data axis,
``TPU.SHARD_CAMERAS`` sets predict3D's camera axis); each data group
decodes and predicts its contiguous slice of the recording
(:func:`pod_frame_shard`, ``multihost.process_frame_range``) into
``<csv>.part<k:05d>`` with no header (in predict3D camera rank 0 of the
group writes it; its other ranks decode only their cameras' videos), a
barrier follows, and rank 0 merges the shards in order under one header
(:func:`merge_pod_shards`; a missing shard raises). All ranks take rank
0's time stamp for the run directory. ``params.process_index`` /
``process_count`` override the group's identity (a pod simulated in one
process). A pod shard needs the recording's frame count: unknown, it
raises.

The CSV writers and :func:`stream_rows` are shared with the 3D driver and
need neither yaml, cv2 nor tqdm; the drivers import those where they read
a project, decode video or show progress.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time


from ..config.project_manager import ProjectManager
from ..parallel import multihost
from ..parallel.mesh import make_mesh, plan_inference_devices
from ..utils import clp
from ..utils.param_classes import Predict2DParams
from ..utils.transfer import HostToDevice
from . import compile_cache
from .video_io import open_single_video_reader


def compiled_predictor(params, cfg, kind: str, shape, make, mesh=None):
    """The driver's predictor under ``params.trt_mode``, as the JAX drivers
    pick it (``predict3d.py:316-337``, ``predict2d.py:150-172``): 'previous'
    loads the artifact of this pipeline, input ``shape`` and numerics
    (``export.artifact_path``) where it exists, outside a mesh; else
    ``make()`` builds the predictor, and 'new' exports it there (outside a
    mesh: a sharded step's collectives are not exported)."""
    from . import export

    artifact = export.artifact_path(cfg, kind, shape)
    if params.trt_mode == "previous" and mesh is None:
        if os.path.isfile(artifact):
            clp.info(f"Loading exported predictor: {artifact}")
            return export.load_predictor(artifact)
        clp.warning(f"No exported predictor at {artifact}; building it.")
    predictor = make()
    if params.trt_mode == "new":
        if mesh is not None:
            clp.warning("trt_mode 'new' exports no predictor under a mesh of several ranks.")
        else:
            import torch

            export.export_predictor(predictor, torch.zeros(shape, dtype=torch.uint8), artifact)
            clp.info(f"Exported compiled predictor: {artifact}")
    return predictor


@contextlib.contextmanager
def profile_trace(cfg, predictor, shape):
    """``TPU.PROFILE_DIR``: a ``torch.profiler`` trace of the driver's loop
    from its first step to its last (the JAX drivers' ``jax.profiler``
    trace, ``predict3d.py:339-355``), written by ``tensorboard_trace_handler``
    into the directory; CPU and, on the card, CUDA activity. A graphed step
    is captured for the batch ``shape`` before the trace starts: the loop's
    steps are then replays, which the trace records kernel by kernel, and no
    capture runs under the profiler. Without the key, nothing."""
    profile_dir = cfg.get("TPU", {}).get("PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if predictor.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        predictor(torch.zeros(shape, dtype=torch.uint8, device=predictor.device))
        torch.cuda.synchronize(predictor.device)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield
    clp.info(f"Trace of the prediction loop written to {profile_dir}")


def inference_mesh(cfg, num_cameras: int = 0, n_cam: int = 1):
    """The drivers' mesh over the world, or None for one process: joins
    the world, then ``plan_inference_devices`` over its ranks with
    ``TPU.MESH_DATA_AXIS`` and ``n_cam`` camera ranks (where
    ``num_cameras`` splits). Ranks past the mesh idle."""
    world = multihost.world_size()
    if world <= 1:
        return None
    multihost.initialize_distributed()
    ranks, n_cam = plan_inference_devices(
        list(range(world)), n_data_cap=int(cfg.get("TPU", {}).get("MESH_DATA_AXIS", -1)),
        n_cam=n_cam, num_cameras=num_cameras)
    mesh = make_mesh(len(ranks) // n_cam, n_cam, ranks=ranks)
    if mesh.rank == 0:
        clp.info(f"Sharded inference over {mesh.size} ranks "
                 f"(data={mesh.n_data}, cameras={mesh.n_cameras})")
    return mesh


def _pod_identity(params, mesh=None) -> tuple[int, int]:
    """(data index, data groups): ``params.process_index`` /
    ``process_count`` where given (a simulated pod), else the mesh's."""
    pi = getattr(params, "process_index", None)
    pc = getattr(params, "process_count", None)
    pi = (mesh.data_index if mesh is not None else 0) if pi is None else int(pi)
    pc = (mesh.n_data if mesh is not None else 1) if pc is None else int(pc)
    return pi, pc


def pod_frame_shard(params, probe_path: str, pi: int, pc: int):
    """This data group's (frame_start, number_frames, shard suffix) of the
    recording at ``probe_path``: the identity for one group, else its
    ``process_frame_range`` and ``.part<k:05d>``. Raises where the frame
    count is needed and unknown."""
    if pc <= 1:
        return params.frame_start, params.number_frames, ""
    from .video_io import probe_frame_count

    number_frames = params.number_frames
    if number_frames == -1:
        total = probe_frame_count(probe_path)
        if total <= 0:
            raise ValueError(
                "Pod-sharded prediction needs a total frame count to "
                "split, but the container reports none — pass "
                "number_frames explicitly.")
        number_frames = total - params.frame_start
    lo, hi = multihost.process_frame_range(number_frames, pi, pc)
    return params.frame_start + lo, hi - lo, f".part{pi:05d}"


def merge_pod_shards(output_dir: str, csv_name: str, pc: int, cfg, per_joint) -> None:
    """Rank 0's merge: the header, then the shards' rows in rank order
    (contiguous, rank-ordered time slices: concatenation restores the
    frame order). Raises when a shard is missing: a silently absent merged
    CSV must not read as a successful run."""
    parts = [os.path.join(output_dir, f"{csv_name}.part{pi:05d}") for pi in range(pc)]
    missing = [p for p in parts if not os.path.isfile(p)]
    if missing:
        raise RuntimeError(
            f"Cannot merge pod shards into {csv_name}, missing: {missing} "
            "(a process failed to write its shard, or the shared filesystem "
            "has not made it visible). The .partNNNNN files are left in "
            "place for a manual merge.")
    with open(os.path.join(output_dir, csv_name), "w", newline="") as out:
        writer = csv.writer(out, delimiter=",", quotechar='"', quoting=csv.QUOTE_MINIMAL)
        if len(cfg.KEYPOINT_NAMES) == int(cfg.KEYPOINTDETECT.NUM_JOINTS):
            _write_header(writer, cfg, per_joint=per_joint)
        for p in parts:
            with open(p, newline="") as f:
                out.write(f.read())
    for p in parts:
        os.remove(p)


def finish_pod(params, cfg, mesh, csv_names, pi: int, pc: int, per_joint) -> None:
    """After every shard is written: the barrier of the world, then rank
    0 merges each of ``csv_names`` (where the recording was sharded)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    rank0 = mesh is None or mesh.rank == 0
    if pc > 1 and rank0 and getattr(params, "merge_shards", True):
        for name in csv_names:
            merge_pod_shards(params.output_dir, name, pc, cfg, per_joint)


def stream_rows(cfg, steps, csv_path: str, per_joint, progress=None,
                header: bool = True) -> None:
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
        if header and len(cfg.KEYPOINT_NAMES) == num_joints:
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


def output_dir(project, cfg, params, kind: str, mesh=None) -> str:
    """``params.output_dir``, or a new time-stamped run directory under
    ``projects/<p>/predictions/predictions<kind>/``, on every rank of a
    mesh with rank 0's time stamp."""
    if not params.output_dir:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        if mesh is not None:
            import torch.distributed as dist

            box = [stamp]
            dist.broadcast_object_list(box, src=0)
            stamp = box[0]
        params.output_dir = os.path.join(
            project.parent_dir, cfg.PROJECTS_ROOT_PATH, params.project_name,
            "predictions", f"predictions{kind}", f"Predictions_{kind}_{stamp}",
        )
    os.makedirs(params.output_dir, exist_ok=True)
    return params.output_dir


def predict2D(params: Predict2DParams, device="cuda") -> str | None:
    project = ProjectManager()
    if not project.load(params.project_name):
        clp.error(f"Could not load project: {params.project_name}! Aborting...")
        return None
    cfg = project.cfg
    compile_cache.configure(cfg, params.trt_mode)
    mesh = inference_mesh(cfg) if params.process_count is None else None
    pi, pc = _pod_identity(params, mesh)
    output_dir(project, cfg, params, "2D", mesh)
    if mesh is None or mesh.rank == 0:
        _write_info(params)
    working = mesh is None or mesh.member

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
    csv_names = []
    for recording_path in recording_paths:
        csv_name = "data2D.csv"
        if multiple_videos:
            stem = os.path.basename(recording_path).split(".")[0]
            csv_name = f"{stem}_{csv_name}"
        csv_names.append(csv_name)
        if not working:
            continue
        # pod streaming: this data group's slice of the video into a shard
        frame_start, number_frames, suffix = pod_frame_shard(params, recording_path, pi, pc)
        reader = open_single_video_reader(
            recording_path,
            backend=cfg.get("TPU", {}).get("DECODE_BACKEND"),
            frame_start=frame_start,
            number_frames=number_frames,
            batch_size=batch,
        )
        W, H = reader.img_size
        shape = (batch, H, W, 3)
        if predictor is None:
            from ..parallel.predict_step import build_sharded_predict2d

            predictor = compiled_predictor(
                params, cfg, "predict2D", shape,
                lambda: build_sharded_predict2d(cfg, params.weights_center_detect,
                                                params.weights_keypoint_detect, mesh=mesh,
                                                device=device), mesh)
        steps = _fused_steps(predictor, reader)
        update, close = progress_callback(params, reader.number_frames)
        try:
            with profile_trace(cfg, predictor, shape):
                stream_rows(cfg, steps, os.path.join(params.output_dir, csv_name + suffix),
                            ("x", "y", "confidence"), update, header=not suffix)
        finally:
            close()
            reader.release()
    finish_pod(params, cfg, mesh, csv_names, pi, pc, ("x", "y", "confidence"))
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
