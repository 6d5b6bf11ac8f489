"""Multi-camera video -> 3D pose CSV driver (port of
``jarvis_hybridnet_tpu/prediction/predict3d.py``), on one device or several
processes.

Equivalent of the reference predict3D (jarvis/prediction/predict3D.py:27-105)
with identical output layout: writes
``projects/<p>/predictions/predictions3D/Predictions_3D_<ts>/`` with
``info.yaml`` and ``data3D.csv`` (two-row header / x,y,z,confidence; NaN rows
when fewer than two cameras detect the subject). Videos are matched to
calibration camera names; framesets are decoded ahead by the reader and
processed in ``FRAME_BATCH`` batches, one batch in flight on the device
while the previous one's rows are written. On the card each step (each
phase of the split cascade) replays a CUDA graph (``predict2d.py``'s
docstring).

``params.trt_mode`` and ``TPU.PROFILE_DIR`` as in ``predict2d.py``: 'new'
exports the fused predictor, 'previous' loads it (and so runs the fused
cascade where ``TPU.TWO_PHASE`` is set), the trace covers the fused loop.

With ``TPU.TWO_PHASE`` and the native video library, the split cascade
streams instead: the reader's paired low-resolution ring feeds phase A, the
host cuts the crops out of the full-resolution ring, phase B runs on them.

Several processes (``torchrun``): pod streaming as ``predict2d.py``'s
docstring says. With ``TPU.SHARD_CAMERAS`` = n the camera ranks of each data
group decode only their cameras' videos and run the camera-sharded
cascade (``parallel/predict_step.build_sharded_predict3d``); camera rank 0
of the group writes its shard. The two-phase cascade runs each data group's
slice on its camera rank 0, without camera sharding, as the JAX driver
runs it without the mesh.
"""

from __future__ import annotations

import os

from ..config.project_manager import ProjectManager
from ..utils import clp
from ..utils.calibration import CameraRig, load_camera_rigs
from ..utils.param_classes import Predict3DParams
from ..utils.transfer import HostToDevice
from . import compile_cache
from .loaders import make_predictor3d_twophase
from .predict2d import (
    _fused_steps,
    _pod_identity,
    _write_info,
    compiled_predictor,
    finish_pod,
    inference_mesh,
    output_dir,
    pod_frame_shard,
    profile_trace,
    progress_callback,
    stream_rows,
)
from .video_io import get_video_paths, open_multi_camera_reader

PER_JOINT = ("x", "y", "z", "confidence")


def get_camera_rig(cfg, dataset_name=None) -> CameraRig:
    """Resolve the calibration rig for a project
    (reference get_repro_tool, jarvis/utils/reprojection.py:115-146)."""
    dataset_dir = os.path.join(
        cfg.PARENT_DIR, cfg.DATASET.DATASET_ROOT_DIR, cfg.DATASET.DATASET_3D
    )
    rigs = load_camera_rigs(dataset_dir)
    if dataset_name is not None and dataset_name in rigs:
        return rigs[dataset_name]
    return rigs[next(iter(rigs))]


def stream_predict3d(cfg, predictor, reader, out_dir: str, progress=None,
                     suffix: str = "", write: bool = True) -> str:
    """The fused streaming loop: each batch ``(frames (T, C, H, W, 3), n)``
    of ``reader`` goes to the device and through ``predictor``; rows go to
    ``out_dir/data3D.csv`` + ``suffix`` (a pod shard, without header), or
    nowhere where ``write`` is False (a camera rank past the first).
    ``reader`` has the interface of ``video_io.MultiCameraReader``
    (iteration, ``recycle``); the caller releases it. The copy to the
    device overlaps the previous batch's work
    (``utils/transfer.HostToDevice``). Returns the CSV's path."""
    steps = _fused_steps(predictor, reader)
    path = os.path.join(out_dir, "data3D.csv" + suffix)
    stream_rows(cfg, steps, path if write else os.devnull, PER_JOINT, progress,
                header=not suffix)
    return path


def stream_predict3d_twophase(cfg, phases, reader, device, out_dir: str,
                              progress=None, suffix: str = "") -> str:
    """The two-phase streaming loop (``predict3d.py:176-208``): each batch
    ``(full, lowres, n)`` of ``reader`` runs phase A on the low-resolution
    frames, copies the crop centers to the host (the step's one
    synchronization), cuts the crops out of ``full`` with ``crop_fn`` and
    runs phase B on them. Returns the CSV's path."""
    phase_a, phase_b, crop_fn = phases

    def steps():
        upload_low, upload_crops = HostToDevice(device), HostToDevice(device)
        for full, low, n in reader:
            cx, cy, c3d, valid = phase_a(upload_low(low))
            crops = crop_fn(full, cx.cpu().numpy(), cy.cpu().numpy())
            reader.recycle(full)
            pts, conf = phase_b(upload_crops(crops), cx, cy, c3d)
            yield (pts, conf, valid), n

    path = os.path.join(out_dir, "data3D.csv" + suffix)
    stream_rows(cfg, steps(), path, PER_JOINT, progress, header=not suffix)
    return path


def _predict3d_twophase(params, cfg, rig, video_paths, batch, device, shard):
    """Split-cascade streaming: the host uploads 4x-downscaled frames for
    CenterDetect and only the bbox^2 crop windows for the rest of the
    cascade — ~9x less host-to-device traffic than full frames. Requires
    the native decode pipeline (its paired lowres ring comes from the same
    decoded frame at no extra decode)."""
    from .video_io import NativeMultiCameraReader

    factor = int(cfg.get("TPU", {}).get("LOWRES_FACTOR", 4))
    frame_start, number_frames, suffix = shard
    reader = NativeMultiCameraReader(
        video_paths, frame_start=frame_start,
        number_frames=number_frames, batch_size=batch, lowres_factor=factor,
    )
    phases = make_predictor3d_twophase(
        cfg, rig, reader.img_size,
        weights_center_detect=params.weights_center_detect,
        weights_hybridnet=params.weights_hybridnet, device=device,
    )
    update, close = progress_callback(params, reader.number_frames)
    try:
        stream_predict3d_twophase(cfg, phases, reader, device, params.output_dir, update,
                                  suffix)
    finally:
        close()
        reader.release()
    return params.output_dir


def predict3D(params: Predict3DParams, device="cuda") -> str | None:
    project = ProjectManager()
    if not project.load(params.project_name):
        clp.error(f"Could not load project: {params.project_name}! Aborting...")
        return None
    cfg = project.cfg
    compile_cache.configure(cfg, params.trt_mode)

    rig = get_camera_rig(cfg, params.dataset_name)
    video_paths = get_video_paths(params.recording_path, rig.camera_names)
    tpu = cfg.get("TPU", {})
    # a loaded artifact is the fused cascade: 'previous' skips the split one
    two_phase = params.trt_mode != "previous" and bool(tpu.get("TWO_PHASE", False))
    if two_phase:
        from .. import native

        two_phase = native.video_available()
        if not two_phase:
            clp.warning("TPU.TWO_PHASE requires the native video pipeline; "
                        "falling back to the fused predictor.")
    # pod streaming: this data group's time slice, its cameras on this rank
    mesh = None
    if params.process_count is None:
        mesh = inference_mesh(cfg, rig.num_cameras,
                              1 if two_phase else int(tpu.get("SHARD_CAMERAS", 1)))
    pi, pc = _pod_identity(params, mesh)
    shard = pod_frame_shard(params, video_paths[0], pi, pc)
    output_dir(project, cfg, params, "3D", mesh)
    if mesh is None or mesh.rank == 0:
        _write_info(params)
    working = mesh is None or mesh.member
    writer = working and (mesh is None or mesh.camera_index == 0)

    batch = int(tpu.get("FRAME_BATCH", 8))

    # split-cascade streaming (lowres CenterDetect + host crops): takes
    # precedence over the fused path when enabled and the native decoder
    # loads
    if two_phase:
        if writer:
            _predict3d_twophase(params, cfg, rig, video_paths, batch, device, shard)
    elif working:
        from ..parallel.predict_step import build_sharded_predict3d

        cams = slice(None) if mesh is None else mesh.cameras(rig.num_cameras)
        frame_start, number_frames, suffix = shard
        reader = open_multi_camera_reader(
            video_paths[cams],
            backend=tpu.get("DECODE_BACKEND"),
            frame_start=frame_start,
            number_frames=number_frames,
            batch_size=batch,
        )
        W, H = reader.img_size
        shape = (batch, len(video_paths[cams]), H, W, 3)
        predictor = compiled_predictor(
            params, cfg, "predict3D", shape,
            lambda: build_sharded_predict3d(cfg, rig, params.weights_center_detect,
                                            params.weights_hybridnet, mesh=mesh,
                                            shard_cameras=mesh is not None, device=device,
                                            graph=mesh is None or mesh.backend == "nccl"),
            mesh)
        update, close = progress_callback(params, reader.number_frames)
        try:
            with profile_trace(cfg, predictor, shape):
                stream_predict3d(cfg, predictor, reader, params.output_dir, update, suffix,
                                 write=writer)
        finally:
            close()
            reader.release()
    finish_pod(params, cfg, mesh, ["data3D.csv"], pi, pc, PER_JOINT)
    return params.output_dir

