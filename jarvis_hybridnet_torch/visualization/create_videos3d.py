"""Overlay reprojected 3D poses on every camera's video (port of
``jarvis_hybridnet_tpu/visualization/create_videos3d.py``; reference:
jarvis/visualization/create_videos3D.py:22-143): reads the data3D.csv,
projects each frame's 3D pose into all cameras with
``utils/reprojection.project_points`` on ``device`` (the card unless the
caller asks for the CPU), and writes one overlay mp4 per selected camera.

The points of ``PROJECT_FRAMES`` frames are projected in one call and
copied to the host once, so the device is synchronized once per batch of
frames, and cv2 draws from host numpy arrays.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config.project_manager import ProjectManager
from ..prediction.predict3d import get_camera_rig
from ..prediction.video_io import get_video_paths
from ..utils import clp
from ..utils.param_classes import CreateVideos3DParams
from ..utils.reprojection import project_points
from ..utils.skeleton import get_skeleton
from . import visualization_utils as utils

PROJECT_FRAMES = 64  # frames whose points one projection call takes


def _has_text_header(csv_path: str) -> bool:
    """True when the CSV starts with the two-row joint-name header. A NaN
    check on the first value would misfire on an undetected (all-'NaN')
    first frame row, which is numeric."""
    with open(csv_path) as f:
        first = f.readline().split(",")[0].strip()
    try:
        float(first)
        return False
    except ValueError:
        return True


def projected_frames(points3D: np.ndarray, rig, device) -> np.ndarray:
    """(F, J, C, 2) pixels of (F, J * 3) world points, projected on
    ``device`` ``PROJECT_FRAMES`` frames a call, each call's result copied
    to the host once. NaN rows stay NaN."""
    dev = torch.device(device)
    cams = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in (rig.camera_matrices, rig.intrinsics, rig.distortions)]
    pts = points3D.reshape(len(points3D), -1, 3).astype(np.float32)
    out = []
    for i in range(0, len(pts), PROJECT_FRAMES):
        chunk = torch.as_tensor(pts[i:i + PROJECT_FRAMES], device=dev)
        out.append(project_points(chunk, *cams).cpu().numpy())
    C = len(rig.camera_matrices)
    return (np.concatenate(out) if out
            else np.zeros((0, pts.shape[1], C, 2), np.float32))


def create_videos3D(params: CreateVideos3DParams, device="cuda") -> str | None:
    import cv2
    from tqdm import tqdm

    project = ProjectManager()
    if not project.load(params.project_name):
        clp.error(f"Could not load project: {params.project_name}!")
        return None
    cfg = project.cfg
    rig = get_camera_rig(cfg, params.dataset_name)

    params.output_dir = os.path.join(
        project.parent_dir, cfg.PROJECTS_ROOT_PATH, params.project_name,
        "visualization", f'Videos_3D_{time.strftime("%Y%m%d-%H%M%S")}',
    )
    os.makedirs(params.output_dir, exist_ok=True)

    video_paths = get_video_paths(params.recording_path, rig.camera_names)
    make_video = [not params.video_cam_list or camera in params.video_cam_list
                  for camera in rig.camera_names]

    caps, outs = [], []
    img_size = [0, 0]
    for i, path in enumerate(video_paths):
        cap = cv2.VideoCapture(path)
        size = [int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))]
        assert img_size == [0, 0] or img_size == size, (
            "All videos need to have the same resolution")
        img_size = size
        cap.set(cv2.CAP_PROP_POS_FRAMES, params.frame_start)
        caps.append(cap)
        if make_video[i]:
            stem = os.path.basename(path).split(".")[0]
            outs.append(cv2.VideoWriter(
                os.path.join(params.output_dir, stem + ".mp4"),
                cv2.VideoWriter_fourcc("m", "p", "4", "v"),
                cap.get(cv2.CAP_PROP_FPS), (img_size[0], img_size[1]),
            ))
        else:
            outs.append(None)

    colors, line_idxs = get_skeleton(cfg)
    data = np.genfromtxt(params.data_csv, delimiter=",")
    if _has_text_header(params.data_csv):
        data = data[2:]
    points3D = np.delete(data, list(range(3, data.shape[1], 4)), axis=1)

    total = int(caps[0].get(cv2.CAP_PROP_FRAME_COUNT))
    if params.number_frames == -1:
        params.number_frames = total - params.frame_start
    else:
        assert params.frame_start + params.number_frames <= total

    frames = min(params.number_frames, len(points3D))
    points2D_all = projected_frames(points3D[:frames], rig, device)  # (F, J, C, 2)
    for frame_num in tqdm(range(frames)):
        imgs = []
        for cap in caps:
            ret, img = cap.read()
            imgs.append(img if ret else None)
        if not np.isnan(points3D[frame_num, 0]):
            points2D = points2D_all[frame_num]
            for ci in range(len(caps)):
                if make_video[ci] and imgs[ci] is not None:
                    cam_pts = points2D[:, ci]
                    for line in line_idxs:
                        utils.draw_line(imgs[ci], line, cam_pts, img_size, colors[line[1]])
                    for j, pt in enumerate(cam_pts):
                        utils.draw_point(imgs[ci], pt, img_size, colors[j])
        for ci, out in enumerate(outs):
            if out is not None and imgs[ci] is not None:
                out.write(imgs[ci])
        if params.progress_bar is not None:
            params.progress_bar.progress((frame_num + 1) / params.number_frames)

    for out in outs:
        if out is not None:
            out.release()
    for cap in caps:
        cap.release()
    return params.output_dir
