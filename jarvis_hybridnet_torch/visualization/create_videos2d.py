"""Overlay predicted 2D poses on a video (port of
``jarvis_hybridnet_tpu/visualization/create_videos2d.py``; reference:
jarvis/visualization/create_videos2D.py:19-79). Host code: cv2 reads the
video and draws the CSV's points; cv2 and tqdm are imported where used."""

from __future__ import annotations

import os
import time

import numpy as np

from ..config.project_manager import ProjectManager
from ..utils import clp
from ..utils.param_classes import CreateVideos2DParams
from ..utils.skeleton import get_skeleton
from . import visualization_utils as utils


def create_videos2D(params: CreateVideos2DParams) -> str | None:
    import cv2
    from tqdm import tqdm

    project = ProjectManager()
    if not project.load(params.project_name):
        clp.error(f"Could not load project: {params.project_name}!")
        return None
    cfg = project.cfg

    params.output_dir = os.path.join(
        project.parent_dir, cfg.PROJECTS_ROOT_PATH, params.project_name,
        "visualization", f'Videos_2D_{time.strftime("%Y%m%d-%H%M%S")}',
    )
    os.makedirs(params.output_dir, exist_ok=True)

    video_path = params.recording_path
    if os.path.isdir(video_path):
        # a multi-video predict2D run stores the recording DIRECTORY in
        # info.yaml and one "<stem>_data2D.csv" per video: find the video
        # this CSV belongs to by its stem
        csv_name = os.path.basename(params.data_csv)
        stem = (csv_name[: -len("_data2D.csv")]
                if csv_name.endswith("_data2D.csv") else None)
        match = [f for f in sorted(os.listdir(video_path))
                 if stem is not None and f.split(".")[0] == stem]
        if not match:
            clp.error(f"Could not find the video for {csv_name} in {video_path}!")
            return None
        video_path = os.path.join(video_path, match[0])

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        clp.error(f"Could not open video: {video_path}!")
        return None
    cap.set(cv2.CAP_PROP_POS_FRAMES, params.frame_start)
    img_size = [int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))]
    frame_rate = cap.get(cv2.CAP_PROP_FPS)
    stem = os.path.basename(video_path).split(".")[0]
    out = cv2.VideoWriter(
        os.path.join(params.output_dir, stem + ".mp4"),
        cv2.VideoWriter_fourcc("m", "p", "4", "v"), frame_rate,
        (img_size[0], img_size[1]),
    )

    colors, line_idxs = get_skeleton(cfg)
    header = np.genfromtxt(params.data_csv, delimiter=",", dtype=str, max_rows=2)
    points2D_all = np.genfromtxt(params.data_csv, delimiter=",")
    if header.ndim == 2 and header[1, 0] == "x":
        points2D_all = points2D_all[2:]

    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert params.frame_start < total, "frame_start bigger than framecount!"
    if params.number_frames == -1:
        params.number_frames = total - params.frame_start
    else:
        assert params.frame_start + params.number_frames <= total

    # bounded by the CSV too: a preempted prediction run has fewer rows
    # than the video has frames
    for frame_num in tqdm(range(min(params.number_frames, len(points2D_all)))):
        ret, img = cap.read()
        if not ret:
            break
        points2D = points2D_all[frame_num].reshape(-1, 3)
        if not np.isnan(points2D[0, 0]):
            for line in line_idxs:
                utils.draw_line(img, line, points2D, img_size, colors[line[1]])
            for j, point in enumerate(points2D):
                utils.draw_point(img, point, img_size, colors[j])
        out.write(img)
        if params.progress_bar is not None:
            params.progress_bar.progress((frame_num + 1) / params.number_frames)

    out.release()
    cap.release()
    return params.output_dir
