"""Parameter dataclasses of the prediction drivers and the video overlays
(reference: jarvis/utils/paramClasses.py:11-57).

A copy of ``Predict3DParams``, ``Predict2DParams``, ``CreateVideos3DParams``
and ``CreateVideos2DParams`` from
``jarvis_hybridnet_tpu/utils/param_classes.py``, with the same fields and
defaults. ``process_index`` / ``process_count`` override a driver's pod
identity (its data group and the number of groups), as in the JAX package;
left None, a multi-process run takes them from its mesh."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class Predict3DParams:
    project_name: str
    recording_path: str
    weights_center_detect: str = "latest"
    weights_hybridnet: str = "latest"
    output_dir: str = ""
    frame_start: int = 0
    number_frames: int = -1
    dataset_name: Any = None
    # reference trt_mode ('off'/'new'/'previous'): prediction/export.py
    trt_mode: str = "off"
    progress_bar: Any = None
    # multi-host (pod) streaming identity (None: the mesh's)
    process_index: Any = None
    process_count: Any = None
    merge_shards: bool = True


@dataclass
class Predict2DParams:
    project_name: str
    recording_path: str
    weights_center_detect: str = "latest"
    weights_keypoint_detect: str = "latest"
    output_dir: str = ""
    frame_start: int = 0
    number_frames: int = -1
    trt_mode: str = "off"
    progress_bar: Any = None
    # multi-host (pod) streaming identity (None: the mesh's)
    process_index: Any = None
    process_count: Any = None
    merge_shards: bool = True


@dataclass
class CreateVideos3DParams:
    project_name: str
    recording_path: str
    data_csv: str
    filename: str = ""
    output_dir: str = ""
    frame_start: int = 0
    number_frames: int = -1
    dataset_name: Any = None
    video_cam_list: list = field(default_factory=list)
    progress_bar: Any = None


@dataclass
class CreateVideos2DParams:
    project_name: str
    recording_path: str
    data_csv: str
    filename: str = ""
    output_dir: str = ""
    frame_start: int = 0
    number_frames: int = -1
    progress_bar: Any = None
