"""Visualization pages of the Streamlit GUI (port of
``jarvis_hybridnet_tpu/ui/gui/visualize_gui.py``; reference:
jarvis/ui/gui/visualize_gui.py:1-177): create overlay videos from saved
predictions (prediction-run picker + info.yaml round-trip; the 3D videos
project on ``device``) and browse dataset samples. streamlit and yaml are
imported when a page renders."""

from __future__ import annotations

import os

from ...config.project_manager import ProjectManager
from ...utils.param_classes import (
    CreateVideos2DParams,
    CreateVideos3DParams,
)
from ...utils.utils import list_run_dirs


def get_prediction_paths(cfg, kind: str):
    """(run names newest-first, base dir) for kind in {'2D', '3D'};
    (None, path) when none exist (reference visualize_gui.py:98-118)."""
    base = os.path.join(
        cfg.PARENT_DIR, cfg.PROJECTS_ROOT_PATH, cfg.PROJECT_NAME,
        "predictions", f"predictions{kind}",
    )
    runs = list_run_dirs(base)
    return (runs or None), base


def get_data_csvs(prediction_path: str) -> list[str]:
    return sorted(f for f in os.listdir(prediction_path)
                  if f.endswith(".csv"))


def _create_video_gui(project, cfg, kind: str, device="cuda"):
    import streamlit as st
    import yaml

    st.header(f"Create Video {kind}")
    st.write(f"Create annotated video from {kind} predictions.")
    runs, base = get_prediction_paths(cfg, kind)
    if runs is None:
        st.warning(f"No predictions created yet. Please run Predict{kind} "
                   "first!")
        return
    run = st.selectbox("Select Prediction to load", runs)
    prediction_path = os.path.join(base, run)
    csvs = get_data_csvs(prediction_path)
    if not csvs:
        st.error(f"Please make sure you created valid predictions with "
                 f"'Predict{kind}'!")
        return
    data_csv_name = st.selectbox("Select Prediction '.csv' to use", csvs)
    data_csv = os.path.join(prediction_path, data_csv_name)
    if not st.button("Create Video"):
        return
    with open(os.path.join(prediction_path, "info.yaml")) as f:
        info = yaml.safe_load(f)
    if kind == "3D":
        from ...visualization.create_videos3d import create_videos3D

        params = CreateVideos3DParams(project, info["recording_path"],
                                      data_csv)
        # multi-session projects: reproject with the calibration rig the
        # prediction ran with, not an arbitrary first one
        params.dataset_name = info.get("dataset_name")
        params.frame_start = info.get("frame_start", 0)
        params.number_frames = info.get("number_frames", -1)
        params.progress_bar = st.progress(0)
        out = create_videos3D(params, device=device)
    else:
        from ...visualization.create_videos2d import create_videos2D

        params = CreateVideos2DParams(project, info["recording_path"],
                                      data_csv)
        params.frame_start = info.get("frame_start", 0)
        params.number_frames = info.get("number_frames", -1)
        params.progress_bar = st.progress(0)
        out = create_videos2D(params)
    if out:
        st.success(f"Videos written to {out}")
    else:
        st.error("Video creation failed.")


def create_video2D_gui(project, cfg, device="cuda"):
    _create_video_gui(project, cfg, "2D", device)


def create_video3D_gui(project, cfg, device="cuda"):
    _create_video_gui(project, cfg, "3D", device)


def visualize_dataset_gui(project, cfg):
    import streamlit as st

    st.header("Visualize Dataset Samples")
    mode = st.selectbox("Dataset", ["Dataset3D", "Dataset2D CenterDetect",
                                    "Dataset2D KeypointDetect"])
    split = st.selectbox("Split", ["train", "val"])
    idx = st.number_input("Sample index:", value=0, min_value=0)
    if not st.button("Show sample"):
        return
    pm = ProjectManager()
    pm.load(project)
    cfg = pm.get_cfg()
    from ...visualization import visualize_dataset as vd

    if mode == "Dataset3D":
        from ...dataset.dataset3d import Dataset3D

        ds = Dataset3D(cfg, set=split)
        fig = vd.visualize_3D_sample(ds, int(idx))
    else:
        from ...dataset.dataset2d import Dataset2D

        dmode = ("CenterDetect" if "CenterDetect" in mode
                 else "KeypointDetect")
        ds = Dataset2D(cfg, set=split, mode=dmode)
        fig = vd.visualize_2D_sample(ds, dmode, int(idx))
    st.pyplot(fig)


def visualize_gui(project, cfg, device="cuda"):
    import streamlit as st

    what = st.selectbox(
        "What to visualize",
        ["Create Video 3D", "Create Video 2D", "Dataset Samples"])
    if what == "Create Video 3D":
        create_video3D_gui(project, cfg, device)
    elif what == "Create Video 2D":
        create_video2D_gui(project, cfg, device)
    else:
        visualize_dataset_gui(project, cfg)
