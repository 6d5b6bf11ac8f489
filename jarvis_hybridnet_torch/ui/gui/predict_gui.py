"""Prediction pages of the Streamlit GUI (port of
``jarvis_hybridnet_tpu/ui/gui/predict_gui.py``; reference:
jarvis/ui/gui/predict_gui.py). The drivers run on ``device``; streamlit is
imported when a page renders."""

from __future__ import annotations


from ...utils.param_classes import Predict2DParams, Predict3DParams


def predict2D_gui(project, cfg, device="cuda"):
    import streamlit as st

    st.header("Predict 2D")
    st.write("Predict 2D keypoints on a single-camera video.")
    with st.form("predict2d_form"):
        rec = st.text_input("Video path:")
        col1, col2 = st.columns(2)
        with col1:
            frame_start = st.number_input("Start frame:", value=0,
                                          min_value=0)
        with col2:
            number_frames = st.number_input("Number of frames (-1 = all):",
                                            value=-1, min_value=-1)
        weights_center = st.text_input("CenterDetect weights:",
                                       value="latest")
        weights_keypoint = st.text_input("KeypointDetect weights:",
                                         value="latest")
        trt_mode = st.selectbox("Compiled-model cache:",
                                ["off", "new", "previous"])
        submitted = st.form_submit_button("Predict")
    if not submitted or not rec:
        return
    from ...prediction.predict2d import predict2D

    params = Predict2DParams(project, rec)
    params.frame_start = int(frame_start)
    params.number_frames = int(number_frames)
    params.weights_center_detect = weights_center
    params.weights_keypoint_detect = weights_keypoint
    params.trt_mode = trt_mode
    params.progress_bar = st.progress(0)
    out = predict2D(params, device=device)
    if out:
        st.success(f"Predictions written to {out}")
    else:
        st.error("Prediction failed.")


def predict3D_gui(project, cfg, device="cuda"):
    import streamlit as st

    st.header("Predict 3D")
    st.write("Predict 3D poses from a multi-camera recording directory.")
    with st.form("predict3d_form"):
        rec = st.text_input("Recording directory:")
        col1, col2 = st.columns(2)
        with col1:
            frame_start = st.number_input("Start frame:", value=0,
                                          min_value=0)
        with col2:
            number_frames = st.number_input("Number of frames (-1 = all):",
                                            value=-1, min_value=-1)
        weights_center = st.text_input("CenterDetect weights:",
                                       value="latest")
        weights_hybridnet = st.text_input("HybridNet weights:",
                                          value="latest")
        trt_mode = st.selectbox("Compiled-model cache:",
                                ["off", "new", "previous"])
        submitted = st.form_submit_button("Predict")
    if not submitted or not rec:
        return
    from ...prediction.predict3d import predict3D

    params = Predict3DParams(project, rec)
    params.frame_start = int(frame_start)
    params.number_frames = int(number_frames)
    params.weights_center_detect = weights_center
    params.weights_hybridnet = weights_hybridnet
    params.trt_mode = trt_mode
    params.progress_bar = st.progress(0)
    out = predict3D(params, device=device)
    if out:
        st.success(f"Predictions written to {out}")
    else:
        st.error("Prediction failed.")


def predict_gui(project, cfg, device="cuda"):
    import streamlit as st

    what = st.selectbox("Mode", ["Predict 3D", "Predict 2D"])
    if what == "Predict 3D":
        predict3D_gui(project, cfg, device)
    else:
        predict2D_gui(project, cfg, device)
