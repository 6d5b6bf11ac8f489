"""Analysis pages of the Streamlit GUI (port of
``jarvis_hybridnet_tpu/ui/gui/analyze_gui.py``; reference:
jarvis/ui/gui/analyze_gui.py): run the validation analysis on ``device``
and render the error plots inline; streamlit is imported when the page
renders."""

from __future__ import annotations

import os


from ...utils.utils import latest_run_dir


def _latest_analysis_dir(cfg):
    base = os.path.join(cfg.PARENT_DIR, cfg.PROJECTS_ROOT_PATH,
                        cfg.PROJECT_NAME, "analysis")
    return latest_run_dir(base)


def analyze_gui(project, cfg, device="cuda"):
    import streamlit as st

    st.header("Validation analysis")
    col1, col2 = st.columns(2)
    with col1:
        weights_center = st.text_input("CenterDetect weights:",
                                       value="latest")
    with col2:
        weights_hybridnet = st.text_input("HybridNet weights:",
                                          value="latest")
    from ...utils.calibration import discover_camera_names

    camera_names = discover_camera_names(cfg)
    cameras_to_use = st.multiselect(
        "Select cameras to use for analysis",
        options=camera_names, default=camera_names)
    if st.button("Analyze validation data"):
        from ...analysis.analyze import analyze_validation_data

        if camera_names and not cameras_to_use:
            st.error("Select at least one camera (or all, to use every "
                     "camera).")
            return
        bar = st.progress(0)
        use = (cameras_to_use
               if camera_names and len(cameras_to_use) < len(camera_names)
               else None)
        out = analyze_validation_data(
            project, weights_center=weights_center,
            weights_hybridnet=weights_hybridnet, cameras_to_use=use,
            progress_bar=bar, device=device)
        if out:
            st.success(f"Analysis written to {out}")
            st.session_state["analysis_dir"] = out
        else:
            st.error("Analysis failed.")

    path = st.session_state.get("analysis_dir") or _latest_analysis_dir(cfg)
    if path is None:
        st.info("No analysis runs yet.")
        return
    st.subheader(f"Plots — {os.path.basename(path)}")
    plot = st.selectbox("Plot", ["Error histogram", "Error per keypoint",
                                 "Error histogram per keypoint"])
    cutoff = st.number_input("Cutoff (mm, -1 = none):", value=-1)
    if st.button("Render plot"):
        from ...analysis import plotting

        if plot == "Error histogram":
            fig = plotting.plot_error_histogram(
                path, cutoff=int(cutoff), interactive=False)
        elif plot == "Error per keypoint":
            fig = plotting.plot_error_per_keypoint(
                path, project, interactive=False)
        else:
            fig = plotting.plot_error_histogram_per_keypoint(
                path, project, cutoff=int(cutoff), interactive=False)
        st.pyplot(fig)
