"""Streamlit GUI (browser dashboard), port of
``jarvis_hybridnet_tpu/ui/gui/jarvis_gui.py``.

Equivalent of the reference GUI (jarvis/ui/gui/jarvis_gui.py and siblings):
project create/load sidebar plus Training / Prediction / Visualization /
Analysis pages wired to the same interface functions as the CLIs, with
live training monitors (5-widget protocol, utils/st_monitor.py), config
sanity checks, prediction-run pickers and inline result plots. Run via
``jarvis-torch launch`` or ``streamlit run jarvis_gui.py [device]``; the
pages run their networks on ``device`` (the command line's root
``--device``, default ``cuda``). Each page imports ``streamlit`` when it
renders, so the package imports without it.
"""

import os
import sys


def project_page(pm, projects):
    import streamlit as st

    st.header("Create a new project")
    with st.form("create_project_form"):
        name = st.text_input("Project name")
        d3d = st.text_input("3D dataset path")
        d2d = st.text_input("2D dataset path (defaults to 3D)")
        submitted = st.form_submit_button("Create")
    if submitted and name:
        ok = pm.create_new(name, d2d or d3d, d3d or None)
        (st.success if ok else st.error)(
            "Project created." if ok else "Creation failed.")
    st.header("Existing projects")
    st.write(projects)


def main(device: str = "cuda"):
    import streamlit as st

    from jarvis_hybridnet_torch.config.project_manager import ProjectManager

    st.set_page_config(page_title="JARVIS PyTorch", layout="wide")
    st.sidebar.title("JARVIS (PyTorch / CUDA edition)")

    pm = ProjectManager()
    projects = pm.get_projects()
    page = st.sidebar.radio(
        "Menu",
        ["Project", "Training", "Prediction", "Visualization", "Analysis"])

    if page == "Project":
        project_page(pm, projects)
        return

    if not projects:
        st.warning("No projects found — create one on the Project page.")
        return
    project = st.sidebar.selectbox("Project", projects)
    if not pm.load(project):
        st.error(f"Could not load project {project}.")
        return
    cfg = pm.get_cfg()

    if page == "Training":
        from jarvis_hybridnet_torch.ui.gui.train_gui import train_gui

        train_gui(project, cfg, device)
    elif page == "Prediction":
        from jarvis_hybridnet_torch.ui.gui.predict_gui import predict_gui

        predict_gui(project, cfg, device)
    elif page == "Visualization":
        from jarvis_hybridnet_torch.ui.gui.visualize_gui import visualize_gui

        visualize_gui(project, cfg, device)
    elif page == "Analysis":
        from jarvis_hybridnet_torch.ui.gui.analyze_gui import analyze_gui

        analyze_gui(project, cfg, device)


if __name__ == "__main__":
    # ``streamlit run`` executes this file as a script: the repository root
    # on the path makes the package importable
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
    main(*sys.argv[1:2])
