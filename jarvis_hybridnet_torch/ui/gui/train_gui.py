"""Training pages of the Streamlit GUI (port of
``jarvis_hybridnet_tpu/ui/gui/train_gui.py``), training on ``device``;
streamlit is imported when a page renders.

Parity with the reference train GUI (jarvis/ui/gui/train_gui.py):
per-network forms (epochs, weights, pretrain picker), config sanity
checks surfaced as st.error before launch (train_gui.py:273-388 — backed
here by config/checks.py), and the full 5-widget live-monitor protocol
(progress bars, epoch counter, loss/accuracy line charts) driven by the
trainers via utils/st_monitor.py.
"""

from __future__ import annotations


from ...config import checks
from ...training import train_interface
from ...utils.utils import get_available_pretrains


def _monitor_widgets(container=None):
    """The 5-widget list of the reference protocol
    (train_gui.py:56-60)."""
    import streamlit as st

    c = container or st
    col1, col2 = c.columns([1, 5])
    with col1:
        epoch_counter = c.empty()
        epoch_counter.markdown("Epoch 0")
    with col2:
        progress_epoch = c.progress(0)
    progress_total = c.progress(0)
    c.subheader("Loss Monitor")
    plot_loss = c.empty()
    c.subheader("Accuracy Monitor")
    plot_acc = c.empty()
    return [progress_total, progress_epoch, epoch_counter,
            plot_loss, plot_acc]


def _check_or_error(cfg, mode: str) -> bool:
    import streamlit as st

    problems = checks.check_config(cfg, mode)
    for p in problems:
        st.error(p)
    return not problems


def _render_cached_results():
    """Re-render the last run's charts from st.session_state
    (reference jarvis_gui.py:74-151)."""
    import streamlit as st

    if not st.session_state.get("results_available"):
        return
    for mode in ("CenterDetect", "KeypointDetect", "HybridNet"):
        key = mode + "/Train Loss"
        if key not in st.session_state:
            continue
        st.subheader(f"{mode} — last run")
        st.line_chart({
            "Train Loss": st.session_state.get(mode + "/Train Loss", []),
            "Val Loss": st.session_state.get(mode + "/Val Loss", []),
        })
        st.line_chart({
            "Train Accuracy": st.session_state.get(
                mode + "/Train Accuracy", []),
            "Val Accuracy": st.session_state.get(mode + "/Val Accuracy", []),
        })


def train_all_gui(project, cfg, device="cuda"):
    import streamlit as st

    st.header("Train Full Network")
    st.write("Train all parts of the network: CenterDetect and the 2D and "
             "3D keypoint detectors.")
    with st.form("train_full_form"):
        col1, col2, col3 = st.columns(3)
        with col1:
            epochs_center = st.number_input(
                "Epochs CenterDetect:",
                value=int(cfg.CENTERDETECT.NUM_EPOCHS),
                min_value=1, max_value=1000)
        with col2:
            epochs_keypoint = st.number_input(
                "Epochs KeypointDetect:",
                value=int(cfg.KEYPOINTDETECT.NUM_EPOCHS),
                min_value=1, max_value=1000)
        with col3:
            epochs_hybridnet = st.number_input(
                "Epochs HybridNet:",
                value=int(cfg.HYBRIDNET.NUM_EPOCHS),
                min_value=1, max_value=1000)
        pretrain = st.selectbox(
            "Pretraining to use",
            ["None"] + get_available_pretrains(cfg.PARENT_DIR))
        submitted = st.form_submit_button("Train")
    if not submitted:
        _render_cached_results()
        return
    if not _check_or_error(cfg, "all"):
        return
    for mode, epochs in (("CenterDetect", epochs_center),
                         ("KeypointDetect", epochs_keypoint)):
        with st.expander(f"Expand {mode} Training", expanded=True):
            st.header(f"Training {mode}")
            widgets = _monitor_widgets()
            ok = train_interface.train_efficienttrack(
                mode, project, int(epochs),
                None if pretrain == "None" else pretrain,
                streamlit_widgets=widgets, device=device)
            if not ok:
                st.error(f"{mode} training did not complete (missing "
                         "weights or preempted), aborting the chain!")
                return
    with st.expander("Expand HybridNet Training", expanded=True):
        st.header("Training HybridNet")
        widgets = _monitor_widgets()
        ok = train_interface.train_hybridnet(
            project, int(epochs_hybridnet), "latest", None, "3D_only",
            streamlit_widgets=widgets, device=device)
    if ok:
        st.success("Training finished.")
    else:
        st.error("HybridNet training did not complete (preempted or "
                 "failed).")


def _train_single_gui(project, cfg, mode, device="cuda"):
    import streamlit as st

    st.header(f"Train {mode} Network")
    section = cfg[mode.upper()] if mode != "HybridNet" else cfg.HYBRIDNET
    with st.form(f"train_{mode}_form"):
        epochs = st.number_input(
            "Epochs:", value=int(section.NUM_EPOCHS),
            min_value=1, max_value=1000)
        weights = st.text_input(
            "Weights:", value="",
            help="'latest', a checkpoint path, or empty")
        pretrain = st.selectbox(
            "Pretraining to use",
            ["None"] + get_available_pretrains(cfg.PARENT_DIR))
        finetune = False
        train_mode = "3D_only"
        if mode == "HybridNet":
            train_mode = st.selectbox(
                "Training mode", ["3D_only", "last_layers", "bifpn", "all"])
            finetune = st.checkbox("Finetune (LR/10)", value=False)
        submitted = st.form_submit_button("Train")
    if not submitted:
        _render_cached_results()
        return
    if not _check_or_error(cfg, mode):
        return
    widgets = _monitor_widgets()
    weights_arg = weights or (None if pretrain == "None" else pretrain)
    if mode == "HybridNet":
        ok = train_interface.train_hybridnet(
            project, int(epochs), "latest", weights_arg or None, train_mode,
            finetune=finetune, streamlit_widgets=widgets, device=device)
    else:
        ok = train_interface.train_efficienttrack(
            mode, project, int(epochs), weights_arg,
            streamlit_widgets=widgets, device=device)
    if ok:
        st.success("Training finished.")
    else:
        st.error("Training failed — check weights/pretrain settings.")


def train_center_detect_gui(project, cfg, device="cuda"):
    _train_single_gui(project, cfg, "CenterDetect", device)


def train_keypoint_detect_gui(project, cfg, device="cuda"):
    _train_single_gui(project, cfg, "KeypointDetect", device)


def train_hybridnet_gui(project, cfg, device="cuda"):
    _train_single_gui(project, cfg, "HybridNet", device)


def train_gui(project, cfg, device="cuda"):
    import streamlit as st

    what = st.selectbox(
        "What to train",
        ["Full Network", "CenterDetect", "KeypointDetect", "HybridNet"])
    if what == "Full Network":
        train_all_gui(project, cfg, device)
    elif what == "CenterDetect":
        train_center_detect_gui(project, cfg, device)
    elif what == "KeypointDetect":
        train_keypoint_detect_gui(project, cfg, device)
    else:
        train_hybridnet_gui(project, cfg, device)
