"""The port's Streamlit GUI (``jarvis_hybridnet_torch/ui/gui/``) against the
JAX package's (``jarvis_hybridnet_tpu/ui/gui/``), page by page.

Streamlit is not installed; ``tests/fake_streamlit.FakeStreamlit`` records
every widget and display call and answers the scripted responses. It is put
in ``sys.modules`` for each test alone (``monkeypatch``), and the JAX
package's page modules imported under it are dropped again after the test,
so no other test file sees it. For the same responses each page of both
packages records the same calls (the sidebar's title names the package),
and the entry points the pages reach (monkeypatched in both packages)
receive equal arguments, the port's on the device the page was given. The
project is a ``testing.write_project`` on a ``write_dataset3d`` dataset of
4 cameras, which both packages load.
"""

import dataclasses
import importlib
import sys

import pytest

from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from tests import fake_streamlit

CAMS, W, H = 4, 320, 256
PROJECT = "GuiProj"


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(CAMS, W, H), W, H, 23,
                    splits=(("train", 2), ("val", 2)), extent_mm=40.0, seed=4)
    write_project(str(root), PROJECT, {
        "DATASET": {"DATASET_2D": "Synth", "DATASET_3D": "Synth"},
        "KEYPOINTDETECT": {"NUM_JOINTS": 23},
        "HYBRIDNET": {"NUM_CAMERAS": CAMS, "ROI_CUBE_SIZE": 144, "GRID_SPACING": 2}})
    return root


@pytest.fixture
def run_pages(parent, monkeypatch):
    """``run(responses, patch=None) -> {"port": fake, "jax": fake}``: the
    GUI's ``main`` of each package under a fresh fake streamlit; ``patch(pkg,
    calls)`` monkeypatches that package's entry points before its run."""
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(parent))
    before = set(sys.modules)

    def run(responses, patch=None):
        fakes, calls = {}, []
        for pkg in ("port", "jax"):
            fake = fake_streamlit.FakeStreamlit(responses)
            monkeypatch.setitem(sys.modules, "streamlit", fake)
            for name in [n for n in sys.modules if "jarvis_hybridnet_tpu.ui.gui" in n]:
                monkeypatch.delitem(sys.modules, name)
            if patch is not None:
                patch(pkg, calls)
            if pkg == "port":
                from jarvis_hybridnet_torch.ui.gui import jarvis_gui

                jarvis_gui.main("cpu")
            else:
                from jarvis_hybridnet_tpu.ui.gui import jarvis_gui

                jarvis_gui.main()
            fakes[pkg] = fake
        return fakes, calls

    yield run
    for name in set(sys.modules) - before:
        if "jarvis_hybridnet_tpu.ui.gui" in name:
            del sys.modules[name]


def _log(fake):
    """The recorded calls, with the sidebar's title (the package's name)
    left out."""
    return [e for e in fake.log if e[0] != "title"]


def _same(fakes):
    assert _log(fakes["port"]) == _log(fakes["jax"])
    return fakes["port"]


def _params(a):
    if dataclasses.is_dataclass(a):
        return {k: v for k, v in dataclasses.asdict(a).items() if k != "progress_bar"}
    return a


def _patcher(monkeypatch, module, names, result=True):
    """A ``patch(pkg, calls)`` that replaces ``names`` of the package's
    module ``module`` (its dotted name under the package) by recorders of
    their arguments (the device apart); a trainer's widgets are driven as
    the trainers drive them."""

    def patch(pkg, calls):
        base = "jarvis_hybridnet_torch" if pkg == "port" else "jarvis_hybridnet_tpu"
        mod = importlib.import_module(f"{base}.{module}")
        for name in names:
            def rec(*a, _pkg=pkg, _name=name, **k):
                device = k.pop("device", None)
                widgets = k.pop("streamlit_widgets", None)
                calls.append((_pkg, _name, [_params(x) for x in a],
                              {n: _params(v) for n, v in k.items() if n != "progress_bar"},
                              device))
                if widgets is not None:
                    _drive_monitor(_pkg, widgets, a[0])
                return result
            monkeypatch.setattr(mod, name, rec)
    return patch


def _drive_monitor(pkg, widgets, mode):
    """Drive the monitor as the trainers do (the 5-widget protocol)."""
    if pkg == "port":
        from jarvis_hybridnet_torch.utils.st_monitor import StreamlitTrainingMonitor
    else:
        from jarvis_hybridnet_tpu.utils.st_monitor import StreamlitTrainingMonitor
    assert len(widgets) == 5
    m = StreamlitTrainingMonitor(widgets, mode)
    m.start(2)
    m.step(0, 10)
    m.epoch(0, 2, {"train_loss": [1.0], "val_loss": [1.2], "train_acc": [3.0],
                   "val_acc": [4.0]})


def _calls_agree(calls):
    port = [c[1:4] for c in calls if c[0] == "port"]
    jax = [c[1:4] for c in calls if c[0] == "jax"]
    assert port and port == jax
    assert all(c[4] == "cpu" for c in calls if c[0] == "port")
    return port


@pytest.mark.parametrize("responses", [
    {"Menu": "Project"},
    {"Menu": "Training", "Project": PROJECT, "What to train": "Full Network"},
    {"Menu": "Training", "Project": PROJECT, "What to train": "HybridNet"},
    {"Menu": "Prediction", "Project": PROJECT, "Mode": "Predict 3D"},
    {"Menu": "Prediction", "Project": PROJECT, "Mode": "Predict 2D"},
    {"Menu": "Visualization", "Project": PROJECT, "What to visualize": "Create Video 3D"},
    {"Menu": "Visualization", "Project": PROJECT, "What to visualize": "Create Video 2D"},
    {"Menu": "Visualization", "Project": PROJECT, "What to visualize": "Dataset Samples"},
    {"Menu": "Analysis", "Project": PROJECT},
], ids=["project", "train_all", "train_hybridnet", "predict3d", "predict2d", "video3d",
        "video2d", "dataset_samples", "analysis"])
def test_pages_render_as_jax(responses, run_pages):
    fake = _same(run_pages(responses)[0])
    assert fake.calls("header") or fake.calls("warning")


@pytest.mark.parametrize("what, entry", [("CenterDetect", "train_efficienttrack"),
                                         ("HybridNet", "train_hybridnet"),
                                         ("Full Network", None)])
def test_training_submit_drives_monitor_as_jax(what, entry, run_pages, monkeypatch):
    responses = {"Menu": "Training", "Project": PROJECT, "What to train": what, "Train": True}
    fakes, calls = run_pages(responses, _patcher(
        monkeypatch, "training.train_interface", ("train_efficienttrack", "train_hybridnet")))
    fake = _same(fakes)
    port = _calls_agree(calls)
    if entry is not None:
        assert [c[0] for c in port] == [entry]
    else:
        assert [c[0] for c in port] == ["train_efficienttrack"] * 2 + ["train_hybridnet"]
    assert any("Train Loss" in c for c in fake.calls("line_chart") if isinstance(c, dict))
    assert any("Training finished." in s for s in fake.calls("success"))
    assert fake.session_state.get("results_available") is True


def test_training_config_check_blocks_bad_config(run_pages, monkeypatch):
    def patch(pkg, calls):
        base = "jarvis_hybridnet_torch" if pkg == "port" else "jarvis_hybridnet_tpu"
        checks = importlib.import_module(f"{base}.config.checks")
        monkeypatch.setattr(checks, "check_config", lambda cfg, mode: ["BATCH_SIZE bad"])
        _patcher(monkeypatch, "training.train_interface", ("train_efficienttrack",))(pkg, calls)

    fakes, calls = run_pages({"Menu": "Training", "Project": PROJECT,
                              "What to train": "CenterDetect", "Train": True}, patch)
    fake = _same(fakes)
    assert any("BATCH_SIZE bad" in e for e in fake.calls("error"))
    assert not calls


@pytest.mark.parametrize("mode", ["Predict 3D", "Predict 2D"])
def test_prediction_submit_as_jax(mode, run_pages, parent, monkeypatch):
    kind = mode[-2:]

    responses = {"Menu": "Prediction", "Project": PROJECT, "Mode": mode, "Predict": True,
                 "Recording directory:": str(parent / "recording"),
                 "Video path:": str(parent / "recording" / "Cam0.avi"),
                 "Compiled-model cache:": "previous", "Start frame:": 2}
    fakes, calls = run_pages(responses, _patcher(
        monkeypatch, f"prediction.predict{kind.lower()}", (f"predict{kind}",),
        result=str(parent / "out")))
    _same(fakes)
    (name, (params,), _), = _calls_agree(calls)
    assert name == f"predict{kind}" and params["trt_mode"] == "previous"
    assert params["frame_start"] == 2


def test_visualization_creates_videos_as_jax(run_pages, parent, monkeypatch):
    run = parent / "projects" / PROJECT / "predictions" / "predictions3D" / "Predictions_3D_1"
    run.mkdir(parents=True, exist_ok=True)
    (run / "data3D.csv").write_text("x\n")
    (run / "info.yaml").write_text(f"recording_path: {parent / 'recording'}\n"
                                   "frame_start: 2\nnumber_frames: 4\ndataset_name: null\n")

    fakes, calls = run_pages({"Menu": "Visualization", "Project": PROJECT,
                              "What to visualize": "Create Video 3D", "Create Video": True},
                             _patcher(monkeypatch, "visualization.create_videos3d",
                                      ("create_videos3D",), result=str(parent / "v")))
    _same(fakes)
    (name, (params,), _), = _calls_agree(calls)
    assert params["frame_start"] == 2 and params["data_csv"].endswith("data3D.csv")


@pytest.mark.parametrize("cameras", [["Cam0", "Cam2"], []], ids=["subset", "none"])
def test_analysis_cameras_as_jax(cameras, run_pages, monkeypatch):
    fakes, calls = run_pages({"Menu": "Analysis", "Project": PROJECT,
                              "Select cameras to use for analysis": cameras,
                              "Analyze validation data": True},
                             _patcher(monkeypatch, "analysis.analyze",
                                      ("analyze_validation_data",), result="analysis_out"))
    fake = _same(fakes)
    if cameras:
        (_, _, kw), = _calls_agree(calls)
        assert kw["cameras_to_use"] == cameras
    else:
        assert not calls
        assert any("at least one camera" in str(a) for a in fake.calls("error"))
