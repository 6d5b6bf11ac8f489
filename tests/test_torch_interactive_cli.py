"""The port's interactive CLI (``jarvis_hybridnet_torch/ui/interactive_cli.py``)
against the JAX package's (``jarvis_hybridnet_tpu/ui/interactive_cli.py``).

Its pickers and prompts, driven by scripted ``input()`` answers, as
``tests/test_interactive_cli.py`` holds JAX's (the compiled-model wizard
over the port's ``export.list_artifacts``); then the same scripted answers
through both packages' ``launch_interactive_prompt``, from the main menu to
an entry point, hand equal arguments (the same Params, the same trainer
and analysis arguments) to the monkeypatched entry points of each package,
the port's with the ``device`` it was given. The project is a
``testing.write_project`` on a ``write_dataset3d`` dataset, which both
packages' project managers load.
"""

import builtins
import dataclasses
import os

import numpy as np
import pytest

from jarvis_hybridnet_torch.config import get_default_cfg
from jarvis_hybridnet_torch.prediction import export
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.ui import interactive_cli
from jarvis_hybridnet_tpu.ui import interactive_cli as jax_cli

CAMS, W, H = 4, 320, 256


def _script(monkeypatch, answers):
    it = iter(answers)
    monkeypatch.setattr(builtins, "input", lambda *a: next(it))


def test_menu_navigation(monkeypatch, capsys):
    _script(monkeypatch, ["bogus", "2", "q"])
    assert interactive_cli._menu("Pick:", ["alpha", "beta"]) == "beta"
    assert "Please enter a valid option" in capsys.readouterr().out
    assert interactive_cli._menu("Pick:", ["alpha"]) is None


def test_main_menu_quits(monkeypatch, capsys):
    monkeypatch.setattr(builtins, "input", lambda *a: "q")
    interactive_cli.launch_interactive_prompt("cpu")
    assert "PyTorch" in capsys.readouterr().out


def test_pickers_match_jax(monkeypatch, tmp_path):
    """The project, pretrain and weights pickers return what JAX's return
    for the same answers."""
    (tmp_path / "projects" / "P1").mkdir(parents=True)
    (tmp_path / "projects" / "P1" / "config.yaml").write_text("{}")
    pt = tmp_path / "pretrained" / "MonkeyHand"
    pt.mkdir(parents=True)
    (pt / "EfficientTrack_Center-small.pth").write_bytes(b"x")
    w = tmp_path / "w.ckpt"
    w.write_bytes(b"x")
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(tmp_path))
    cases = [("_pick_project", (), ["1"]),
             ("_pick_weights_or_pretrain", (str(tmp_path),), ["2"]),
             ("_pick_weights_or_pretrain", (str(tmp_path),), ["1", "2"]),
             ("_pick_weights_or_pretrain", (str(tmp_path),), ["1", "1", "/nope.pth", str(w)]),
             ("_pick_model_weights", ("CenterDetect",), ["1"]),
             ("_pick_model_weights", ("CenterDetect",), ["2", str(w)])]
    for name, args, answers in cases:
        got = []
        for module in (interactive_cli, jax_cli):
            _script(monkeypatch, answers)
            got.append(getattr(module, name)(*args))
        assert got[0] == got[1], (name, answers)
    assert got[0] == str(w)


def test_frame_range_prompt_bounded(monkeypatch, tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "cam.avi"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (32, 32))
    for _ in range(10):
        w.write(np.zeros((32, 32, 3), np.uint8))
    w.release()
    _script(monkeypatch, ["1"])
    assert interactive_cli.get_frame_start_number(str(path)) == (0, -1)
    _script(monkeypatch, ["2", "99", "2", "4"])
    assert interactive_cli.get_frame_start_number(str(path)) == (2, 4)


def test_compiled_mode_wizard(monkeypatch, tmp_path):
    cfg = get_default_cfg()
    cfg.PARENT_DIR = str(tmp_path)
    cfg.PROJECT_NAME = "P"
    _script(monkeypatch, ["1"])  # no saved artifact -> 'new'
    assert interactive_cli.get_compiled_mode(cfg, "predict3D") == "new"
    other = get_default_cfg()
    other.PARENT_DIR, other.PROJECT_NAME = str(tmp_path), "P"
    other.TPU.REPRO_MODE = "half" if cfg.TPU.REPRO_MODE != "half" else "exact"
    art = export.artifact_path(other, "predict3D", (1, 2))  # another repro mode's: not offered
    os.makedirs(os.path.dirname(art), exist_ok=True)
    with open(art, "wb") as f:
        f.write(b"x")
    _script(monkeypatch, ["1"])
    assert interactive_cli.get_compiled_mode(cfg, "predict3D") == "new"
    art = export.artifact_path(cfg, "predict3D", (1, 2))
    with open(art, "wb") as f:
        f.write(b"x")
    _script(monkeypatch, ["1", "1"])
    assert interactive_cli.get_compiled_mode(cfg, "predict3D") == "previous"
    _script(monkeypatch, ["1", "2", "1"])
    assert interactive_cli.get_compiled_mode(cfg, "predict3D") == "new"
    _script(monkeypatch, ["2"])
    assert interactive_cli.get_compiled_mode(cfg, "predict3D") == "off"


def test_analysis_run_picker(monkeypatch, tmp_path):
    cfg = get_default_cfg()
    cfg.PARENT_DIR = str(tmp_path)
    cfg.PROJECT_NAME = "P"
    assert interactive_cli._pick_analysis_run(cfg) is None
    base = tmp_path / "projects" / "P" / "analysis"
    (base / "Validation_Predictions_1").mkdir(parents=True)
    (base / "Validation_Predictions_2").mkdir()
    _script(monkeypatch, ["1"])
    assert interactive_cli._pick_analysis_run(cfg).endswith("Validation_Predictions_2")


def test_analyze_cameras_subset_no_dataset(monkeypatch, tmp_path, capsys):
    cfg = get_default_cfg()
    cfg.PARENT_DIR = str(tmp_path)
    assert cfg.DATASET.DATASET_3D is None
    _script(monkeypatch, ["2"])
    assert interactive_cli._pick_cameras_subset(cfg) is None
    assert "using all" in capsys.readouterr().out


def test_check_devices(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not interactive_cli._check_devices("cuda")
    assert interactive_cli._check_devices("cpu")


# -------------------------------------------------- whole sessions vs JAX ---

@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(CAMS, W, H), W, H, 23,
                    splits=(("train", 2), ("val", 2)), extent_mm=40.0, seed=4)
    write_project(str(root), "P", {"DATASET": {"DATASET_2D": "Synth", "DATASET_3D": "Synth"},
                                   "KEYPOINTDETECT": {"NUM_JOINTS": 23},
                                   "HYBRIDNET": {"NUM_CAMERAS": CAMS}})
    rec = root / "recording"
    rec.mkdir()
    cv2 = pytest.importorskip("cv2")
    for c in range(CAMS):  # 6 frames: the frame-range prompts are bounded by them
        w = cv2.VideoWriter(str(rec / f"Cam{c}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 30,
                            (32, 32))
        for _ in range(6):
            w.write(np.zeros((32, 32, 3), np.uint8))
        w.release()
    (root / "weights.ckpt").write_bytes(b"x")
    pred = root / "projects" / "P" / "predictions" / "predictions3D" / "Predictions_3D_1"
    pred.mkdir(parents=True)
    (pred / "data3D.csv").write_text("x\n")
    (pred / "info.yaml").write_text(f"recording_path: {rec}\nframe_start: 2\n"
                                    "number_frames: 4\ndataset_name: null\n")
    (root / "projects" / "P" / "analysis" / "run_1").mkdir(parents=True)
    return root


def _record(monkeypatch, calls):
    """Every entry point the menus reach, in both packages, replaced by a
    recorder of its arguments (Params as dicts without the progress bar)."""
    import jarvis_hybridnet_torch.analysis.analyze as port_analyze
    import jarvis_hybridnet_torch.analysis.plotting as port_plotting
    import jarvis_hybridnet_torch.prediction.predict2d as port_p2
    import jarvis_hybridnet_torch.prediction.predict3d as port_p3
    import jarvis_hybridnet_torch.training.train_interface as port_ti
    import jarvis_hybridnet_torch.visualization.create_videos3d as port_v3
    import jarvis_hybridnet_tpu.analysis.analyze as jax_analyze
    import jarvis_hybridnet_tpu.analysis.plotting as jax_plotting
    import jarvis_hybridnet_tpu.prediction.predict2d as jax_p2
    import jarvis_hybridnet_tpu.prediction.predict3d as jax_p3
    import jarvis_hybridnet_tpu.training.train_interface as jax_ti
    import jarvis_hybridnet_tpu.visualization.create_videos3d as jax_v3

    def plain(a):
        return dataclasses.asdict(a) if dataclasses.is_dataclass(a) else a

    for pkg, mods in (("port", (port_analyze, port_plotting, port_p2, port_p3, port_ti, port_v3)),
                      ("jax", (jax_analyze, jax_plotting, jax_p2, jax_p3, jax_ti, jax_v3))):
        analyze, plotting, p2, p3, ti, v3 = mods
        for mod, name in ((analyze, "analyze_validation_data"),
                          (plotting, "plot_error_histogram"),
                          (plotting, "plot_error_per_keypoint"), (p2, "predict2D"),
                          (p3, "predict3D"), (ti, "train_efficienttrack"),
                          (ti, "train_hybridnet"), (v3, "create_videos3D")):
            def rec(*a, _pkg=pkg, _name=name, **k):
                device = k.pop("device", None)
                calls.append((_pkg, _name, [plain(x) for x in a], k, device))
                return True
            monkeypatch.setattr(mod, name, rec)


SESSIONS = {
    "predict3D": ["3", "1", "1", "{rec}", "2", "1", "3", "2", "2", "{w}", "1", "q"],
    "predict3D_previous": ["3", "1", "1", "{rec}", "1", "1", "1", "q"],
    "predict2D": ["3", "1", "2", "{rec}/Cam0.avi", "1", "2", "1", "1", "q"],
    "train_center": ["2", "1", "2", "3", "1", "2", "q"],
    "train_hybridnet": ["2", "1", "4", "4", "2", "2", "{w}", "2", "q"],
    "train_all": ["2", "1", "1", "2", "3", "4", "1", "2", "q"],
    "create_videos3D": ["4", "1", "1", "1", "q"],
    "analyze_validation": ["5", "1", "1", "1", "2", "{w}", "1", "q"],
    "plot_histogram": ["5", "1", "2", "1", "1", "2", "25", "2", "q"],
    "plot_per_keypoint": ["5", "1", "3", "1", "1", "q"],
}


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_sessions_call_the_entry_points_as_jax(session, parent, monkeypatch):
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(parent))
    monkeypatch.setattr(interactive_cli, "_check_devices", lambda device: True)
    monkeypatch.setattr(jax_cli, "_check_devices", lambda: True)
    if session == "predict3D_previous":  # a saved artifact of the project's numerics
        from jarvis_hybridnet_torch.config.project_manager import ProjectManager
        from jarvis_hybridnet_tpu.config.project_manager import ProjectManager as JaxPM
        from jarvis_hybridnet_tpu.prediction import export as jax_export

        for pm_cls, exp in ((ProjectManager, export), (JaxPM, jax_export)):
            pm = pm_cls()
            assert pm.load("P")
            art = exp.artifact_path(pm.get_cfg(), "predict3D", (8, CAMS, H, W, 3))
            os.makedirs(os.path.dirname(art), exist_ok=True)
            with open(art, "wb") as f:
                f.write(b"x")
    calls = []
    _record(monkeypatch, calls)
    answers = [a.format(rec=parent / "recording", w=parent / "weights.ckpt")
               for a in SESSIONS[session]]
    _script(monkeypatch, answers)
    interactive_cli.launch_interactive_prompt("cpu")
    _script(monkeypatch, answers)
    jax_cli.launch_interactive_prompt()
    port = [c[1:4] for c in calls if c[0] == "port"]
    jax = [c[1:4] for c in calls if c[0] == "jax"]
    assert port and port == jax
    # every entry point that runs a network runs on the prompt's device
    assert all(c[4] == ("cpu" if "plot" not in c[1] else None) for c in calls if c[0] == "port")
    if session == "predict3D_previous":
        assert port[0][1][0]["trt_mode"] == "previous"
