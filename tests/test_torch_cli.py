"""The port's ``jarvis-torch`` command line (``jarvis_hybridnet_torch/ui/cli.py``)
against the JAX package's ``jarvis`` (``jarvis_hybridnet_tpu/ui/cli.py``).

The command tree, names, parameters, defaults and choices equal JAX's, plus
the root group's ``--device``; command names resolve case-insensitively.
``create-project`` writes the same config.yaml text as JAX's ``create_new``
on one ``testing.write_dataset3d`` dataset. The train commands call the
trainers with JAX's arguments, and ``train hybridNet`` trains on the CPU.
On the small project of ``test_torch_drivers.py`` (4 cameras, 4-frame MJPG
videos of 320x256, the MonkeyHand networks at CenterDetect 64^2, bbox 128,
a 144 mm cube at 4 mm, float32, CenterDetect's head scaled by 8 so that its
maxima straddle the gates) ``predict predict3D`` / ``predict2D`` with
``--device cpu`` write the CSVs of the port's direct calls, within the
drivers' bounds of the JAX CLI's (3D: points 2e-2 mm, confidences 1e-4;
2D: points identical, confidences 1e-5), with ``--trt_mode`` 'new' and
'previous' the direct calls' CSVs, and ``visualize create-videos3D``
/ ``create-videos2D`` write the direct calls' videos, frame for frame
JAX's ``create_videos3D`` / ``create_videos2D`` on the same CSV (the 3D
projections within 1e-3 px of JAX's ``project_points``). ``launch-cli``
runs the interactive CLI and ``launch`` the GUI (or reports streamlit
missing, as JAX's does), and ``--device cuda`` without a card raises.
"""

import csv
import os
import pathlib
import shutil

import click
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from click.testing import CliRunner

from jarvis_hybridnet_torch.prediction.predict2d import predict2D
from jarvis_hybridnet_torch.prediction.predict3d import predict3D
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.ui.cli import cli
from jarvis_hybridnet_torch.utils.param_classes import (
    CreateVideos2DParams,
    CreateVideos3DParams,
    Predict2DParams,
    Predict3DParams,
)
from jarvis_hybridnet_torch.utils.utils import latest_run_dir
from jarvis_hybridnet_torch.visualization.create_videos2d import create_videos2D
from jarvis_hybridnet_torch.visualization.create_videos3d import create_videos3D
from jarvis_hybridnet_tpu.config.project_manager import ProjectManager as JaxProjectManager
from jarvis_hybridnet_tpu.training.checkpoints import load_checkpoint, save_checkpoint
from jarvis_hybridnet_tpu.ui.cli import cli as jax_cli
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

cv2 = pytest.importorskip("cv2")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CAMS, H, W, FRAMES, JOINTS = 4, 256, 320, 4, 23
PREDICT_CONFIG = {
    "DATASET": {"DATASET_2D": "Synth", "DATASET_3D": "Synth"},
    "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": 64},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": JOINTS, "BOUNDING_BOX_SIZE": 128},
    "HYBRIDNET": {"NUM_CAMERAS": CAMS, "ROI_CUBE_SIZE": 144, "GRID_SPACING": 4},
    "KEYPOINT_NAMES": [f"Joint_{j}" for j in range(JOINTS)],
    "TPU": {"FRAME_BATCH": 2, "INFERENCE_DTYPE": "float32", "MESH_DATA_AXIS": 1},
}
TRAIN_CONFIG = {
    "DATASET": {"DATASET_2D": "Synth", "DATASET_3D": "Synth"},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": JOINTS, "BOUNDING_BOX_SIZE": 128},
    "HYBRIDNET": {"ROI_CUBE_SIZE": 48, "GRID_SPACING": 4, "BATCH_SIZE": 1,
                  "NUM_CAMERAS": CAMS},
    "TPU": {"DEVICE_AUG": False, "REPRO_MODE": "quarter_fused", "TRAIN_DTYPE": "float32"},
    "DATALOADER_NUM_WORKERS": 2,
}


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    """A parent directory with the dataset, the projects (each command's
    outputs are stamped to the second, so the port's CLI, its direct calls
    and JAX's CLI each write into a project of their own), a recording and
    the weights."""
    root = tmp_path_factory.mktemp("parent")
    rig = synthetic_rig(CAMS, W, H)
    write_dataset3d(str(root / "datasets" / "Synth"), rig, W, H, JOINTS,
                    splits=(("train", 4), ("val", 2)), extent_mm=40.0, seed=4)
    for name in ("Port", "Direct", "Jax", "Trt"):
        write_project(str(root), name, PREDICT_CONFIG)
    write_project(str(root), "Train", TRAIN_CONFIG)

    rng = np.random.default_rng(7)
    low = torch.from_numpy(rng.random((CAMS * FRAMES, 3, 8, 10)).astype(np.float32))
    smooth = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    frames = smooth.permute(0, 2, 3, 1).numpy() * 255 + rng.normal(0, 6, (CAMS * FRAMES, H, W, 3))
    frames = np.clip(frames, 0, 255).astype(np.uint8).reshape(CAMS, FRAMES, H, W, 3)
    rec = root / "recording"
    rec.mkdir()
    for c in range(CAMS):
        w = cv2.VideoWriter(str(rec / f"Cam{c}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 30,
                            (W, H))
        for t in range(FRAMES):
            w.write(np.ascontiguousarray(frames[c, t, :, :, ::-1]))
        w.release()

    tree = load_checkpoint(str(TRAINED / "CenterDetect_final.ckpt"))
    tree["deconv1"]["kernel"] = np.asarray(tree["deconv1"]["kernel"]) * 8.0
    center = str(root / "weights" / "CenterDetect_x8.ckpt")
    save_checkpoint(tree, center)
    weights = {"center": center, "keypoint": str(TRAINED / "KeypointDetect_final.ckpt"),
               "hybrid": str(TRAINED / "HybridNet_final.ckpt")}
    return root, rec, weights


def _invoke(command, args, parent_dir, monkeypatch, input=None):
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(parent_dir))
    result = CliRunner().invoke(command, args, catch_exceptions=False, input=input)
    assert result.exit_code == 0, result.output
    return result


def _port(args, parent_dir, monkeypatch):
    return _invoke(cli, ["--device", "cpu", *args], parent_dir, monkeypatch)


# ------------------------------------------------------------- the tree ---
def _param(p):
    choices = getattr(p.type, "choices", None)
    return (p.name, type(p).__name__, tuple(p.opts), p.default, p.required, p.nargs,
            p.type.name, tuple(choices) if choices is not None else None,
            getattr(p.type, "case_sensitive", None), getattr(p.type, "min", None))


def _tree(command):
    node = {"params": [_param(p) for p in command.params if p.name != "help"],
            "group": isinstance(command, click.Group)}
    if node["group"]:
        node["commands"] = {name: _tree(sub) for name, sub in command.commands.items()}
        node["order"] = list(command.list_commands(None))
    return node


def test_command_tree_matches_jax():
    port, ref = _tree(cli), _tree(jax_cli)
    (device,) = port["params"]
    assert device[:4] == ("device", "Option", ("--device",), "cuda")
    port["params"] = []
    assert port == ref


@pytest.mark.parametrize("args", [["PREDICT", "PREDICT3D", "--help"],
                                  ["predict", "predict3d", "--help"],
                                  ["Train", "HYBRIDNET", "--help"],
                                  ["visualize", "Create-Videos3d", "--help"],
                                  ["ANALYZE", "analyze-VALIDATION-data", "--help"]])
def test_commands_resolve_case_insensitively(args):
    result = CliRunner().invoke(cli, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    ref = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
    # the same command's help, apart from the program name in the usage line
    assert result.output.splitlines()[1:] == ref.output.splitlines()[1:]


# -------------------------------------------------------- create-project ---
def test_create_project_writes_the_jax_config(parent, monkeypatch):
    root, _, _ = parent
    _port(["create-project", "--dataset3d", "Synth", "Created"], root, monkeypatch)
    JaxProjectManager(str(root)).create_new(name="CreatedJax", dataset2D_path="Synth",
                                            dataset3D_path="Synth")
    text = (root / "projects" / "Created" / "config.yaml").read_text()
    assert text == (root / "projects" / "CreatedJax" / "config.yaml").read_text()
    cfg = yaml.safe_load(text)
    assert cfg["KEYPOINTDETECT"]["NUM_JOINTS"] == JOINTS
    assert cfg["HYBRIDNET"]["NUM_CAMERAS"] == CAMS
    assert cfg["KEYPOINTDETECT"]["BOUNDING_BOX_SIZE"] % 64 == 0
    assert cfg["HYBRIDNET"]["ROI_CUBE_SIZE"] % (4 * cfg["HYBRIDNET"]["GRID_SPACING"]) == 0
    assert cfg["KEYPOINT_NAMES"] == [f"Joint_{j}" for j in range(JOINTS)]
    for module in ("CenterDetect", "KeypointDetect", "HybridNet"):
        assert (root / "projects" / "Created" / "models" / module).is_dir()
        assert (root / "projects" / "Created" / "logs" / module).is_dir()
    # a second project of the same name is refused, as in JAX
    result = CliRunner().invoke(cli, ["create-project", "--dataset3d", "Synth", "Created"])
    assert "already exists" in result.output


def test_interactive_create_new_matches_jax(parent, monkeypatch):
    """``create_new(interactive=True)`` asks for each suggestion as JAX's
    does: the same answers (a word that is neither yes nor no, a custom box
    that is not a multiple of 64, then one that is) give the same text."""
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager

    root, _, _ = parent
    texts = []
    for name, manager in (("AskedPort", ProjectManager), ("AskedJax", JaxProjectManager)):
        answers = iter(["maybe", "no", "100", "320", "yes", "yes"])
        monkeypatch.setattr("builtins.input", lambda *a: next(answers))
        assert manager(str(root)).create_new(name=name, dataset2D_path="Synth",
                                             dataset3D_path="Synth", interactive=True)
        assert next(answers, None) is None
        texts.append((root / "projects" / name / "config.yaml").read_text())
    assert texts[0] == texts[1]
    assert yaml.safe_load(texts[0])["KEYPOINTDETECT"]["BOUNDING_BOX_SIZE"] == 320


def test_run_dirs_pretrains_projects_and_weights_match_jax(parent, tmp_path, monkeypatch):
    """``utils/utils.py``, ``get_projects`` and ``get_latest_weights_path``
    against JAX's: run directories by mtime without stray files, named
    pretrains (not EcoSet, not empty), the projects, the newest final
    weights."""
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.training.train_interface import get_latest_weights_path
    from jarvis_hybridnet_torch.utils import utils as port_utils
    from jarvis_hybridnet_tpu.training.train_interface import (
        get_latest_weights_path as jax_get_latest_weights_path,
    )
    from jarvis_hybridnet_tpu.utils import utils as jax_utils

    runs = tmp_path / "runs"
    for i, name in enumerate(["b", "a", "c"]):
        (runs / name).mkdir(parents=True)
        os.utime(runs / name, (1000 + i, 1000 + i))
    (runs / "stray.part00001").write_text("")
    for newest in (True, False):
        assert (port_utils.list_run_dirs(str(runs), newest)
                == jax_utils.list_run_dirs(str(runs), newest)
                == (["c", "a", "b"] if newest else ["b", "a", "c"]))
    assert port_utils.latest_run_dir(str(runs)) == jax_utils.latest_run_dir(str(runs))
    assert port_utils.latest_run_dir(str(tmp_path / "none")) is None
    for name, files in (("EcoSet", ["x.pth"]), ("Hand", ["w.ckpt"]), ("Empty", [])):
        (tmp_path / "pretrained" / name).mkdir(parents=True)
        for f in files:
            (tmp_path / "pretrained" / name / f).write_text("")
    assert (port_utils.get_available_pretrains(str(tmp_path))
            == jax_utils.get_available_pretrains(str(tmp_path)) == ["Hand"])

    root, _, _ = parent
    assert ProjectManager(str(root)).get_projects() == JaxProjectManager(str(root)).get_projects()
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    run = root / "projects" / "Port" / "models" / "HybridNet" / "Run_1"
    run.mkdir(parents=True, exist_ok=True)
    (run / "HybridNet-small_final.ckpt").write_bytes(b"")
    for module in ("HybridNet", "CenterDetect"):
        assert (get_latest_weights_path("Port", module)
                == jax_get_latest_weights_path("Port", module))
    assert get_latest_weights_path("Port", "HybridNet") == str(run / "HybridNet-small_final.ckpt")
    (run / "HybridNet-small_final.ckpt").unlink()
    run.rmdir()


# ----------------------------------------------------------------- train ---
TRAIN_CALLS = [
    ["train", "centerDetect", "--num_epochs", "3", "--pretrained_weights", "EcoSet", "P"],
    ["train", "keypointDetect", "--weights_path", "w.ckpt", "--resume", "latest", "P"],
    ["train", "hybridNet", "--num_epochs", "2", "--weights_keypoint_detect", "k.ckpt",
     "--mode", "all", "P"],
    ["train", "hybridNet", "--weights_hybridnet", "h.ckpt", "P"],
    ["train", "all", "--num_epochs_center", "1", "--num_epochs_keypoint", "2",
     "--num_epochs_hybridnet", "3", "--pretrain", "MonkeyHand", "P"],
]


@pytest.mark.parametrize("args", TRAIN_CALLS, ids=lambda a: " ".join(a[:2]))
def test_train_commands_call_the_trainers_as_jax(args, monkeypatch):
    """Each train command calls the trainers with the JAX CLI's arguments,
    and the port's with ``device`` besides."""
    from jarvis_hybridnet_torch.training import train_interface as port_ti
    from jarvis_hybridnet_tpu.training import train_interface as jax_ti

    calls = {"port": [], "jax": []}

    def record(side, name):
        def fn(*a, **kw):
            calls[side].append((name, a, kw))
            return True
        return fn

    for side, mod in (("port", port_ti), ("jax", jax_ti)):
        for name in ("train_efficienttrack", "train_hybridnet"):
            monkeypatch.setattr(mod, name, record(side, name))
    CliRunner().invoke(cli, ["--device", "cpu", *args], catch_exceptions=False)
    CliRunner().invoke(jax_cli, args, catch_exceptions=False)
    assert calls["jax"]
    assert len(calls["port"]) == len(calls["jax"])
    for (name, a, kw), (ref_name, ref_a, ref_kw) in zip(calls["port"], calls["jax"]):
        assert (name, a) == (ref_name, ref_a)
        assert kw.pop("device") == "cpu"
        assert kw == ref_kw


def test_train_hybridnet_command_trains_on_the_cpu(parent, monkeypatch):
    root, _, weights = parent
    result = _port(["train", "hybridNet", "--num_epochs", "1", "--weights_hybridnet",
                    weights["hybrid"], "Train"], root, monkeypatch)
    assert "Successfully finished training" in result.output
    run = latest_run_dir(str(root / "projects" / "Train" / "models" / "HybridNet"))
    assert os.path.isfile(os.path.join(run, "HybridNet-small_final.ckpt"))


# --------------------------------------------------------------- predict ---
def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[:2], np.array(rows[2:], dtype=np.float64)


def _compare(got_csv, ref_csv, per_joint, point_tol, conf_tol):
    header, got = _read(got_csv)
    ref_header, ref = _read(ref_csv)
    assert header == ref_header
    assert got.shape == ref.shape == (FRAMES, JOINTS * per_joint)
    nan = np.isnan(got).all(axis=1)
    np.testing.assert_array_equal(nan, np.isnan(ref).all(axis=1))
    got = got[~nan].reshape(-1, JOINTS, per_joint)
    ref = ref[~nan].reshape(-1, JOINTS, per_joint)
    np.testing.assert_allclose(got[..., :-1], ref[..., :-1], rtol=0, atol=point_tol)
    np.testing.assert_allclose(got[..., -1], ref[..., -1], rtol=0, atol=conf_tol)
    return int(nan.sum())


def _latest(root, project, *sub, prefix=""):
    base = root / "projects" / project / pathlib.Path(*sub)
    runs = sorted((p for p in base.iterdir() if p.name.startswith(prefix)),
                  key=os.path.getmtime)
    return str(runs[-1])


@pytest.fixture(scope="module")
def predicted3d(parent):
    """``predict predict3D`` through both CLIs and the port's direct call."""
    root, rec, weights = parent
    with pytest.MonkeyPatch.context() as mp:
        args = ["predict", "predict3D", "--weights_center_detect", weights["center"],
                "--weights_hybridnet", weights["hybrid"]]
        _port([*args, "Port", str(rec)], root, mp)
        _invoke(jax_cli, [*args, "Jax", str(rec)], root, mp)
        direct = predict3D(Predict3DParams(
            "Direct", str(rec), weights_center_detect=weights["center"],
            weights_hybridnet=weights["hybrid"]), device="cpu")
    return {"port": _latest(root, "Port", "predictions", "predictions3D"),
            "jax": _latest(root, "Jax", "predictions", "predictions3D"), "direct": direct}


def test_predict3d_command_matches_direct_call_and_jax(predicted3d):
    out = predicted3d["port"]
    with open(os.path.join(out, "data3D.csv")) as f, \
            open(os.path.join(predicted3d["direct"], "data3D.csv")) as g:
        assert f.read() == g.read()
    nan_rows = _compare(os.path.join(out, "data3D.csv"),
                        os.path.join(predicted3d["jax"], "data3D.csv"), 4, 2e-2, 1e-4)
    assert 0 < nan_rows < FRAMES
    with open(os.path.join(out, "info.yaml")) as f, \
            open(os.path.join(predicted3d["jax"], "info.yaml")) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)


@pytest.fixture(scope="module")
def predicted2d(parent):
    root, rec, weights = parent
    video = str(rec / "Cam1.avi")
    with pytest.MonkeyPatch.context() as mp:
        args = ["predict", "predict2D", "--weights_center_detect", weights["center"],
                "--weights_keypoint_detect", weights["keypoint"]]
        _port([*args, "Port", video], root, mp)
        _invoke(jax_cli, [*args, "Jax", video], root, mp)
        direct = predict2D(Predict2DParams(
            "Direct", video, weights_center_detect=weights["center"],
            weights_keypoint_detect=weights["keypoint"]), device="cpu")
    return {"port": _latest(root, "Port", "predictions", "predictions2D"),
            "jax": _latest(root, "Jax", "predictions", "predictions2D"), "direct": direct}


def test_predict2d_command_matches_direct_call_and_jax(predicted2d):
    out = predicted2d["port"]
    with open(os.path.join(out, "data2D.csv")) as f, \
            open(os.path.join(predicted2d["direct"], "data2D.csv")) as g:
        assert f.read() == g.read()
    nan_rows = _compare(os.path.join(out, "data2D.csv"),
                        os.path.join(predicted2d["jax"], "data2D.csv"), 3, 0.0, 1e-5)
    assert nan_rows < FRAMES


# ------------------------------------------------------------- visualize ---
def _frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(img)
    cap.release()
    return np.stack(out)


def _videos(run):
    return {f: _frames(os.path.join(run, f)) for f in sorted(os.listdir(run))}


def test_create_videos3d_command_matches_direct_call(parent, predicted3d, monkeypatch):
    root, rec, _ = parent
    _port(["visualize", "create-videos3D", "Port"], root, monkeypatch)
    got = _videos(_latest(root, "Port", "visualization", prefix="Videos_3D_"))
    params = CreateVideos3DParams("Direct", str(rec),
                                  os.path.join(predicted3d["port"], "data3D.csv"))
    params.video_cam_list = [f"Cam{c}" for c in range(CAMS)]
    ref = _videos(create_videos3D(params, device="cpu"))
    assert sorted(got) == [f"Cam{c}.mp4" for c in range(CAMS)]
    for name, frames in got.items():
        assert frames.shape == (FRAMES, H, W, 3)
        np.testing.assert_array_equal(frames, ref[name])


def test_create_videos3d_matches_jax(parent, predicted3d):
    """The port's overlay of the port's data3D.csv against JAX's
    ``create_videos3D`` on the same CSV and recording: the port's
    ``projected_frames`` within 1e-3 px of JAX's ``project_points`` frame
    by frame, the pixels cv2 draws at (the points truncated to integers)
    the same, and the drawn frames identical."""
    from jarvis_hybridnet_tpu.prediction.predict3d import get_camera_rig as jax_get_camera_rig
    from jarvis_hybridnet_tpu.utils.param_classes import (
        CreateVideos3DParams as JaxCreateVideos3DParams,
    )
    from jarvis_hybridnet_tpu.utils.reprojection import project_points as jax_project_points
    from jarvis_hybridnet_tpu.visualization.create_videos3d import (
        create_videos3D as jax_create_videos3D,
    )
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager
    from jarvis_hybridnet_torch.prediction.predict3d import get_camera_rig
    from jarvis_hybridnet_torch.visualization.create_videos3d import projected_frames

    root, rec, _ = parent
    csv_path = os.path.join(predicted3d["port"], "data3D.csv")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JARVIS_PARENT_DIR", str(root))
        project, jax_project = ProjectManager(), JaxProjectManager()
        assert project.load("Direct") and jax_project.load("Jax")
        rig, jax_rig = get_camera_rig(project.cfg), jax_get_camera_rig(jax_project.cfg)
        got_videos = _videos(create_videos3D(CreateVideos3DParams("Direct", str(rec), csv_path),
                                             device="cpu"))
        ref_videos = _videos(jax_create_videos3D(JaxCreateVideos3DParams("Jax", str(rec),
                                                                         csv_path)))

    _, values = _read(csv_path)
    points3D = np.delete(values, list(range(3, values.shape[1], 4)), axis=1)
    valid = ~np.isnan(points3D[:, 0])
    assert 0 < valid.sum() < FRAMES
    got = projected_frames(points3D, rig, "cpu")[valid]
    ref = np.stack([np.asarray(jax_project_points(
        p.reshape(-1, 3).astype(np.float32), jax_rig.camera_matrices, jax_rig.intrinsics,
        jax_rig.distortions)) for p in points3D[valid]])
    assert got.shape == ref.shape == (valid.sum(), JOINTS, CAMS, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.astype(np.int64), ref.astype(np.int64))
    assert sorted(got_videos) == sorted(ref_videos) == [f"Cam{c}.mp4" for c in range(CAMS)]
    for name, frames in ref_videos.items():
        assert frames.shape == (FRAMES, H, W, 3)
        np.testing.assert_array_equal(got_videos[name], frames)


def test_create_videos2d_command_matches_direct_call_and_jax(parent, predicted2d, monkeypatch):
    """The port's overlay of the port's CSV, through the CLI and directly,
    and JAX's overlay of the same CSV: identical frames."""
    from jarvis_hybridnet_tpu.utils.param_classes import (
        CreateVideos2DParams as JaxCreateVideos2DParams,
    )
    from jarvis_hybridnet_tpu.visualization.create_videos2d import (
        create_videos2D as jax_create_videos2D,
    )

    root, rec, _ = parent
    _port(["visualize", "create-videos2D", "Port"], root, monkeypatch)
    got = _videos(_latest(root, "Port", "visualization", prefix="Videos_2D_"))
    csv_path = os.path.join(predicted2d["port"], "data2D.csv")
    direct = _videos(create_videos2D(CreateVideos2DParams("Direct", str(rec / "Cam1.avi"),
                                                          csv_path)))
    ref = _videos(jax_create_videos2D(JaxCreateVideos2DParams("Jax", str(rec / "Cam1.avi"),
                                                              csv_path)))
    assert list(got) == list(direct) == list(ref) == ["Cam1.mp4"]
    assert got["Cam1.mp4"].shape == (FRAMES, H, W, 3)
    np.testing.assert_array_equal(got["Cam1.mp4"], direct["Cam1.mp4"])
    np.testing.assert_array_equal(got["Cam1.mp4"], ref["Cam1.mp4"])


# ------------------------------------------ launch, launch-cli, trt_mode ---
def test_launch_cli_runs_the_interactive_cli(parent, monkeypatch):
    """``launch-cli`` opens the port's interactive menus, whose entry points
    run on the root ``--device``; the menus print as the JAX package's."""
    root, _, _ = parent
    port = _invoke(cli, ["--device", "cpu", "launch-cli"], root, monkeypatch, input="q\n")
    jax = _invoke(jax_cli, ["launch-cli"], root, monkeypatch, input="q\n")
    assert "Welcome to JARVIS (PyTorch / CUDA edition) interactive CLI!" in port.output
    assert port.output.split("\n")[1:] == jax.output.split("\n")[1:]
    from jarvis_hybridnet_torch.ui import interactive_cli

    seen = []
    monkeypatch.setattr(interactive_cli, "launch_interactive_prompt", seen.append)
    _invoke(cli, ["--device", "cpu", "launch-cli"], root, monkeypatch)
    assert seen == ["cpu"]


def test_launch_runs_the_gui_or_reports_streamlit_missing(parent, monkeypatch):
    """``launch`` runs the port's Streamlit GUI on the root ``--device``
    through streamlit's bootstrap (a stand-in here), or, where streamlit is
    not installed, says so and returns, as the JAX package's does."""
    import sys
    import types

    root, _, _ = parent
    monkeypatch.setitem(sys.modules, "streamlit", None)  # not installed
    port = _invoke(cli, ["--device", "cpu", "launch"], root, monkeypatch)
    jax = _invoke(jax_cli, ["launch"], root, monkeypatch)
    assert "streamlit is not installed" in port.output and port.output == jax.output
    runs = []
    web = types.ModuleType("streamlit.web")
    web.bootstrap = types.SimpleNamespace(run=lambda *a: runs.append(a))
    monkeypatch.setitem(sys.modules, "streamlit", types.ModuleType("streamlit"))
    monkeypatch.setitem(sys.modules, "streamlit.web", web)
    monkeypatch.setitem(sys.modules, "streamlit.web.bootstrap", web.bootstrap)
    _invoke(cli, ["--device", "cpu", "launch"], root, monkeypatch)
    (script, hello, args, flags), = runs
    assert script.endswith(os.path.join("jarvis_hybridnet_torch", "ui", "gui", "jarvis_gui.py"))
    assert os.path.isfile(script) and (hello, args, flags) == (False, ["cpu"], {})


@pytest.mark.parametrize("kind, modes", [("predict2D", ("new", "previous")),
                                         ("predict3D", ("previous",))],
                         ids=["predict2D", "predict3D"])
def test_trt_mode_runs_and_matches_the_direct_call(parent, kind, modes, predicted2d,
                                                   predicted3d, monkeypatch):
    """``predict ... --trt_mode``: 'new' exports the predictor into the
    project's compiled-models, 'previous' loads it; 'previous' without an
    artifact builds the predictor. The CSVs equal the direct call's."""
    root, rec, weights = parent
    path = str(rec / "Cam1.avi") if kind == "predict2D" else str(rec)
    args = (["--weights_keypoint_detect", weights["keypoint"]] if kind == "predict2D"
            else ["--weights_hybridnet", weights["hybrid"]])
    direct = (predicted2d if kind == "predict2D" else predicted3d)["direct"]
    name = "data2D.csv" if kind == "predict2D" else "data3D.csv"
    for mode in modes:
        _port(["predict", kind, "--weights_center_detect", weights["center"], *args,
               "--trt_mode", mode, "Trt", path], root, monkeypatch)
        run = _latest(root, "Trt", "predictions", f"predictions{kind[-2:]}")
        with open(os.path.join(run, name)) as f, open(os.path.join(direct, name)) as g:
            assert f.read() == g.read(), mode
        shutil.rmtree(run)  # the next run's directory is stamped to the second
    arts = sorted(os.listdir(root / "projects" / "Trt" / "compiled-models"))
    assert [a for a in arts if a.startswith(kind)] == (
        [f"{kind}_2x256x320x3_quarter_fused-float32.pt2"] if "new" in modes else [])


def test_device_cuda_without_a_card_raises(parent, monkeypatch):
    """Nothing carries on on the CPU when ``--device cuda`` finds no card:
    the entry point's error reaches the caller and no row is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    root, rec, weights = parent
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    runs = root / "projects" / "Port" / "predictions" / "predictions3D"
    before = set(os.listdir(runs)) if runs.is_dir() else set()
    result = CliRunner().invoke(cli, ["predict", "predict3D", "--weights_center_detect",
                                      weights["center"], "--weights_hybridnet",
                                      weights["hybrid"], "Port", str(rec)])
    assert result.exit_code != 0
    assert result.exception is not None and not isinstance(result.exception, SystemExit)
    for run in set(os.listdir(runs)) - before:
        csv_path = runs / run / "data3D.csv"
        assert not csv_path.exists() or len(csv_path.read_text().splitlines()) <= 2
