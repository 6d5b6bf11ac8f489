"""The port's video -> CSV drivers against the JAX package's, end to end.

A synthetic project in a temporary directory: a ``config.yaml`` (the
MonkeyHand networks at CenterDetect 64^2, bbox 128, a 144 mm cube at 4 mm,
``FRAME_BATCH: 2``, ``INFERENCE_DTYPE: float32``, ``MESH_DATA_AXIS: 1``),
OpenCV-YAML calibrations of 4 synthetic cameras written from
``synthetic_rig``, and 4-frame MJPG videos of 320x256 written with cv2.
The weights are the committed checkpoints, with CenterDetect's stride-2
head scaled by 8 so that its maxima straddle both gates (> 50 in 3D, > 40 in
2D) on these frames: the CSVs then hold values and NaN rows both. The JAX
driver and the port's run on the same inputs; their CSVs must have the same
header rows, NaN rows in the same places, and values within the predictors'
float32 bounds (3D: points 2e-2 mm, confidences 1e-4, ROADMAP.md section C;
2D: points identical, confidences 1e-5).
"""

import csv
import os
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from jarvis_hybridnet_torch import native as port_native
from jarvis_hybridnet_torch.prediction.predict2d import predict2D
from jarvis_hybridnet_torch.prediction.predict3d import predict3D
from jarvis_hybridnet_torch.testing import synthetic_rig
from jarvis_hybridnet_torch.testing import write_calibration as _write_calibration
from jarvis_hybridnet_torch.utils.param_classes import Predict2DParams, Predict3DParams
from jarvis_hybridnet_tpu.prediction.predict2d import predict2D as jax_predict2D
from jarvis_hybridnet_tpu.prediction.predict3d import predict3D as jax_predict3D
from jarvis_hybridnet_tpu.training.checkpoints import load_checkpoint, save_checkpoint
from jarvis_hybridnet_tpu.utils import param_classes as jax_params
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

cv2 = pytest.importorskip("cv2")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CAMS, H, W, FRAMES = 4, 256, 320, 4
JOINTS = [f"Joint_{j}" for j in range(23)]


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    rig = synthetic_rig(CAMS, W, H)
    names = [f"Cam{c}" for c in range(CAMS)]
    ds = root / "datasets" / "Synth"
    (ds / "annotations").mkdir(parents=True)
    (ds / "calib_params" / "Session").mkdir(parents=True)
    for c, name in enumerate(names):
        _write_calibration(ds / "calib_params" / "Session" / f"{name}.yaml",
                           rig.camera_matrices[c], rig.intrinsics[c], rig.distortions[c])
    with open(ds / "annotations" / "instances_val.json", "w") as f:
        f.write('{"calibrations": {"Session": {%s}}}' % ", ".join(
            f'"{n}": "calib_params/Session/{n}.yaml"' for n in names))
    cfg = {
        "DATASET": {"DATASET_3D": "Synth"},
        "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": 64},
        "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": 23,
                           "BOUNDING_BOX_SIZE": 128},
        "HYBRIDNET": {"NUM_CAMERAS": CAMS, "ROI_CUBE_SIZE": 144, "GRID_SPACING": 4},
        "KEYPOINT_NAMES": JOINTS,
        "TPU": {"FRAME_BATCH": 2, "INFERENCE_DTYPE": "float32", "MESH_DATA_AXIS": 1},
    }
    for name, extra in (("Proj", {}), ("ProjTwoPhase", {"TWO_PHASE": True,
                                                        "LOWRES_FACTOR": 4}),
                        ("ProjTrt", {}), ("ProjTrace", {"PROFILE_DIR": str(root / "trace")})):
        proj = root / "projects" / name
        proj.mkdir(parents=True)
        c = {**cfg, "TPU": {**cfg["TPU"], **extra}}
        with open(proj / "config.yaml", "w") as f:
            yaml.safe_dump(c, f)

    rng = np.random.default_rng(7)
    low = torch.from_numpy(rng.random((CAMS * FRAMES, 3, 8, 10)).astype(np.float32))
    smooth = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    frames = smooth.permute(0, 2, 3, 1).numpy() * 255 + rng.normal(0, 6, (CAMS * FRAMES, H, W, 3))
    frames = np.clip(frames, 0, 255).astype(np.uint8).reshape(CAMS, FRAMES, H, W, 3)
    rec = root / "recording"
    rec.mkdir()
    for c, name in enumerate(names):
        w = cv2.VideoWriter(str(rec / f"{name}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 30,
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


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[:2], np.array(rows[2:], dtype=np.float64)


def _compare(port_csv, jax_csv, per_joint, point_tol, conf_tol):
    header, got = _read(port_csv)
    ref_header, ref = _read(jax_csv)
    assert header == ref_header
    assert header[1][:len(per_joint)] == list(per_joint)
    assert got.shape == ref.shape == (FRAMES, 23 * len(per_joint))
    nan = np.isnan(got).all(axis=1)
    np.testing.assert_array_equal(nan, np.isnan(ref).all(axis=1))
    assert not np.isnan(got[~nan]).any()
    got = got[~nan].reshape(-1, 23, len(per_joint))
    ref = ref[~nan].reshape(-1, 23, len(per_joint))
    np.testing.assert_allclose(got[..., :-1], ref[..., :-1], rtol=0, atol=point_tol)
    np.testing.assert_allclose(got[..., -1], ref[..., -1], rtol=0, atol=conf_tol)
    return int(nan.sum())


_JAX_RUNS = {}  # (parent, driver, project) -> the JAX driver's output directory


def _jax_run(project, kind, name="Proj"):
    """The JAX driver of ``kind`` on project ``name`` (predict2D: camera 1's
    video), run once a module."""
    root, rec, weights = project
    key = (str(root), kind, name)
    if key not in _JAX_RUNS:
        kw = dict(project_name=name, weights_center_detect=weights["center"])
        # JAX writes to a directory of its own: its default name, stamped to
        # the second, could be the port's and overwrite the port's CSV
        if kind == "predict3D":
            _JAX_RUNS[key] = jax_predict3D(jax_params.Predict3DParams(
                **kw, recording_path=str(rec), weights_hybridnet=weights["hybrid"],
                output_dir=str(root / "out" / f"{name}_jax")))
        else:
            _JAX_RUNS[key] = jax_predict2D(jax_params.Predict2DParams(
                **kw, recording_path=str(rec / "Cam1.avi"),
                weights_keypoint_detect=weights["keypoint"],
                output_dir=str(root / "out" / "2d_jax")))
    return _JAX_RUNS[key]


def _run_3d(project, monkeypatch, name):
    root, rec, weights = project
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    kw = dict(project_name=name, recording_path=str(rec),
              weights_center_detect=weights["center"], weights_hybridnet=weights["hybrid"])
    out = predict3D(Predict3DParams(**kw, output_dir=str(root / "out" / f"{name}_port")),
                    device="cpu")
    ref = _jax_run(project, "predict3D", name)
    with open(os.path.join(out, "info.yaml")) as f, open(os.path.join(ref, "info.yaml")) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    return _compare(os.path.join(out, "data3D.csv"), os.path.join(ref, "data3D.csv"),
                    ("x", "y", "z", "confidence"), 2e-2, 1e-4)


def test_predict3d_driver_matches_jax(project, monkeypatch):
    nan_rows = _run_3d(project, monkeypatch, "Proj")
    assert 0 < nan_rows < FRAMES


def test_predict3d_twophase_driver_matches_jax(project, monkeypatch):
    """``TPU.TWO_PHASE``: the native reader's low-resolution ring, phase A,
    host crops, phase B. Where neither package's native video library
    loads, both drivers take the fused predictor instead, and their CSVs
    must still agree; skipped only where one loads and the other does not
    (the two would take different cascades)."""
    from jarvis_hybridnet_tpu import native as jax_native

    if port_native.video_available() != jax_native.video_available():
        pytest.skip("native video decode available in one package only")
    _run_3d(project, monkeypatch, "ProjTwoPhase")


def test_predict2d_driver_matches_jax(project, monkeypatch):
    root, rec, weights = project
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    kw = dict(project_name="Proj", recording_path=str(rec / "Cam1.avi"),
              weights_center_detect=weights["center"],
              weights_keypoint_detect=weights["keypoint"])
    out = predict2D(Predict2DParams(**kw), device="cpu")
    ref = _jax_run(project, "predict2D")
    assert out != ref
    assert os.path.basename(out).startswith("Predictions_2D_")
    assert os.path.dirname(out) == str(root / "projects" / "Proj" / "predictions" /
                                       "predictions2D")
    nan_rows = _compare(os.path.join(out, "data2D.csv"), os.path.join(ref, "data2D.csv"),
                        ("x", "y", "confidence"), 0.0, 1e-5)
    assert nan_rows < FRAMES


def test_drivers_refuse_what_is_not_ported(project, monkeypatch):
    root, rec, weights = project
    # pod streaming is ported (parallel/): one process as data group 0 of 2
    # writes its shard, and the merge refuses the missing shard 1
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    with pytest.raises(RuntimeError, match="missing"):
        predict2D(Predict2DParams(project_name="Proj", recording_path=str(rec / "Cam0.avi"),
                                  weights_center_detect=weights["center"],
                                  weights_keypoint_detect=weights["keypoint"],
                                  output_dir=str(root / "out" / "pod_shard"),
                                  process_index=0, process_count=2), device="cpu")


# ------------------------------------------- trt_mode and PROFILE_DIR ---

def _port_run(project, monkeypatch, kind, name, out, **kw):
    """The port's driver of ``kind`` on project ``name`` into ``out``: the
    CSV's path."""
    root, rec, weights = project
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    if kind == "predict3D":
        predict3D(Predict3DParams(project_name=name, recording_path=str(rec),
                                  weights_center_detect=weights["center"],
                                  weights_hybridnet=weights["hybrid"],
                                  output_dir=str(root / "out" / out), **kw), device="cpu")
        return root / "out" / out / "data3D.csv"
    predict2D(Predict2DParams(project_name=name, recording_path=str(rec / "Cam1.avi"),
                              weights_center_detect=weights["center"],
                              weights_keypoint_detect=weights["keypoint"],
                              output_dir=str(root / "out" / out), **kw), device="cpu")
    return root / "out" / out / "data2D.csv"


@pytest.mark.parametrize("kind", ["predict3D", "predict2D"])
def test_drivers_trt_modes_match_off_and_jax(project, monkeypatch, kind):
    """``trt_mode`` 'new' exports the predictor into the project's
    compiled-models and predicts with it, 'previous' loads that artifact
    (and nothing else): both CSVs equal 'off''s text, and within the
    drivers' bounds of the JAX driver's on the same inputs."""
    from jarvis_hybridnet_torch.prediction import export

    root = project[0]
    loaded = []
    load = export.load_predictor
    monkeypatch.setattr(export, "load_predictor", lambda p: loaded.append(p) or load(p))
    text = {mode: _port_run(project, monkeypatch, kind, "ProjTrt", f"trt_{kind}_{mode}",
                            trt_mode=mode).read_text()
            for mode in ("off", "new", "previous")}
    from jarvis_hybridnet_torch.config.project_manager import ProjectManager

    pm = ProjectManager()
    assert pm.load("ProjTrt")
    shape = (2, CAMS, H, W, 3) if kind == "predict3D" else (2, H, W, 3)
    artifact = export.artifact_path(pm.get_cfg(), kind, shape)
    assert export.list_artifacts(pm.get_cfg(), kind) == [os.path.basename(artifact)]
    assert loaded == [artifact]
    assert text["new"] == text["off"] and text["previous"] == text["off"]
    ref = _jax_run(project, kind)  # the same config, weights and inputs as ProjTrt's
    if kind == "predict3D":
        _compare(root / "out" / f"trt_{kind}_previous" / "data3D.csv",
                 os.path.join(ref, "data3D.csv"), ("x", "y", "z", "confidence"), 2e-2, 1e-4)
    else:
        _compare(root / "out" / f"trt_{kind}_previous" / "data2D.csv",
                 os.path.join(ref, "data2D.csv"), ("x", "y", "confidence"), 0.0, 1e-5)


@pytest.mark.parametrize("kind", ["predict3D", "predict2D"])
def test_drivers_profile_dir_writes_a_trace(project, monkeypatch, kind):
    """``TPU.PROFILE_DIR``: the driver's loop under ``torch.profiler``
    writes a trace file there, and its rows equal the untraced run's."""
    root = project[0]
    trace = root / "trace"
    before = set(os.listdir(trace)) if trace.is_dir() else set()
    traced = _port_run(project, monkeypatch, kind, "ProjTrace", f"traced_{kind}").read_text()
    plain = _port_run(project, monkeypatch, kind, "Proj", f"untraced_{kind}").read_text()
    new = set(os.listdir(trace)) - before
    assert len(new) == 1 and next(iter(new)).endswith(".pt.trace.json")
    assert traced == plain
