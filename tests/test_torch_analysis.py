"""The port's validation analysis, error plots, skeleton colors and
time-slice plot (``jarvis_hybridnet_torch/analysis``, ``utils/skeleton.py``,
``visualization/``) against the JAX package's, on the same inputs.

``analyze_validation_data`` runs on a synthetic project
(``testing.write_dataset3d``: 4 cameras of 320x256 JPEG frames, 6 val
framesets, the MonkeyHand networks at CenterDetect 64^2, bbox 128, a 144 mm
cube at 4 mm, float32, CenterDetect's head scaled by 8 so that its maxima
straddle the gate, ``frame_batch`` 4 so that the tail batch is padded): with
the real predictors ``frame_names.csv``, the ground truth and the gate are
identical and the points within 2e-2 mm of JAX's (the float32 bound of the
predictor tests, ROADMAP.md section C); with one stand-in predictor in both
packages, through the native frameset pipeline and through cv2, all three
CSVs are byte-identical and every predictor call takes ``frame_batch``
framesets. The plots' error arrays (masked distances, per-joint means)
equal JAX's, and the headless PNGs are written under JAX's names, directly
and through ``jarvis-torch analyze``. ``get_skeleton`` equals JAX's, with
and without a skeleton (the port computes matplotlib's jet colormap
without matplotlib).
"""

import os
import pathlib
import shutil

import matplotlib
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from jarvis_hybridnet_torch import native as port_native
from jarvis_hybridnet_torch.analysis import analyze as port_analyze
from jarvis_hybridnet_torch.analysis import plotting as port_plotting
from jarvis_hybridnet_torch.config.cfg_node import CfgNode
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.ui.cli import cli
from jarvis_hybridnet_torch.utils.skeleton import get_skeleton, jet
from jarvis_hybridnet_tpu import native as jax_native
from jarvis_hybridnet_tpu.analysis import analyze as jax_analyze
from jarvis_hybridnet_tpu.analysis import plotting as jax_plotting
from jarvis_hybridnet_tpu.training.checkpoints import load_checkpoint, save_checkpoint
from jarvis_hybridnet_tpu.utils.skeleton import get_skeleton as jax_get_skeleton
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

cv2 = pytest.importorskip("cv2")
matplotlib.use("Agg")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CAMS, H, W, JOINTS, VAL, BATCH = 4, 256, 320, 23, 6, 4
CONFIG = {
    "DATASET": {"DATASET_2D": "Synth", "DATASET_3D": "Synth"},
    "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": 64},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": JOINTS, "BOUNDING_BOX_SIZE": 128},
    "HYBRIDNET": {"NUM_CAMERAS": CAMS, "ROI_CUBE_SIZE": 144, "GRID_SPACING": 4},
    "KEYPOINT_NAMES": [f"Joint_{j}" for j in range(JOINTS)],
    "TPU": {"INFERENCE_DTYPE": "float32"},
}
CSVS = ("frame_names.csv", "points_HybridNet.csv", "points_GroundTruth.csv")


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(CAMS, W, H), W, H, JOINTS,
                    splits=(("train", 2), ("val", VAL)), extent_mm=40.0)
    # each run directory is stamped to the second: one project a run
    for name in ("Port", "Jax", "Port_native", "Jax_native", "Port_cv2", "Jax_cv2"):
        write_project(str(root), name, CONFIG)
    tree = load_checkpoint(str(TRAINED / "CenterDetect_final.ckpt"))
    tree["deconv1"]["kernel"] = np.asarray(tree["deconv1"]["kernel"]) * 8.0
    center = str(root / "weights" / "CenterDetect_x8.ckpt")
    save_checkpoint(tree, center)
    return root, center


def _read(run, name):
    with open(os.path.join(run, name)) as f:
        return f.read()


# -------------------------------------------------------------- analysis ---
def test_analyze_validation_data_matches_jax(project, monkeypatch):
    root, center = project
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    hybrid = str(TRAINED / "HybridNet_final.ckpt")
    out = port_analyze.analyze_validation_data("Port", center, hybrid, frame_batch=BATCH,
                                               device="cpu")
    ref = jax_analyze.analyze_validation_data("Jax", center, hybrid, frame_batch=BATCH)
    assert _read(out, "frame_names.csv") == _read(ref, "frame_names.csv")
    assert _read(out, "points_GroundTruth.csv") == _read(ref, "points_GroundTruth.csv")
    names = _read(out, "frame_names.csv").split()
    assert 0 < len(names) < VAL  # the gate passes some framesets and not others
    got = np.loadtxt(os.path.join(out, "points_HybridNet.csv"), delimiter=",")
    want = np.loadtxt(os.path.join(ref, "points_HybridNet.csv"), delimiter=",")
    assert got.shape == want.shape == (len(names), JOINTS * 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def _stand_in(calls):
    """A predictor factory for both packages: points, confidences and gate
    computed in numpy from the frames (uint8 or float32 in [0, 1]), so that
    identical frames give identical rows; each call's leading size is
    recorded."""
    def factory(cfg, rig, weights_center, weights_hybridnet, *a, as_torch=False, **kw):
        def predictor(imgs):
            imgs = np.asarray(imgs)
            calls.append(imgs.shape[0])
            u8 = np.rint(imgs * 255.0) if imgs.dtype != np.uint8 else imgs.astype(np.float64)
            mean = u8.mean(axis=(1, 2, 3, 4))
            pts = (mean[:, None, None] + np.arange(JOINTS * 3).reshape(1, JOINTS, 3)
                   ).astype(np.float32)
            conf = np.full((len(imgs), JOINTS), 0.5, np.float32)
            valid = (u8[:, 0, 0, 0, 0] % 3) != 0
            out = pts, conf, valid
            return tuple(torch.from_numpy(np.asarray(a)) for a in out) if as_torch else out
        return predictor
    return factory


@pytest.mark.parametrize("reader", ["native", "cv2"])
def test_analysis_driver_is_jax_with_one_predictor(project, reader, monkeypatch):
    """The driver's own work (the reader, batching, the padded tail, the
    gate, the CSVs) with one stand-in predictor in both packages: identical
    files, and every call of ``frame_batch`` framesets."""
    root, center = project
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    if reader == "native":
        if not (port_native.available() and jax_native.available()):
            pytest.skip("the native JPEG library does not build here")
    else:
        monkeypatch.setattr(port_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    port_calls, jax_calls = [], []
    port_factory, jax_factory = _stand_in(port_calls), _stand_in(jax_calls)
    monkeypatch.setattr(port_analyze, "make_predictor3d",
                        lambda *a, **kw: port_factory(*a, as_torch=True, **kw))
    monkeypatch.setattr(jax_analyze, "make_predictor3d", jax_factory)
    out = port_analyze.analyze_validation_data(f"Port_{reader}", frame_batch=BATCH,
                                               device="cpu")
    ref = jax_analyze.analyze_validation_data(f"Jax_{reader}", frame_batch=BATCH)
    for name in CSVS:
        assert _read(out, name) == _read(ref, name), name
    assert port_calls == jax_calls == [BATCH] * -(-VAL // BATCH)
    assert 0 < len(_read(out, "frame_names.csv").split()) < VAL


def test_analyze_command_matches_direct_call(project, monkeypatch):
    """``jarvis-torch --device cpu analyze analyze-validation-data`` calls
    the analysis with the CLI's weights, no camera subset and the device."""
    root, _ = project
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    seen = []
    monkeypatch.setattr(port_analyze, "analyze_validation_data",
                        lambda *a, **kw: seen.append((a, kw)))
    result = CliRunner().invoke(cli, ["--device", "cpu", "analyze", "analyze-validation-data",
                                      "--weights_center_detect", "c.ckpt", "Port"],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    assert seen == [(("Port", "c.ckpt", "latest", None), {"device": "cpu"})]


# ----------------------------------------------------------------- plots ---
def _analysis_run(root, project_name, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-50, 50, (12, JOINTS, 3))
    gt[3, 5] = 0.0  # unlabeled joints: all-zero ground-truth triplets
    gt[:, 9] = 0.0  # a joint never labeled
    net = gt + rng.normal(0, 3, gt.shape)
    run = root / "projects" / project_name / "analysis" / f"Validation_Predictions_{seed}"
    run.mkdir(parents=True)
    np.savetxt(run / "points_GroundTruth.csv", gt.reshape(12, -1), delimiter=",")
    np.savetxt(run / "points_HybridNet.csv", net.reshape(12, -1), delimiter=",")
    return run


def _written(run):
    return sorted(str(p.relative_to(run)) for p in run.rglob("*.png"))


@pytest.mark.parametrize("cutoff", [-1, 5])
def test_error_arrays_match_jax(project, cutoff):
    root, _ = project
    run = _analysis_run(root, "Port", seed=1 + cutoff)
    gt, net = port_plotting._load_points(str(run))
    ref_gt, ref_net = jax_plotting._load_points(str(run))
    np.testing.assert_array_equal(gt, ref_gt)
    np.testing.assert_array_equal(net, ref_net)
    got = port_plotting._masked_distances_mm(net, gt, cutoff)
    want = jax_plotting._masked_distances_mm(ref_net, ref_gt, cutoff)
    np.testing.assert_array_equal(got, want)
    assert got.size == 12 * JOINTS - 12 - 1


def test_plots_match_jax(project, monkeypatch):
    """Each plot, headless, on copies of one analysis run: the same PNG
    names, the per-joint bars of the same heights, the per-keypoint
    histograms of every joint."""
    root, _ = project
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    run = _analysis_run(root, "Port", seed=7)
    ref_run = root / "projects" / "Jax" / "analysis" / run.name
    shutil.copytree(run, ref_run)
    import matplotlib.pyplot as plt

    for mod, path, name in ((port_plotting, run, "Port"), (jax_plotting, ref_run, "Jax")):
        mod.plot_error_histogram(str(path), cutoff=10, interactive=False)
        mod.plot_error_histogram_per_keypoint(str(path), name, cutoff=10, interactive=False)
    bars = [[p.get_height() for p in mod.plot_error_per_keypoint(
        str(path), name, interactive=False).axes[0].patches]
        for mod, path, name in ((port_plotting, run, "Port"), (jax_plotting, ref_run, "Jax"))]
    plt.close("all")
    assert _written(run) == _written(ref_run)
    assert "error_histogram.png" in _written(run)
    assert "error_per_joint.png" in _written(run)
    assert len([p for p in _written(run) if p.startswith("keypoint_histograms")]) == JOINTS
    assert len(bars[0]) == JOINTS
    np.testing.assert_array_equal(np.ma.filled(np.array(bars[0], dtype=float), -1.0),
                                  np.ma.filled(np.array(bars[1], dtype=float), -1.0))


@pytest.mark.parametrize("command,png", [("plot-error-histogram", "error_histogram.png"),
                                         ("plot-error-per-keypoint", "error_per_joint.png"),
                                         ("plot-error-histogram-per-keypoint",
                                          "keypoint_histograms/Joint_0.png")])
def test_plot_commands_write_the_pngs(project, command, png, monkeypatch, tmp_path):
    """``jarvis-torch analyze <plot> --mode headless`` on the newest run."""
    root, _ = project
    parent = tmp_path / "parent"
    shutil.copytree(root / "projects" / "Port", parent / "projects" / "Port",
                    ignore=shutil.ignore_patterns("analysis"))
    run = _analysis_run(parent, "Port", seed=11)
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(parent))
    result = CliRunner().invoke(cli, ["analyze", command, "--mode", "headless", "Port"],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    assert (run / png).is_file()
    import matplotlib.pyplot as plt

    plt.close("all")


# ------------------------------------------------------ skeleton, slices ---
SKELETONS = {
    "none": [],
    "chains and a cycle": [["J0", "J1"], ["J1", "J2"], ["J2", "J3"], ["J3", "J1"],
                           ["J3", "J4"], ["J5", "J6"], ["J6", "J7"], ["J2", "J8"]],
    "hand": [["J0", "J1"], ["J1", "J2"], ["J3", "J4"], ["J4", "J2"], ["J5", "J6"],
             ["J6", "J2"], ["J2", "J7"], ["J7", "J8"], ["J8", "J9"], ["J9", "J7"]],
}


@pytest.mark.parametrize("name", list(SKELETONS))
@pytest.mark.parametrize("joints", [10, 23])
def test_get_skeleton_matches_jax(name, joints):
    cfg = CfgNode()
    cfg.KEYPOINT_NAMES = [f"J{j}" for j in range(joints)]
    cfg.SKELETON = SKELETONS[name]
    cfg.KEYPOINTDETECT = CfgNode()
    cfg.KEYPOINTDETECT.NUM_JOINTS = joints
    assert get_skeleton(cfg) == jax_get_skeleton(cfg)


def test_get_skeleton_reads_a_null_skeleton_as_none():
    """A project created from a dataset without a skeleton reads SKELETON
    back as None: the port colors its joints as with no skeleton, where the
    JAX package's get_skeleton raises."""
    cfg = CfgNode()
    cfg.KEYPOINT_NAMES = [f"J{j}" for j in range(5)]
    cfg.SKELETON = []
    cfg.KEYPOINTDETECT = CfgNode()
    cfg.KEYPOINTDETECT.NUM_JOINTS = 5
    want = jax_get_skeleton(cfg)
    cfg.SKELETON = None
    assert get_skeleton(cfg) == want
    with pytest.raises(TypeError):
        jax_get_skeleton(cfg)


def test_jet_equals_matplotlib():
    cmap = matplotlib.colormaps.get_cmap("jet")
    xs = np.concatenate([np.linspace(0, 1, 1001), [i / j for j in range(1, 40) for i in range(j)]])
    assert all(jet(float(x)) == tuple(cmap(float(x))) for x in xs)


def test_time_slices_match_jax(project, tmp_path):
    """``plot_slices`` on one data3D.csv (header rows, x,y,z,confidence):
    the same figure, pixel for pixel."""
    from matplotlib import pyplot as plt

    from jarvis_hybridnet_torch.visualization.time_slices import plot_slices
    from jarvis_hybridnet_tpu.visualization.time_slices import plot_slices as jax_plot_slices

    rng = np.random.default_rng(3)
    rows = rng.uniform(-40, 40, (6, JOINTS, 4))
    rows[..., 3] = rng.uniform(0, 1, (6, JOINTS))
    path = tmp_path / "data3D.csv"
    with open(path, "w") as f:
        f.write(",".join(f"J{j}" for j in range(JOINTS) for _ in range(4)) + "\n")
        f.write(",".join(["x", "y", "z", "confidence"] * JOINTS) + "\n")
        np.savetxt(f, rows.reshape(6, -1), delimiter=",")
    figs = [fn(str(path), str(tmp_path / f"{tag}.png"), 1, 2, 2, plot_azim=30.0, plot_elev=10.0)
            for fn, tag in ((plot_slices, "port"), (jax_plot_slices, "jax"))]
    images = []
    for fig in figs:
        fig.set_dpi(50)
        fig.canvas.draw()
        images.append(np.asarray(fig.canvas.buffer_rgba()).copy())
    plt.close("all")
    assert (tmp_path / "port.png").is_file() and (tmp_path / "jax.png").is_file()
    np.testing.assert_array_equal(images[0], images[1])
