"""Sharded inference (``parallel/predict_step.py``) and the drivers' pod
streaming on real gloo ranks, against one process and the JAX package, on
the CPU.

- predict3D at float32 on the 4-camera synthetic rig of
  ``test_torch_predictor3d.py`` (T = 2 seeded frames of 256x320, the
  committed MonkeyHand checkpoints): on a 2 x 1 mesh (a frameset a rank)
  and a 1 x 2 mesh (two cameras a rank: CenterDetect on its own cameras,
  the centers gathered over the camera group, KeypointDetect on its own
  crops, the camera sum of the partial volumes). The crop centers, the
  gate and the valid flags identical to one process's, the DLT centers
  within 1e-4 mm, the points within 1e-3 mm and the confidences within
  1e-6 (only the order of the camera sum differs), and the points within
  2e-2 mm / confidences 1e-4 of JAX's ``make_predictor3d`` (the bound of
  ``test_predictor3d_f32_matches_jax``).
- predict2D data-parallel on 2 ranks: points, confidences and gate
  identical to one process's.
- The drivers on 2 ranks (the project and recording of
  ``test_torch_drivers.py``): predict3D data-sharded (2 x 1) and
  camera-sharded (1 x 2, ``TPU.SHARD_CAMERAS: 2``) and predict2D write
  merged CSVs equal to one process's row for row (points 2e-2 mm and
  confidences 1e-4 in 3D, identical in 2D); a missing shard and an unknown
  frame count raise.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from jarvis_hybridnet_torch.prediction import video_io
from jarvis_hybridnet_torch.prediction.loaders import make_predictor2d, make_predictor3d
from jarvis_hybridnet_torch.prediction.predict2d import predict2D
from jarvis_hybridnet_torch.prediction.predict3d import predict3D
from jarvis_hybridnet_torch.utils.param_classes import Predict2DParams, Predict3DParams
from jarvis_hybridnet_tpu.prediction.loaders import make_predictor3d as jax_make_predictor3d
from tests import torch_parallel_ranks as ranks
from tests.test_torch_drivers import _read, project  # noqa: F401
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_predictor2d import KEYPOINT
from tests.test_torch_predictor2d import setup as setup2d  # noqa: F401
from tests.test_torch_predictor3d import CENTER, HYBRID, setup  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.mark.parametrize("n_data,n_cam", [(2, 1), (1, 2)])
def test_sharded_predict3d_matches_one_process_and_jax(setup, tmp_path,  # noqa: F811
                                                       n_data, n_cam):
    cfg, jcfg, rig, frames = setup
    one = make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32", device="cpu")
    points, conf, valid = one(frames)
    center_hm, center3d, gate = one.centers(torch.from_numpy(frames))
    got = ranks.run_ranks(ranks.predict3d, n_data * n_cam, tmp_path, cfg, rig, frames,
                          n_data, n_cam)
    rows = [g for g in got if g["mesh"][1] == 0]  # camera rank 0 of each data group
    for g in got:  # every camera rank of a group holds its group's rows
        same = rows[g["mesh"][0]]
        assert torch.equal(g["points"], same["points"]) and torch.equal(g["conf"], same["conf"])

    def cat(key):
        return torch.cat([g[key] for g in rows])

    assert torch.equal(cat("center_hm"), center_hm)
    assert torch.equal(cat("valid"), gate) and torch.equal(cat("valid2"), valid)
    assert float((cat("center3d") - center3d).abs().max()) <= 1e-4
    assert float((cat("points") - points).abs().max()) <= 1e-3
    assert float((cat("conf") - conf).abs().max()) <= 1e-6
    ref_p, ref_c, ref_v = (np.asarray(a) for a in jax_make_predictor3d(
        jcfg, rig, CENTER, HYBRID, dtype=jnp.float32)(frames))
    np.testing.assert_array_equal(cat("valid2").numpy(), ref_v)
    np.testing.assert_allclose(cat("points").numpy(), ref_p, rtol=0, atol=2e-2)
    np.testing.assert_allclose(cat("conf").numpy(), ref_c, rtol=0, atol=1e-4)


def test_sharded_predict2d_matches_one_process(setup2d, tmp_path):  # noqa: F811
    cfg, _, frames = setup2d
    points, conf, valid = make_predictor2d(cfg, ranks.CENTER, KEYPOINT, dtype="float32",
                                           device="cpu")(frames["uint8"])
    got = ranks.run_ranks(ranks.predict2d, 2, tmp_path, cfg, frames["uint8"])
    assert torch.equal(torch.cat([g["points"] for g in got]), points)
    assert torch.equal(torch.cat([g["conf"] for g in got]), conf)
    assert torch.equal(torch.cat([g["valid"] for g in got]), valid)


def _pod_projects(root):
    """Projects beside ``Proj`` whose config meshes every rank on the data
    axis (``PodData``) or shards the cameras over two (``PodCams``)."""
    with open(os.path.join(root, "projects", "Proj", "config.yaml")) as f:
        base = yaml.safe_load(f)
    for name, tpu in (("PodData", {"MESH_DATA_AXIS": -1}),
                      ("PodCams", {"MESH_DATA_AXIS": 1, "SHARD_CAMERAS": 2})):
        path = os.path.join(root, "projects", name)
        if not os.path.isdir(path):
            os.makedirs(path)
            with open(os.path.join(path, "config.yaml"), "w") as f:
                yaml.safe_dump({**base, "TPU": {**base["TPU"], **tpu}}, f)


def _rows_close(got_csv, want_csv, point_tol, conf_tol, per):
    header, got = _read(got_csv)
    ref_header, ref = _read(want_csv)
    assert header == ref_header and got.shape == ref.shape
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    got, ref = np.nan_to_num(got).reshape(len(got), -1, per), np.nan_to_num(ref).reshape(
        len(ref), -1, per)
    np.testing.assert_allclose(got[..., :-1], ref[..., :-1], rtol=0, atol=point_tol)
    np.testing.assert_allclose(got[..., -1], ref[..., -1], rtol=0, atol=conf_tol)


def test_pod_drivers_merge_what_one_process_writes(project, tmp_path, monkeypatch):  # noqa: F811
    root, rec, weights = project
    _pod_projects(str(root))
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    kw3 = dict(recording_path=str(rec), weights_center_detect=weights["center"],
               weights_hybridnet=weights["hybrid"])
    kw2 = dict(project_name="PodData", recording_path=str(rec / "Cam0.avi"),
               weights_center_detect=weights["center"],
               weights_keypoint_detect=weights["keypoint"])
    out = tmp_path / "out"
    one3 = predict3D(Predict3DParams(project_name="PodData", **kw3,
                                     output_dir=str(out / "one3")), device="cpu")
    one2 = predict2D(Predict2DParams(**kw2, output_dir=str(out / "one2")), device="cpu")
    for name in ("PodData", "PodCams"):
        got = ranks.run_ranks(ranks.drivers, 2, tmp_path, str(root),
                              dict(project_name=name, **kw3, output_dir=str(out / f"{name}3")),
                              dict(kw2, output_dir=str(out / f"{name}2")))
        assert got[0] == got[1]
        assert sorted(os.listdir(got[0]["3d"])) == ["data3D.csv", "info.yaml"]
        _rows_close(os.path.join(got[0]["3d"], "data3D.csv"), os.path.join(one3, "data3D.csv"),
                    2e-2, 1e-4, 4)
        assert sorted(os.listdir(got[0]["2d"])) == ["data2D.csv", "info.yaml"]
        _rows_close(os.path.join(got[0]["2d"], "data2D.csv"), os.path.join(one2, "data2D.csv"),
                    0.0, 0.0, 3)


def test_pod_shards_refuse_a_missing_shard_and_an_unknown_length(project, tmp_path,  # noqa: F811
                                                                 monkeypatch):
    """One process as data group 0 of 2 (``process_index`` /
    ``process_count``, as the JAX drivers take them) writes its shard and
    its merge raises for the missing shard 1, leaving the shard in place; a
    recording whose frame count is unknown cannot be split and raises."""
    root, rec, weights = project
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(root))
    kw = dict(project_name="Proj", recording_path=str(rec),
              weights_center_detect=weights["center"], weights_hybridnet=weights["hybrid"],
              process_index=0, process_count=2)
    with pytest.raises(RuntimeError, match="missing"):
        predict3D(Predict3DParams(**kw, output_dir=str(tmp_path / "a")), device="cpu")
    assert os.path.isfile(tmp_path / "a" / "data3D.csv.part00000")
    with open(tmp_path / "a" / "data3D.csv.part00000") as f:
        assert len(f.read().splitlines()) == 2  # no header in a shard: a row a frame
    monkeypatch.setattr(video_io, "probe_frame_count", lambda path: 0)
    with pytest.raises(ValueError, match="frame count"):
        predict3D(Predict3DParams(**kw, output_dir=str(tmp_path / "b")), device="cpu")
    shutil.rmtree(tmp_path / "a")
