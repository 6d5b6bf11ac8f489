"""Exported predictors, continued from ``test_torch_export.py`` (its setup
and helpers): the half and half_fused predict3D cascades and predict2D,
exported, saved and loaded, give the live predictor's outputs bit for bit
on two seeded batches, each serving kernel one node of the loaded graph."""

import pytest
import torch

from jarvis_hybridnet_torch.prediction.loaders import make_predictor2d
from tests.test_torch_export import (
    CENTER,
    KEYPOINT,
    _cfg,
    _frames,
    _round_trip,
    check_exported_predict3d,
)
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.mark.parametrize("mode", ["half", "half_fused"])
def test_exported_predict3d_equals_live(mode, tmp_path):
    check_exported_predict3d(mode, tmp_path)


def test_exported_predict2d_equals_live(tmp_path):
    live = make_predictor2d(_cfg(), CENTER, KEYPOINT, dtype="float32", device="cpu")
    batches = [_frames(7)[:, 1], _frames(9)[:, 2]]
    loaded, ops = _round_trip(live, torch.zeros_like(batches[0]), tmp_path / "p2.pt2")
    assert ops == {"instance_norm_act", "resize_normalize", "argmax2d"}
    for frames in batches:
        for g, w in zip(loaded(frames), live(frames)):
            assert g.dtype == w.dtype and torch.equal(g, w)
