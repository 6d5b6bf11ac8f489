"""The port's 2D predictor against the JAX package's ``make_predictor2d``.

T = 4 seeded frames of 256x320 (the production ratios of 1280x1024 at
CenterDetect 64^2), bbox 128, the committed MonkeyHand CenterDetect and
KeypointDetect checkpoints, uint8 frames and the same frames as float32 in
[0, 1].
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jarvis_hybridnet_torch.prediction.loaders import make_predictor2d
from jarvis_hybridnet_torch.testing import monkeyhand_cfg
from jarvis_hybridnet_tpu.config import get_default_cfg
from jarvis_hybridnet_tpu.models.efficienttrack import EfficientTrackBackbone
from jarvis_hybridnet_tpu.ops.image import normalize_imagenet, resize_bilinear_mxu
from jarvis_hybridnet_tpu.prediction.loaders import make_predictor2d as jax_make_predictor2d
from jarvis_hybridnet_tpu.training.checkpoints import load_checkpoint
from tests.test_torch_models import few_torch_threads, range_ulps  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CENTER = str(TRAINED / "CenterDetect_final.ckpt")
KEYPOINT = str(TRAINED / "KeypointDetect_final.ckpt")
N, H, W = 4, 256, 320


@pytest.fixture(scope="module")
def setup():
    cfg = monkeyhand_cfg(center_size=64, bbox=128, cube=144, spacing=4, num_cameras=4)
    jcfg = get_default_cfg()
    jcfg.merge_from_other_cfg(cfg)
    rng = np.random.default_rng(7)
    low = torch.from_numpy(rng.random((N, 3, 16, 20)).astype(np.float32))
    smooth = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    frames = smooth.permute(0, 2, 3, 1).numpy() * 255 + rng.normal(0, 6, (N, H, W, 3))
    frames = np.clip(frames, 0, 255).astype(np.uint8)
    return cfg, jcfg, {"uint8": frames, "float32": frames.astype(np.float32) / 255.0}


@pytest.mark.parametrize("frame_type", ["uint8", "float32"])
def test_predictor2d_f32_matches_jax(setup, frame_type):
    """float32: the argmax-derived points (crop corner + 2 x argmax) and the
    gate identical, confidences within 1e-5 (3.7e-6 measured)."""
    cfg, jcfg, frames = setup
    frames = frames[frame_type]
    ref_p, ref_c, ref_v = (np.asarray(a) for a in jax_make_predictor2d(
        jcfg, CENTER, KEYPOINT, dtype=jnp.float32)(frames))
    predictor = make_predictor2d(cfg, CENTER, KEYPOINT, dtype="float32", device="cpu")
    points, conf, valid = predictor(frames)
    assert points.shape == (N, 23, 2) and conf.shape == (N, 23) and valid.shape == (N,)
    np.testing.assert_array_equal(points.numpy(), ref_p)
    np.testing.assert_array_equal(valid.numpy(), ref_v)
    np.testing.assert_allclose(conf.numpy(), ref_c, rtol=0, atol=1e-5)
    # the gate is maxval > 40 on the CenterDetect heatmap
    _, _, gate, hm = predictor.detect(torch.from_numpy(frames))
    assert torch.equal(gate, hm.amax(dim=(1, 2, 3)) > 40.0)


@pytest.mark.parametrize("frame_type", ["uint8", "float32"])
def test_predictor2d_bf16_heatmaps_match_jax(setup, frame_type):
    """bf16, in bf16 ulps of each heatmap's range against JAX's bf16 run:
    the CenterDetect heatmap (each package on its own resize: K4 rounds
    once, JAX's bf16 path after every op) within 16 (7.5 measured on uint8
    frames, 11.5 on float; JAX's own bf16 run is 5.6-9.1 from its float32
    one), and the KeypointDetect heatmaps on the crops at the float32 crop
    centers within 32 (19.3 measured; JAX's own 14.0), the fixed-crop bound
    of the 3D cascade (ROADMAP.md section C). Crop centers come from an
    argmax, which bf16 rounding can flip, so the points are not compared."""
    cfg, _, frames = setup
    frames = frames[frame_type]
    scale = 255.0 if frame_type == "uint8" else 1.0
    mean = np.asarray(cfg.DATASET.MEAN, np.float32)
    std = np.asarray(cfg.DATASET.STD, np.float32)
    p16 = make_predictor2d(cfg, CENTER, KEYPOINT, dtype="bfloat16", device="cpu")
    p32 = make_predictor2d(cfg, CENTER, KEYPOINT, dtype="float32", device="cpu")
    x = torch.from_numpy(frames)
    cx, cy, _, _ = p32.detect(x)
    _, _, _, hm16 = p16.detect(x)
    _, _, khm16 = p16.keypoints(x, cx, cy)

    inp = normalize_imagenet(resize_bilinear_mxu(jnp.asarray(frames), 64, 64, jnp.bfloat16)
                             / scale, mean.astype(jnp.bfloat16), std.astype(jnp.bfloat16))
    center = EfficientTrackBackbone(model_size="small", output_channels=1, dtype=jnp.bfloat16)
    jhm16 = np.asarray(jax.jit(center.apply)({"params": load_checkpoint(CENTER)}, inp)[1],
                       np.float32)
    crops = np.stack([frames[t, int(cy[t]) - 64:int(cy[t]) + 64, int(cx[t]) - 64:int(cx[t]) + 64]
                      for t in range(N)])
    crops = normalize_imagenet(jnp.asarray(crops, jnp.float32) / scale, mean, std)
    keypoint = EfficientTrackBackbone(model_size="small", output_channels=23,
                                      dtype=jnp.bfloat16)
    jkhm16 = np.asarray(jax.jit(keypoint.apply)({"params": load_checkpoint(KEYPOINT)},
                                                crops.astype(jnp.bfloat16))[1], np.float32)
    center_ulps = range_ulps(hm16.permute(0, 2, 3, 1).numpy(), jhm16)
    keypoint_ulps = range_ulps(khm16.permute(0, 2, 3, 1).numpy(), jkhm16)
    assert center_ulps <= 16.0 and keypoint_ulps <= 32.0, (center_ulps, keypoint_ulps)
    points, conf, valid = p16(frames)
    assert torch.isfinite(points).all() and torch.isfinite(conf).all()


def test_predictor2d_clamps_crops_inside_the_frame(setup):
    """The 2D clamp is [bbox/2, W - bbox/2 - 1], one less than the 3D
    cascade's: a detection at the far corner puts the crop's last column at
    W - 2 (``predictor2d.py:103-104``)."""
    cfg, _, _ = setup
    predictor = make_predictor2d(cfg, CENTER, KEYPOINT, dtype="float32", device="cpu")
    frames = torch.zeros((1, H, W, 3), dtype=torch.uint8)
    points, _, _ = predictor.keypoints(frames, torch.tensor([W - 64 - 1], dtype=torch.int32),
                                       torch.tensor([H - 64 - 1], dtype=torch.int32))
    assert float(points[..., 0].max()) <= W - 2 and float(points[..., 1].max()) <= H - 2
    hm = torch.zeros((1, 1, 32, 32))
    hm[0, 0, 31, 31] = 100.0
    predictor.center_model.heatmap2 = lambda x: hm
    cx, cy, valid, _ = predictor.detect(frames)
    assert (int(cx), int(cy), bool(valid)) == (W - 64 - 1, H - 64 - 1, True)
