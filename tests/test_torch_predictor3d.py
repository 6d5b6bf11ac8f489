"""The port's predict3D cascade against the JAX package's, end to end.

``make_predictor3d(device="cpu")`` of the port against the JAX
``make_predictor3d`` on the committed MonkeyHand checkpoints, 4 synthetic
cameras and T=2 seeded uint8 frames of 256x320: the production ratios of
the 1280x1024 rig at CenterDetect 64^2, with bbox 128 and a 144 mm cube at
4 mm (G = 36).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jarvis_hybridnet_torch.prediction.loaders import make_predictor3d
from jarvis_hybridnet_torch.testing import monkeyhand_cfg, synthetic_rig
from jarvis_hybridnet_torch.utils.reprojection import project_points as port_project
from jarvis_hybridnet_torch.utils.reprojection import triangulate as port_triangulate
from jarvis_hybridnet_tpu.config import get_default_cfg
from jarvis_hybridnet_tpu.models.efficienttrack import EfficientTrackBackbone
from jarvis_hybridnet_tpu.models.hybridnet import HybridNetBackbone
from jarvis_hybridnet_tpu.ops.heatmap import argmax_2d
from jarvis_hybridnet_tpu.ops.image import normalize_imagenet, resize_bilinear
from jarvis_hybridnet_tpu.prediction.loaders import make_predictor3d as jax_make_predictor3d
from jarvis_hybridnet_tpu.training.checkpoints import load_checkpoint
from jarvis_hybridnet_tpu.utils.reprojection import project_points, triangulate
from tests.test_torch_models import few_torch_threads, range_ulps  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CENTER = str(TRAINED / "CenterDetect_final.ckpt")
HYBRID = str(TRAINED / "HybridNet_final.ckpt")
T, C, H, W = 2, 4, 256, 320


@pytest.fixture(scope="module")
def setup():
    cfg = monkeyhand_cfg(center_size=64, bbox=128, cube=144, spacing=4, num_cameras=C)
    jcfg = get_default_cfg()
    jcfg.merge_from_other_cfg(cfg)
    rig = synthetic_rig(C, W, H)
    rng = np.random.default_rng(7)
    low = torch.from_numpy(rng.random((T * C, 3, 16, 20)).astype(np.float32))
    smooth = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    frames = smooth.permute(0, 2, 3, 1).numpy() * 255 + rng.normal(0, 6, (T * C, H, W, 3))
    frames = np.clip(frames, 0, 255).astype(np.uint8).reshape(T, C, H, W, 3)
    return cfg, jcfg, rig, frames


def _jax_centers(jcfg, rig, frames):
    """predictor3d.py:90-134 at float32 with the JAX package's functions:
    (crop centers (T, C, 2), center3d (T, 3), valid (T,))."""
    cs, hw = int(jcfg.CENTERDETECT.IMAGE_SIZE), int(jcfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE) // 2
    params = load_checkpoint(CENTER)
    P, K, D = rig.camera_matrices, rig.intrinsics, rig.distortions

    @jax.jit
    def centers(imgs):
        flat = imgs.reshape(T * C, H, W, 3)
        value_scale = 255.0 if imgs.dtype == jnp.uint8 else 1.0
        inp = normalize_imagenet(resize_bilinear(flat, cs, cs) / value_scale,
                                 np.asarray(jcfg.DATASET.MEAN, np.float32),
                                 np.asarray(jcfg.DATASET.STD, np.float32))
        _, hm = EfficientTrackBackbone(model_size="small", output_channels=1).apply(
            {"params": params}, inp)
        xy, maxval = argmax_2d(hm)
        preds = xy[:, 0].reshape(T, C, 2).astype(jnp.float32)
        maxvals = maxval[:, 0].reshape(T, C)
        valid = jnp.sum(maxvals > 50.0, axis=1) >= 2
        scale = jnp.asarray([W / float(cs), H / float(cs)], jnp.float32)
        c3d = jax.vmap(lambda p, w: triangulate(p, w, P, K, D))(preds * (scale * 2.0),
                                                               maxvals / 255.0)
        c3d = jnp.where(valid[:, None], c3d, 0.0)
        cen = jax.vmap(lambda c: project_points(c, P, K, D))(c3d).astype(jnp.int32)
        cx = jnp.clip(cen[..., 0], hw, W - hw)
        cy = jnp.clip(cen[..., 1], hw, H - hw)
        return jnp.stack([cx, cy], axis=-1), c3d, valid

    return [np.asarray(a) for a in centers(frames)]


def test_predictor3d_f32_matches_jax(setup):
    """Points agree to 2e-2 mm, not the 1e-2 mm first aimed at: the JAX
    package's own float32 error here is of that size (its XLA CPU convs
    differ from float64 by ~2e-5 of the heatmaps' range, the port's by
    ~4e-6), and one point of 138 differs by 0.012 mm (ROADMAP.md
    section C)."""
    cfg, jcfg, rig, frames = setup
    ref_p, ref_c, ref_v = (np.asarray(a) for a in jax_make_predictor3d(
        jcfg, rig, CENTER, HYBRID, dtype=jnp.float32)(frames))
    predictor = make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32", device="cpu")
    points, conf, valid = predictor(frames)
    assert points.shape == (T, 23, 3) and conf.shape == (T, 23) and valid.shape == (T,)
    np.testing.assert_array_equal(valid.numpy(), ref_v)
    np.testing.assert_allclose(points.numpy(), ref_p, rtol=0, atol=2e-2)
    np.testing.assert_allclose(conf.numpy(), ref_c, rtol=0, atol=1e-4)


def test_predictor3d_exact_f32_matches_jax(setup):
    """The reference-faithful repro mode end to end (K5's exact gather, V2V's
    unfused front), at the bound of test_predictor3d_f32_matches_jax."""
    cfg, jcfg, rig, frames = (setup[0].clone(), setup[1].clone(), *setup[2:])
    cfg.TPU.REPRO_MODE = jcfg.TPU.REPRO_MODE = "exact"
    ref_p, ref_c, ref_v = (np.asarray(a) for a in jax_make_predictor3d(
        jcfg, rig, CENTER, HYBRID, dtype=jnp.float32)(frames))
    predictor = make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32", device="cpu")
    assert predictor.hybrid_model.repro_mode == "exact"
    points, conf, valid = predictor(frames)
    np.testing.assert_array_equal(valid.numpy(), ref_v)
    np.testing.assert_allclose(points.numpy(), ref_p, rtol=0, atol=2e-2)
    np.testing.assert_allclose(conf.numpy(), ref_c, rtol=0, atol=1e-4)


def test_repro_mode_falls_back_to_exact(setup):
    """A configuration without TPU.REPRO_MODE gets exact, as the JAX
    predictor's (predictor3d.py:80); one that names a mode gets it."""
    cfg, _, rig, _ = setup
    bare = cfg.clone()
    del bare.TPU["REPRO_MODE"]
    modes = {}
    for name, c in (("bare", bare), ("named", cfg)):
        predictor = make_predictor3d(c, rig, CENTER, HYBRID, dtype="float32", device="cpu")
        modes[name] = predictor.hybrid_model.repro_mode
    assert modes == {"bare": "exact", "named": "quarter_fused"}


def test_center_stage_f32_matches_jax(setup):
    """Resize + CenterDetect + argmax + gate + DLT + crop placement."""
    cfg, jcfg, rig, frames = setup
    ref_hm, ref_c3d, ref_v = _jax_centers(jcfg, rig, frames)
    predictor = make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32", device="cpu")
    center_hm, center3d, valid = predictor.centers(torch.from_numpy(frames))
    np.testing.assert_array_equal(valid.numpy(), ref_v)
    np.testing.assert_array_equal(center_hm.numpy(), ref_hm)
    np.testing.assert_allclose(center3d.numpy(), ref_c3d, rtol=0, atol=1e-3)


def test_dlt_and_crop_centers_match_jax():
    """The gate-passing branch: weighted DLT of noisy detections, then the
    truncated, clamped crop centers, on the 12-camera 1280x1024 rig; and a
    degenerate system (all weights 0) that yields non-finite values
    instead of raising, as the gate then masks them."""
    rig = synthetic_rig(12, 1280, 1024)
    rng = np.random.default_rng(11)
    pts3d = rng.uniform(-60, 60, (6, 3)).astype(np.float32)
    P, K, D = (torch.from_numpy(a) for a in (rig.camera_matrices, rig.intrinsics,
                                              rig.distortions))
    p2d = port_project(torch.from_numpy(pts3d), P, K, D).numpy()
    p2d = (p2d + rng.normal(0, 2.0, p2d.shape)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (6, 12)).astype(np.float32)
    w[0, :10] = 0.0  # two cameras left
    ref = np.asarray(jax.vmap(lambda p, wt: triangulate(
        p, wt, rig.camera_matrices, rig.intrinsics, rig.distortions))(p2d, w))
    got = port_triangulate(torch.from_numpy(p2d), torch.from_numpy(w), P, K, D).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert np.abs(got - pts3d).max() < 5.0

    ref_cen = np.asarray(jax.vmap(lambda c: project_points(
        c, rig.camera_matrices, rig.intrinsics, rig.distortions))(ref)).astype(np.int32)
    got_cen = port_project(torch.from_numpy(np.array(ref)), P, K, D).to(torch.int32).numpy()
    np.testing.assert_array_equal(got_cen, ref_cen)

    zero = port_triangulate(torch.from_numpy(p2d[:1]), torch.zeros(1, 12), P, K, D)
    assert not torch.isfinite(zero).all()


def _bf16_fixed_crops(setup, frames):
    """bf16 HybridNet of both packages on the crops of ``frames`` at JAX's
    float32 crop centers: (padded heatmaps and volume in bf16 ulps of their
    range against JAX's bf16 run, RMS point error against the port's float32
    points of the port's bf16 run and of JAX's)."""
    cfg, jcfg, rig, _ = setup
    center_hm, center3d, _ = _jax_centers(jcfg, rig, frames)
    center3d = center3d.astype(np.int32)
    cams = [np.broadcast_to(a, (T,) + a.shape).copy()
            for a in (rig.camera_matrices, rig.intrinsics, rig.distortions)]
    port = {dt: make_predictor3d(cfg, rig, CENTER, HYBRID, dtype=dt, device="cpu")
            for dt in ("float32", "bfloat16")}
    crops = port["float32"].crops(torch.from_numpy(frames), torch.from_numpy(center_hm))
    args = [torch.from_numpy(a) for a in (center_hm, center3d, *cams)]
    with torch.no_grad():
        p32 = port["float32"].hybrid_model.points(crops, *args)[0].numpy()
        vol16, hm16, p16, _ = (a.float().numpy() for a in port["bfloat16"].hybrid_model(
            crops, *args))
    params = load_checkpoint(HYBRID)
    model = HybridNetBackbone(num_joints=23, model_size="small", roi_cube_size=144,
                              grid_spacing=4, dtype=jnp.bfloat16, repro_mode="quarter_fused")
    jvol16, jhm16, j16, _ = (np.asarray(a, np.float32) for a in jax.jit(model.apply)(
        {"params": params}, crops.numpy(), center_hm, center3d, *cams))
    assert np.isfinite(p16).all()

    def rms(a):
        return float(np.sqrt((np.linalg.norm(a - p32, axis=-1) ** 2).mean()))

    return range_ulps(hm16, jhm16), range_ulps(vol16, jvol16), rms(p16), rms(j16)


def test_predictor3d_bf16_fixed_crops(setup):
    """bf16 with the crop centers fixed (JAX's float32 ones), so no argmax
    flip can move a crop. The padded KeypointDetect heatmaps are held
    within 32 bf16 ulps of their range of JAX's bf16 ones (23.5 measured;
    JAX's bf16 run is 19.4 from its float32 one) and the double-softplus
    volume within 48 (32.2 measured; JAX's own 31.1): on these crops the
    two packages differ by about JAX's own bf16 error, which the per-block
    bf16 tests of test_torch_models.py bound tightly.

    The JAX package's own budget for its bf16 fast mode is 0.65 mm per
    point, measured on real frames; on these synthetic frames the networks
    are far less confident, and bf16 rounding moves points by millimetres
    in both packages (ROADMAP.md section C). So the points are held to the
    size of JAX's bf16 error instead: against the float32 result, the
    port's RMS point error stays within 1.5x that of JAX's bf16 run (13.8
    against 10.4 mm measured)."""
    hm_ulps, vol_ulps, rms16, jrms16 = _bf16_fixed_crops(setup, setup[3])
    assert hm_ulps <= 32.0 and vol_ulps <= 48.0, (hm_ulps, vol_ulps)
    assert rms16 <= 1.5 * jrms16, (rms16, jrms16)


def test_predictor3d_float_frames_match_jax(setup):
    """float32 RGB frames in [0, 1] (the JAX predictor's documented input,
    ``value_scale`` 1): at float32 the points hold JAX's within 2e-2 mm and
    the gate is identical, as for uint8 frames; at bf16, with the crop
    centers fixed, the bounds of test_predictor3d_bf16_fixed_crops
    (ROADMAP.md section C; 23.5 and 32.2 ulps, RMS 13.8 against JAX's
    10.4 mm measured, as for uint8 frames). Any other dtype is still
    refused."""
    cfg, jcfg, rig, frames = setup
    frames = frames.astype(np.float32) / 255.0
    ref_p, ref_c, ref_v = (np.asarray(a) for a in jax_make_predictor3d(
        jcfg, rig, CENTER, HYBRID, dtype=jnp.float32)(frames))
    predictor = make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32", device="cpu")
    points, conf, valid = predictor(frames)
    np.testing.assert_array_equal(valid.numpy(), ref_v)
    np.testing.assert_allclose(points.numpy(), ref_p, rtol=0, atol=2e-2)
    np.testing.assert_allclose(conf.numpy(), ref_c, rtol=0, atol=1e-4)
    hm_ulps, vol_ulps, rms16, jrms16 = _bf16_fixed_crops(setup, frames)
    assert hm_ulps <= 32.0 and vol_ulps <= 48.0, (hm_ulps, vol_ulps)
    assert rms16 <= 1.5 * jrms16, (rms16, jrms16)
    with pytest.raises(ValueError):
        predictor(frames.astype(np.float64))
