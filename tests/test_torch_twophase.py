"""The port's two-phase predict3D cascade against the JAX package's
``build_predict3d_twophase``.

Full-resolution frames of 256x320 (4 synthetic cameras, T = 2, the
production ratios of the 1280x1024 rig at CenterDetect 64^2, bbox 128, a
144 mm cube at 4 mm) and their 4x area-reduced 64x80 frames, so phase A's
resize runs at ratio 1 on H and 1.25 on W, as 256x320 -> 256^2 does at the
production size. The committed MonkeyHand checkpoints.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jarvis_hybridnet_torch.kernels.resize_normalize import linear_tables
from jarvis_hybridnet_torch.prediction.loaders import (
    make_predictor3d,
    make_predictor3d_twophase,
)
from jarvis_hybridnet_torch.testing import monkeyhand_cfg, synthetic_rig
from jarvis_hybridnet_tpu.config import get_default_cfg
from jarvis_hybridnet_tpu.ops.image import _linear_tables
from jarvis_hybridnet_tpu.prediction.loaders import (
    make_predictor3d_twophase as jax_make_twophase,
)
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CENTER = str(TRAINED / "CenterDetect_final.ckpt")
HYBRID = str(TRAINED / "HybridNet_final.ckpt")
T, C, H, W, F_LOW = 2, 4, 256, 320, 4


def area_reduce(frames: np.ndarray, f: int) -> np.ndarray:
    """Mean of f x f pixel blocks, rounded: the reader's area downscale."""
    t, c, h, w, _ = frames.shape
    blocks = frames.reshape(t, c, h // f, f, w // f, f, 3).astype(np.float64)
    return np.rint(blocks.mean(axis=(3, 5))).astype(np.uint8)


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
    jax_phases = jax_make_twophase(jcfg, rig, (W, H), CENTER, HYBRID, lowres_factor=F_LOW,
                                   dtype=jnp.float32)
    port_phases = make_predictor3d_twophase(cfg, rig, (W, H), CENTER, HYBRID,
                                            lowres_factor=F_LOW, dtype="float32",
                                            device="cpu")
    return cfg, rig, frames, area_reduce(frames, F_LOW), jax_phases, port_phases


@pytest.mark.parametrize("frame_type", ["uint8", "float32"])
def test_phase_a_matches_jax(setup, frame_type):
    """Crop centers in full-resolution pixels, the int32 center3d and the
    gate, from the low-resolution frames: identical at float32."""
    _, _, _, lowres, jax_phases, port_phases = setup
    if frame_type == "float32":
        lowres = lowres.astype(np.float32) / 255.0
    ref = [np.asarray(a) for a in jax_phases[0](lowres)]
    got = [a.numpy() for a in port_phases[0](lowres)]
    for name, g, r in zip(("cx", "cy", "center3d", "valid"), got, ref):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_crop_fn_matches_jax(setup):
    _, _, frames, lowres, jax_phases, port_phases = setup
    cx, cy, _, _ = (np.asarray(a) for a in jax_phases[0](lowres))
    np.testing.assert_array_equal(port_phases[2](frames, cx, cy),
                                  jax_phases[2](frames, cx, cy))


@pytest.mark.parametrize("frame_type", ["uint8", "float32"])
def test_phase_b_matches_jax(setup, frame_type):
    """Points within 2e-2 mm of JAX's phase B on the same crops and centers,
    the fused predictor's float32 bound (ROADMAP.md section C)."""
    _, _, frames, lowres, jax_phases, port_phases = setup
    cx, cy, c3d, _ = (np.asarray(a) for a in jax_phases[0](lowres))
    crops = jax_phases[2](frames, cx, cy)
    if frame_type == "float32":
        crops = crops.astype(np.float32) / 255.0
    ref_p, ref_c = (np.asarray(a) for a in jax_phases[1](crops, cx, cy, c3d))
    got_p, got_c = port_phases[1](crops, cx, cy, c3d)
    assert got_p.shape == (T, 23, 3) and got_c.shape == (T, 23)
    np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got_c.numpy(), ref_c, rtol=0, atol=1e-4)


def test_twophase_on_full_frames_equals_fused(setup):
    """Phase A on the full-resolution frames, the host crops and phase B
    are the fused cascade's steps: the same points as ``make_predictor3d``
    on the same frames, bit for bit."""
    cfg, rig, frames, _, _, port_phases = setup
    phase_a, phase_b, crop_fn = port_phases
    cx, cy, c3d, valid = phase_a(frames)
    points, conf = phase_b(crop_fn(frames, cx.numpy(), cy.numpy()), cx, cy, c3d)
    fused = make_predictor3d(cfg, rig, CENTER, HYBRID, dtype="float32", device="cpu")
    ref_p, ref_c, ref_v = fused(frames)
    assert torch.equal(valid, ref_v)
    assert torch.equal(points, ref_p) and torch.equal(conf, ref_c)


def test_k4_taps_match_jax_at_the_lowres_ratio():
    """Phase A resizes 256x320 to 256^2 at f = 4 (ratio 1 on H, 1.25 on
    W); K4's tap tables are JAX's ``_linear_tables`` there and at the test
    size (64x80 -> 64^2). K4's values at that ratio:
    ``test_torch_kernels.py::test_k4_production_ratios_match_jax``."""
    for out_size, in_size in ((256, 320), (256, 256), (64, 80), (64, 64)):
        for got, ref in zip(linear_tables(out_size, in_size), _linear_tables(out_size, in_size)):
            np.testing.assert_array_equal(got, ref)
