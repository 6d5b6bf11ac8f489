"""The port's networks against the JAX package, on the committed trained
weights (EfficientTrack, its blocks, V2V's blocks, HybridNetBackbone), on
the reference torch V2V golden, and on a random JAX init (V2V with the
fused up-front conv).

Inputs are seeded smooth images, closer to camera frames than white noise.
float32 tolerances sit above the JAX package's own float32 error on these
nets: its XLA CPU convolutions differ from a float64 run of the same weights
by ~2e-5 of the heatmaps' range, where the port's float32 differs by ~4e-6
(``test_efficienttrack_matches_jax_f32`` asserts both readings).

bfloat16 is held block by block, where the two packages see the same bf16
input and differ only by the bf16 roundings of one block, in bf16 ulps of
the block output's range; then for each whole network, where those
differences compound.
"""

import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jarvis_hybridnet_torch.models import efficientnet
from jarvis_hybridnet_torch.models.efficienttrack import MODEL_SIZES, EfficientTrackBackbone
from jarvis_hybridnet_torch.models.hybridnet import HybridNetBackbone
from jarvis_hybridnet_torch.models.layers import cast_convs
from jarvis_hybridnet_torch.models.v2v import V2VNet
from jarvis_hybridnet_torch.models.weights import params_from_jax, v2v_params_from_jax
from jarvis_hybridnet_torch.testing import synthetic_rig
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.models import bifpn as jax_bifpn
from jarvis_hybridnet_tpu.models import efficientnet as jax_efficientnet
from jarvis_hybridnet_tpu.models import v2v as jax_v2v
from jarvis_hybridnet_tpu.models.efficienttrack import EfficientTrackBackbone as JaxEfficientTrack
from jarvis_hybridnet_tpu.models.hybridnet import HybridNetBackbone as JaxHybridNet
from jarvis_hybridnet_tpu.models.v2v import V2VNet as JaxV2V
from jarvis_hybridnet_tpu.utils.reprojection import project_points
from tests.test_torch_kernels import bf16_ulps

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAINED = REPO / "trained" / "MonkeyHand"
BF16 = jnp.bfloat16


@pytest.fixture(scope="module")
def few_torch_threads():
    """Two PyTorch intra-op threads for a module's tests: the Tier-1 command
    runs six test processes at once, and PyTorch's default of a thread per
    core oversubscribes the CPU (on 8 cores the four end-to-end files of the
    serving entry points took 157 s together with the default and 38 s
    with two threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def range_ulps(got, ref) -> float:
    """Largest |got - ref| in bf16 ulps of max|ref|: the resolution of a
    bf16 output of that range."""
    return float(bf16_ulps(np.asarray(got, np.float32), ref, np.abs(ref).max()).max())


def _bf16_values(a) -> np.ndarray:
    """float32 array holding ``a`` rounded to bf16."""
    return np.asarray(jnp.asarray(a, BF16).astype(jnp.float32))


def _sub(state_dict: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def smooth_images(n, size, seed, low=12):
    """Seeded images: bilinear-upsampled low-res noise plus fine noise."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, 3, low, low)).astype(np.float32))
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)
    return (x.permute(0, 2, 3, 1).numpy()
            + 0.1 * rng.standard_normal((n, size, size, 3))).astype(np.float32)


def _load(module, tree, size="small"):
    module.load_state_dict(params_from_jax(tree, size), strict=True)
    return cast_convs(module.eval(), torch.float32)


@pytest.mark.parametrize("name,joints", [("CenterDetect", 1), ("KeypointDetect", 23)])
def test_efficienttrack_matches_jax_f32(name, joints):
    tree = read_ckpt(str(TRAINED / f"{name}_final.ckpt"))
    x = smooth_images(2, 128, seed=0)
    ref1, ref2 = jax.jit(JaxEfficientTrack(model_size="small", output_channels=joints).apply)(
        {"params": tree}, x)
    model = _load(EfficientTrackBackbone("small", joints), tree)
    with torch.no_grad():
        got1, got2 = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for ref, got in ((ref1, got1), (ref2, got2)):
        ref = np.asarray(ref)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
        flat = lambda a: a.reshape(a.shape[0], -1, a.shape[-1]).argmax(axis=1)
        np.testing.assert_array_equal(flat(got), flat(ref))
    with torch.no_grad():  # the stride-2 head alone, as the predictors run it
        alone = model.heatmap2(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(alone - got2.numpy()).max() <= 1e-4 * np.abs(ref2).max()

    # float64 yardstick: both packages' float32 errors are readings of this
    # test; the port's stays below 1e-5 of the range, the JAX package's below
    # 1e-4 (KeypointDetect: port 4.2e-6, JAX 2.0e-5)
    with torch.no_grad():
        exact = model.double()(torch.from_numpy(x).double().permute(0, 3, 1, 2))[1]
    exact = exact.permute(0, 2, 3, 1).numpy()
    scale = np.abs(exact).max()
    port_err = np.abs(got2.permute(0, 2, 3, 1).numpy() - exact).max() / scale
    jax_err = np.abs(np.asarray(ref2) - exact).max() / scale
    assert port_err <= 1e-5 and jax_err <= 1e-4, (port_err, jax_err)


@pytest.mark.parametrize("name,joints", [("CenterDetect", 1), ("KeypointDetect", 23)])
def test_efficienttrack_bf16_matches_jax(name, joints):
    """The whole network at bf16: both heads within 16 bf16 ulps of their
    range of the JAX bf16 run. The per-block differences of one or two ulps
    compound over the 7 blocks, 3 BiFPN cells and the heads; JAX's own bf16
    run is ~20 ulps of the range from its float32 run here."""
    tree = read_ckpt(str(TRAINED / f"{name}_final.ckpt"))
    x = _bf16_values(smooth_images(2, 128, seed=0))
    ref = jax.jit(JaxEfficientTrack(model_size="small", output_channels=joints,
                                    dtype=BF16).apply)({"params": tree}, x)
    model = cast_convs(_load(EfficientTrackBackbone("small", joints), tree), torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    for r, g in zip(ref, got):
        r = np.asarray(r.astype(jnp.float32))
        ulps = range_ulps(g.float().permute(0, 2, 3, 1).numpy(), r)
        assert ulps <= 16.0, ulps


_CC = MODEL_SIZES["small"].compound_coef


@pytest.mark.parametrize("i", range(7))
def test_mbconv_block_bf16_matches_jax(i):
    """Each MBConv block of the trained KeypointDetect alone at bf16 (stem
    stages' full conv; from stage 4 the expand and depthwise convs; the SE
    gate; K1's SiLU and plain IN), on the same bf16 input: within 2 bf16
    ulps of the output's range."""
    tree = read_ckpt(str(TRAINED / "KeypointDetect_final.ckpt"))
    spec = jax_efficientnet.truncate_and_tap(jax_efficientnet.build_block_plan(_CC)[1])[0][i]
    port_spec = efficientnet.truncate_and_tap(efficientnet.build_block_plan(_CC)[1])[0][i]
    x = _bf16_values(np.random.default_rng(i).standard_normal((2, 16, 16, spec.in_filters)))
    ref = jax.jit(jax_efficientnet.MBConvBlock(spec, dtype=BF16).apply)(
        {"params": tree["backbone_net"][f"_blocks_{i}"]}, jnp.asarray(x, BF16))
    block = efficientnet.MBConvBlock(port_spec)
    block.load_state_dict(_sub(params_from_jax(tree, "small"),
                               f"backbone_net.model._blocks.{i}."), strict=True)
    block = cast_convs(block.eval(), torch.bfloat16)
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    ulps = range_ulps(got.float().permute(0, 2, 3, 1).numpy(),
                      np.asarray(ref.astype(jnp.float32)))
    assert ulps <= 2.0, ulps


@pytest.mark.parametrize("cell", range(3))
def test_bifpn_cell_bf16_matches_jax(cell):
    """Each BiFPN cell of the trained KeypointDetect alone at bf16 (float32
    fusions and SiLU, bf16 separable convs, K1's IN), on the bf16-rounded
    float32 features that reach it from 256^2 images: every level within 8
    bf16 ulps of its range. A cell chains eight separable convs, and the IN
    over P7's 4x4 pixels amplifies roundings: the JAX bf16 cell is itself
    up to 4.7 ulps from its float32 run here, the port 6.1 ulps from JAX."""
    tree = read_ckpt(str(TRAINED / "KeypointDetect_final.ckpt"))
    model = _load(EfficientTrackBackbone("small", 23), tree)
    x = torch.from_numpy(smooth_images(2, 256, seed=4, low=24)).permute(0, 3, 1, 2)
    with torch.no_grad():
        feats = model.backbone_net(x)
        for c in model.bifpn[:cell]:
            feats = c(feats)
    feats = [_bf16_values(f.permute(0, 2, 3, 1).numpy()) for f in feats]
    spec = MODEL_SIZES["small"]
    ref = jax.jit(jax_bifpn.BiFPN(spec.fpn_num_filters, first=cell == 0, dtype=BF16).apply)(
        {"params": tree[f"bifpn_{cell}"]}, [jnp.asarray(f, BF16) for f in feats])
    port_cell = cast_convs(model.bifpn[cell], torch.bfloat16)
    with torch.no_grad():
        got = port_cell([torch.from_numpy(f).to(torch.bfloat16).permute(0, 3, 1, 2)
                         for f in feats])
    for r, g in zip(ref, got):
        ulps = range_ulps(g.float().permute(0, 2, 3, 1).numpy(), np.asarray(r.astype(jnp.float32)))
        assert ulps <= 8.0, ulps


_J = 23
_V2V_BLOCKS = {  # name: (JAX block, port block, input channels, input size)
    "front_basic": (lambda: jax_v2v.Basic3DBlock(2 * _J, 3, 2, dtype=BF16, fused_up=True),
                    lambda v: v.front_layers[0], _J, 8),
    "front_res": (lambda: jax_v2v.Res3DBlock(2 * _J, dtype=BF16),
                  lambda v: v.front_layers[1], 2 * _J, 8),
    "encoder_pool1": (lambda: jax_v2v.Basic3DBlock(4 * _J, 2, 2, dtype=BF16),
                      lambda v: v.encoder_decoder.encoder_pool1, 2 * _J, 8),
    "mid_res": (lambda: jax_v2v.Res3DBlock(4 * _J, dtype=BF16),
                lambda v: v.encoder_decoder.mid_res, 4 * _J, 4),
    "decoder_upsample1": (lambda: jax_v2v.Upsample3DBlock(2 * _J, dtype=BF16),
                          lambda v: v.encoder_decoder.decoder_upsample1, 4 * _J, 4),
}


@pytest.mark.parametrize("name", list(_V2V_BLOCKS))
def test_v2v_block_bf16_matches_jax(name):
    """Each kind of V2V block of the trained HybridNet alone at bf16 (the
    fused up-front conv, the k2 s2 pool conv, the k2 s2 deconv, K1's ReLU
    and residual add + ReLU), on the same bf16 input: within 4 bf16 ulps of
    the output's range."""
    make_jax, pick, cin, size = _V2V_BLOCKS[name]
    tree = read_ckpt(str(TRAINED / "HybridNet_final.ckpt"))
    rng = np.random.default_rng(len(name))
    x = _bf16_values(np.maximum(rng.standard_normal((2, size, size, size, cin)), 0.0))
    ref = jax.jit(make_jax().apply)({"params": tree["v2vNet"][name]}, jnp.asarray(x, BF16))
    v2v = V2VNet(_J, fused_upsample_front=True)
    v2v.load_state_dict(_sub(params_from_jax(tree, "small"), "v2vNet."), strict=True)
    block = pick(cast_convs(v2v.eval(), torch.bfloat16))
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(torch.bfloat16).permute(0, 4, 1, 2, 3))
    ulps = range_ulps(got.float().permute(0, 2, 3, 4, 1).numpy(),
                      np.asarray(ref.astype(jnp.float32)))
    assert ulps <= 4.0, ulps


def test_v2v_matches_reference_torch_golden():
    """The reference torch V2VNet's (state dict, output) pair, fused front off:
    input default_rng(1).random((1, 5, 32, 32, 32)) as in
    tests/test_hybridnet_golden.py."""
    with open(REPO / "tests" / ".golden_cache" / "v2v_seed0_v1.pkl", "rb") as f:
        sd, ref = pickle.load(f)
    model = V2VNet(5)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    cast_convs(model.eval(), torch.float32)
    vol = np.random.default_rng(1).random((1, 5, 32, 32, 32), dtype=np.float32)
    x = torch.from_numpy(vol).contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        got = model(x).numpy()
    assert got.shape == ref.shape == (1, 5, 16, 16, 16)
    assert np.abs(got - ref).max() < 5e-5


def test_v2v_fused_front_matches_jax():
    """fused_upsample_front: the (G/2)^3 input and the exact fused
    up2 + stride-2 conv (J = 5, 16^3), on a random JAX init."""
    J, L = 5, 16
    rng = np.random.default_rng(2)
    x = rng.random((2, L, L, L, J), dtype=np.float32)
    jm = JaxV2V(J, fused_upsample_front=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]
    params = jax.tree.map(lambda a: np.asarray(a) * 300.0, params)  # N(0, .3) weights
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    model = V2VNet(J, fused_upsample_front=True)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in v2v_params_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    model.load_state_dict(sd, strict=True)
    cast_convs(model.eval(), torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == ref.shape == (2, L, L, L, J)  # up2 then stride 2
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["exact", "half", "half_fused", "quarter_fused"])
def test_hybridnet_backbone_matches_jax_f32(mode):
    """All four outputs on the trained HybridNet: double-softplus volume,
    padded heatmaps, points3D and confidences, on a fixed cube center, in
    every repro mode. exact and half run V2V's unfused front (a stride-2
    conv on the G^3 volume) with the checkpoint's conv weights, so the same
    weight bridge loads every mode.

    In every mode the port's float32 run is held to its float64 run at the
    bounds it is held to JAX's (measured: 1.0e-5 of the volume's range,
    0.0006 mm). In exact mode the JAX package's own float32 run is 7.8e-4 of
    the volume's range and 0.0173 mm from that float64 run (half 5.0e-5 and
    0.0076 mm), so there the port is held to JAX within 1e-3 of the range and
    2e-2 mm (ROADMAP.md section C)."""
    tree = read_ckpt(str(TRAINED / "HybridNet_final.ckpt"))
    B, C, S, cube, spacing = 1, 4, 128, 144, 4
    rig = synthetic_rig(C, 320, 256)
    imgs = smooth_images(B * C, S, seed=3).reshape(B, C, S, S, 3)
    center3d = np.array([[6, -9, 14]], np.int32)
    center_hm = np.asarray(project_points(center3d[0].astype(np.float32), rig.camera_matrices,
                                          rig.intrinsics, rig.distortions))
    center_hm = (center_hm.astype(np.int32) + np.array([[7, -5]], np.int32))[None]
    cams = [np.broadcast_to(a, (B,) + a.shape).copy()
            for a in (rig.camera_matrices, rig.intrinsics, rig.distortions)]
    jm = JaxHybridNet(num_joints=23, model_size="small", roi_cube_size=cube,
                      grid_spacing=spacing, repro_mode=mode)
    ref = [np.asarray(a) for a in jax.jit(jm.apply)({"params": tree}, imgs, center_hm,
                                                     center3d, *cams)]
    model = _load(HybridNetBackbone(23, "small", cube, spacing, repro_mode=mode), tree)
    assert model.v2vNet.front_layers[0].fused_up == (mode in ("half_fused", "quarter_fused"))
    args = [torch.from_numpy(a) for a in (imgs, center_hm, center3d, *cams)]
    with torch.no_grad():
        got = [a.numpy() for a in model(*args)]
        exact = [a.numpy() for a in model.double()(*(
            a.double() if a.is_floating_point() else a for a in args))]
        model.float()
    volume, heatmaps, points, conf = got
    assert volume.shape == ref[0].shape == (B, 18, 18, 18, 23)
    assert heatmaps.shape == ref[1].shape == (B, C, 23, 66, 66)
    vol_tol, pts_tol = (1e-3, 2e-2) if mode == "exact" else (1e-4, 1e-2)
    for other, vt, pt in ((ref, vol_tol, pts_tol), (exact, 1e-4, 1e-2)):
        assert np.abs(heatmaps - other[1]).max() <= 1e-4 * np.abs(other[1]).max()
        assert np.abs(volume - other[0]).max() <= vt * np.abs(other[0]).max()
        np.testing.assert_allclose(points, other[2], rtol=0, atol=pt)
        np.testing.assert_allclose(conf, other[3], rtol=0, atol=1e-4)
    with torch.no_grad():  # the predictor's path gives the same points
        p2, c2 = model.points(torch.from_numpy(imgs), torch.from_numpy(center_hm),
                              torch.from_numpy(center3d), *(torch.from_numpy(a) for a in cams))
    np.testing.assert_allclose(p2.numpy(), points, rtol=0, atol=1e-3)
    np.testing.assert_allclose(c2.numpy(), conf, rtol=0, atol=1e-5)
