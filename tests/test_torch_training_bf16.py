"""bf16 mixed-precision training (``TPU.TRAIN_DTYPE: bfloat16``) against the
JAX package's, on the CPU.

JAX trains at bf16 with float32 parameters and bf16 compute (flax's
``dtype=bf16, param_dtype=float32``); the port keeps float32 masters and
casts at every convolution (``layers.set_compute_dtype``). On the small rig
of ``test_torch_training.py`` (4 cameras, 128^2 crops, a 48 mm cube at 4 mm,
G = 12, 23 joints, quarter_fused; 64^2 inputs and batch 2 for the 2D nets),
the committed MonkeyHand checkpoints, inputs from numpy seeds:

- V2V's fused front kernels (ROADMAP.md C.7): the interior kernel and all
  26 corrections bit-equal to JAX's ``_transform_interior`` /
  ``_contract_delta`` of the float32 weight followed by ``.astype(bf16)``,
  in serving (``cast_convs``) and in training (float32 master);
- dropout and drop-connect at bf16 (and float32) bit-equal to flax's on the
  same masks;
- the gathers' VJP at bf16 rows (the plain K11 / K12) against ``jax.vjp``
  of ``reprojection_layer(..., gather_dtype=bf16)``, both held to a float64
  VJP: the port sums in float32 and rounds once, JAX adds rounded
  cotangents into a bf16 table, so the port's error is at most JAX's;
- K8's plain version at bf16 heads against ``jax.value_and_grad`` of
  ``heatmap_loss``;
- one bf16 step in each freeze mode and of each 2D net against the JAX
  package's bf16 step (``deterministic=True``, as the float32 step tests),
  both held to JAX's float64 run (the model modules' float32 casts widened,
  as ``test_torch_training_modes.py`` builds it);
- the trained parameters, AdamW's state and the written ``.ckpt`` and train
  state stay float32, and the JAX package's ``load_checkpoint`` reads them;
- the graphed bf16 steps against the eager ones on the stand-in of
  ``test_torch_train_graphs.py``, and ``chip_smoke.py``'s rule for the
  card's bf16 replays where K11 / K12 add with atomics.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
from jarvis_hybridnet_torch.kernels.heatmap2d_loss import (heatmap2d_loss_bwd_plain,
                                                           heatmap2d_loss_fwd_plain)
from jarvis_hybridnet_torch.models.layers import cast_convs, dropout, drop_connect
from jarvis_hybridnet_torch.models.repro import reprojection_layer as port_repro
from jarvis_hybridnet_torch.models.v2v import V2VNet
from jarvis_hybridnet_torch.models.weights import (efficienttrack_params_to_jax, params_from_jax,
                                                   params_to_jax)
from jarvis_hybridnet_torch.training import checkpoints, graphed, optim
from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer, host_batch
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.training.trainer3d import BATCH_KEYS, HybridNetTrainer
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.models import repro as jax_repro
from jarvis_hybridnet_tpu.models.efficienttrack import EfficientTrackBackbone as JaxEfficientTrack
from jarvis_hybridnet_tpu.models.hybridnet import HybridNetBackbone as JaxHybridNet
from jarvis_hybridnet_tpu.models.hybridnet import hybridnet_mse_loss
from jarvis_hybridnet_tpu.models.layers import drop_connect as jax_drop_connect
from jarvis_hybridnet_tpu.ops import fused_upfront as jax_fused
from jarvis_hybridnet_tpu.ops.heatmap import (gaussian_heatmaps_3d_on_device,
                                              gaussian_heatmaps_on_device)
from jarvis_hybridnet_tpu.training import checkpoints as jax_checkpoints
from jarvis_hybridnet_tpu.training import optim as jax_optim
from jarvis_hybridnet_tpu.training.trainer2d import heatmap_loss
from tests.test_torch_graphs import fake_cuda  # noqa: F401
from tests.test_torch_kernels import bf16_ulps
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_train_graphs import seeded, stand_in  # noqa: F401
from tests.test_torch_train_graphs import _batches2d, _equal_states, _moments
from tests.test_torch_training import CONFIG, CUBE, HYBRID, SPACING, TRAINED, _cfg
from tests.test_torch_training2d import _step_batch
from tests.test_torch_training_modes import _Float64Names, _jax_loss_and_grads, _repro_inputs

pytestmark = pytest.mark.usefixtures("few_torch_threads")
pytest.importorskip("cv2")

BF16 = jnp.bfloat16
LR = 1e-3
KEYPOINT = str(TRAINED / "KeypointDetect_final.ckpt")
CENTER = str(TRAINED / "CenterDetect_final.ckpt")
S2D = 64


FRAMESETS = 6  # the steps' batch: one frameset's bf16 error is one draw of a large noise


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    """``test_torch_training.py``'s project and rig, with FRAMESETS val
    framesets (no host augmentation on the val split)."""
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, 23,
                    splits=(("train", 2), ("val", FRAMESETS)), extent_mm=40.0, seed=4,
                    unlabeled=(7,))
    write_project(str(root), "P", CONFIG)
    return str(root)


def _val_batch(cfg, n: int = FRAMESETS) -> dict:
    ds = Dataset3D(cfg, set="val", device_targets=True)
    samples = [ds[i] for i in range(n)]
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in BATCH_KEYS}


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_values(a) -> np.ndarray:
    """float32 array holding ``a`` rounded to bf16."""
    return _f32(jnp.asarray(a, BF16))


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


# ------------------------------------------------- C.7: fused front ---

def _jax_fused_kernels(kernel: np.ndarray):
    """JAX's fused front kernels of a (3, 3, 3, Cin, Cout) float32 kernel, as
    ``fused_up_conv3d`` computes them at bf16: transformed in float32, then
    ``.astype(bf16)`` (the interior, then the 26 corrections in order)."""
    k = jnp.asarray(kernel)
    interior = _f32(jax_fused._transform_interior(k).astype(BF16))
    corr = []
    for size in (1, 2, 3):
        for axes in itertools.combinations((0, 1, 2), size):
            for faces in itertools.product((True, False), repeat=size):
                w = jax_fused._transform_interior(k, [a for a in (0, 1, 2) if a not in axes])
                consumed = 0
                for a, lo in sorted(zip(axes, faces)):
                    w = jax_fused._contract_delta(w, a - consumed, lo)
                    consumed += 1
                corr.append(_f32(w.astype(BF16)))
    return interior, corr


def _v2v(tree) -> V2VNet:
    v2v = V2VNet(23, fused_upsample_front=True)
    state = params_from_jax(tree, "small")
    v2v.load_state_dict({k[len("v2vNet."):]: v for k, v in state.items()
                         if k.startswith("v2vNet.")}, strict=True)
    return v2v


def _as_jax_layout(w: torch.Tensor) -> np.ndarray:
    """A port kernel (Cout, Cin, *spatial), or a corner's (Cin, Cout), in
    JAX's (*spatial, Cin, Cout)."""
    w = w.detach().float()
    if w.dim() > 2:
        w = w.permute(*range(2, w.dim()), 1, 0)
    return w.numpy()


@pytest.mark.parametrize("path", ["serving", "training"])
def test_fused_front_kernels_bf16_bit_equal_to_jax(path):
    """ROADMAP.md C.7, on the committed HybridNet's front conv weight: the
    port's interior kernel and its 26 corrections at bf16 bit-equal to JAX's
    (transform the float32 weight, round once). 3f1331b rounded the weight
    to bf16 in ``cast_convs`` and transformed the rounded weight: 16.5% of
    the interior's entries and 57.9% of the corrections' differed, and this
    test failed."""
    tree = read_ckpt(HYBRID)
    kernel = np.asarray(tree["v2vNet"]["front_basic"]["conv"]["kernel"], np.float32)
    want_interior, want_corr = _jax_fused_kernels(kernel)
    v2v = _v2v(tree)
    block = v2v.front_layers[0]
    if path == "serving":
        cast_convs(v2v.eval(), torch.bfloat16)
        assert block.block[0].weight.dtype == torch.float32  # the master is kept
        with torch.no_grad():
            interior, corr = block._fused_weights()
    else:
        from jarvis_hybridnet_torch.models.layers import set_compute_dtype

        set_compute_dtype(cast_convs(v2v, torch.float32), torch.bfloat16)
        interior, corr = block._fused_weights()  # with grad, from the live master
        assert interior.requires_grad
    assert interior.dtype == torch.bfloat16 and len(corr) == len(want_corr) == 26
    np.testing.assert_array_equal(_as_jax_layout(interior), want_interior)
    for got, want in zip(corr, want_corr):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_as_jax_layout(got), want)


# --------------------------------------------- dropout, drop-connect ---

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dropout_and_drop_connect_match_flax(dtype):
    """flax's ``nn.Dropout(0.2)`` (V2V) and the JAX package's
    ``drop_connect`` (EfficientNet) against the port's on the same masks:
    bit-equal. JAX rounds the weak-typed 0.8 to the input's dtype before
    ``x / keep``; PyTorch would divide a bf16 tensor by float32's 0.8, which
    differs on 13.6% of 1e5 seeded bf16 values (``layers.weak``)."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 6, 6, 6, 46)) * 3).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    drop = flax_nn.Dropout(0.2, deterministic=False)
    key = jax.random.PRNGKey(5)
    want = drop.apply({}, xj, rngs={"dropout": key})
    mask = _f32(drop.apply({}, jnp.ones_like(xj), rngs={"dropout": key})) != 0
    assert 0.7 < mask.mean() < 0.9
    got = dropout(torch.from_numpy(x).to(tdt), 0.2, None, mask=torch.from_numpy(mask))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))

    x2 = (rng.standard_normal((256, 5, 5, 8)) * 3).astype(np.float32)
    key2 = jax.random.PRNGKey(7)
    want2 = jax_drop_connect(jnp.asarray(x2, jdt), 0.2, False, key2)
    u = _f32(jax.random.uniform(key2, (256, 1, 1, 1), dtype=jdt)).reshape(-1)
    got2 = drop_connect(torch.from_numpy(x2).to(tdt), 0.2, None,
                        uniform=torch.from_numpy(u).to(tdt))
    kept = (_f32(want2) != 0).any(axis=(1, 2, 3))
    assert 0.6 < kept.mean() < 0.95
    np.testing.assert_array_equal(got2.float().numpy(), _f32(want2))


# -------------------------------------------------- the gathers' VJP ---

@pytest.mark.parametrize("mode", ["exact", "half", "half_fused", "quarter_fused"])
def test_gather_vjp_at_bf16_rows(mode):
    """The heatmaps' gradient at bf16 rows (B = 2, 4 cameras, hs = 66,
    J = 23, G = 12): the port's plain K11 / K12 (float32 sums, one rounding,
    ``repro_gather.round_rows``) and ``jax.vjp`` of JAX's
    ``reprojection_layer`` at ``gather_dtype=bf16`` (exact: the float32
    gather of the bf16 heatmaps, as JAX's HybridNet gathers exact), both
    against a float64 VJP (JAX's, with the camera sum in float64).
    Elementwise the port's error is at most JAX's plus one bf16 ulp of the
    element, and at most one ulp (measured 0.502 ulps at exact, half and
    half_fused, 0.656 at quarter_fused, where a float32 sum cancels); JAX's
    reaches 1224 ulps (half), 1848 (half_fused) and 118 (quarter_fused) on
    elements whose sum cancels, and 0.502 at exact, where both round one
    float32 sum once and no element differs (0.39%, 0.40% and 0.047% of
    the elements differ in the half modes)."""
    heatmaps, center3d, center_hm, cams = _repro_inputs()
    hm16 = _bf16_values(heatmaps)
    G = CUBE // SPACING
    args = (center3d, center_hm, *cams)
    gather_dtype = None if mode == "exact" else BF16

    def jax_layer(hm):
        return jax_repro.reprojection_layer(hm.astype(jnp.float32), *args, G, float(SPACING),
                                            mode=mode, gather_dtype=gather_dtype)

    def vjp_of(layer, hm, up):
        return jax.jit(lambda h, u: jax.vjp(layer, h)[1](u)[0])(hm, up)

    shape = jax.eval_shape(jax_layer, jnp.asarray(hm16, BF16)).shape
    up = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jgrad = _f32(vjp_of(jax_layer, jnp.asarray(hm16, BF16), jnp.asarray(up)))
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        gather = jax_repro.gather_voxel_volume
        mp.setattr(jax_repro, "gather_voxel_volume",
                   lambda hm, idx: gather(hm, idx, acc_dtype=jnp.float64))
        ref = np.asarray(vjp_of(lambda hm: jax_repro.reprojection_layer(
            hm, *args, G, float(SPACING), mode=mode), jnp.asarray(hm16, jnp.float64),
            jnp.asarray(up, jnp.float64)), np.float64)

    hm = torch.from_numpy(hm16).to(torch.bfloat16).requires_grad_()
    vol = port_repro(hm, *(torch.from_numpy(a) for a in args), G, float(SPACING), mode=mode)
    vol.backward(torch.from_numpy(up))
    assert hm.grad.dtype == torch.bfloat16
    got = hm.grad.float().numpy()
    port_err, jax_err = bf16_ulps(got, ref), bf16_ulps(jgrad, ref)
    assert (port_err <= jax_err + 1.0).all(), float((port_err - jax_err).max())
    assert port_err.max() <= 1.0, float(port_err.max())
    if mode == "exact":
        np.testing.assert_array_equal(got, jgrad)
    else:
        assert jax_err.max() > 1.0  # JAX's bf16 scatter is the less exact one
    assert (got != 0).sum() > 1000


# ------------------------------------------------------------- K8 ---

def test_k8_plain_at_bf16_heads_matches_jax():
    """K8's plain version on bf16 heads (KeypointDetect's: 23 joints, batch
    2, 16^2 and 32^2 of a 64^2 input, one unlabeled joint) against
    ``jax.value_and_grad`` of ``heatmap_loss`` on the same bf16 outputs
    (JAX promotes ``out - tgt`` to float32; the transpose rounds the
    gradient to bf16): the loss within 1e-6 relative of the float64 loss of
    the same heads and targets (measured 3.8e-9; JAX's own float32 sum is
    1.5e-5 off, so the planned 1e-6 against JAX's cannot hold), the
    gradient within 1 bf16 ulp of each element of JAX's (measured 0: both
    compute it in float32 and round once)."""
    rng = np.random.default_rng(2)
    B, J = 2, 23
    kxy = rng.uniform(4, S2D - 4, (B, J, 2)).astype(np.float32)
    kxy[0, 3] = 0.0
    heads = [_bf16_values(rng.random((B, S2D // f, S2D // f, J)) * 200.0) for f in (4, 2)]
    sig = [1.5 * (S2D // f) / 64 for f in (4, 2)]
    targets = [gaussian_heatmaps_on_device(jnp.asarray(kxy), S2D, S2D // f, s)
               for f, s in zip((4, 2), sig)]
    jloss, jgrads = jax.value_and_grad(lambda o: heatmap_loss(o, targets))(
        tuple(jnp.asarray(h, BF16) for h in heads))
    port = [torch.from_numpy(h).to(torch.bfloat16).permute(0, 3, 1, 2) for h in heads]
    kps = torch.from_numpy(kxy)
    loss, _ = heatmap2d_loss_fwd_plain(*port, kps, S2D, 1.5)
    loss64 = sum(np.mean(np.square(h.astype(np.float64) - np.asarray(t, np.float64)))
                 for h, t in zip(heads, targets))
    assert abs(float(loss) - loss64) <= 1e-6 * loss64
    assert abs(float(loss) - loss64) <= abs(float(jloss) - loss64)
    grads = heatmap2d_loss_bwd_plain(*port, kps, S2D, 1.5, torch.ones(()))
    for got, want in zip(grads, jgrads):
        assert got.dtype == torch.bfloat16
        want = _f32(want)
        ulps = bf16_ulps(got.permute(0, 2, 3, 1).float().numpy(), want.astype(np.float64))
        assert ulps.max() <= 1.0, float(ulps.max())


# ------------------------------------------------------- one step ---

def _bf16_cfg(parent):
    cfg = _cfg(parent)
    cfg.TPU.TRAIN_DTYPE = "bfloat16"
    return cfg


def _jax_bf16_loss_and_grads(batch, cfg):
    """JAX's mixed-precision loss and gradients (float32 parameters, bf16
    compute, float32 input, ``deterministic=True``) at the committed
    checkpoint."""
    model = JaxHybridNet(num_joints=23, model_size="small", roi_cube_size=CUBE,
                         grid_spacing=SPACING, repro_mode="quarter_fused", dtype=BF16)
    mean = jnp.asarray(cfg.DATASET.MEAN, jnp.float32)
    std = jnp.asarray(cfg.DATASET.STD, jnp.float32)
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        x = (b["imgs"].astype(jnp.float32) / 255.0 - mean) / std
        gt = gaussian_heatmaps_3d_on_device(b["kp_vox"], b["keypoints3D"], CUBE // SPACING // 2)
        hm, _, _, _ = model.apply({"params": params}, x, b["center_hm"], b["center3d"],
                                  b["camera_matrices"], b["intrinsics"], b["distortions"],
                                  deterministic=True)
        return hybridnet_mse_loss(hm, gt)

    params = jax.tree.map(jnp.asarray, read_ckpt(HYBRID))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return params, float(loss), {k: torch.from_numpy(np.array(v, np.float64)) for k, v in
                                 params_from_jax(jax.tree.map(np.asarray, grads), "small").items()}


def _float64_run(run, modules):
    """``run()`` with x64 on and the given JAX model modules' float32 casts
    widened to float64 (``_Float64Names``)."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for m in modules:
            mp.setattr(m, "jnp", _Float64Names())
        gather = jax_repro.gather_voxel_volume
        mp.setattr(jax_repro, "gather_voxel_volume",
                   lambda hm, idx: gather(hm, idx, acc_dtype=jnp.float64))
        return run()


@pytest.fixture(scope="module")
def jax_bf16_3d(parent):
    """JAX's bf16 loss and gradients on the first val frameset, and its
    float64 run (the yardstick)."""
    from jarvis_hybridnet_tpu.models import (bifpn, efficientnet, efficienttrack, hybridnet,
                                             layers, v2v)

    cfg = _bf16_cfg(parent)
    batch = _val_batch(cfg)
    params, loss, grads = _jax_bf16_loss_and_grads(batch, cfg)
    _, loss64, grads64 = _float64_run(
        lambda: _jax_loss_and_grads(batch, cfg, jnp.float64),
        (bifpn, efficientnet, efficienttrack, hybridnet, layers, v2v, jax_fused))
    return dict(cfg=cfg, batch=batch, params=params, loss=loss, grads=grads, loss64=loss64,
                grads64=grads64)


# The bf16 steps' gates. bf16 round-off is amplified along the backward (a
# gradient of the 2D backbone lies 10-100% of its RMS from the float64 run,
# in both packages), so one tensor's error is one draw of a heavy-tailed
# noise. The gates hold, against JAX's error on the same float64 run: the
# mean over the tensors of their RMS errors relative to their RMS
# (MEAN_RATIO x JAX's); every tensor (TENSOR_RATIO x JAX's; the BiFPN
# fusion weights as one tensor; set from the readings in the two step
# tests, the largest 2.79x; a convolution that rounds at another point
# than JAX's shows in ``test_bf16_step_convs_round_once`` instead, where
# each is held to its own float64 value); the tensors that are zero but for
# round-off (a conv bias ahead of an InstanceNorm; RMS below 1e-6 of the
# largest) by their largest error (MEAN_RATIO x JAX's); the loss
# (MEAN_RATIO x JAX's error); AdamW's first update of the whole trained
# tree as one vector (MEAN_RATIO x JAX's RMS error).
MEAN_RATIO = 1.5
TENSOR_RATIO = 3.0


def _hold_gradients(port: dict, jax_bf16: dict, ref: dict) -> tuple[float, float]:
    """Apply the gradient gates to name -> float64 array dicts; returns
    (mean ratio, largest tensor ratio, zero gradients' ratio)."""
    fusion = [n for n in ref if "_w1" in n or "_w2" in n or "weights_cat" in n]
    if fusion:  # 2-3 values each, sums of whole feature maps that cancel: one tensor
        port, jax_bf16, ref = ({**{n: d[n] for n in d if n not in fusion},
                                "fusion": np.concatenate([d[n].ravel() for n in fusion])}
                               for d in (port, jax_bf16, ref))
    rms = {n: _rms(ref[n]) for n in ref}
    top = max(rms.values())
    live = [n for n in ref if rms[n] >= 1e-6 * top]
    zero = [n for n in ref if rms[n] < 1e-6 * top]
    e_port = np.array([_rms(port[n] - ref[n]) / rms[n] for n in live])
    e_jax = np.array([_rms(jax_bf16[n] - ref[n]) / rms[n] for n in live])
    worst = e_port / e_jax
    assert e_port.mean() <= MEAN_RATIO * e_jax.mean(), (e_port.mean(), e_jax.mean())
    assert (worst <= TENSOR_RATIO).all(), [(n, w) for n, w in zip(live, worst) if w > TENSOR_RATIO]
    z_ratio = 0.0
    if zero:
        z_port = max(float(np.abs(port[n] - ref[n]).max()) for n in zero)
        z_jax = max(float(np.abs(jax_bf16[n] - ref[n]).max()) for n in zero)
        assert z_port <= MEAN_RATIO * z_jax, (z_port, z_jax)
        z_ratio = z_port / z_jax
    return float(e_port.mean() / e_jax.mean()), float(worst.max()), z_ratio


def _hold_update(port: dict, jax_bf16: dict, ref: dict) -> float:
    """AdamW's first update of the trained tree as one vector: the port's
    RMS error within MEAN_RATIO x JAX's; returns the ratio."""
    names = sorted(ref)
    cat = [np.concatenate([d[n].ravel() for n in names]) for d in (port, jax_bf16, ref)]
    ratio = _rms(cat[0] - cat[2]) / _rms(cat[1] - cat[2])
    assert ratio <= MEAN_RATIO, ratio
    return ratio


def _adamw_updates(params, grads: dict, labels=None) -> dict:
    """JAX's ``make_optimizer('adamw')`` first update at LR of ``grads``, a
    dict of the port's names -> tensors, as name -> float64 array."""
    tx = jax_optim.make_optimizer("adamw", LR, labels)
    updates, _ = jax.jit(tx.update)(jax.tree.map(lambda g: jnp.asarray(g, jnp.float32),
                                                 params_to_jax(grads, "small")),
                                    tx.init(params), params)
    return {k: np.asarray(v, np.float64) for k, v in
            params_from_jax(jax.tree.map(np.asarray, updates), "small").items()}


@pytest.mark.parametrize("mode", ["all", "bifpn", "last_layers", "3D_only"])
def test_bf16_step_in_mode_matches_jax(parent, jax_bf16_3d, mode):
    """One bf16 AdamW step (lr 1e-3) of ``HybridNetTrainer`` in ``mode`` from
    the committed checkpoint, on FRAMESETS framesets, in ``eval()`` (JAX's
    ``deterministic=True``), against JAX's bf16 step, both held to JAX's
    float64 run (the gates above the helpers). Measured (all / bifpn /
    last_layers / 3D_only): the loss 0.35x JAX's error; the gradients' mean
    relative error 0.92x / 1.02x / 1.02x / 0.93x JAX's, the largest tensor
    1.93x / 1.93x / 1.93x / 1.16x (the 2D net's first depthwise kernel, a
    sum over every pixel of one draw of the upstream noise; V2V's front
    conv in 3D_only), the zero gradients 0.31x / 0.31x / 0.031x / 0.031x;
    the update 0.98x / 0.97x / 0.97x / 0.96x. The planned 1.5x for every
    tensor cannot hold: on six single framesets the bf16 V2V output's
    relative error measured 0.60-1.50x JAX's (0.096 against 0.089 on
    average). The
    parameters are float32 and the port's update is JAX's
    ``make_optimizer`` of the port's gradients (1e-6); the frozen tensors
    get no gradient and stay bitwise unchanged; AdamW's moments are
    float32."""
    ref = jax_bf16_3d
    trainer = HybridNetTrainer("train", ref["cfg"], weights=HYBRID, device="cpu",
                               run_name=f"Bf16_{mode}", training_mode=mode)
    model = trainer.model
    assert trainer.dtype == model.dtype == torch.bfloat16
    labels = optim.hybridnet_freeze_labels(model, mode)
    opt = optim.make_optimizer("adamw", optim.apply_freeze(model, labels), LR)
    model.eval()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, _ = trainer.train_step({k: torch.from_numpy(v) for k, v in ref["batch"].items()},
                                 opt, LR)
    loss_ratio = abs(float(loss) - ref["loss64"]) / abs(ref["loss"] - ref["loss64"])
    assert loss_ratio <= MEAN_RATIO, loss_ratio

    trained = [n for n, v in labels.items() if v == "train"]
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
        assert (p.grad is None) == (labels[n] == "freeze"), n
        if labels[n] == "freeze":
            assert torch.equal(p.detach(), before[n]), n
    assert all(v.dtype == torch.float32 for v in _moments(opt))
    port_g = {n: model.get_parameter(n).grad for n in trained}
    _hold_gradients({n: g.double().numpy() for n, g in port_g.items()},
                             {n: ref["grads"][n].numpy() for n in trained},
                             {n: ref["grads64"][n].numpy() for n in trained})

    zeros = {n: torch.zeros_like(before[n]) for n in labels}
    jlabels = jax_optim.hybridnet_freeze_labels(ref["params"], mode)
    updates = [_adamw_updates(ref["params"], {**zeros, **{n: g[n].float() for n in trained}},
                              jlabels)
               for g in (port_g, ref["grads"], ref["grads64"])]
    for n in trained:
        np.testing.assert_allclose(model.get_parameter(n).detach().double().numpy(),
                                   before[n].double().numpy() + updates[0][n], rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    _hold_update(*({n: u[n] for n in trained} for u in updates))


@pytest.fixture(scope="module", params=["CenterDetect", "KeypointDetect"])
def jax_bf16_2d(request, parent):
    """A 2D net's seeded batch (FRAMESETS images of 64^2, no color record)
    and JAX's bf16 loss and gradients of it, and its float64 run, at the
    committed checkpoint."""
    from jarvis_hybridnet_tpu.models import bifpn, efficientnet, efficienttrack, layers

    net = request.param
    joints = 1 if net == "CenterDetect" else 23
    sigma = 1.0 if net == "CenterDetect" else 1.5
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JARVIS_PARENT_DIR", parent)
        cfg = _bf16_cfg(parent)
    cfg.CENTERDETECT.MODEL_SIZE = "small"
    cfg.CENTERDETECT.IMAGE_SIZE = S2D
    cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE = S2D
    imgs, kps, _ = _step_batch(np.random.default_rng(3), FRAMESETS, joints)
    tree = read_ckpt(CENTER if net == "CenterDetect" else KEYPOINT)
    kxy = kps.reshape(FRAMESETS, -1, 3)[..., :2]

    def loss_and_grads(dtype, param_dtype):
        model = JaxEfficientTrack(model_size="small", output_channels=joints, dtype=dtype)
        mean = jnp.asarray(cfg.DATASET.MEAN, param_dtype)
        std = jnp.asarray(cfg.DATASET.STD, param_dtype)
        t = [gaussian_heatmaps_on_device(jnp.asarray(kxy, param_dtype), S2D, S2D // f,
                                         sigma * (S2D // f) / 64) for f in (4, 2)]

        def loss_fn(p):
            x = (jnp.asarray(imgs, param_dtype) / 255.0 - mean) / std
            return heatmap_loss(model.apply({"params": p}, x), t)

        params = jax.tree.map(lambda a: jnp.asarray(a, param_dtype), tree)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        return params, float(loss), grads

    params, loss, grads = loss_and_grads(BF16, jnp.float32)
    _, loss64, grads64 = _float64_run(lambda: loss_and_grads(jnp.float64, jnp.float64),
                                      (bifpn, efficientnet, efficienttrack, layers))
    arrays, _ = host_batch((imgs, kps))
    return dict(net=net, cfg=cfg, batch=arrays, params=params, loss=loss, grads=grads,
                loss64=loss64, grads64=grads64)


def test_bf16_2d_step_matches_jax(parent, monkeypatch, jax_bf16_2d):
    """One bf16 AdamW step of ``EfficientTrackTrainer`` (K9, the network at
    bf16, K8 on bf16 heads) in ``eval()`` from the committed CenterDetect /
    KeypointDetect checkpoint, on FRAMESETS images, against JAX's bf16 step,
    both held to JAX's float64 run (the gates of the 3D step). Measured
    (CenterDetect / KeypointDetect): the loss 0.60x / 0.86x JAX's error;
    the gradients' mean relative error 1.09x / 0.97x, the largest tensor
    2.79x / 1.50x (SE reduce tensors: both packages are 2-7% off in an SE
    branch alone, and it magnifies the error of the gradient it receives),
    the zero gradients 0.24x / 1.04x; the update 1.05x / 0.98x. The
    parameters, gradients and AdamW's moments are float32; the heads are bf16; the port's update is JAX's
    ``make_optimizer`` of the port's gradients (1e-6)."""
    ref = jax_bf16_2d
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    weights = CENTER if ref["net"] == "CenterDetect" else KEYPOINT
    trainer = EfficientTrackTrainer(ref["net"], ref["cfg"], weights=weights, device="cpu",
                                    run_name="Bf16")
    model = trainer.model
    opt = optim.make_optimizer("adamw", list(model.parameters()), LR)
    model.eval()
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with torch.no_grad():
        _, out2 = trainer.forward(batch)
    assert out2.dtype == torch.bfloat16
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, _ = trainer.train_step(batch, opt, LR)
    loss_ratio = abs(float(loss) - ref["loss64"]) / abs(ref["loss"] - ref["loss64"])
    assert loss_ratio <= MEAN_RATIO, loss_ratio
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(v.dtype == torch.float32 for v in _moments(opt))

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    port_tree = efficienttrack_params_to_jax({n: p.grad for n, p in model.named_parameters()},
                                             "small")
    jax_g, g64 = flat(ref["grads"]), flat(ref["grads64"])
    live = [k for k in jax_g if np.abs(g64[k]).max() > 0]  # the dead parameters get zeros
    assert len(live) >= 100
    _hold_gradients(*({k: d[k] for k in live} for d in (flat(port_tree), jax_g, g64)))

    tx = jax_optim.make_optimizer("adamw", LR)
    params = ref["params"]

    def update(grads):
        u, _ = jax.jit(tx.update)(jax.tree.map(lambda g: jnp.asarray(g, jnp.float32), grads),
                                  tx.init(params), params)
        return flat(u)

    updates = [update(g) for g in (port_tree, ref["grads"], ref["grads64"])]
    stepped = flat(efficienttrack_params_to_jax(
        {n: p.detach() for n, p in model.named_parameters()}, "small"))
    start = flat(efficienttrack_params_to_jax(before, "small"))
    for k in live:
        np.testing.assert_allclose(stepped[k], start[k] + updates[0][k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    _hold_update(*({k: u[k] for k in live} for u in updates))


@pytest.mark.parametrize("net", ["HybridNet", "KeypointDetect"])
def test_bf16_step_convs_round_once(parent, monkeypatch, net):
    """Every bf16 convolution of a bf16 step (``all``: the 2D net's and
    V2V's, on 2 framesets; KeypointDetect on 2 images of 64^2), recorded by
    ``chip_smoke.conv_witness``, against its float64 value from the same
    bf16 operands (``chip_smoke.conv_rounding``): the output, the input
    gradient and the weight gradient each within CONV_ONE_ROUNDING (1.1) of
    the RMS error of the float64 value rounded once to bf16, the CPU's
    convolutions correctly rounded. Measured: 1.0000 for all three in both
    steps (the worst of 95 / 85 convolutions); rounded partial sums read
    1.4-1.5 and a sum in bf16 2.7 or more (the test below). The conv's bias
    is added after its rounding, as flax adds it (``layers.conv``), so it is
    not part of the convolution held here."""
    import chip_smoke

    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    cfg = _bf16_cfg(parent)
    if net == "HybridNet":
        trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu",
                                   run_name="Witness", training_mode="all")
        batch = {k: torch.from_numpy(v) for k, v in _val_batch(cfg, 2).items()}
    else:
        cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE = S2D
        trainer = EfficientTrackTrainer(net, cfg, weights=KEYPOINT, device="cpu",
                                        run_name="Witness")
        imgs, kps, _ = _step_batch(np.random.default_rng(3), 2, 23)
        batch = {k: torch.from_numpy(v) for k, v in host_batch((imgs, kps))[0].items()}
    trainer.model.eval()
    with chip_smoke.conv_witness() as calls:
        loss, _ = trainer.forward(batch)
        loss.backward()
    rounding = chip_smoke.conv_rounding(calls)
    assert rounding["calls"] >= 80, rounding["calls"]
    for kind in ("y", "dx", "dw"):
        assert rounding[kind][0] <= chip_smoke.CONV_ONE_ROUNDING, (kind, rounding[kind])


@pytest.mark.parametrize("K", [64, 336, 6912])
def test_conv_rounding_reads_accumulation(K):
    """``chip_smoke.conv_rounding``'s reading of a 1x1 convolution over K
    input channels (a dot product of K bf16 terms, 2048 outputs) whose
    output was summed in float32 and rounded once (1.0), with its float32
    partial sums rounded to bf16 before the last add (split in 2, 4 or 16:
    measured 1.37-1.50, under CONV_ROUND_TOL), in bf16 pairwise (2.65-3.83)
    and in bf16 term by term (6.14-55.9, both above it)."""
    import chip_smoke

    torch.manual_seed(K)
    bf = torch.bfloat16
    x = torch.randn(2048, K, 1, 1).to(bf)
    w = torch.randn(1, K, 1, 1).to(bf)
    terms = (x.double() * w.double()).reshape(2048, K)  # exact products

    def reading(y):
        rec = dict(fn=torch.nn.functional.conv2d, args=(1, 0, 1, 1), x=x, w=w,
                   y=y.to(bf).reshape(2048, 1, 1, 1), dy=torch.zeros(2048, 1, 1, 1))
        return chip_smoke.conv_rounding([rec])["y"][0]

    def pairwise(t):
        t = t.to(bf)
        while t.shape[1] > 1:
            t = torch.cat([t, torch.zeros(len(t), t.shape[1] % 2, dtype=bf)], 1)
            t = (t[:, 0::2].float() + t[:, 1::2].float()).to(bf)
        return t[:, 0]

    def sequential(t):
        acc = torch.zeros(len(t), dtype=bf)
        for k in range(t.shape[1]):
            acc = (acc.float() + t[:, k].float()).to(bf)
        return acc

    assert reading(terms.float().sum(1)) <= 1.0 + 1e-6
    for s in (2, 4, 16):
        split = terms.float().reshape(2048, s, K // s).sum(2).to(bf).float().sum(1)
        assert 1.3 <= reading(split) < chip_smoke.CONV_ROUND_TOL, s
    assert reading(pairwise(terms)) > chip_smoke.CONV_ROUND_TOL
    assert reading(sequential(terms)) > chip_smoke.CONV_ROUND_TOL


# ----------------------------------------------- float32 state on disk ---

def test_bf16_checkpoints_stay_float32_and_jax_reads_them(parent, tmp_path, jax_bf16_3d):
    """The port's counterpart of ``tests/test_training.py:435``: after a bf16
    step in ``all``, the ``.ckpt`` the trainer writes holds float32 leaves,
    which the JAX package's ``load_checkpoint`` reads into the JAX model's
    tree equal to the trained parameters; the train state's parameters and
    AdamW moments are float32 too, in the JAX package's layout, which JAX's
    ``load_train_state`` restores onto its optimizer's state. The same for
    KeypointDetect's ``.ckpt``."""
    ref = jax_bf16_3d
    trainer = HybridNetTrainer("train", ref["cfg"], weights=HYBRID, device="cpu",
                               run_name="Bf16Ckpt", training_mode="all")
    model = trainer.model
    opt = optim.make_optimizer("adamw", optim.apply_freeze(
        model, optim.hybridnet_freeze_labels(model, "all")), LR)
    trainer.train_step({k: torch.from_numpy(v) for k, v in ref["batch"].items()}, opt, LR)
    trainer.save_checkpoint("Bf16")
    path = f"{trainer.model_savepath}/Bf16.ckpt"
    tree = jax_checkpoints.load_checkpoint(path)
    leaves = jax.tree_util.tree_leaves(tree)
    assert leaves and all(np.asarray(a).dtype == np.float32 for a in leaves)
    back = params_from_jax(jax.tree.map(np.asarray, tree), "small")
    for n, p in model.named_parameters():
        assert torch.equal(back[n], p.detach()), n
    state_path = str(tmp_path / "train_state.ckpt")
    checkpoints.save_train_state(state_path, model.state_dict(), optim.optax_state(
        opt.state_dict(), optim.param_names(model, opt), model.state_dict(), 1, True,
        "small", "all"), 1, "small")
    state, opt_state, epoch = checkpoints.load_train_state(state_path, "small")
    assert epoch == 1 and all(v.dtype == torch.float32 for v in state.values()
                              if v.is_floating_point())
    adam = opt_state["inner_states"]["train"]["inner_state"]["0"]
    moments = jax.tree_util.tree_leaves([adam["mu"], adam["nu"]])
    assert moments and all(np.asarray(v).dtype == np.float32 for v in moments)
    # JAX's reader restores it onto its optimizer's state, moments in float32
    jparams = jax.tree.map(jnp.asarray, params_to_jax(model.state_dict(), "small"))
    tx = jax_optim.make_optimizer("adamw", jax_optim.onecycle_schedule(LR, 10),
                                  jax_optim.hybridnet_freeze_labels(jparams, "all"))
    _, restored, _ = jax_checkpoints.load_train_state(state_path, tx.init(jparams))
    leaves = jax.tree_util.tree_leaves(restored)
    assert leaves and all(np.asarray(v).dtype in (np.float32, np.int32) for v in leaves)

    cfg = _bf16_cfg(parent)
    cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE = S2D
    t2 = EfficientTrackTrainer("KeypointDetect", cfg, weights=KEYPOINT, device="cpu",
                               run_name="Bf16Ckpt")
    opt2 = optim.make_optimizer("adamw", list(t2.model.parameters()), LR)
    t2.train_step(_batches2d(1)[0], opt2, LR)
    t2.save_checkpoint("Bf16")
    tree2 = jax_checkpoints.load_checkpoint(f"{t2.model_savepath}/Bf16.ckpt")
    assert all(np.asarray(a).dtype == np.float32 for a in jax.tree_util.tree_leaves(tree2))


# ------------------------------------------------------ graphed steps ---

def test_graphed_bf16_2d_steps_equal_eager(seeded, stand_in):
    """KeypointDetect at bf16 in train mode (drop-connect from the trainer's
    generator), AdamW, the lr changed every step, two alternating batches,
    graphed on the stand-in against eager: the outputs, the float32
    parameters and AdamW's state bit-equal after every step, one graph."""
    cfg = _bf16_cfg(seeded)
    cfg.KEYPOINTDETECT.BOUNDING_BOX_SIZE = S2D
    trainers = [EfficientTrackTrainer("KeypointDetect", cfg, weights=KEYPOINT, device="cpu",
                                      run_name=f"G{g}", graph=g) for g in (True, False)]
    opts = [optim.make_optimizer("adamw", list(t.model.parameters()), LR) for t in trainers]
    batches = _batches2d()
    for n, lr in enumerate((1e-3, 4e-4, 2.5e-3, 7e-4), start=1):
        outs = [t.train_step(batches[n % 2], o, lr) for t, o in zip(trainers, opts)]
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        assert _equal_states(trainers[0].model, trainers[1].model), n
        assert all(torch.equal(a, b) for a, b in zip(*map(_moments, opts)))
    (step,) = stand_in.steps
    assert len(step.graphs) == 1 and sum(step.calls.values()) == graphed.WARMUP


@pytest.mark.parametrize("mode", ["all", "3D_only"])
def test_graphed_bf16_3d_steps_equal_eager(seeded, stand_in, mode):
    """HybridNet at bf16 in ``mode`` (quarter_fused; dropout and
    drop-connect from the trainer's generator), graphed on the stand-in
    against eager over WARMUP + 2 train steps and one eval step: the
    losses, points, float32 parameters and AdamW's state bit-equal."""
    cfg = _bf16_cfg(seeded)
    trainers = [HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu",
                                 run_name=f"G3{g}", training_mode=mode, graph=g)
                for g in (True, False)]
    opts = []
    for t in trainers:
        labels = optim.hybridnet_freeze_labels(t.model, mode)
        opts.append(optim.make_optimizer("adamw", optim.apply_freeze(t.model, labels), LR))
    batches = [{k: torch.from_numpy(v[i:i + 1]) for k, v in _val_batch(cfg, 2).items()}
               for i in range(2)]
    for n in range(graphed.WARMUP + 2):
        outs = [t.train_step(batches[n % 2], o, LR * (1 + n)) for t, o in zip(trainers, opts)]
        assert all(torch.equal(a, b) for a, b in zip(*outs)), n
        assert _equal_states(trainers[0].model, trainers[1].model), n
        assert all(torch.equal(a, b) for a, b in zip(*map(_moments, opts)))
    evals = [t.eval_step(batches[0]) for t in trainers]
    assert all(torch.equal(a, b) for a, b in zip(*evals))
    assert len(stand_in.steps[0].graphs) == 1


def test_chip_smoke_flip_rule(parent, monkeypatch):
    """``chip_smoke.py``'s rule for a bf16 train step whose gather backward
    adds with atomics (``split_state``, ``flip_verdict``), on a CPU trainer
    at bf16 in ``all`` after two steps: the same step again from the same
    state, with the rows' gradient (K11's output) as it is, with 1e-4 of
    its elements one bf16 ulp up (a rounding flip), zeroed, one step old
    (the other batch's) and halved. The flip holds (measured: medians
    0.0168 / 0.0153 / 0.0215 for exp_avg / exp_avg_sq / parameters, the
    largest tensor 0.0969, an SE branch's), the faults do not (medians
    0.26-1.02, the largest tensor 0.71-2.71); the split copies the state;
    an output or a V2V tensor moved by 1e-6 of its largest element fails."""
    import copy

    import chip_smoke
    from jarvis_hybridnet_torch.kernels import repro_gather

    cfg = _bf16_cfg(parent)
    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name="Flip",
                               training_mode="all")
    opt = optim.make_optimizer("adamw", optim.apply_freeze(
        trainer.model, optim.hybridnet_freeze_labels(trainer.model, "all")), LR)
    trainer.model.eval()
    batches = [{k: torch.from_numpy(v[i:i + 1]) for k, v in _val_batch(cfg, 2).items()}
               for i in range(2)]
    for n in range(2):
        trainer.train_step(batches[n % 2], opt, LR)
    backward = repro_gather.repro_quarter_gather_backward
    rows_grad = {}

    def step(change, batch=0):
        """The step from the current state with the rows' gradient
        ``change``d; returns its split state, the state restored."""
        model = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        state = copy.deepcopy(opt.state_dict())
        before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()
                  if k.startswith("effTrack.")}
        monkeypatch.setattr(repro_gather, "repro_quarter_gather_backward",
                            lambda *a: change(backward(*a)))
        out = trainer.train_step(batches[batch], opt, LR)
        monkeypatch.setattr(repro_gather, "repro_quarter_gather_backward", backward)
        part = chip_smoke.split_state(out, trainer, opt, before)
        trainer.model.load_state_dict(model)
        opt.load_state_dict(state)
        return out, part

    def keep(g):
        rows_grad["other"] = g.clone()
        return g

    def flip(g):
        flat = g.flatten().clone()
        live = torch.nonzero(flat != 0).flatten()
        pick = live[torch.from_numpy(np.random.default_rng(0).choice(
            len(live), max(1, g.numel() // 10_000), replace=False))]
        v = flat[pick].float()
        flat[pick] = (v + torch.exp2(torch.floor(torch.log2(v.abs())) - 7)).to(g.dtype)
        return flat.reshape(g.shape)

    step(keep, batch=1)
    out, twin = step(lambda g: g)
    assert chip_smoke.flip_verdict([(step(lambda g: g)[1], twin)])[0]
    held, words = chip_smoke.flip_verdict([(step(flip)[1], twin)])
    assert held, words
    for fault in (torch.zeros_like, lambda g: rows_grad["other"], lambda g: g * 0.5):
        held, words = chip_smoke.flip_verdict([(step(fault)[1], twin)])
        assert not held, words

    def moved(index):
        up = list(twin[0])
        up[index] = up[index] + 1e-6 * up[index].abs().max()
        return up, twin[1]

    assert not chip_smoke.flip_verdict([(moved(0), twin)])[0]  # the loss
    assert not chip_smoke.flip_verdict([(moved(len(out)), twin)])[0]  # V2V's first tensor
    name = "effTrack.deconv1.weight"
    copied = twin[1]["p"][name].clone()
    with torch.no_grad():
        trainer.model.get_parameter(name).add_(1.0)
    assert torch.equal(twin[1]["p"][name], copied)  # the split kept its own copy
