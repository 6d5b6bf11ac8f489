"""HybridNet training in the freeze modes ``all``, ``bifpn`` and ``last_layers``
against the JAX package's, on the CPU.

On the small rig of ``test_torch_training.py`` (4 cameras of the synthetic
rig, 128^2 crops, a 48 mm cube at 4 mm, 23 joints, float32, the committed
MonkeyHand HybridNet checkpoint), in ``eval()`` as JAX's
``deterministic=True``:

- the reprojection gather's VJP with respect to the heatmaps in all four
  repro modes: the port's ``reprojection_layer`` backward (the plain
  versions of K11 and K12 behind the gathers' autograd Functions) against
  ``jax.vjp`` of JAX's ``reprojection_layer``, B = 2, seeded heatmaps and
  upstream gradient; and a hand-built case where every point clamps to one
  edge pixel of every camera's window;
- one AdamW step of ``HybridNetTrainer`` in each of the three modes against
  ``jax.value_and_grad`` over the whole parameter tree and
  ``optim.make_optimizer`` with ``hybridnet_freeze_labels(mode)``: the
  loss, every trained tensor's gradient, the parameters after the step when
  JAX's optimizer is fed the port's gradients, the frozen tensors bitwise
  unchanged in both packages; and at lr 1e-1 the trained tensors that reach
  no loss decayed as JAX's optimizer decays them (ROADMAP.md C.3);
- ``HybridNetTrainer``'s default mode equals JAX's, and both trainers pass
  the config's ``DATALOADER_WORKER_MODE`` to their loaders, warning
  nothing.
"""

import inspect
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jarvis_hybridnet_torch.dataset import loader
from jarvis_hybridnet_torch.models.repro import reprojection_layer as port_repro
from jarvis_hybridnet_torch.models.weights import params_from_jax, params_to_jax
from jarvis_hybridnet_torch.testing import synthetic_rig
from jarvis_hybridnet_torch.training import optim
from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer
from jarvis_hybridnet_torch.training.trainer3d import HybridNetTrainer
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.models.hybridnet import HybridNetBackbone as JaxHybridNet
from jarvis_hybridnet_tpu.models.hybridnet import hybridnet_mse_loss
from jarvis_hybridnet_tpu.models.repro import reprojection_layer
from jarvis_hybridnet_tpu.ops.heatmap import gaussian_heatmaps_3d_on_device
from jarvis_hybridnet_tpu.training import optim as jax_optim
from jarvis_hybridnet_tpu.training.trainer3d import HybridNetTrainer as JaxHybridNetTrainer
from jarvis_hybridnet_tpu.utils.reprojection import project_points
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_training import CUBE, HYBRID, SPACING, _batch, _cfg, parent  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")
pytest.importorskip("cv2")

REPRO_MODES = ("exact", "half", "half_fused", "quarter_fused")
FREEZE_MODES = ("all", "bifpn", "last_layers")
LR = 1e-3
# the gathers' VJP: float32 sums in another order (the transposed stencils'
# three passes, the scatter-add) on both sides; measured 0 for exact and
# half_fused (the scatter alone), 1.6e-7 for half and 1.8e-7 for
# quarter_fused of the gradient's largest element
VJP_TOL = 1e-6


def _repro_inputs(seed=0, J=23, B=2, C=4, hs=66, off=90):
    """Seeded (B, C, J, hs, hs) heatmaps, cube centers, crop centers ``off``
    px around each center's projection (so the window's clamp is reached)
    and the rig's cameras, as numpy arrays."""
    rng = np.random.default_rng(seed)
    rig = synthetic_rig(C, 320, 256, seed=seed)
    heatmaps = (rng.random((B, C, J, hs, hs)) * 255.0).astype(np.float32)
    center3d = rng.integers(-30, 30, (B, 3)).astype(np.int32)
    centers = np.stack([np.asarray(project_points(c.astype(np.float32), rig.camera_matrices,
                                                  rig.intrinsics, rig.distortions))
                        for c in center3d]).astype(np.int32)
    center_hm = centers + rng.integers(-off, off + 1, (B, C, 2)).astype(np.int32)
    cams = [np.broadcast_to(a, (B,) + a.shape).astype(np.float32).copy()
            for a in (rig.camera_matrices, rig.intrinsics, rig.distortions)]
    return heatmaps, center3d, center_hm, cams


def _vjps(mode, heatmaps, center3d, center_hm, cams, seed=1):
    """(port's heatmap gradient, JAX's) of ``reprojection_layer`` at G = 12
    for a seeded upstream gradient."""
    G = CUBE // SPACING
    args = (center3d, center_hm, *cams)
    out, vjp = jax.vjp(lambda hm: reprojection_layer(hm, *args, G, float(SPACING), mode=mode),
                       jnp.asarray(heatmaps))
    up = np.random.default_rng(seed).standard_normal(out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(up))
    hm = torch.from_numpy(heatmaps.copy()).requires_grad_()
    vol = port_repro(hm, *(torch.from_numpy(a) for a in args), G, float(SPACING), mode=mode)
    assert tuple(vol.shape) == out.shape
    vol.backward(torch.from_numpy(up))
    return hm.grad.numpy(), np.asarray(want)


@pytest.mark.parametrize("mode", REPRO_MODES)
def test_gather_vjp_matches_jax(mode):
    got, want = _vjps(mode, *_repro_inputs())
    assert np.abs(got - want).max() <= VJP_TOL * np.abs(want).max()
    # the gradient reaches many pixels of every camera, not only the clamped edges
    pixels = (want != 0).any(axis=(0, 2)).sum(axis=(1, 2))
    assert (pixels >= 10).all(), pixels


@pytest.mark.parametrize("mode", REPRO_MODES)
def test_gather_vjp_all_clamped_to_one_pixel(mode):
    """Crop centers 4000 px off every projection: every point of every
    camera clamps to the window's corner (pixel 0 of the padded heatmap), so
    each camera's corner receives the whole upstream gradient's sum over the
    volume divided by C (each transposed stencil's weights sum to one) and
    no other pixel receives anything."""
    heatmaps, center3d, center_hm, cams = _repro_inputs(seed=3)
    center_hm = center_hm + 4000
    got, want = _vjps(mode, heatmaps, center3d, center_hm, cams)
    assert np.abs(got - want).max() <= VJP_TOL * np.abs(want).max()
    G = CUBE // SPACING
    n = G // 2 if mode in ("half_fused", "quarter_fused") else G
    up = np.random.default_rng(1).standard_normal((2, n, n, n, 23)).astype(np.float32)
    corner = up.astype(np.float64).sum(axis=(1, 2, 3)) / heatmaps.shape[1]  # (B, J)
    for c in range(heatmaps.shape[1]):
        np.testing.assert_allclose(got[:, c, :, 0, 0], corner, rtol=1e-5, atol=1e-4)
    rest = got.copy()
    rest[..., 0, 0] = 0.0
    assert not rest.any()


class _Float64Names:
    """``jnp`` as the JAX model modules see it in the float64 reference:
    ``jnp.float32`` reads as float64, so their float32 casts (the
    InstanceNorm statistics, the heatmaps before the gather, the V2V output
    before the softplus) keep float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_loss_and_grads(batch, cfg, dtype):
    """JAX's loss and gradients over the whole parameter tree at the
    committed checkpoint (``deterministic=True``), in ``dtype``. The cameras
    stay float32, so the reprojection indices are float32's."""
    model = JaxHybridNet(num_joints=23, model_size="small", roi_cube_size=CUBE,
                         grid_spacing=SPACING, repro_mode="quarter_fused", dtype=dtype)
    mean = jnp.asarray(cfg.DATASET.MEAN, dtype)
    std = jnp.asarray(cfg.DATASET.STD, dtype)
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        x = (b["imgs"].astype(dtype) / 255.0 - mean) / std
        gt = gaussian_heatmaps_3d_on_device(b["kp_vox"], b["keypoints3D"], CUBE // SPACING // 2)
        hm, _, _, _ = model.apply({"params": params}, x, b["center_hm"], b["center3d"],
                                  b["camera_matrices"], b["intrinsics"], b["distortions"],
                                  deterministic=True)
        assert hm.dtype == dtype
        return hybridnet_mse_loss(hm, gt.astype(dtype))

    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), read_ckpt(HYBRID))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return params, float(loss), {k: torch.from_numpy(np.array(v, np.float64)) for k, v in
                                 params_from_jax(jax.tree.map(np.asarray, grads), "small").items()}


@pytest.fixture(scope="module")
def jax_reference(parent):  # noqa: F811
    """JAX's loss and gradients on the first val frameset in float32, and the
    same in float64: the model modules' float32 casts widened
    (``_Float64Names``) and the gather's camera sum in float64."""
    from jarvis_hybridnet_tpu.models import (bifpn, efficientnet, efficienttrack, hybridnet,
                                             layers, repro, v2v)
    from jarvis_hybridnet_tpu.ops import fused_upfront

    cfg = _cfg(parent)
    batch = _batch(cfg)
    params, loss, grads = _jax_loss_and_grads(batch, cfg, jnp.float32)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for m in (bifpn, efficientnet, efficienttrack, hybridnet, layers, v2v, fused_upfront):
            mp.setattr(m, "jnp", _Float64Names())
        gather = repro.gather_voxel_volume
        mp.setattr(repro, "gather_voxel_volume",
                   lambda hm, idx: gather(hm, idx, acc_dtype=jnp.float64))
        _, loss64, grads64 = _jax_loss_and_grads(batch, cfg, jnp.float64)
    return dict(cfg=cfg, batch=batch, params=params, loss=loss, grads=grads, loss64=loss64,
                grads64=grads64)


def _near_zero(name: str, ref: torch.Tensor, wmax: float) -> bool:
    """A gradient that is zero but for round-off: a conv bias ahead of an
    InstanceNorm, or a tensor (a fusion weight of the last BiFPN cell that
    reaches no head) below 1e-6 of the largest weight gradient."""
    return (name.endswith("pointwise_conv.bias") or bool(re.search(r"\.\d\.bias$", name))
            or (name.startswith("v2vNet.") and name.endswith(".bias")
                and "output_layer" not in name)
            or float(ref.abs().max()) < 1e-6 * wmax)


def _is_fusion(name: str) -> bool:
    return bool(re.search(r"_w\d$", name)) or name.endswith("weights_cat")


@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_train_step_in_mode_matches_jax(parent, jax_reference, mode):  # noqa: F811
    """One AdamW step (lr 1e-3) from the committed checkpoint in ``mode``.

    - The loss within 2e-5 relative of JAX's float32 loss.
    - Every trained tensor's gradient against JAX's float64 run: each
      convolution's within 5e-3 of its own largest element (measured
      3.6e-3, ``bifpn.2.conv4_up``'s depthwise kernel), each BiFPN fusion
      weight's within 5e-3 of the largest fusion-weight gradient (measured
      2.1e-3: each sums a whole feature map and cancels to a small value),
      and the ones that are zero but for round-off (``_near_zero``) within
      1e-4 of the largest weight gradient (measured 2.5e-5). The planned
      2e-3 against JAX's float32 gradients cannot hold: JAX's own float32
      run lies up to 8.6e-2 of a tensor's max from its float64 run in the
      2D backbone (``bifpn.0.p5_to_p6``), where the gradient crosses six
      InstanceNorm-free MBConv stages and three BiFPN cells (ROADMAP.md
      section C). V2V's gradients are also held to JAX's float32 ones
      within 2e-3 of each tensor's max, as ``test_torch_training.py`` holds
      them in 3D_only.
    - The frozen tensors get no gradient in the port; every trained one
      gets one (zeros for the tensors that reach no loss, as JAX's
      ``value_and_grad`` gives them).
    - The parameters after the step within 1e-6 abs + 1e-6 relative of
      JAX's ``make_optimizer`` with ``hybridnet_freeze_labels(mode)`` fed
      the port's gradients (zeros for the frozen tensors, which JAX's
      ``set_to_zero`` ignores).
    - The frozen tensors bitwise unchanged in both packages."""
    ref = jax_reference
    trainer = HybridNetTrainer("train", ref["cfg"], weights=HYBRID, device="cpu",
                               run_name=f"Step_{mode}", training_mode=mode)
    model = trainer.model
    labels = optim.hybridnet_freeze_labels(model, mode)
    opt = optim.make_optimizer("adamw", optim.apply_freeze(model, labels), LR)
    model.eval()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, _ = trainer.train_step({k: torch.from_numpy(v) for k, v in ref["batch"].items()},
                                 opt, LR)
    assert abs(float(loss) - ref["loss"]) <= 2e-5 * abs(ref["loss"])

    grads = {n: p.grad for n, p in model.named_parameters()}
    g64, g32 = ref["grads64"], ref["grads"]
    wmax = max(float(g.abs().max()) for n, g in g64.items() if n.endswith("weight"))
    fmax = max(float(g.abs().max()) for n, g in g64.items() if _is_fusion(n))
    trained_eff = [n for n, v in labels.items() if v == "train" and n.startswith("effTrack.")]
    assert len(trained_eff) == {"all": 164, "bifpn": 115, "last_layers": 7}[mode]
    for name, label in labels.items():
        if label == "freeze":
            assert grads[name] is None, name
            continue
        want = g64[name]
        got = grads[name].double()
        diff = float((got - want).abs().max())
        if _near_zero(name, want, wmax):
            assert diff <= 1e-4 * wmax, (name, diff / wmax)
        elif _is_fusion(name):
            assert diff <= 5e-3 * fmax, (name, diff / fmax)
        else:
            assert diff <= 5e-3 * float(want.abs().max()), (name, diff / float(want.abs().max()))
            if name.startswith("v2vNet."):
                assert float((got - g32[name]).abs().max()) <= 2e-3 * float(
                    g32[name].abs().max()), name

    port_grads = {n: (g if g is not None else torch.zeros_like(before[n]))
                  for n, g in grads.items()}
    tx = jax_optim.make_optimizer("adamw", LR,
                                  jax_optim.hybridnet_freeze_labels(ref["params"], mode))
    updates, _ = tx.update(jax.tree.map(jnp.asarray, params_to_jax(port_grads, "small")),
                           tx.init(ref["params"]), ref["params"])
    stepped = params_from_jax(jax.tree.map(np.asarray, optax.apply_updates(ref["params"],
                                                                            updates)), "small")
    start = params_from_jax(read_ckpt(HYBRID), "small")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        if labels[name] == "freeze":
            assert torch.equal(p.detach(), before[name]), name
            assert torch.equal(stepped[name], start[name]), name


# lr * weight decay = 1e-5 a step: 84-168 float32 ulps of each value
DECAY_LR = 1e-1


@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_tensors_without_a_gradient_decay_as_jax(parent, jax_reference, mode):  # noqa: F811
    """ROADMAP.md C.3: one AdamW step at lr 1e-1 from the committed
    checkpoint in ``mode``. The trained tensors that reach no loss (JAX's
    float32 gradient exactly zero: ``final_conv1`` and the last BiFPN
    cell's fusion weights that feed no head) get a zero gradient in the port
    and move as JAX's ``make_optimizer`` with
    ``hybridnet_freeze_labels(mode)``, fed JAX's own gradients, moves them:
    within one float32 ulp (at most 1.19e-7 relative; the two optimizers
    round p - lr * 1e-4 * p each its own way, which measured 1 ulp on 1e5
    seeded values, so the planned 1e-7 relative cannot hold for values
    whose mantissa is near 1). 3ddb97d's trainer left them without a
    gradient and torch's AdamW skipped them, decay included: 1e-5 relative
    (84-168 ulps) from JAX's, which fails here. The frozen tensors stay
    without a gradient and bitwise unchanged."""
    ref = jax_reference
    trainer = HybridNetTrainer("train", ref["cfg"], weights=HYBRID, device="cpu",
                               run_name=f"Decay_{mode}", training_mode=mode)
    model = trainer.model
    labels = optim.hybridnet_freeze_labels(model, mode)
    opt = optim.make_optimizer("adamw", optim.apply_freeze(model, labels), DECAY_LR)
    model.eval()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.train_step({k: torch.from_numpy(v) for k, v in ref["batch"].items()}, opt, DECAY_LR)

    g32 = ref["grads"]
    unreached = [n for n, v in labels.items() if v == "train" and not g32[n].any()]
    assert "effTrack.final_conv1.weight" in unreached
    assert any(_is_fusion(n) for n in unreached) == (mode != "last_layers")
    tx = jax_optim.make_optimizer("adamw", DECAY_LR,
                                  jax_optim.hybridnet_freeze_labels(ref["params"], mode))
    own = params_to_jax({n: g.float() for n, g in g32.items()}, "small")
    updates, _ = tx.update(jax.tree.map(jnp.asarray, own), tx.init(ref["params"]),
                           ref["params"])
    stepped = params_from_jax(jax.tree.map(np.asarray, optax.apply_updates(ref["params"],
                                                                            updates)), "small")
    for name in unreached:
        p = model.get_parameter(name)
        assert p.grad is not None and not p.grad.any(), name
        moved = p.detach() != before[name]
        assert torch.equal(moved, before[name] != 0), name  # decayed where not zero
        np.testing.assert_array_max_ulp(p.detach().numpy(), stepped[name].numpy(), maxulp=1)
    for name, label in labels.items():
        if label == "freeze":
            assert model.get_parameter(name).grad is None, name
            assert torch.equal(model.get_parameter(name).detach(), before[name]), name


def test_default_training_mode_matches_jax():
    def default(cls):
        return inspect.signature(cls.__init__).parameters["training_mode"].default

    assert default(HybridNetTrainer) == default(JaxHybridNetTrainer) == "all"


class _LoaderBuilt(Exception):
    pass


@pytest.mark.parametrize("mode", ["process", "thread", "spawn"])
@pytest.mark.parametrize("net", ["HybridNet", "KeypointDetect"])
def test_trainers_pass_the_config_worker_mode(parent, monkeypatch, capsys, net, mode):  # noqa: F811
    """Each trainer builds its loaders with ``DATALOADER_WORKER_MODE`` as the
    config gives it (the default 'process', as JAX's trainers do) and warns
    nothing: no stand-in worker mode."""
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    seen = []

    def fake_loader(dataset, **kw):
        seen.append(kw["worker_mode"])
        raise _LoaderBuilt

    monkeypatch.setattr(loader, "DataLoader", fake_loader)
    cfg = _cfg(parent)
    assert cfg.DATALOADER_WORKER_MODE == "process"
    cfg.DATALOADER_WORKER_MODE = mode
    ds = types.SimpleNamespace(set_name="val", analysisMode=False)
    if net == "HybridNet":
        trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu",
                                   run_name=f"Workers_{mode}", training_mode="3D_only")
    else:
        trainer = EfficientTrackTrainer("KeypointDetect", cfg, weights=None, device="cpu",
                                        run_name=f"Workers_{mode}")
    capsys.readouterr()
    with pytest.raises(_LoaderBuilt):
        trainer.train(ds, ds, 1)
    out = capsys.readouterr().out
    assert "Warning" not in out and "DATALOADER_WORKER_MODE" not in out, out
    assert seen == [mode]

