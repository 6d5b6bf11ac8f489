"""The port's 3D_only training against the JAX package's, on the CPU.

A synthetic COCO-style dataset and project in a temporary directory
(``testing.write_dataset3d``: 4 cameras of the synthetic rig, 320x256 JPEG
frames, 23 seeded keypoints spanning under 40 mm, one unlabeled; 128^2
crops, a 48 mm cube at 4 mm, quarter_fused, float32), the committed
MonkeyHand HybridNet checkpoint.

- One training step: the loss and V2V's gradients of the port's
  ``HybridNetTrainer`` against ``jax.value_and_grad`` of the JAX package's
  own functions (``model.apply(..., deterministic=True)``,
  ``hybridnet_mse_loss`` on ``gaussian_heatmaps_3d_on_device``), and the
  parameters after 1 and 3 AdamW steps and one SGD step against
  ``optim.make_optimizer`` with ``hybridnet_freeze_labels('3D_only')`` fed
  the same gradients. Dropout and drop-connect off (``eval()``, as JAX's
  ``deterministic=True``).
- ``onecycle_schedule`` and ``PlateauScheduler`` against JAX's over whole runs.
- ``train_hybridnet`` / ``HybridNetTrainer.train`` on the CPU: the 2D net
  bitwise frozen and V2V updated; the loss halves over a short plateau-LR
  overfit (as ``tests/test_training.py:130`` asks of the JAX trainer); a
  resume from ``train_state.ckpt`` gives the uninterrupted run's parameters;
  the options that are not ported raise (on-device color augmentation and
  the freeze modes other than 3D_only are ported and no longer among them:
  ``test_torch_training_modes.py`` holds those modes to JAX).
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jarvis_hybridnet_torch.config.project_manager import ProjectManager
from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
from jarvis_hybridnet_torch.models.weights import params_from_jax, v2v_params_from_jax
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.training import optim
from jarvis_hybridnet_torch.training.train_interface import train_hybridnet
from jarvis_hybridnet_torch.training.trainer3d import BATCH_KEYS, HybridNetTrainer
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.models.hybridnet import HybridNetBackbone as JaxHybridNet
from jarvis_hybridnet_tpu.models.hybridnet import hybridnet_mse_loss
from jarvis_hybridnet_tpu.ops.heatmap import gaussian_heatmaps_3d_on_device
from jarvis_hybridnet_tpu.training import optim as jax_optim
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")
pytest.importorskip("cv2")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
HYBRID = str(TRAINED / "HybridNet_final.ckpt")
CUBE, SPACING, BBOX = 48, 4, 128
CONFIG = {
    "DATASET": {"DATASET_3D": "Synth"},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": 23, "BOUNDING_BOX_SIZE": BBOX},
    "HYBRIDNET": {"ROI_CUBE_SIZE": CUBE, "GRID_SPACING": SPACING, "BATCH_SIZE": 1},
    "TPU": {"DEVICE_AUG": False, "REPRO_MODE": "quarter_fused", "TRAIN_DTYPE": "float32"},
    "DATALOADER_NUM_WORKERS": 2,
}


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, 23,
                    splits=(("train", 4), ("val", 2)), extent_mm=40.0, seed=4, unlabeled=(7,))
    write_project(str(root), "P", CONFIG)
    return str(root)


def _cfg(parent, **hybridnet):
    pm = ProjectManager(parent)
    assert pm.load("P")
    cfg = pm.get_cfg()
    for k, v in hybridnet.items():
        cfg.HYBRIDNET[k] = v
    return cfg


def _batch(cfg, index=0):
    ds = Dataset3D(cfg, set="val", device_targets=True)
    s = ds[index]
    return {k: np.asarray(s[k])[None] for k in BATCH_KEYS}


class _JaxStep:
    """The JAX package's 3D_only step on the same batch: value_and_grad of
    ``hybridnet_mse_loss`` through ``model.apply(deterministic=True)`` with
    respect to V2V's parameters (the frozen 2D net's gradient is never used:
    ``multi_transform`` zeroes its update), and ``make_optimizer`` with the
    3D_only labels."""

    def __init__(self, cfg, batch, tree, optimizer, lr):
        self.model = JaxHybridNet(num_joints=23, model_size="small", roi_cube_size=CUBE,
                                  grid_spacing=SPACING, repro_mode="quarter_fused")
        mean = jnp.asarray(cfg.DATASET.MEAN, jnp.float32)
        std = jnp.asarray(cfg.DATASET.STD, jnp.float32)
        g2 = CUBE // SPACING // 2
        b = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(v2v, eff):
            x = (b["imgs"].astype(jnp.float32) / 255.0 - mean) / std
            gt = gaussian_heatmaps_3d_on_device(b["kp_vox"], b["keypoints3D"], g2)
            hm, _, _, _ = self.model.apply(
                {"params": {"effTrack": eff, "v2vNet": v2v}}, x, b["center_hm"],
                b["center3d"], b["camera_matrices"], b["intrinsics"], b["distortions"],
                deterministic=True)
            return hybridnet_mse_loss(hm, gt)

        self.value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
        self.params = jax.tree.map(jnp.asarray, tree)
        self.tx = jax_optim.make_optimizer(
            optimizer, lr, jax_optim.hybridnet_freeze_labels(self.params, "3D_only"))
        self.opt_state = self.tx.init(self.params)

    def loss_and_grads(self):
        return self.value_and_grad(self.params["v2vNet"], self.params["effTrack"])

    def update(self, v2v_grads):
        grads = {"effTrack": jax.tree.map(jnp.zeros_like, self.params["effTrack"]),
                 "v2vNet": v2v_grads}
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
        self.params = optax.apply_updates(self.params, updates)


def _port_v2v_grads_as_jax(model, jax_v2v):
    """The port's V2V gradients in the JAX tree (the layouts of
    ``models/weights``), to feed JAX's optimizer the same gradients."""
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    out = {}
    for path_leaf, name in _v2v_leaves(jax_v2v):
        g = grads[name].detach().numpy()
        node = out
        for k in path_leaf[:-1]:
            node = node.setdefault(k, {})
        node[path_leaf[-1]] = jnp.asarray(
            g.transpose(*range(2, g.ndim), 1, 0) if g.ndim > 1 else g)
    return out


def _v2v_leaves(tree):
    """((JAX path, port name)) of every V2V leaf."""
    from jarvis_hybridnet_torch.models.weights import _V2V_MAP

    for path, name in _V2V_MAP.items():
        for leaf, suffix in (("kernel", ".weight"), ("bias", ".bias")):
            yield path + (leaf,), "v2vNet." + name + suffix


def _v2v_state(model):
    return {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("v2vNet.")}


def _jax_v2v_state(params):
    return v2v_params_from_jax(jax.tree.map(np.asarray, params["v2vNet"]), prefix="v2vNet.")


@pytest.mark.parametrize("optimizer,steps", [("adamw", 3), ("sgd", 1)])
def test_training_step_matches_jax(parent, optimizer, steps):
    """The first step from the committed checkpoint: the loss within 2e-5
    relative and V2V's gradients within 2e-3 of each tensor's largest (the
    forward holds to JAX's at float32 round-off, points 2e-2 mm, ROADMAP.md
    section C; the backward crosses ten convolutions and InstanceNorms summed
    in another order; measured up to 8.5e-5). The conv biases ahead of an
    InstanceNorm have a zero gradient in exact arithmetic, so theirs are
    round-off in both packages (measured up to 1.1e-5 of the largest kernel
    gradient) and each is held to 1e-4 of it. Every step: JAX's
    optimizer is fed the port's gradients and the parameters after it agree
    within 1e-6 abs + 1e-6 relative (AdamW's and SGD's float32 update
    arithmetic in two orders), and the loss at the parameters reached within
    2e-5 relative. The gradients are compared at the first step only: from
    the third on, a ReLU whose input lies within round-off of zero can take
    the other branch in the other package (measured at the third AdamW step:
    the front conv's gradient 4.3e-3 off in norm, the other tensors within
    8.2e-5). The 2D net unchanged in both."""
    cfg = _cfg(parent)
    batch = _batch(cfg)
    lr = 1e-3
    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name=optimizer,
                               training_mode="3D_only")
    model = trainer.model
    trained = optim.apply_freeze(model, optim.hybridnet_freeze_labels(model, "3D_only"))
    assert all(n.startswith("v2vNet.") for n, p in model.named_parameters() if p.requires_grad)
    opt = optim.make_optimizer(optimizer, trained, lr)
    model.eval()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = _JaxStep(cfg, batch, read_ckpt(HYBRID), optimizer, lr)
    eff_before = {n: p.detach().clone() for n, p in model.named_parameters()
                  if n.startswith("effTrack.")}
    for step in range(steps):
        jl, jg = ref.loss_and_grads()
        loss, _ = trainer.train_step(b, opt, lr)
        assert abs(float(loss) - float(jl)) <= 2e-5 * abs(float(jl))
        if step == 0:
            port_grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
            jgrads = {k: torch.from_numpy(v.copy()) for k, v in v2v_params_from_jax(
                jax.tree.map(np.asarray, jg), prefix="v2vNet.").items()}
            assert set(jgrads) == set(port_grads)
            scale = max(float(g.abs().max()) for n, g in jgrads.items() if n.endswith(".weight"))
            for name, g in jgrads.items():
                got = port_grads[name]
                if name.endswith(".bias") and "output_layer" not in name:
                    assert max(float(got.abs().max()), float(g.abs().max())) <= 1e-4 * scale, name
                else:
                    assert float((got - g).abs().max()) <= 2e-3 * float(g.abs().max()), name
        ref.update(_port_v2v_grads_as_jax(model, ref.params["v2vNet"]))
        want = _jax_v2v_state(ref.params)
        for name, p in _v2v_state(model).items():
            np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    for n, p in model.named_parameters():
        if n.startswith("effTrack."):
            assert torch.equal(p, eff_before[n]), n
    np.testing.assert_array_equal(np.asarray(ref.params["effTrack"]["weights_cat"]),
                                  np.asarray(read_ckpt(HYBRID)["effTrack"]["weights_cat"]))


def test_onecycle_schedule_matches_jax():
    """A whole run of 37 steps: float32 cos round-off, 1e-6 relative."""
    for max_lr, total in ((0.003, 37), (0.02, 120)):
        ours, ref = optim.onecycle_schedule(max_lr, total), jax_optim.onecycle_schedule(max_lr,
                                                                                         total)
        got = np.array([ours(s) for s in range(total)])
        want = np.array([float(ref(s)) for s in range(total)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_plateau_scheduler_matches_jax():
    rng = np.random.default_rng(3)
    losses = list(np.cumsum(rng.normal(-0.05, 0.3, 60)) + 10.0)
    ours, ref = optim.PlateauScheduler(0.003), jax_optim.PlateauScheduler(0.003)
    assert [ours.step(v) for v in losses] == [ref.step(v) for v in losses]


def test_freeze_labels_match_jax():
    """Every parameter's label equals the JAX package's label of the same
    parameter group, in every mode; 3D_only trains V2V alone."""
    from jarvis_hybridnet_torch.models.hybridnet import HybridNetBackbone

    model = HybridNetBackbone(23, "small", CUBE, SPACING)
    tree = read_ckpt(HYBRID)
    for mode in optim.TRAINING_MODES:
        labels = optim.hybridnet_freeze_labels(model, mode)
        ref = jax_optim.hybridnet_freeze_labels(tree, mode)
        for name, label in labels.items():
            parts = name.split(".")
            if parts[0] == "v2vNet":
                assert label == "train"
                continue
            key = f"bifpn_{parts[2]}" if parts[1] == "bifpn" else parts[1]
            if key == "final_conv2":  # the reference's dead head: the JAX tree has none
                key = "final_conv1"
            (want,) = set(jax.tree_util.tree_leaves(ref["effTrack"][key]))
            assert label == want, (mode, name)
    labels = optim.hybridnet_freeze_labels(model, "3D_only")
    assert {n for n, v in labels.items() if v == "train"} == {
        n for n, _ in model.named_parameters() if n.startswith("v2vNet.")}


def _train(parent, tmp_run, epochs, **kw):
    res = {}
    ok = train_hybridnet("P", epochs, kw.pop("weights_kd", None), kw.pop("weights", HYBRID),
                         run_name=tmp_run, device="cpu", results=res, **kw)
    return ok, res


def test_train_hybridnet_freezes_2d_and_trains_v2v(parent, monkeypatch):
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    start = params_from_jax(read_ckpt(HYBRID), "small")
    ok, res = _train(parent, "Freeze", 1, mode="3D_only")
    assert ok
    h = res["history"]
    assert len(h["train_loss"]) == 1 and np.isfinite(h["train_loss"] + h["val_loss"]).all()
    state = res["trainer"].model.state_dict()
    for k, v in state.items():
        if k.startswith("effTrack."):
            assert torch.equal(v, start[k]), k
    changed = [k for k in state if k.startswith("v2vNet.") and k.endswith(".weight")
               and not torch.equal(state[k], start[k])]
    assert "v2vNet.front_layers.0.block.0.weight" in changed and len(changed) == 12
    run = os.path.join(parent, "projects", "P", "models", "HybridNet", "Freeze")
    assert {"HybridNet-small_final.ckpt", "HybridNet-small_final.pth"} <= set(os.listdir(run))


def test_plateau_overfit_halves_the_loss(parent, monkeypatch):
    """3D_only overfit on the two val framesets (no jitter) with the
    constant-LR plateau path at LR 0.02, V2V from its initialization and
    the 2D net from the committed KeypointDetect checkpoint, as the JAX
    trainer's ``test_trainer3d_converges``: the loss halves and the
    mm-accuracy improves."""
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    cfg = _cfg(parent, USE_ONECYLCLE=False, MAX_LEARNING_RATE=0.02, VAL_INTERVAL=100)
    ds = Dataset3D(cfg, set="val")
    val = Dataset3D(cfg, set="val")
    val.frameset_keys, val.keypoints3D = val.frameset_keys[:1], val.keypoints3D[:1]
    trainer = HybridNetTrainer("train", cfg, weights=None,
                               efficienttrack_weights=str(TRAINED / "KeypointDetect_final.ckpt"),
                               device="cpu", run_name="Converge", training_mode="3D_only")
    h = trainer.train(ds, val, num_epochs=12)["history"]
    assert h["train_loss"][-1] < 0.5 * h["train_loss"][0], h["train_loss"]
    assert h["train_acc"][-1] < h["train_acc"][0], h["train_acc"]


def test_resume_matches_the_uninterrupted_run(parent, monkeypatch):
    """Two epochs in one run against a run preempted at the end of its first
    epoch (the preemption path writes ``train_state.ckpt``) and resumed from
    it: the same final parameters, bit for bit (the val split as the
    training set, so no host jitter; dropout reseeded per epoch)."""
    from jarvis_hybridnet_torch.utils import preemption

    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)

    def train(run, epochs, resume=None):
        cfg = _cfg(parent, VAL_INTERVAL=100)
        ds, val = Dataset3D(cfg, set="val"), Dataset3D(cfg, set="val")
        trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name=run,
                                   training_mode="3D_only")
        results = trainer.train(ds, val, num_epochs=epochs, resume_from=resume)
        return trainer, results

    whole, _ = train("Whole", 2)
    with monkeypatch.context() as m:  # a stop request seen at the end of epoch 1
        m.setattr(preemption.PreemptionGuard, "should_stop_global",
                  lambda self, stride=None: stride is None)
        first, results = train("Split", 2)
    assert results["preempted"]
    state = os.path.join(first.model_savepath, "train_state.ckpt")
    resumed, _ = train("Split", 2, resume=state)
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert not torch.equal(first.model.state_dict()["v2vNet.output_layer.weight"],
                           resumed.model.state_dict()["v2vNet.output_layer.weight"])


def test_unported_options_raise(parent, monkeypatch):
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    cfg = _cfg(parent)
    ds = Dataset3D(cfg, set="val")
    trainer = HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name="Raise",
                               training_mode="3D_only")
    with pytest.raises(NotImplementedError, match="A.13"):
        trainer.train(ds, ds, 1, streamlitWidgets={})
    cfg.TPU.TRAIN_DTYPE = "bfloat16"
    with pytest.raises(NotImplementedError, match="float32 only"):
        HybridNetTrainer("train", cfg, weights=HYBRID, device="cpu", run_name="Raise")
