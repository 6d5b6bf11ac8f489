"""The port's EfficientTrack (2D) training against the JAX package's, on the
CPU.

- One train step of the small EfficientTrack from the committed
  KeypointDetect checkpoint (23 joints, batch 2, 64^2 inputs, device color
  augmentation at pinned parameters with no noise, a rotated ``minv``):
  the loss and every parameter's gradient of the port's
  ``EfficientTrackTrainer.forward`` (K9, the network, K8) against
  ``jax.value_and_grad`` of the JAX package's own functions
  (``make_color_aug`` + ``make_border_zero``, ``model.apply``,
  ``heatmap_loss`` on ``gaussian_heatmaps_on_device``), and the parameters
  after one AdamW step against ``optim.make_optimizer`` fed the same
  gradients. Drop-connect off (``eval()``, JAX's ``deterministic=True``).
- ``train_efficienttrack`` for CenterDetect and KeypointDetect, 2 epochs on
  a synthetic dataset (``testing.write_dataset3d``: 4 cameras of 320x256
  JPEG, 3 joints; 64^2 inputs, batch 2, device augmentation on): the train
  loss falls from a random initialization; the final ``.ckpt`` is read by
  the JAX package's ``load_checkpoint`` into the JAX model's parameter tree
  (structure and shapes) and equals the trained parameters; the final ``.pth`` has the keys,
  shapes and values of the JAX package's ``save_torch_checkpoint`` of them.
- The preemption contract: a run stopped at the end of its first epoch, and
  one stopped inside its second, each resumed from ``train_state.ckpt``,
  end with the uninterrupted run's parameters, bit for bit (the val split as
  the training set, so no host augmentation; drop-connect reseeded per
  epoch).
"""

import math
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jarvis_hybridnet_torch.config.project_manager import ProjectManager
from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
from jarvis_hybridnet_torch.models.weights import efficienttrack_params_to_jax
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.training.train_interface import train_efficienttrack
from jarvis_hybridnet_torch.training.trainer2d import EfficientTrackTrainer, host_batch
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_tpu.models.efficienttrack import EfficientTrackBackbone as JaxEfficientTrack
from jarvis_hybridnet_tpu.ops.augment import make_border_zero, make_color_aug
from jarvis_hybridnet_tpu.ops.heatmap import gaussian_heatmaps_on_device
from jarvis_hybridnet_tpu.training import checkpoints as jax_checkpoints
from jarvis_hybridnet_tpu.training import optim as jax_optim
from jarvis_hybridnet_tpu.training.trainer2d import heatmap_loss
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")
pytest.importorskip("cv2")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
S, J, LR = 64, 3, 1e-3
CONFIG = {
    "DATASET": {"DATASET_2D": "Synth"},
    "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": S, "BATCH_SIZE": 2,
                     "MAX_LEARNING_RATE": 0.01},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": J, "BOUNDING_BOX_SIZE": S,
                       "BATCH_SIZE": 2, "MAX_LEARNING_RATE": 0.01},
    "DATALOADER_NUM_WORKERS": 2,
}
# the step's gap between the packages (ROADMAP.md section C): measured 5.0e-6
# relative on the loss, 1.05e-5 of a tensor's largest element on the conv
# gradients and 7.8e-5 on the fusion weights' (each a sum over a whole
# feature map), the float32 round-off of the two frameworks' networks (K8
# and K9 alone agree with JAX to 1e-6 and 2e-6); the conv biases ahead of an
# InstanceNorm and the tensors whose gradient is below 1e-6 of the largest
# weight gradient (zero but for round-off) within 1e-4 of it, as the 3D gate
# holds such biases
LOSS_TOL, GRAD_TOL, FUSE_TOL, BIAS_TOL = 1e-5, 3e-5, 2e-4, 1e-4


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, J,
                    splits=(("train", 2), ("val", 1)), extent_mm=40.0, seed=8)
    write_project(str(root), "P", CONFIG)
    return str(root)


def _cfg(parent):
    pm = ProjectManager(parent)
    assert pm.load("P")
    return pm.get_cfg()


def _step_batch(rng, b, joints):
    """A device-aug batch: uint8 images, keypoints (1, J * 3), the color
    record at pinned parameters without noise and a rotated ``minv``."""
    imgs = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    kps = np.zeros((b, 1, joints * 3), np.float32)
    kps[..., 0::3] = rng.uniform(4, S - 4, (b, 1, joints))
    kps[..., 1::3] = rng.uniform(4, S - 4, (b, 1, joints))
    kps[..., 2::3] = 1.0
    kps[0, 0, :3] = 0.0  # an unlabeled joint
    a = 0.3
    minv = np.array([[math.cos(a), -math.sin(a), 12.0], [math.sin(a), math.cos(a), -10.0]],
                    np.float32)
    rec = {"blur_sigma": np.array([0.4, 0.0][:b], np.float32),
           "noise_scale": np.zeros(b, np.float32), "noise_pc": np.ones(b, np.float32),
           "noise_seed": np.arange(b, dtype=np.uint32),
           "contrast": np.array([1.1, 0.9][:b], np.float32),
           "mul": np.array([0.95, 1.05][:b], np.float32),
           "chan_mul": rng.uniform(0.8, 1.2, (b, 3)).astype(np.float32),
           "minv": np.broadcast_to(minv, (b, 2, 3)).copy()}
    return imgs, kps, rec


def test_train_step_matches_jax(parent, monkeypatch):
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    cfg = _cfg(parent)
    cfg.KEYPOINTDETECT.NUM_JOINTS = 23
    trainer = EfficientTrackTrainer("KeypointDetect", cfg,
                                    weights=str(TRAINED / "KeypointDetect_final.ckpt"),
                                    device="cpu", run_name="Step")
    model = trainer.model
    imgs, kps, rec = _step_batch(np.random.default_rng(3), 2, 23)
    arrays, _ = host_batch((imgs, kps, rec))
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}

    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model.eval()
    loss, _ = trainer.forward(batch)
    opt.zero_grad()
    loss.backward()
    live = {n: p for n, p in model.named_parameters() if p.grad is not None}
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    jax_grads_of_port = efficienttrack_params_to_jax(grads, "small")
    opt.step()

    jmodel = JaxEfficientTrack(model_size="small", output_channels=23, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, read_ckpt(str(TRAINED / "KeypointDetect_final.ckpt")))
    mean = jnp.asarray(cfg.DATASET.MEAN, jnp.float32)
    std = jnp.asarray(cfg.DATASET.STD, jnp.float32)
    color, border = make_color_aug(cfg.AUGMENTATION), make_border_zero()
    jrec = {k: jnp.asarray(v) for k, v in rec.items()}
    kxy = jnp.asarray(kps.reshape(2, -1, 3)[..., :2])

    def loss_fn(p):
        x = border(color(jnp.asarray(imgs, jnp.float32) / 255.0, jrec), jrec["minv"])
        x = (x - mean) / std
        t4 = gaussian_heatmaps_on_device(kxy, S, S // 4, 1.5 * (S // 4) / 64)
        t2 = gaussian_heatmaps_on_device(kxy, S, S // 2, 1.5 * (S // 2) / 64)
        return heatmap_loss(jmodel.apply({"params": p}, x), (t4, t2))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    flat_port = dict(jax.tree_util.tree_flatten_with_path(jax_grads_of_port)[0])
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    wmax = max(float(np.abs(np.asarray(r)).max()) for p, r in leaves
               if jax.tree_util.keystr(p).endswith("['kernel']"))
    worst = fused = ahead = 0.0
    for path, ref in leaves:
        ref, name = np.asarray(ref), jax.tree_util.keystr(path)
        diff = float(np.abs(np.asarray(flat_port[path]) - ref).max())
        if (name.endswith(("['pointwise_conv']['bias']", "['conv']['bias']"))
                or np.abs(ref).max() < 1e-6 * wmax):
            # zero but for round-off: a conv bias ahead of an InstanceNorm, or
            # a fusion weight of the last BiFPN cell that reaches no head
            ahead = max(ahead, diff / wmax)
        elif name.endswith("['w']") or name == "['weights_cat']":
            fused = max(fused, diff / float(np.abs(ref).max()))
        else:
            worst = max(worst, diff / float(np.abs(ref).max()))
    assert worst <= GRAD_TOL, worst
    assert fused <= FUSE_TOL, fused
    assert ahead <= BIAS_TOL, ahead
    assert len(flat_port) == len(jax.tree_util.tree_leaves(jgrads)) and len(live) >= 100

    tx = jax_optim.make_optimizer("adamw", LR)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, jax_grads_of_port), tx.init(params), params)
    stepped = optax.apply_updates(params, updates)
    mine = efficienttrack_params_to_jax({n: p.detach() for n, p in model.named_parameters()},
                                        "small")
    for path, ref in jax.tree_util.tree_flatten_with_path(stepped)[0]:
        got = dict(jax.tree_util.tree_flatten_with_path(mine)[0])[path]
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("mode", ["CenterDetect", "KeypointDetect"])
def test_train_efficienttrack_two_epochs(parent, monkeypatch, mode):
    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)
    res = {}
    assert train_efficienttrack(mode, "P", 2, None, run_name="Two", device="cpu", results=res)
    h = res["history"]
    assert len(h["train_loss"]) == len(h["val_loss"]) == 2
    assert np.isfinite(h["train_loss"] + h["val_loss"] + h["train_acc"]).all()
    assert h["train_loss"][1] < h["train_loss"][0], h["train_loss"]
    trainer = res["trainer"]
    state = trainer.model.state_dict()
    run = os.path.join(parent, "projects", "P", "models", mode, "Two")
    final = os.path.join(run, "EfficientTrack-small_final")
    assert {"EfficientTrack-small_final.ckpt", "EfficientTrack-small_final.pth"} <= set(
        os.listdir(run))
    joints = 1 if mode == "CenterDetect" else J
    # the JAX model's parameter tree (shapes only: no init is run)
    target = jax.eval_shape(JaxEfficientTrack(model_size="small", output_channels=joints).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))["params"]
    loaded = jax_checkpoints.load_checkpoint(final + ".ckpt")
    trained = efficienttrack_params_to_jax(state, "small")
    assert jax.tree.structure(loaded) == jax.tree.structure(trained) == jax.tree.structure(
        target)
    for a, b, t in zip(jax.tree.leaves(loaded), jax.tree.leaves(trained),
                       jax.tree.leaves(target)):
        assert np.asarray(a).shape == t.shape and np.array_equal(np.asarray(a), b)
    pth = torch.load(final + ".pth", weights_only=True)
    jax_checkpoints.save_torch_checkpoint(jax.tree.map(np.asarray, loaded),
                                          os.path.join(run, "jax.pth"), "small")
    ref = torch.load(os.path.join(run, "jax.pth"), weights_only=True)
    assert set(pth) == set(ref)
    for k in ref:
        assert pth[k].dtype == ref[k].dtype == torch.float32, k
        assert torch.equal(pth[k], ref[k]), k


def test_resume_matches_the_uninterrupted_run(parent, monkeypatch):
    """Two epochs in one run against a run stopped at the end of epoch 1 and
    one stopped at the first step of epoch 2 (the state of epoch 2's start
    is saved), each resumed from its ``train_state.ckpt``."""
    from jarvis_hybridnet_torch.utils import preemption

    monkeypatch.setenv("JARVIS_PARENT_DIR", parent)

    def train(run, resume=None):
        cfg = _cfg(parent)
        ds, val = (Dataset2D(cfg, set="val", mode="KeypointDetect") for _ in range(2))
        trainer = EfficientTrackTrainer("KeypointDetect", cfg, weights=None, device="cpu",
                                        run_name=run)
        trainer.model.train()
        results = trainer.train(ds, val, num_epochs=2, resume_from=resume)
        return trainer, results

    whole, _ = train("Whole")
    stops = {"epoch_end": lambda self, stride=None: stride is None}
    calls = []

    def inside_second(self, stride=None):
        calls.append(stride)
        return stride is not None and len(calls) == 4  # steps 1-2, the end of 1, step 3

    stops["inside"] = inside_second
    for name, stop in stops.items():
        with monkeypatch.context() as m:
            m.setattr(preemption.PreemptionGuard, "should_stop_global", stop)
            first, results = train(f"Split_{name}")
        assert results["preempted"]
        resumed, _ = train(f"Split_{name}",
                           resume=os.path.join(first.model_savepath, "train_state.ckpt"))
        for k, v in whole.model.state_dict().items():
            assert torch.equal(v, resumed.model.state_dict()[k]), (name, k)
