"""The port's 3D training data and checkpoint files against the JAX package.

A synthetic COCO-style dataset in a temporary directory
(``testing.write_dataset3d``: 4 cameras of the synthetic rig, 320x256 JPEG
frames, 23 seeded keypoints spanning under 40 mm, one joint unlabeled, 4
train and 2 val framesets) and a project on it (128^2 crops, a 48 mm cube at
4 mm), loaded by both packages' ``ProjectManager``:

- ``Dataset3D`` sample by sample: the val split exactly, with and without
  ``device_targets``; the train split (crop and cube jitter, host color
  augmentation, or the device-augmentation record) exactly with both
  packages' generators seeded alike;
- ``train_hybridnet`` at the default ``TPU`` section (device augmentation
  on) on the CPU, its ``prepare`` against the JAX package's at no noise;
- the port's ``.ckpt`` read by the JAX package's ``load_checkpoint(target=)``
  equals the params; its ``.pth`` equals the JAX package's
  ``save_torch_checkpoint`` key by key; a train state round-trips;
- the two-phase ``crop_fn`` keeps float frames as float (a deviation from
  the JAX package, whose ``crop_fn`` casts to uint8).
"""

import pathlib
import types

import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch.config.project_manager import ProjectManager
from jarvis_hybridnet_torch.dataset.dataset3d import Dataset3D
from jarvis_hybridnet_torch.models.weights import params_from_jax, params_to_jax
from jarvis_hybridnet_torch.prediction.predictor3d import build_predict3d_twophase
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.training import checkpoints
from jarvis_hybridnet_torch.utils.ckpt_io import read_ckpt
from jarvis_hybridnet_torch.utils.rng import ThreadLocalGenerator
from jarvis_hybridnet_tpu.config.project_manager import ProjectManager as JaxProjectManager
from jarvis_hybridnet_tpu.dataset.dataset3d import Dataset3D as JaxDataset3D
from jarvis_hybridnet_tpu.training import checkpoints as jax_checkpoints
from jarvis_hybridnet_tpu.utils.rng import ThreadLocalGenerator as JaxThreadLocalGenerator
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytest.importorskip("cv2")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CONFIG = {
    "DATASET": {"DATASET_3D": "Synth"},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": 23, "BOUNDING_BOX_SIZE": 128},
    "HYBRIDNET": {"ROI_CUBE_SIZE": 48, "GRID_SPACING": 4},
    "TPU": {"DEVICE_AUG": False},
}


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, 23,
                    splits=(("train", 4), ("val", 2)), extent_mm=40.0, seed=3, unlabeled=(5,))
    write_project(str(root), "P", CONFIG)
    return str(root)


def _cfgs(parent):
    port, jax_pm = ProjectManager(parent), JaxProjectManager(parent_dir=parent)
    assert port.load("P") and jax_pm.load("P")
    return port.get_cfg(), jax_pm.get_cfg()


def _same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k]
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("device_targets", [True, False])
def test_dataset3d_val_split_matches_jax(parent, device_targets):
    cfg, jcfg = _cfgs(parent)
    port = Dataset3D(cfg, set="val", device_targets=device_targets)
    ref = JaxDataset3D(jcfg, set="val", device_targets=device_targets)
    assert len(port) == len(ref) == 2
    assert port.frameset_keys == ref.frameset_keys
    for i in range(len(port)):
        _same_sample(port[i], ref[i])
    if device_targets:
        s = port[0]
        assert s["imgs"].dtype == np.uint8 and s["imgs"].shape == (4, 128, 128, 3)
        assert not s["keypoints3D"][5].any()  # the unlabeled joint


def test_dataset3d_train_split_matches_jax_with_generators_seeded_alike(parent):
    """Crop jitter, cube jitter and host color augmentation draw from the
    datasets' generators; seeded alike, both packages give the same samples."""
    cfg, jcfg = _cfgs(parent)
    port = Dataset3D(cfg, set="train", device_targets=True)
    ref = JaxDataset3D(jcfg, set="train", device_targets=True)
    port.rng, ref.rng = ThreadLocalGenerator(11), JaxThreadLocalGenerator(11)
    port.augpipe.rng, ref.augpipe.rng = ThreadLocalGenerator(12), JaxThreadLocalGenerator(12)
    assert len(port) == len(ref) == 4
    for i in range(len(port)):
        _same_sample(port[i], ref[i])


def test_device_aug_raises(parent):
    """On-device color augmentation no longer raises: a train sample with
    ``device_aug`` carries the raw uint8 crops and the per-camera color
    record ``aug``, equal to the JAX package's with both datasets'
    generators seeded alike."""
    cfg, jcfg = _cfgs(parent)
    port = Dataset3D(cfg, set="train", device_targets=True, device_aug=True)
    ref = JaxDataset3D(jcfg, set="train", device_targets=True, device_aug=True)
    port.rng, ref.rng = ThreadLocalGenerator(13), JaxThreadLocalGenerator(13)
    port.augpipe.rng, ref.augpipe.rng = ThreadLocalGenerator(14), JaxThreadLocalGenerator(14)
    for i in range(len(port)):
        a, b = port[i], ref[i]
        aug_a, aug_b = a.pop("aug"), b.pop("aug")
        _same_sample(a, b)
        _same_sample(aug_a, aug_b)
        assert a["imgs"].dtype == np.uint8 and aug_a["chan_mul"].shape == (4, 3)


@pytest.mark.usefixtures("few_torch_threads")
def test_train_hybridnet_at_the_default_config(parent, tmp_path, monkeypatch):
    """``TPU.DEVICE_AUG`` at its default (on, with color manipulation on):
    ``train_hybridnet`` runs one epoch on the CPU, and the trainer's
    ``prepare`` of a train batch (K9's plain version) equals the JAX
    package's ``/255``, ``make_color_aug`` and normalize within 2e-6 / min
    std at ``noise_scale`` 0."""
    import jax.numpy as jnp

    from jarvis_hybridnet_torch.dataset.loader import DataLoader
    from jarvis_hybridnet_torch.training.train_interface import train_hybridnet
    from jarvis_hybridnet_torch.training.trainer3d import host_batch
    from jarvis_hybridnet_tpu.ops.augment import make_color_aug

    write_project(str(tmp_path), "P", {**CONFIG, "TPU": {}, "DATALOADER_NUM_WORKERS": 2,
                                       "DATASET": {"DATASET_3D": str(pathlib.Path(parent)
                                                                     / "datasets" / "Synth")}})
    monkeypatch.setenv("JARVIS_PARENT_DIR", str(tmp_path))
    res = {}
    assert train_hybridnet("P", 1, None, str(TRAINED / "HybridNet_final.ckpt"), mode="3D_only",
                           device="cpu", run_name="Default", results=res)
    trainer = res["trainer"]
    assert trainer.cfg.TPU.DEVICE_AUG and np.isfinite(res["history"]["train_loss"]).all()
    ds = Dataset3D(trainer.cfg, set="train", device_targets=True, device_aug=True)
    b = next(iter(DataLoader(ds, batch_size=1, num_workers=0)))
    b["aug"]["noise_scale"][:] = 0.0
    got = trainer.prepare({k: torch.from_numpy(v) for k, v in host_batch(b).items()}).numpy()
    x = make_color_aug(trainer.cfg.AUGMENTATION)(jnp.asarray(b["imgs"], jnp.float32) / 255.0,
                                                 {k: jnp.asarray(v) for k, v in b["aug"].items()})
    std = np.asarray(trainer.cfg.DATASET.STD, np.float32)
    ref = (np.asarray(x) - np.asarray(trainer.cfg.DATASET.MEAN, np.float32)) / std
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 2e-6 / std.min()


def _trained_state():
    return params_from_jax(read_ckpt(str(TRAINED / "HybridNet_final.ckpt")), "small")


def test_port_ckpt_loads_in_jax(tmp_path):
    state = _trained_state()
    state["v2vNet.output_layer.bias"] = state["v2vNet.output_layer.bias"] + 0.5  # not the file's
    path = str(tmp_path / "HybridNet.ckpt")
    checkpoints.save_checkpoint(state, path, "small")
    target = params_to_jax(state, "small")
    zeros = jax_checkpoints.load_checkpoint(str(TRAINED / "HybridNet_final.ckpt"))
    loaded = jax_checkpoints.load_checkpoint(path, target=zeros)

    def check(a, b, where=""):
        if isinstance(a, dict):
            assert set(a) == set(b), where
            for k in a:
                check(a[k], b[k], f"{where}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=where)

    check(loaded, target)
    back = checkpoints.load_checkpoint(path)
    check(back, target)


def test_port_pth_equals_jax_pth(tmp_path):
    state = _trained_state()
    checkpoints.save_torch_checkpoint(state, str(tmp_path / "port.pth"))
    jax_checkpoints.save_torch_checkpoint(params_to_jax(state, "small"), str(tmp_path / "jax.pth"),
                                          "small", kind="hybridnet")
    port = torch.load(tmp_path / "port.pth", weights_only=True)
    ref = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype == torch.float32, k
        assert torch.equal(port[k], ref[k]), k


def test_train_state_round_trip(tmp_path):
    state = _trained_state()
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    model(torch.randn(4, 3)).sum().backward()
    opt.step()
    path = str(tmp_path / "train_state.ckpt")
    checkpoints.save_train_state(path, state, {"optimizer": opt.state_dict(), "step": 7}, 3,
                                 "small")
    back, opt_state, epoch = checkpoints.load_train_state(path, "small")
    assert epoch == 3 and opt_state["step"] == 7
    assert set(back) <= set(state) and all(torch.equal(back[k], state[k]) for k in back)
    opt2 = torch.optim.AdamW(model.parameters(), lr=1e-3)
    opt2.load_state_dict(opt_state["optimizer"])
    for k, v in opt.state_dict()["state"][0].items():
        assert torch.equal(opt2.state_dict()["state"][0][k], v)
    assert jax_checkpoints.load_checkpoint(path)["epoch"] == 3  # the JAX reader reads the file


def test_crop_fn_keeps_float_frames():
    """The port's two-phase ``crop_fn`` cuts float32 [0, 1] frames into
    float32 windows with the frames' values (the JAX package's casts them
    to uint8, which cuts such frames down to 0 or 1: a recorded
    deviation); uint8 frames stay uint8. The windows are the same."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, 3, 96, 120, 3), dtype=np.uint8)
    _, _, crop_fn = build_predict3d_twophase(types.SimpleNamespace(bbox=32), (120, 96))
    cx = rng.integers(16, 120 - 16, (2, 3)).astype(np.int32)
    cy = rng.integers(16, 96 - 16, (2, 3)).astype(np.int32)
    u8 = crop_fn(frames, cx, cy)
    f32 = crop_fn(frames.astype(np.float32) / 255.0, cx, cy)
    assert u8.dtype == np.uint8 and f32.dtype == np.float32
    assert u8.shape == f32.shape == (2, 3, 32, 32, 3)
    np.testing.assert_array_equal(f32, u8.astype(np.float32) / 255.0)
    t, c = 1, 2
    np.testing.assert_array_equal(u8[t, c], frames[t, c, cy[t, c] - 16:cy[t, c] + 16,
                                                   cx[t, c] - 16:cx[t, c] + 16])
