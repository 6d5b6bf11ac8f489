"""The port's ``Dataset2D`` against the JAX package's, sample by sample, on
the CPU.

A synthetic COCO-style dataset in a temporary directory
(``testing.write_dataset3d``: 4 cameras of the synthetic rig, 320x256 JPEG
frames, 3 seeded keypoints, one unlabeled in every camera; 2 train and 1 val
framesets, so 8 and 4 images, each with its bounding box and keypoints)
and a project on it (64^2 CenterDetect input, 64^2 KeypointDetect crops),
loaded by both packages' ``ProjectManager``. For CenterDetect and
KeypointDetect: the val split and the train split (mirror / affine / host
color augmentation) with and without the device-augmentation record
(``device_aug``: the per-sample color parameters and ``minv``), both
datasets' generators seeded alike, with ``device_targets`` (uint8 images,
(1, J * 3) keypoints) and without (normalized float32 images, the two
target maps). Every leaf identical. The preload cache gives the same
samples.
"""

import numpy as np
import pytest

from jarvis_hybridnet_torch.config.project_manager import ProjectManager
from jarvis_hybridnet_torch.dataset.dataset2d import Dataset2D
from jarvis_hybridnet_torch.dataset.loader import DataLoader
from jarvis_hybridnet_torch.testing import synthetic_rig, write_dataset3d, write_project
from jarvis_hybridnet_torch.utils.rng import ThreadLocalGenerator
from jarvis_hybridnet_tpu.config.project_manager import ProjectManager as JaxProjectManager
from jarvis_hybridnet_tpu.dataset.dataset2d import Dataset2D as JaxDataset2D
from jarvis_hybridnet_tpu.utils.rng import ThreadLocalGenerator as JaxThreadLocalGenerator

pytest.importorskip("cv2")

CONFIG = {
    "DATASET": {"DATASET_2D": "Synth"},
    "CENTERDETECT": {"MODEL_SIZE": "small", "IMAGE_SIZE": 64},
    "KEYPOINTDETECT": {"MODEL_SIZE": "small", "NUM_JOINTS": 3, "BOUNDING_BOX_SIZE": 64},
    # every draw of the pipeline taken: mirror and affine always on
    "AUGMENTATION": {"MIRROR": {"PROBABILITY": 0.5}, "AFFINE_TRANSFORM": {"PROBABILITY": 1.0}},
}
MODES = ("CenterDetect", "KeypointDetect")


@pytest.fixture(scope="module")
def parent(tmp_path_factory):
    root = tmp_path_factory.mktemp("parent")
    write_dataset3d(str(root / "datasets" / "Synth"), synthetic_rig(4, 320, 256), 320, 256, 3,
                    splits=(("train", 2), ("val", 1)), extent_mm=40.0, seed=7, unlabeled=(1,))
    write_project(str(root), "P", CONFIG)
    return str(root)


def _pair(parent, mode, split, device_targets, device_aug=False, seed=21):
    port, jax_pm = ProjectManager(parent), JaxProjectManager(parent_dir=parent)
    assert port.load("P") and jax_pm.load("P")
    a = Dataset2D(port.get_cfg(), set=split, mode=mode, device_targets=device_targets,
                  device_aug=device_aug)
    b = JaxDataset2D(jax_pm.get_cfg(), set=split, mode=mode, device_targets=device_targets,
                     device_aug=device_aug)
    a.augpipe.rng, b.augpipe.rng = ThreadLocalGenerator(seed), JaxThreadLocalGenerator(seed)
    return a, b


def _same(x, y, where):
    if isinstance(x, dict):
        assert set(x) == set(y), where
        for k in x:
            _same(x[k], y[k], f"{where}.{k}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            _same(u, v, f"{where}[{i}]")
    else:
        u, v = np.asarray(x), np.asarray(y)
        assert u.dtype == v.dtype and u.shape == v.shape, where
        np.testing.assert_array_equal(u, v, err_msg=where)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("split,device_targets,device_aug", [
    ("val", True, False), ("val", False, False), ("train", True, False),
    ("train", True, True), ("train", False, False)],
    ids=["val-u8", "val-f32", "train-u8-host-aug", "train-u8-device-aug", "train-f32"])
def test_dataset2d_matches_jax(parent, mode, split, device_targets, device_aug):
    a, b = _pair(parent, mode, split, device_targets, device_aug)
    assert len(a) == len(b) == (8 if split == "train" else 4)
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        _same(sa, sb, f"{mode} {split} sample {i}")
    if device_targets:
        img, kps = sa[0], sa[1]
        size = 64
        assert img.dtype == np.uint8 and img.shape == (size, size, 3)
        j = 1 if mode == "CenterDetect" else 3
        assert kps.shape == (1, j * 3)
        if device_aug:
            assert set(sa[2]) == {"blur_sigma", "noise_scale", "noise_pc", "noise_seed",
                                  "contrast", "mul", "chan_mul", "minv"}
            assert sa[2]["minv"].shape == (2, 3) and sa[2]["chan_mul"].shape == (3,)


@pytest.mark.parametrize("mode", MODES)
def test_preload_and_collate_match_jax(parent, mode):
    """The preload cache gives the samples the files give; the thread loader
    collates device-aug records into (B, ...) leaves."""
    a, b = _pair(parent, mode, "train", True, True)
    cold = [a[i] for i in range(len(a))]
    a.preload(log=False)
    b.preload(log=False)
    a.augpipe.rng, b.augpipe.rng = ThreadLocalGenerator(21), JaxThreadLocalGenerator(21)
    for i in range(len(a)):
        warm = a[i]
        _same(warm, b[i], f"{mode} preloaded sample {i}")
        _same(warm[1:2], cold[i][1:2], f"{mode} keypoints of sample {i}")
    batch = next(iter(DataLoader(a, batch_size=4, num_workers=2, drop_last=True)))
    assert batch[0].shape == (4, 64, 64, 3) and batch[2]["minv"].shape == (4, 2, 3)
    assert batch[2]["chan_mul"].shape == (4, 3) and batch[2]["noise_seed"].shape == (4,)
