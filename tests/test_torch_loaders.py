"""Weight resolution of the port (``training/checkpoints.py``, the loader
factories) against the JAX package's ``training/checkpoints.py``.

A project tree in a temporary directory holds run directories under
``projects/P/models/<module>/`` and pretrains under ``pretrained/``, made
from the committed MonkeyHand checkpoints: ``.ckpt`` copies and ``.pth``
state dicts written by the JAX package's ``weights_io`` exporters and
``torch.save``. Each spec is resolved by both packages onto the same
all-zero initial weights, and the JAX result, converted to reference names,
must equal the port's state dict exactly; the warnings printed must be the
same text.
"""

import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from jarvis_hybridnet_torch.models.weights import params_from_jax
from jarvis_hybridnet_torch.prediction import loaders
from jarvis_hybridnet_torch.testing import monkeyhand_cfg, synthetic_rig
from jarvis_hybridnet_torch.training import checkpoints as port_ckpt
from jarvis_hybridnet_tpu.config import get_default_cfg
from jarvis_hybridnet_tpu.models import weights_io
from jarvis_hybridnet_tpu.prediction import loaders as jax_loaders
from jarvis_hybridnet_tpu.training import checkpoints as jax_ckpt
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"


def _save_pth(tree, path, kind):
    sd = (weights_io.efficienttrack_params_to_torch(tree, "small") if kind == "et"
          else weights_io.hybridnet_params_to_torch(tree, "small"))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """(port cfg, JAX cfg) of project P under a temporary parent directory:
    an older and a newer run of each module (the newer one holds the
    committed checkpoint, the older a file no reader accepts), the same
    weights as ``.pth`` files, pretrains named ``MonkeyHand`` and an EcoSet
    pretrain."""
    root = tmp_path_factory.mktemp("parent")
    models = root / "projects" / "P" / "models"
    for module, size_name, src in (
            ("CenterDetect", "EfficientTrack-small", "CenterDetect"),
            ("KeypointDetect", "EfficientTrack-small", "KeypointDetect"),
            ("HybridNet", "HybridNet-small", "HybridNet")):
        old, new = models / module / "run_old", models / module / "run_new"
        old.mkdir(parents=True)
        new.mkdir(parents=True)
        (old / f"{size_name}_final.ckpt").write_bytes(b"not a checkpoint")
        shutil.copyfile(TRAINED / f"{src}_final.ckpt", new / f"{size_name}_final.ckpt")
        os.utime(old, (1_000_000_000, 1_000_000_000))
        os.utime(new, (1_700_000_000, 1_700_000_000))
    trees = {n: jax_ckpt.load_checkpoint(str(TRAINED / f"{n}_final.ckpt"))
             for n in ("CenterDetect", "KeypointDetect", "HybridNet")}
    pths = root / "pths"
    _save_pth(trees["CenterDetect"], pths / "center.pth", "et")
    _save_pth(trees["KeypointDetect"], pths / "keypoint.pth", "et")
    _save_pth(trees["HybridNet"], pths / "hybrid.pth", "hybrid")
    pre = root / "pretrained"
    _save_pth(trees["CenterDetect"], pre / "MonkeyHand" / "EfficientTrack_Center-small.pth", "et")
    _save_pth(trees["KeypointDetect"],
              pre / "MonkeyHand" / "EfficientTrack_Keypoints-small.pth", "et")
    _save_pth(trees["HybridNet"], pre / "MonkeyHand" / "HybridNet-small.pth", "hybrid")
    _save_pth(trees["KeypointDetect"], pre / "EcoSet" / "EfficientTrack-small.pth", "et")
    cfg = monkeyhand_cfg(center_size=64, bbox=128, cube=144, spacing=4, num_cameras=4)
    cfg.PARENT_DIR, cfg.PROJECT_NAME = str(root), "P"
    jcfg = get_default_cfg()
    jcfg.merge_from_other_cfg(cfg)
    return cfg, jcfg, root


def _spec(root, name):
    return {"ckpt_center": str(TRAINED / "CenterDetect_final.ckpt"),
            "ckpt_keypoint": str(TRAINED / "KeypointDetect_final.ckpt"),
            "ckpt_hybrid": str(TRAINED / "HybridNet_final.ckpt"),
            "pth_center": str(root / "pths" / "center.pth"),
            "pth_keypoint": str(root / "pths" / "keypoint.pth"),
            "pth_hybrid": str(root / "pths" / "hybrid.pth"),
            "missing": str(root / "nowhere" / "weights.ckpt")}.get(name, name)


EFFICIENTTRACK_SPECS = [
    ("CenterDetect", "ckpt_center"), ("CenterDetect", "pth_center"),
    ("CenterDetect", "latest"), ("CenterDetect", "MonkeyHand"),
    ("KeypointDetect", "latest"), ("KeypointDetect", "MonkeyHand"),
    ("KeypointDetect", "pth_keypoint"), ("KeypointDetect", "ecoset"),
    ("CenterDetect", "pth_keypoint"), ("CenterDetect", "missing"), ("CenterDetect", None),
]


@pytest.mark.parametrize("module,spec", EFFICIENTTRACK_SPECS,
                         ids=[f"{m}-{s}" for m, s in EFFICIENTTRACK_SPECS])
def test_efficienttrack_resolution_matches_jax(project, module, spec, capsys):
    """A ``.ckpt`` or ``.pth`` path, 'latest' (the newer run directory: the
    older one holds an unreadable file), a pretrain name, EcoSet (head and
    first pointwise conv left at their initial values), a 23-joint
    KeypointDetect ``.pth`` for the 1-joint CenterDetect (its head dropped),
    a missing path (a warning and None) and None (None, silently)."""
    cfg, jcfg, root = project
    weights = _spec(root, spec)
    init = loaders.init_efficienttrack_state(cfg, module, abstract=True)
    got = port_ckpt.load_efficienttrack_state(cfg, module, weights, init_state=init)
    port_out = capsys.readouterr().out
    jinit = jax_loaders.init_efficienttrack_params(jcfg, module, abstract=True)
    ref = jax_ckpt.load_efficienttrack_params(jcfg, module, weights, init_params=jinit)
    assert port_out == capsys.readouterr().out
    if ref is None:
        assert got is None
        return
    ref_sd = params_from_jax(ref, "small")
    assert set(got) == set(init)
    for k, v in got.items():
        assert torch.equal(v.float(), ref_sd[k] if k in ref_sd else init[k]), k


@pytest.mark.parametrize("spec", ["ckpt_hybrid", "pth_hybrid", "latest", "MonkeyHand",
                                  "missing", None])
def test_hybridnet_resolution_matches_jax(project, spec, capsys):
    cfg, jcfg, root = project
    weights = _spec(root, spec)
    init = loaders.init_hybridnet_state(cfg, abstract=True)
    got = port_ckpt.load_hybridnet_state(cfg, weights, init_state=init)
    port_out = capsys.readouterr().out
    jinit = jax_loaders.init_hybridnet_params(jcfg, abstract=True)
    ref = jax_ckpt.load_hybridnet_params(jcfg, weights, init_params=jinit)
    assert port_out == capsys.readouterr().out
    if spec == "missing":
        assert got is None and ref is None
        return
    if spec is None:  # nothing to load: the initial weights come back
        assert got is init
        return
    ref_sd = params_from_jax(ref, "small")
    assert set(got) == set(init)
    for k, v in got.items():
        assert torch.equal(v.float(), ref_sd[k] if k in ref_sd else init[k]), k


def test_latest_without_runs_warns_and_keeps_the_initial_weights(tmp_path, capsys):
    """'latest' in a project with no saved runs: the JAX package's warnings,
    and the initial weights come back (all zeros, as JAX's abstract init)."""
    cfg = monkeyhand_cfg(center_size=64, bbox=128, cube=144, spacing=4, num_cameras=4)
    cfg.PARENT_DIR, cfg.PROJECT_NAME = str(tmp_path), "Empty"
    jcfg = get_default_cfg()
    jcfg.merge_from_other_cfg(cfg)
    init = loaders.init_efficienttrack_state(cfg, "CenterDetect", abstract=True)
    assert port_ckpt.load_efficienttrack_state(cfg, "CenterDetect", "latest", init) is init
    hinit = loaders.init_hybridnet_state(cfg, abstract=True)
    assert port_ckpt.load_hybridnet_state(cfg, "latest", hinit) is hinit
    port_out = capsys.readouterr().out
    jax_ckpt.load_efficienttrack_params(jcfg, "CenterDetect", "latest", init_params={})
    jax_ckpt.load_hybridnet_params(jcfg, "latest", init_params={})
    assert port_out == capsys.readouterr().out
    assert "Could not find previously saved weights" in port_out
    assert all(float(v.abs().max()) == 0.0 for v in init.values())


def test_pth_and_ckpt_give_the_same_outputs(project):
    """The predictors built from the ``.pth`` exports give the same outputs
    as those built from the ``.ckpt`` files, bit for bit."""
    cfg, _, root = project
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 4, 256, 320, 3), dtype=np.uint8)
    rig = synthetic_rig(4, 320, 256)
    a = loaders.make_predictor3d(cfg, rig, _spec(root, "ckpt_center"), _spec(root, "ckpt_hybrid"),
                                 dtype="float32", device="cpu")(frames)
    b = loaders.make_predictor3d(cfg, rig, _spec(root, "pth_center"), _spec(root, "pth_hybrid"),
                                 dtype="float32", device="cpu")(frames)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = loaders.make_predictor2d(cfg, _spec(root, "ckpt_center"), _spec(root, "ckpt_keypoint"),
                                 dtype="float32", device="cpu")(frames[:, 0])
    b = loaders.make_predictor2d(cfg, _spec(root, "pth_center"), _spec(root, "pth_keypoint"),
                                 dtype="float32", device="cpu")(frames[:, 0])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_none_gives_a_seeded_random_init_that_runs(project):
    """weights=None: a random init drawn from a seeded ``torch.Generator``,
    the same on every build, and the cascades run on it."""
    cfg, _, _ = project
    s1 = loaders.init_hybridnet_state(cfg)
    s2 = loaders.init_hybridnet_state(cfg)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert float(s1["v2vNet.output_layer.weight"].abs().max()) > 0.0
    assert not torch.equal(s1["effTrack.deconv1.weight"],
                           loaders.init_hybridnet_state(cfg, seed=1)["effTrack.deconv1.weight"])
    frames = np.random.default_rng(4).integers(0, 256, (1, 4, 256, 320, 3), dtype=np.uint8)
    rig = synthetic_rig(4, 320, 256)
    runs = [loaders.make_predictor3d(cfg, rig, None, None, dtype="float32", device="cpu")(frames)
            for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    assert torch.isfinite(runs[0][0]).all()
    points, conf, valid = loaders.make_predictor2d(cfg, None, None, dtype="float32",
                                                   device="cpu")(frames[:, 0])
    assert points.shape == (1, 23, 2) and torch.isfinite(conf).all()
