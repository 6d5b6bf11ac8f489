"""Exported predictors (``prediction/export.py``: ``export_predictor``,
``load_predictor``, ``list_artifacts``, ``artifact_path``), the serving
kernels as registered operators, and ``prediction/compile_cache.py``.

Each registered op (``jarvis_torch::*``, K1-K5, K10, K13-K16) runs its plain
version on CPU tensors, bit for bit, and passes ``torch.library.opcheck``'s
schema and fake-tensor checks (its fake gives the real output's shapes,
dtypes and strides). A live ``Predict3D`` in every repro mode and a live
``Predict2D`` (the MonkeyHand networks, 4 synthetic cameras of 320x256,
CenterDetect 128^2, bbox 128 (128^2 crops), a 48 mm cube at 4 mm: G = 12,
float32) exported, saved and loaded gives the live predictor's outputs bit
for bit on two seeded batches, with each serving kernel one node of the
loaded graph (K13-K16 included), and K1's calls without a bias are
written as an artifact of the ops before K1's ``bias`` operand wrote them
(four arguments), so such artifacts load and run as they did.
``artifact_path`` / ``list_artifacts`` give the JAX package's
stems (``.pt2`` for ``.jaxexp``) and leave out other modes and dtypes;
``compile_cache.configure`` follows a project switch and leaves a directory
set by someone else alone, as JAX's does (``tests/test_prediction.py``), and
``artifact_path`` / ``list_artifacts`` use the directory it leaves in force.
The drivers' ``trt_mode`` new / previous are held in
``test_torch_drivers.py``; the half and half_fused cascades and predict2D's
in ``test_torch_export_modes.py`` (a file of its own, so that the test
workers share the exports' time).
"""

import importlib
import os
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jarvis_hybridnet_torch import kernels
from jarvis_hybridnet_torch.config import get_default_cfg
from jarvis_hybridnet_torch.kernels.repro_gather import pad_rows
from jarvis_hybridnet_torch.prediction import compile_cache, export
from jarvis_hybridnet_torch.prediction.loaders import make_predictor3d
from jarvis_hybridnet_torch.testing import monkeyhand_cfg, synthetic_rig
from jarvis_hybridnet_tpu.config import get_default_cfg as jax_default_cfg
from jarvis_hybridnet_tpu.prediction import export as jax_export
from tests.test_torch_models import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TRAINED = pathlib.Path(__file__).resolve().parents[1] / "trained" / "MonkeyHand"
CENTER = str(TRAINED / "CenterDetect_final.ckpt")
KEYPOINT = str(TRAINED / "KeypointDetect_final.ckpt")
HYBRID = str(TRAINED / "HybridNet_final.ckpt")
T, C, H, W = 2, 4, 256, 320
OPS = torch.ops.jarvis_torch


# ------------------------------------------------------ registered ops ---

def _repro_args(seed=0):
    """Padded heatmap rows (B, C, 66^2, 5) and the cameras of 4 synthetic
    cameras, crop centers off the cube's center."""
    rng = np.random.default_rng(seed)
    rig = synthetic_rig(C, W, H, seed=seed)
    B, J, hs = 2, 5, 66
    rows = pad_rows(torch.from_numpy((rng.random((B, C, hs * hs, J)) * 255).astype(np.float32)))
    center3d = torch.from_numpy(rng.integers(-20, 20, (B, 3)).astype(np.int32))
    center_hm = torch.from_numpy(rng.integers(80, 200, (B, C, 2)).astype(np.int32))
    cams = [torch.from_numpy(np.broadcast_to(a, (B, *a.shape)).astype(np.float32).copy())
            for a in (rig.camera_matrices, rig.intrinsics, rig.distortions)]
    return (rows, center3d, center_hm, *cams)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 50, 8, generator=g)
    skip = torch.randn(2, 50, 8, generator=g)
    frames = torch.randint(0, 256, (2, 40, 50, 3), dtype=torch.uint8, generator=g)
    vol = torch.randn(2, 6, 6, 6, 5, generator=g)
    c3d = torch.randint(-20, 20, (2, 3), dtype=torch.int32, generator=g)
    hm = torch.randn(3, 9, 7, 4, generator=g)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    repro = _repro_args()
    plain = kernels
    cases = {
        "k1_silu": (OPS.instance_norm_act, (x, "silu", None, False),
                    lambda: (plain.instance_norm_act_plain(x, "silu"),)),
        "k1_add_relu_stats": (OPS.instance_norm_act, (x, "add_relu", skip, True),
                              lambda: (plain.instance_norm_act_plain(x, "add_relu", skip),
                                       kernels.instance_norm.stats_plain(x))),
        "k1_bf16_relu": (OPS.instance_norm_act, (x.bfloat16(), "relu", None, False),
                         lambda: (plain.instance_norm_act_plain(x.bfloat16(), "relu"),)),
        "k4_uint8_bf16": (OPS.resize_normalize, (frames, 16, 24, mean, std, torch.bfloat16),
                          lambda: (plain.resize_normalize_plain(frames, 16, 24, mean, std,
                                                                torch.bfloat16),)),
        "k4_float32": (OPS.resize_normalize, (frames.float() / 255, 20, 20, mean, std,
                                              torch.float32),
                       lambda: (plain.resize_normalize_plain(frames.float() / 255, 20, 20, mean,
                                                             std),)),
        "k3": (OPS.soft_argmax, (vol, c3d, 4.0, 48.0, False),
               lambda: plain.soft_argmax_plain(vol, c3d, 4.0, 48.0)),
        "k3_volume": (OPS.soft_argmax, (vol.bfloat16(), c3d, 4.0, 48.0, True),
                      lambda: plain.soft_argmax_plain(vol.bfloat16(), c3d, 4.0, 48.0, True)),
        "k10": (OPS.argmax2d, (hm,), lambda: plain.argmax_2d_plain(hm)),
        "k10_bf16_strided": (OPS.argmax2d, (hm.bfloat16().permute(0, 2, 1, 3),),
                             lambda: plain.argmax_2d_plain(hm.bfloat16().permute(0, 2, 1, 3))),
        "k2": (OPS.repro_quarter_gather, (*repro, 3, 16.0, True, C),
               lambda: plain.repro_quarter_gather_plain(*repro, 3, 16.0, C)),
        "k2_c_total": (OPS.repro_quarter_gather, (*repro, 3, 16.0, False, 2 * C),
                       lambda: plain.repro_quarter_gather_plain(*repro, 3, 16.0, 2 * C)[:1]),
    }
    for mode in ("exact", "half", "half_fused"):
        cases[f"k5_{mode}"] = (
            OPS.repro_grid_gather, (*repro, 12, 4.0, mode, True, C),
            lambda m=mode: plain.repro_grid_gather_plain(*repro, 12, 4.0, m, C))
    return cases


CASES = _op_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_registered_op_runs_plain_version_and_fake_gives_shapes(name):
    op, args, want = CASES[name]
    got = op(*args)
    want = want()
    got = (got,) if isinstance(got, torch.Tensor) else got
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # outputs not asked for are empty, as the schema fixes the outputs' number
    assert all(g.numel() == 0 for g in got[len(want):])
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


def test_serving_wrappers_call_their_ops(monkeypatch):
    """The live wrappers go through the registered ops (so the artifact and
    the live path run the same code)."""
    seen = []
    for name in kernels.SERVING_OPS:
        op = getattr(OPS, name)
        module = importlib.import_module("jarvis_hybridnet_torch.kernels." + {
            "instance_norm_act": "instance_norm", "repro_quarter_gather": "repro_gather"}.get(
                name, name))
        monkeypatch.setattr(module, "_op", lambda *a, _op=op, _n=name: seen.append(_n) or _op(*a))
    _, args, _ = CASES["k1_silu"]
    kernels.instance_norm_act(args[0], "silu")
    kernels.repro_quarter_gather(*_repro_args(), 3, 16.0)
    kernels.repro_grid_gather(*_repro_args(), 12, 4.0, "half")
    kernels.soft_argmax(CASES["k3"][1][0], CASES["k3"][1][1], 4.0, 48.0)
    kernels.resize_normalize(CASES["k4_uint8_bf16"][1][0], 8, 8, [0.5] * 3, [0.2] * 3)
    kernels.argmax2d(CASES["k10"][1][0])
    x = CASES["k1_silu"][1][0].reshape(2, 8, 5, 10).permute(0, 1, 3, 2)
    kernels.weighted_fuse(torch.ones(2), [x, x], ("same", "same"))
    kernels.se_gate(x, x[:, :, :1, :1].contiguous())
    kernels.heatmap_head(x, torch.ones(8, 3, 4, 4))
    kernels.crop_normalize(CASES["k4_uint8_bf16"][1][0], None, 16, [0.5] * 3, [0.2] * 3)
    assert seen == list(kernels.SERVING_OPS)


# ------------------------------------------------------ exported cascades ---

def _frames(seed):
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.random((T * C, 3, 16, 20)).astype(np.float32))
    smooth = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    frames = smooth.permute(0, 2, 3, 1).numpy() * 255 + rng.normal(0, 6, (T * C, H, W, 3))
    return torch.from_numpy(np.clip(frames, 0, 255).astype(np.uint8).reshape(T, C, H, W, 3))


def _cfg(mode="quarter_fused"):
    cfg = monkeyhand_cfg(center_size=128, bbox=128, cube=48, spacing=4, num_cameras=C)
    cfg.TPU.REPRO_MODE = mode
    return cfg


def k1_arguments(path) -> set:
    """The argument counts of the serialized ``instance_norm_act`` calls of
    an artifact: 4 without a bias (the form of artifacts exported before the
    ``bias`` operand existed), 5 with one."""
    import json
    import zipfile

    with zipfile.ZipFile(path) as z:
        name = next(n for n in z.namelist() if n.endswith("models/model.json"))
        nodes = json.loads(z.read(name))["graph_module"]["graph"]["nodes"]
    return {len(n["inputs"]) for n in nodes if "instance_norm_act" in n["target"]}


def _round_trip(predictor, example, path):
    export.export_predictor(predictor, example, str(path))
    loaded = export.load_predictor(str(path))
    ops = {str(n.target) for n in loaded.module.graph.nodes if n.op == "call_function"}
    assert not [o for o in ops if "grad" in o]  # no grad-mode switch left in the graph
    return loaded, {o.split(".")[1] for o in ops if o.startswith("jarvis_torch.")}


@pytest.mark.parametrize("mode", ["quarter_fused", "exact"])
def test_exported_predict3d_equals_live(mode, tmp_path):
    """The production mode and exact here; half and half_fused, and
    predict2D, in ``test_torch_export_modes.py``."""
    check_exported_predict3d(mode, tmp_path)


def check_exported_predict3d(mode, tmp_path):
    live = make_predictor3d(_cfg(mode), synthetic_rig(C, W, H), CENTER, HYBRID,
                            dtype="float32", device="cpu")
    batches = [_frames(7), _frames(8)]
    loaded, ops = _round_trip(live, torch.zeros_like(batches[0]), tmp_path / "p3.pt2")
    gather = "repro_quarter_gather" if mode == "quarter_fused" else "repro_grid_gather"
    assert ops == {"instance_norm_act", "resize_normalize", "argmax2d", gather, "soft_argmax",
                   "weighted_fuse", "se_gate", "heatmap_head", "crop_normalize"}
    # K1 without a bias in the earlier form; with one (float32: V2V's fused front)
    assert 4 in k1_arguments(tmp_path / "p3.pt2")
    for frames in batches:
        want, got = live(frames), loaded(frames)
        assert len(got) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert loaded.device == torch.device("cpu")
    with pytest.raises(Exception):  # the artifact holds one input shape
        loaded(batches[0][:1])


# ------------------------------------------------ artifact names, cache ---

def _both_cfgs(tmp_path, mode=None, dtype=None):
    out = []
    for make in (get_default_cfg, jax_default_cfg):
        cfg = make()
        cfg.PARENT_DIR = str(tmp_path)
        cfg.PROJECT_NAME = "P"
        if mode is not None:
            cfg.TPU.REPRO_MODE = mode
        if dtype is not None:
            cfg.TPU.INFERENCE_DTYPE = dtype
        out.append(cfg)
    return out


@pytest.mark.parametrize("mode, dtype", [(None, None), ("quarter_fused", "bfloat16"),
                                         ("exact", "float32")])
def test_artifact_path_is_the_jax_key(tmp_path, mode, dtype):
    port, jax = _both_cfgs(tmp_path, mode, dtype)
    for kind, shape in (("predict3D", (8, 12, 1024, 1280, 3)), ("predict2D", (8, 1024, 1280, 3))):
        ours, theirs = export.artifact_path(port, kind, shape), jax_export.artifact_path(
            jax, kind, shape)
        assert ours.endswith(".pt2") and theirs.endswith(".jaxexp")
        assert ours[:-len(".pt2")] == theirs[:-len(".jaxexp")]


def test_list_artifacts_keeps_the_current_numerics(tmp_path):
    port, jax = _both_cfgs(tmp_path, "half", "float32")
    assert export.list_artifacts(port, "predict3D") == []
    for cfg_mode, cfg_dtype in (("half", "float32"), ("exact", "float32"),
                                ("half", "bfloat16")):
        p, j = _both_cfgs(tmp_path, cfg_mode, cfg_dtype)
        for kind in ("predict3D", "predict2D"):
            for path in (export.artifact_path(p, kind, (2, 4, 8, 8, 3)),
                         jax_export.artifact_path(j, kind, (2, 4, 8, 8, 3))):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                pathlib.Path(path).write_bytes(b"x")
    for kind in ("predict3D", "predict2D"):
        ours, theirs = export.list_artifacts(port, kind), jax_export.list_artifacts(jax, kind)
        assert ours == [f"{kind}_2x4x8x8x3_half-float32.pt2"]
        assert [t.replace(".jaxexp", ".pt2") for t in theirs] == ours


def test_compile_cache_follows_project_switch(tmp_path, monkeypatch):
    """As the JAX package's test of the same name: a project switch
    re-points the directory this module set; a directory set by someone
    else is respected, and the artifacts follow the directory in force."""

    class Cfg:
        def __init__(self, parent, name):
            self.PARENT_DIR = str(parent)
            self.PROJECT_NAME = name

    monkeypatch.setattr(compile_cache, "_configured_dir", None)
    monkeypatch.setattr(compile_cache, "_cache_dir", None)
    compile_cache.configure(Cfg(tmp_path, "A"), "off")
    assert compile_cache.cache_dir() is None
    # an outside setting is respected
    compile_cache.set_cache_dir(str(tmp_path / "ext"))
    compile_cache.configure(Cfg(tmp_path, "A"), "new")
    assert compile_cache.cache_dir() == str(tmp_path / "ext")
    # ... and holds the artifacts of every project
    port, _ = _both_cfgs(tmp_path, "half", "float32")
    path = export.artifact_path(port, "predict3D", (2, 4, 8, 8, 3))
    assert os.path.dirname(path) == str(tmp_path / "ext")
    os.makedirs(os.path.dirname(path))
    pathlib.Path(path).write_bytes(b"x")
    assert export.list_artifacts(port, "predict3D") == [os.path.basename(path)]
    # from unset: project A, then a switch to B
    compile_cache.set_cache_dir(None)
    compile_cache.configure(Cfg(tmp_path, "A"), "new")
    a_dir = os.path.join(str(tmp_path), "projects", "A", "compiled-models")
    assert compile_cache.cache_dir() == a_dir and os.path.isdir(a_dir)
    compile_cache.configure(Cfg(tmp_path, "B"), "previous")
    b_dir = os.path.join(str(tmp_path), "projects", "B", "compiled-models")
    assert compile_cache.cache_dir() == b_dir and os.path.isdir(b_dir)
    # the project's own directory holds its artifacts again
    assert os.path.dirname(export.artifact_path(port, "predict3D", (2,))) == os.path.join(
        str(tmp_path), "projects", "P", "compiled-models")
    assert export.list_artifacts(port, "predict3D") == []
