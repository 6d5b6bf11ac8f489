"""Build predictors with resolved weights (port of
``jarvis_hybridnet_tpu/prediction/loaders.py``): the fused 2D and 3D
predictors and the two-phase 3D cascade, on one device."""

from __future__ import annotations

import math

import torch

from ..models.efficienttrack import EfficientTrackBackbone
from ..models.hybridnet import HybridNetBackbone
from ..models.layers import cast_convs
from ..training.checkpoints import load_efficienttrack_state, load_hybridnet_state
from .predictor2d import Predict2D
from .predictor3d import Predict3D, build_predict3d_twophase

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _resolve_dtype(cfg, dtype=None) -> torch.dtype:
    """``dtype`` as given (a torch dtype or its name), else
    ``TPU.INFERENCE_DTYPE`` from the configuration."""
    if dtype is None:
        dtype = str(cfg.get("TPU", {}).get("INFERENCE_DTYPE", "bfloat16"))
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    if dtype not in _DTYPES.values():
        raise ValueError(f"unsupported inference dtype {dtype}")
    return dtype


def _efficienttrack(cfg, module: str) -> EfficientTrackBackbone:
    sub = cfg[module.upper()]
    return EfficientTrackBackbone(sub.MODEL_SIZE, int(sub.NUM_JOINTS))


def _hybridnet(cfg) -> HybridNetBackbone:
    # as the JAX predictor (predictor3d.py:80): a config that names no mode
    # gets the reference-faithful one
    return HybridNetBackbone(
        num_joints=int(cfg.KEYPOINTDETECT.NUM_JOINTS),
        model_size=cfg.KEYPOINTDETECT.MODEL_SIZE,
        roi_cube_size=int(cfg.HYBRIDNET.ROI_CUBE_SIZE),
        grid_spacing=int(cfg.HYBRIDNET.GRID_SPACING),
        repro_mode=str(cfg.get("TPU", {}).get("REPRO_MODE", "exact")))


def _initial_state(module: torch.nn.Module, seed: int, abstract: bool) -> dict:
    """The module's state dict: zeros (``abstract``, what a checkpoint then
    overwrites) or a seeded random init, each convolution's weight and bias
    uniform in +-1/sqrt(fan_in) (PyTorch's default bound) drawn from a
    ``torch.Generator``, every other parameter as the module sets it."""
    state = {k: v.detach().clone() for k, v in module.state_dict().items()}
    if abstract:
        return {k: torch.zeros_like(v) for k, v in state.items()}
    gen = torch.Generator().manual_seed(seed)
    for name, m in module.named_modules():
        if not isinstance(m, torch.nn.modules.conv._ConvNd):
            continue
        # ConvTranspose weights are (in, out / groups, *k); fan_in is
        # computed as PyTorch's reset_parameters computes it
        fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
        bound = 1.0 / math.sqrt(fan_in)
        for p in ("weight", "bias"):
            if getattr(m, p) is not None:
                key = f"{name}.{p}"
                state[key] = (torch.rand(state[key].shape, generator=gen) * 2 - 1) * bound
    return state


def init_efficienttrack_state(cfg, module: str, seed: int = 0,
                              abstract: bool = False) -> dict:
    """Initial state dict of the CenterDetect or KeypointDetect network."""
    return _initial_state(_efficienttrack(cfg, module), seed, abstract)


def init_hybridnet_state(cfg, seed: int = 0, abstract: bool = False) -> dict:
    """Initial state dict of the HybridNet network."""
    return _initial_state(_hybridnet(cfg), seed, abstract)


def _build(module: torch.nn.Module, state: dict, dtype, device):
    module.load_state_dict(state, strict=True)
    return cast_convs(module.to(device).eval(), dtype)


def _float32_precision(dtype) -> None:
    """float32 runs turn TF32 off, as the JAX package runs float32 at full
    precision."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _efficienttrack_state(cfg, module: str, weights):
    state = load_efficienttrack_state(
        cfg, module, weights, init_state=init_efficienttrack_state(cfg, module, abstract=True))
    # explicit weights=None -> run from a real random init (the loader
    # returns None to mean "nothing to load")
    return init_efficienttrack_state(cfg, module) if state is None else state


def _hybrid_state(cfg, weights):
    hybrid = load_hybridnet_state(
        cfg, weights, init_state=init_hybridnet_state(cfg, abstract=True))
    return init_hybridnet_state(cfg) if hybrid is None else hybrid


def make_predictor2d(cfg, weights_center_detect="latest",
                     weights_keypoint_detect="latest", dtype=None,
                     device="cuda") -> Predict2D:
    """Fused 2D predictor on ``device`` (CUDA by default).

    Each weight spec is a ``.ckpt`` or ``.pth`` path, ``'latest'``, a
    pretrain name or None (a seeded random init): see
    ``training/checkpoints.py``."""
    dtype = _resolve_dtype(cfg, dtype)
    _float32_precision(dtype)
    center, keypoint = (
        _build(_efficienttrack(cfg, module), _efficienttrack_state(cfg, module, weights),
               dtype, device)
        for module, weights in (("CenterDetect", weights_center_detect),
                                ("KeypointDetect", weights_keypoint_detect)))
    return Predict2D(cfg, center, keypoint, device)


def make_predictor3d(cfg, rig, weights_center_detect="latest",
                     weights_hybridnet="latest", dtype=None,
                     device="cuda") -> Predict3D:
    """Fused 3D predictor on ``device`` (CUDA by default).

    ``TPU.REPRO_MODE`` picks the reprojection mode (exact, half, half_fused
    or quarter_fused; exact when the configuration names none). ``rig``
    provides camera_matrices (C, 4, 3), intrinsics (C, 3, 3) and
    distortions (C, 1, 5). Weight specs as in :func:`make_predictor2d`.
    """
    dtype = _resolve_dtype(cfg, dtype)
    _float32_precision(dtype)
    center = _build(_efficienttrack(cfg, "CenterDetect"),
                    _efficienttrack_state(cfg, "CenterDetect", weights_center_detect), dtype,
                    device)
    hybrid = _build(_hybridnet(cfg), _hybrid_state(cfg, weights_hybridnet), dtype, device)
    return Predict3D(cfg, center, hybrid, rig.camera_matrices, rig.intrinsics,
                     rig.distortions, device)


def make_predictor3d_twophase(cfg, rig, full_size, weights_center_detect="latest",
                              weights_hybridnet="latest", lowres_factor: int = 4,
                              dtype=None, device="cuda"):
    """(phase_a, phase_b, crop_fn) of the split streaming cascade
    (``predictor3d.build_predict3d_twophase``) with resolved weights.
    ``full_size`` is (W, H) of the recording; phase A takes the reader's
    low-resolution frames.

    ``lowres_factor`` has no effect: the cascade reads the low-resolution
    size from the frames it is given, and the reader alone sets the factor.
    It is kept so that calls written for the JAX package's signature run
    unchanged."""
    del lowres_factor
    predictor = make_predictor3d(cfg, rig, weights_center_detect, weights_hybridnet,
                                 dtype=dtype, device=device)
    return build_predict3d_twophase(predictor, full_size)
