"""Build predictors from configuration and checkpoint files (port of
``jarvis_hybridnet_tpu/prediction/loaders.py::make_predictor3d``)."""

from __future__ import annotations

import torch

from ..models.efficienttrack import EfficientTrackBackbone
from ..models.hybridnet import HybridNetBackbone
from ..models.layers import cast_convs
from ..models.weights import params_from_jax
from ..utils.ckpt_io import read_ckpt
from .predictor3d import Predict3D

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


def _load(module: torch.nn.Module, ckpt: str, model_size: str, dtype, device):
    module.load_state_dict(params_from_jax(read_ckpt(ckpt), model_size), strict=True)
    return cast_convs(module.to(device).eval(), dtype)


def make_predictor3d(cfg, rig, weights_center_detect: str,
                     weights_hybridnet: str, dtype=None,
                     device="cuda") -> Predict3D:
    """Fused 3D predictor from two flax ``.ckpt`` files.

    ``TPU.REPRO_MODE`` picks the reprojection mode (exact, half, half_fused
    or quarter_fused; exact when the configuration names none).

    ``rig`` provides camera_matrices (C, 4, 3), intrinsics (C, 3, 3) and
    distortions (C, 1, 5). Runs on ``device`` (CUDA by default); float32
    runs turn cuDNN's TF32 off, as the JAX package runs float32 at full
    precision.
    """
    dtype = _resolve_dtype(cfg, dtype)
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    # as the JAX predictor (predictor3d.py:80): a config that names no mode
    # gets the reference-faithful one
    mode = str(cfg.get("TPU", {}).get("REPRO_MODE", "exact"))
    center = _load(EfficientTrackBackbone(cfg.CENTERDETECT.MODEL_SIZE, 1),
                   weights_center_detect, cfg.CENTERDETECT.MODEL_SIZE, dtype, device)
    hybrid = _load(HybridNetBackbone(
        num_joints=int(cfg.KEYPOINTDETECT.NUM_JOINTS),
        model_size=cfg.KEYPOINTDETECT.MODEL_SIZE,
        roi_cube_size=int(cfg.HYBRIDNET.ROI_CUBE_SIZE),
        grid_spacing=int(cfg.HYBRIDNET.GRID_SPACING),
        repro_mode=mode), weights_hybridnet, cfg.KEYPOINTDETECT.MODEL_SIZE,
        dtype, device)
    return Predict3D(cfg, center, hybrid, rig.camera_matrices, rig.intrinsics,
                     rig.distortions, device)
