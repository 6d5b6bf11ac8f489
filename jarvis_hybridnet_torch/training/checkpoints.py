"""Reference-compatible weight resolution (port of the loading half of
``jarvis_hybridnet_tpu/training/checkpoints.py:86-241``).

A weight spec is resolved as the reference resolves it
(jarvis/efficienttrack/efficienttrack.py:90-183, train_interface.py:22-50):

  * a filesystem path          -> loaded directly: a flax ``.ckpt`` through
                                  the port's own reader (``utils/ckpt_io``),
                                  a reference ``.pth`` state dict through
                                  ``torch.load``
  * 'latest'                   -> newest run dir (by mtime) under
                                  projects/<p>/models/<module>/ containing a
                                  final checkpoint
  * 'ecoset' / a pretrain name -> pretrained/<name>/EfficientTrack_*.pth
  * None                       -> nothing to load (the caller initializes)

Weights come back as state dicts under the reference torch names, which the
port's modules carry, overlaid on ``init_state`` (a missing key keeps its
initial value: the reference's ``strict=False`` load). Saving checkpoints
belongs to training, which the port does not have yet.
"""

from __future__ import annotations

import os

import torch

from ..models.weights import params_from_jax
from ..utils import clp
from ..utils.ckpt_io import read_ckpt

# the head of an EfficientTrack: its shapes follow the joint count
_HEAD = ("deconv1.weight", "final_conv1.weight", "final_conv2.weight")


def _latest_run_file(search_path: str, final_names: list[str]) -> str | None:
    """Newest run dir (mtime-sorted) containing a final checkpoint
    (reference: efficienttrack.py:165-183)."""
    if not os.path.isdir(search_path):
        return None
    dirs = [os.path.join(search_path, d) for d in os.listdir(search_path)]
    dirs = [d for d in dirs if os.path.isdir(d)]
    dirs.sort(key=os.path.getmtime, reverse=True)
    for d in dirs:
        for name in final_names:
            p = os.path.join(d, name)
            if os.path.isfile(p):
                return p
    return None


def get_latest_weights(cfg, module: str) -> str | None:
    """module in {'CenterDetect', 'KeypointDetect', 'HybridNet'}."""
    sub_cfg = cfg[module.upper()] if module != "HybridNet" else cfg.KEYPOINTDETECT
    size = sub_cfg.MODEL_SIZE
    search = os.path.join(
        cfg.PARENT_DIR, "projects", cfg.PROJECT_NAME, "models", module
    )
    if module == "HybridNet":
        names = [f"HybridNet-{size}_final.ckpt", f"HybridNet-{size}_final.pth"]
    else:
        names = [
            f"EfficientTrack-{size}_final.ckpt",
            f"EfficientTrack-{size}_final.pth",
        ]
    return _latest_run_file(search, names)


def load_torch_state_dict(path: str) -> dict:
    """A reference ``.pth`` state dict as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def merge_state(target: dict | None, loaded: dict) -> dict:
    """``loaded`` overlaid on ``target``, keeping only the keys that
    ``target`` names (the reference's ``strict=False`` load)."""
    if target is None:
        return dict(loaded)
    out = dict(target)
    out.update({k: v for k, v in loaded.items() if k in target})
    return out


def load_efficienttrack_state(
    cfg,
    module: str,  # 'CenterDetect' or 'KeypointDetect'
    weights: str | None,
    init_state: dict | None = None,
) -> dict | None:
    """Resolve + load EfficientTrack weights into a state dict.

    ``init_state`` (the module's initial state dict) takes partial loads
    (pretrains with differing head joints) and is returned updated.
    Returns None when ``weights`` is None (the caller keeps its own init).
    """
    sub_cfg = cfg[module.upper()]
    size = sub_cfg.MODEL_SIZE
    num_joints = int(sub_cfg.NUM_JOINTS)

    path = weights
    is_ecoset = weights in ("ecoset", "EcoSet")
    if weights == "latest":
        path = get_latest_weights(cfg, module)
        if path is None:
            # reference behavior: warn and proceed from random init
            # (train_interface.py:92-97)
            clp.warning("Could not find previously saved weights, "
                        "using random initialization instead")
            return init_state
    elif is_ecoset:
        path = os.path.join(cfg.PARENT_DIR, "pretrained", "EcoSet",
                            f"EfficientTrack-{size}.pth")
    elif weights is not None and not os.path.isfile(weights):
        # a pose-pretrain name (reference: efficienttrack.py:138-162)
        prefix = ("EfficientTrack_Center" if module == "CenterDetect"
                  else "EfficientTrack_Keypoints")
        cand = os.path.join(cfg.PARENT_DIR, "pretrained", weights,
                            f"{prefix}-{size}.pth")
        if os.path.isfile(cand):
            path = cand

    if path is None:
        return None
    if not os.path.isfile(path):
        clp.warning(f"Could not load weights: {path}")
        return None

    if path.endswith(".pth"):
        loaded = load_torch_state_dict(path)
        # the reference drops the head when its joint count differs
        # (efficienttrack.py:100-106): it keeps its initial values
        if loaded["final_conv1.weight"].shape[0] != num_joints:
            loaded = {k: v for k, v in loaded.items() if k not in _HEAD}
        if is_ecoset:
            # the reference re-initializes final_conv1 and the merge head's
            # pointwise conv when transferring from EcoSet
            # (efficienttrack.py:125-129); the depthwise conv is kept
            loaded = {k: v for k, v in loaded.items()
                      if k != "final_conv1.weight"
                      and not k.startswith("first_conv.pointwise_conv.")}
    else:
        loaded = params_from_jax(read_ckpt(path), size)
    clp.info(f"Successfully loaded weights: {path}")
    return merge_state(init_state, loaded)


def load_hybridnet_state(
    cfg,
    weights: str | None,
    init_state: dict | None = None,
    efficienttrack_weights: str | None = None,
) -> dict | None:
    """Resolve + load HybridNet weights (optionally seeding the embedded
    2D net from a KeypointDetect checkpoint, train_interface.py:166-179)."""
    size = cfg.KEYPOINTDETECT.MODEL_SIZE
    state = init_state

    if efficienttrack_weights is not None and state is not None:
        et_init = {k[len("effTrack."):]: v for k, v in state.items()
                   if k.startswith("effTrack.")}
        et = load_efficienttrack_state(cfg, "KeypointDetect",
                                       efficienttrack_weights, init_state=et_init)
        if et is not None:
            state = merge_state(state, {"effTrack." + k: v for k, v in et.items()})

    path = weights
    if weights == "latest":
        path = get_latest_weights(cfg, "HybridNet")
        if path is None:
            clp.warning("No saved HybridNet weights found.")
            return state
    elif weights is not None and not os.path.isfile(weights):
        cand = os.path.join(cfg.PARENT_DIR, "pretrained", weights,
                            f"HybridNet-{size}.pth")
        if os.path.isfile(cand):
            path = cand

    if path is None:
        return state
    if not os.path.isfile(path):
        # an explicitly requested checkpoint that does not exist is an
        # error (reference aborts, train_interface.py:196-199)
        clp.warning(f"Could not load HybridNet weights: {path}")
        return None

    if path.endswith(".pth"):
        loaded = {k: v for k, v in load_torch_state_dict(path).items()
                  if k.startswith(("effTrack.", "v2vNet."))}
    else:
        loaded = params_from_jax(read_ckpt(path), size)
    clp.info(f"Loaded HybridNet weights: {path}")
    return merge_state(init_state, loaded)
