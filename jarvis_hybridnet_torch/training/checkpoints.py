"""Checkpoints and reference-compatible weight resolution (port of
``jarvis_hybridnet_tpu/training/checkpoints.py``).

Writing (``checkpoints.py:30-84``): ``.ckpt`` files hold the JAX package's
parameter tree (``models/weights.params_to_jax``) in flax's msgpack format
(``utils/ckpt_io.write_ckpt``), so its ``load_checkpoint`` reads what the
port trains; ``.pth`` files hold the state dict under the reference torch
names, as the JAX package's ``save_torch_checkpoint`` writes them. A train
state is the JAX package's (``checkpoints.py:44-68``): ``{"params": <the JAX
tree>, "opt_state": <flax's to_state_dict of the optax state>, "epoch"}``,
the optimizer state converted by ``optim.optax_state``. Either package
resumes a train state that the other wrote (``optim.load_optax_state``); a
file in the port's earlier layout (``opt_state: {"optimizer": torch's
Optimizer.state_dict(), "step"}``) still loads.

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
initial value: the reference's ``strict=False`` load).
"""

from __future__ import annotations

import os

import torch

import numpy as np

from ..models.weights import params_from_jax, params_to_jax
from ..utils import clp
from ..utils.ckpt_io import read_ckpt, write_ckpt
from . import optim

# the head of an EfficientTrack: its shapes follow the joint count
_HEAD = ("deconv1.weight", "final_conv1.weight", "final_conv2.weight")


def save_checkpoint(state: dict, path: str, model_size: str) -> None:
    """Write a state dict as a ``.ckpt`` in the JAX package's tree."""
    write_ckpt(path, params_to_jax(state, model_size))


def load_checkpoint(path: str) -> dict:
    """The raw tree of a ``.ckpt`` (numpy leaves)."""
    return read_ckpt(path)


def _from_optimizer_tree(tree: dict) -> dict:
    """``Optimizer.state_dict()`` of the port's earlier train-state layout
    (tensors as numpy, int keys as strings, a group's lr as a float)."""
    def value(v):
        return torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v

    state = {int(k): {name: value(v) for name, v in entry.items()}
             for k, entry in tree["state"].items()}
    groups = [{k: (tuple(v) if k == "betas" else v) for k, v in g.items()}
              for g in tree["param_groups"]]
    return {"state": state, "param_groups": groups}


def save_train_state(path: str, state: dict, opt_state: dict, epoch: int,
                     model_size: str) -> None:
    """Full training state for a mid-run resume, as the JAX package writes
    it: params (the JAX tree of ``state``), the optimizer state in flax's
    layout (``optim.optax_state``) and the epoch."""
    write_ckpt(path, {
        "params": params_to_jax(state, model_size),
        "opt_state": opt_state,
        "epoch": int(epoch),
    })


def load_train_state(path: str, model_size: str):
    """(state dict, optimizer state, epoch) of a train state either package
    wrote: the optimizer state in flax's layout (numpy leaves), or, from a
    file of the port's earlier layout, ``{"optimizer": Optimizer.state_dict(),
    "step": int}``. :func:`restore_optimizer` takes both."""
    tree = read_ckpt(path)
    opt = tree["opt_state"]
    if "optimizer" in opt:
        opt = {"optimizer": _from_optimizer_tree(opt["optimizer"]), "step": int(opt["step"])}
    return params_from_jax(tree["params"], model_size), opt, int(tree["epoch"])


def restore_optimizer(optimizer, names: list[str], opt_state: dict, state: dict,
                      model_size: str) -> int:
    """Load :func:`load_train_state`'s optimizer state into ``optimizer``
    (over the parameters ``names``, the model's ``state`` giving the
    shapes) and return the step count to resume from."""
    if "optimizer" in opt_state:
        optim.load_optimizer_state(optimizer, opt_state["optimizer"])
        return int(opt_state["step"])
    return optim.load_optax_state(optimizer, names, opt_state, state, model_size)


def save_torch_checkpoint(state: dict, path: str) -> None:
    """Write a state dict as a reference-loadable ``.pth`` (float32 CPU
    tensors under the reference names)."""
    tensors = {k: v.detach().cpu().float().contiguous() for k, v in state.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(tensors, path)


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


def get_latest_train_state(cfg, module: str) -> str | None:
    """Newest run's resumable ``train_state.ckpt`` (periodic epoch saves and
    the preemption path both write it) under the project's
    ``models/<module>/``, where both packages' trainers keep their runs: the
    port resumes a run of either."""
    search = os.path.join(
        cfg.PARENT_DIR, "projects", cfg.PROJECT_NAME, "models", module
    )
    return _latest_run_file(search, ["train_state.ckpt"])


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
