"""JAX parameter trees <-> the port's state dicts.

The port's modules carry the reference torch parameter names, the names
``jarvis_hybridnet_tpu/models/weights_io.py`` emits for the reference
(``efficienttrack_params_to_torch``, ``v2v_params_to_torch``,
``hybridnet_params_to_torch``). Layout rules (weights_io.py:28-43):

  * conv kernel  (kH, kW, I, O)        -> weight (O, I, kH, kW)
  * depthwise    (kH, kW, 1, C)        -> weight (C, 1, kH, kW)
  * conv_transpose (kH, kW, O, I)      -> weight (I, O, kH, kW)
  * 3D conv      (kD, kH, kW, I, O)    -> weight (O, I, kD, kH, kW)
  * 3D deconv    (kD, kH, kW, O, I)    -> weight (I, O, kD, kH, kW)

Every one of them is the same axis reversal of the last two axes in front
of the spatial ones. Dead reference parameters the JAX tree does not hold
(``final_conv2``, the stage < 4 ``_expand_conv``) come out as zeros, and
:func:`params_to_jax` leaves them out again.
"""

from __future__ import annotations

import numpy as np
import torch

from .efficientnet import build_block_plan, truncate_and_tap
from .efficienttrack import MODEL_SIZES

_V2V_MAP = {
    ("front_basic", "conv"): "front_layers.0.block.0",
    ("front_res", "conv1"): "front_layers.1.res_branch.0",
    ("front_res", "conv2"): "front_layers.1.res_branch.3",
    ("skip_res1", "conv1"): "encoder_decoder.skip_res1.res_branch.0",
    ("skip_res1", "conv2"): "encoder_decoder.skip_res1.res_branch.3",
    ("encoder_pool1", "conv"): "encoder_decoder.encoder_pool1.block.0",
    ("mid_res", "conv1"): "encoder_decoder.mid_res.res_branch.0",
    ("mid_res", "conv2"): "encoder_decoder.mid_res.res_branch.3",
    ("decoder_upsample1", "deconv"): "encoder_decoder.decoder_upsample1.block.0",
    ("decoder_res1", "conv1"): "encoder_decoder.decoder_res1.res_branch.0",
    ("decoder_res1", "conv2"): "encoder_decoder.decoder_res1.res_branch.3",
    ("output_layer",): "output_layer",
}
_FUSION = ("p6_w1", "p5_w1", "p4_w1", "p3_w1", "p4_w2", "p5_w2", "p6_w2", "p7_w2")
_SEPARABLE = ("conv6_up", "conv5_up", "conv4_up", "conv3_up",
              "conv4_down", "conv5_down", "conv6_down", "conv7_down")
_DOWN_CHANNEL = ("p3_down_channel", "p4_down_channel", "p5_down_channel",
                 "p5_to_p6", "p4_down_channel_2", "p5_down_channel_2")


def _kernel(k) -> np.ndarray:
    """Spatial-first JAX kernel (*k, A, B) -> torch layout (B, A, *k)."""
    k = np.asarray(k, np.float32)
    r = k.ndim
    return k.transpose(r - 1, r - 2, *range(r - 2))


def _get(tree, *path):
    for p in path:
        tree = tree[p]
    return tree


def efficienttrack_params_from_jax(tree: dict, model_size: str) -> dict:
    """numpy state dict (reference names) of an EfficientTrack tree."""
    spec = MODEL_SIZES[model_size]
    _, full = build_block_plan(spec.compound_coef)
    blocks, _ = truncate_and_tap(full)
    sd = {"weights_cat": np.asarray(tree["weights_cat"], np.float32)}
    bb = tree["backbone_net"]
    sd["backbone_net.model._conv_stem.weight"] = _kernel(bb["_conv_stem"]["kernel"])
    for i, b in enumerate(blocks):
        src, dst = bb[f"_blocks_{i}"], f"backbone_net.model._blocks.{i}."
        sd[dst + "_depthwise_conv.weight"] = _kernel(src["_depthwise_conv"]["kernel"])
        if b.expand != 1:
            sd[dst + "_expand_conv.weight"] = (
                _kernel(src["_expand_conv"]["kernel"]) if b.stage_idx >= 4 else
                np.zeros((b.in_filters * b.expand, b.in_filters, 1, 1), np.float32))
        for se in ("_se_reduce", "_se_expand"):
            sd[dst + se + ".weight"] = _kernel(src[se]["kernel"])
            sd[dst + se + ".bias"] = np.asarray(src[se]["bias"], np.float32)
        sd[dst + "_project_conv.weight"] = _kernel(src["_project_conv"]["kernel"])
    for i in range(spec.fpn_cell_repeats):
        cell, dst = tree[f"bifpn_{i}"], f"bifpn.{i}."
        for name in _FUSION:
            sd[dst + name] = np.asarray(cell[name]["w"], np.float32)
        for name in _SEPARABLE:
            for part in ("depthwise_conv", "pointwise_conv"):
                sd[f"{dst}{name}.{part}.weight"] = _kernel(cell[name][part]["kernel"])
            sd[f"{dst}{name}.pointwise_conv.bias"] = np.asarray(
                cell[name]["pointwise_conv"]["bias"], np.float32)
        if i == 0:
            for name in _DOWN_CHANNEL:
                sd[f"{dst}{name}.0.weight"] = _kernel(cell[name]["conv"]["kernel"])
                sd[f"{dst}{name}.0.bias"] = np.asarray(cell[name]["conv"]["bias"],
                                                       np.float32)
    for part in ("depthwise_conv", "pointwise_conv"):
        sd[f"first_conv.{part}.weight"] = _kernel(tree["first_conv"][part]["kernel"])
    sd["first_conv.pointwise_conv.bias"] = np.asarray(
        tree["first_conv"]["pointwise_conv"]["bias"], np.float32)
    sd["deconv1.weight"] = _kernel(tree["deconv1"]["kernel"])
    final1 = _kernel(tree["final_conv1"]["kernel"])
    sd["final_conv1.weight"] = final1
    sd["final_conv2.weight"] = np.zeros(final1.shape[:2] + (1, 1), np.float32)
    return sd


def v2v_params_from_jax(tree: dict, prefix: str = "") -> dict:
    sd = {}
    for path, name in _V2V_MAP.items():
        node = _get(tree, *path)
        sd[prefix + name + ".weight"] = _kernel(node["kernel"])
        sd[prefix + name + ".bias"] = np.asarray(node["bias"], np.float32)
    return sd


def params_from_jax(tree: dict, model_size: str) -> dict:
    """State dict (torch tensors) of a JAX EfficientTrack tree, or of a
    HybridNet tree (``effTrack`` + ``v2vNet``)."""
    if "v2vNet" in tree:
        sd = {"effTrack." + k: v for k, v in
              efficienttrack_params_from_jax(tree["effTrack"], model_size).items()}
        sd.update(v2v_params_from_jax(tree["v2vNet"], prefix="v2vNet."))
    else:
        sd = efficienttrack_params_from_jax(tree, model_size)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _unkernel(w) -> np.ndarray:
    """Torch layout (B, A, *k) -> the JAX kernel (*k, A, B)."""
    w = _numpy(w)
    r = w.ndim
    return np.ascontiguousarray(w.transpose(*range(2, r), 1, 0))


def _numpy(v) -> np.ndarray:
    return np.ascontiguousarray(v.detach().cpu().float().numpy() if hasattr(v, "detach")
                                else np.asarray(v, np.float32))


def efficienttrack_params_to_jax(sd: dict, model_size: str, prefix: str = "") -> dict:
    """The JAX EfficientTrack tree of a state dict (reference names)."""
    spec = MODEL_SIZES[model_size]
    _, full = build_block_plan(spec.compound_coef)
    blocks, _ = truncate_and_tap(full)
    w = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    bb = {"_conv_stem": {"kernel": _unkernel(w["backbone_net.model._conv_stem.weight"])}}
    for i, b in enumerate(blocks):
        src, dst = f"backbone_net.model._blocks.{i}.", {}
        dst["_depthwise_conv"] = {"kernel": _unkernel(w[src + "_depthwise_conv.weight"])}
        if b.expand != 1 and b.stage_idx >= 4:
            dst["_expand_conv"] = {"kernel": _unkernel(w[src + "_expand_conv.weight"])}
        for se in ("_se_reduce", "_se_expand"):
            dst[se] = {"kernel": _unkernel(w[src + se + ".weight"]),
                       "bias": _numpy(w[src + se + ".bias"])}
        dst["_project_conv"] = {"kernel": _unkernel(w[src + "_project_conv.weight"])}
        bb[f"_blocks_{i}"] = dst
    tree = {"backbone_net": bb}
    for i in range(spec.fpn_cell_repeats):
        src, cell = f"bifpn.{i}.", {}
        for name in _FUSION:
            cell[name] = {"w": _numpy(w[src + name])}
        for name in _SEPARABLE:
            cell[name] = {
                "depthwise_conv": {"kernel": _unkernel(w[f"{src}{name}.depthwise_conv.weight"])},
                "pointwise_conv": {"kernel": _unkernel(w[f"{src}{name}.pointwise_conv.weight"]),
                                   "bias": _numpy(w[f"{src}{name}.pointwise_conv.bias"])}}
        if i == 0:
            for name in _DOWN_CHANNEL:
                cell[name] = {"conv": {"kernel": _unkernel(w[f"{src}{name}.0.weight"]),
                                       "bias": _numpy(w[f"{src}{name}.0.bias"])}}
        tree[f"bifpn_{i}"] = cell
    tree["first_conv"] = {
        "depthwise_conv": {"kernel": _unkernel(w["first_conv.depthwise_conv.weight"])},
        "pointwise_conv": {"kernel": _unkernel(w["first_conv.pointwise_conv.weight"]),
                           "bias": _numpy(w["first_conv.pointwise_conv.bias"])}}
    tree["deconv1"] = {"kernel": _unkernel(w["deconv1.weight"])}
    tree["final_conv1"] = {"kernel": _unkernel(w["final_conv1.weight"])}
    tree["weights_cat"] = _numpy(w["weights_cat"])
    return tree


def v2v_params_to_jax(sd: dict, prefix: str = "") -> dict:
    tree: dict = {}
    for path, name in _V2V_MAP.items():
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["kernel"] = _unkernel(sd[prefix + name + ".weight"])
        node["bias"] = _numpy(sd[prefix + name + ".bias"])
    return tree


def params_to_jax(sd: dict, model_size: str) -> dict:
    """The inverse of :func:`params_from_jax`: the JAX parameter tree (numpy
    float32 leaves) of a HybridNet state dict (``effTrack.*`` and
    ``v2vNet.*``) or of an EfficientTrack one."""
    if any(k.startswith("v2vNet.") for k in sd):
        return {"effTrack": efficienttrack_params_to_jax(sd, model_size, prefix="effTrack."),
                "v2vNet": v2v_params_to_jax(sd, prefix="v2vNet.")}
    return efficienttrack_params_to_jax(sd, model_size)
