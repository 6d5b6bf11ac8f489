"""Heatmap decoding (port of ``jarvis_hybridnet_tpu/ops/heatmap.py``)."""

from __future__ import annotations

import torch


def argmax_2d(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel spatial argmax of (..., H, W, C) NHWC heatmaps.

    Returns (xy (..., C, 2) int32, maxvals (..., C)): the first maximal
    index m in row-major order, x = m % W, y = m // W.
    """
    h, w, c = heatmaps.shape[-3:]
    flat = torch.movedim(heatmaps, -1, -3).reshape(*heatmaps.shape[:-3], c, h * w)
    maxvals, m = flat.max(dim=-1)
    xy = torch.stack([m % w, torch.div(m, w, rounding_mode="floor")], dim=-1)
    return xy.to(torch.int32), maxvals
