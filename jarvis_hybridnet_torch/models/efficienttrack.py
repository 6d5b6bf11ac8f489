"""EfficientTrack 2D heatmap network (port of
``jarvis_hybridnet_tpu/models/efficienttrack.py``).

EfficientNet features, N BiFPN cells, a softplus-weighted merge of three
scales at P3 (stride 4), one separable conv, then two heads: ``final_conv1``
(3x3 conv, heatmap at input/4) and ``deconv1`` (ConvTranspose2d k4 s2 p1,
heatmap at input/2; K15 where nothing records a graph). ``final_conv2`` is
the reference's dead parameter, kept so reference state dicts load
strictly; it is never applied.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..kernels import heatmap_head, weighted_fuse
from .bifpn import BiFPN
from .efficientnet import EfficientNetFeatures, build_block_plan, truncate_and_tap
from .layers import SeparableConvBlock, _cast, compute_dtype, conv, records_grad


@dataclass(frozen=True)
class ModelSizeSpec:
    compound_coef: int
    fpn_num_filters: int
    fpn_cell_repeats: int
    final_layer_sizes: int


MODEL_SIZES = {
    "small": ModelSizeSpec(0, 56, 3, 64),
    "medium": ModelSizeSpec(1, 88, 4, 88),
    "large": ModelSizeSpec(3, 160, 6, 160),
}


def _tap_channels(compound_coef: int) -> tuple[int, int, int]:
    _, full = build_block_plan(compound_coef)
    blocks, taps = truncate_and_tap(full)
    return tuple(blocks[i].out_filters for i in taps)


class EfficientTrackBackbone(nn.Module):
    """Input (N, 3, S, S) normalized images; ``forward`` returns the
    (heatmap at S/4, heatmap at S/2) pair as (N, J, h, w)."""

    def __init__(self, model_size: str = "small", output_channels: int = 1):
        super().__init__()
        spec = MODEL_SIZES[model_size]
        self.backbone_net = EfficientNetFeatures(spec.compound_coef)
        n = spec.fpn_num_filters
        self.bifpn = nn.ModuleList(
            [BiFPN(n, _tap_channels(spec.compound_coef))]
            + [BiFPN(n) for _ in range(1, spec.fpn_cell_repeats)])
        self.weights_cat = nn.Parameter(torch.ones(3))
        self.first_conv = SeparableConvBlock(n, spec.final_layer_sizes)
        self.deconv1 = nn.ConvTranspose2d(spec.final_layer_sizes, output_channels,
                                          4, stride=2, padding=1, bias=False)
        self.final_conv1 = nn.Conv2d(spec.final_layer_sizes, output_channels, 3,
                                     padding=1, bias=False)
        self.final_conv2 = nn.Conv2d(spec.final_layer_sizes, output_channels, 1,
                                     bias=False)

    def merged(self, x: torch.Tensor) -> torch.Tensor:
        """Output of ``first_conv``, which both heads read. The merge of P3
        with P4 and P5 upsampled to it is one call of K13."""
        feats = self.backbone_net(x)
        for cell in self.bifpn:
            feats = cell(feats)
        x1 = weighted_fuse(self.weights_cat, feats[:3], ("same", "up2", "up4"), merge=True)
        return self.first_conv(x1)

    def head2(self, m: torch.Tensor, width: int = 0) -> torch.Tensor:
        """``deconv1`` on the merged map ``m``: K15 where nothing records a
        graph (with ``width``, straight into padded heatmap rows,
        ``heatmap_head``), else the convolution with its autograd graph
        (no rows: ``width`` must then be 0)."""
        if records_grad(m, self.deconv1.weight):
            if width:
                raise ValueError("head2: rows are written only where no graph is recorded")
            return conv(self.deconv1, m)
        dt = compute_dtype(self.deconv1)
        return heatmap_head(_cast(m, dt), _cast(self.deconv1.weight, dt), width)

    def heatmap2(self, x: torch.Tensor) -> torch.Tensor:
        """The stride-2 head alone: what both predictors consume."""
        return self.head2(self.merged(x))

    def forward(self, x: torch.Tensor):
        m = self.merged(x)
        return conv(self.final_conv1, m), self.head2(m)
