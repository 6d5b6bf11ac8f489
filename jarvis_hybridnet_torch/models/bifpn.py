"""Weighted bidirectional FPN (port of ``jarvis_hybridnet_tpu/models/bifpn.py``).

Five levels P3-P7, a top-down then a bottom-up pass; every fusion is gated by
ReLU-ed learned scalars normalized to sum one (+1e-4) and every node is a
depthwise-separable conv with InstanceNorm. The first cell also builds P6/P7
from P5 and has 1x1 channel-matching convs.

As in the JAX package, a fusion multiplies float32 weights into its inputs,
so the fused sum and its SiLU are float32; the next conv casts to its dtype.
Each fusion is one call of K13 (``kernels.weighted_fuse``), which reads the
upsampled and pooled inputs in place and, where nothing records a graph,
writes the result in the inputs' dtype (the next conv's cast: the same
bits).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import weighted_fuse
from ..kernels.weighted_fuse import max_pool_2x2
from .layers import SeparableConvBlock, conv_norm

_UP = ("conv6_up", "conv5_up", "conv4_up", "conv3_up")
_DOWN = ("conv4_down", "conv5_down", "conv6_down", "conv7_down")
_FUSION = {"p6_w1": 2, "p5_w1": 2, "p4_w1": 2, "p3_w1": 2,
           "p4_w2": 3, "p5_w2": 3, "p6_w2": 3, "p7_w2": 2}
_CHANNEL_IN = {"p3_down_channel": 0, "p4_down_channel": 1, "p5_down_channel": 2,
               "p5_to_p6": 2, "p4_down_channel_2": 1, "p5_down_channel_2": 2}


class BiFPN(nn.Module):
    """One BiFPN cell; ``in_channels`` (P3, P4, P5 widths) makes it the
    first cell, with the input-transition convs."""

    def __init__(self, num_channels: int, in_channels: tuple[int, int, int] | None = None):
        super().__init__()
        self.first = in_channels is not None
        for name, n in _FUSION.items():
            setattr(self, name, nn.Parameter(torch.ones(n)))
        for name in _UP + _DOWN:
            setattr(self, name, SeparableConvBlock(num_channels, num_channels))
        if self.first:
            for name, level in _CHANNEL_IN.items():
                setattr(self, name, nn.ModuleList(
                    [nn.Conv2d(in_channels[level], num_channels, 1)]))

    def _down_channel(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return conv_norm(getattr(self, name)[0], x)

    def forward(self, inputs):
        if self.first:
            p3, p4, p5 = inputs
            p6_in = max_pool_2x2(self._down_channel("p5_to_p6", p5))
            p7_in = max_pool_2x2(p6_in)
            p3_in = self._down_channel("p3_down_channel", p3)
            p4_in = self._down_channel("p4_down_channel", p4)
            p5_in = self._down_channel("p5_down_channel", p5)
        else:
            p3_in, p4_in, p5_in, p6_in, p7_in = inputs

        up, down = ("same", "up2"), ("same", "same", "pool")
        p6_up = self.conv6_up(weighted_fuse(self.p6_w1, (p6_in, p7_in), up))
        p5_up = self.conv5_up(weighted_fuse(self.p5_w1, (p5_in, p6_up), up))
        p4_up = self.conv4_up(weighted_fuse(self.p4_w1, (p4_in, p5_up), up))
        p3_out = self.conv3_up(weighted_fuse(self.p3_w1, (p3_in, p4_up), up))

        if self.first:
            p4_in = self._down_channel("p4_down_channel_2", p4)
            p5_in = self._down_channel("p5_down_channel_2", p5)

        p4_out = self.conv4_down(weighted_fuse(self.p4_w2, (p4_in, p4_up, p3_out), down))
        p5_out = self.conv5_down(weighted_fuse(self.p5_w2, (p5_in, p5_up, p4_out), down))
        p6_out = self.conv6_down(weighted_fuse(self.p6_w2, (p6_in, p6_up, p5_out), down))
        p7_out = self.conv7_down(weighted_fuse(self.p7_w2, (p7_in, p6_out), ("same", "pool")))
        return p3_out, p4_out, p5_out, p6_out, p7_out
