"""Weighted bidirectional FPN (port of ``jarvis_hybridnet_tpu/models/bifpn.py``).

Five levels P3-P7, a top-down then a bottom-up pass; every fusion is gated by
ReLU-ed learned scalars normalized to sum one (+1e-4) and every node is a
depthwise-separable conv with InstanceNorm. The first cell also builds P6/P7
from P5 and has 1x1 channel-matching convs.

As in the JAX package, a fusion multiplies float32 weights into its inputs,
so the fused sum and its SiLU are float32; the next conv casts to its dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import SeparableConvBlock, conv, instance_norm, max_pool_2x2, silu, upsample_nearest

_UP = ("conv6_up", "conv5_up", "conv4_up", "conv3_up")
_DOWN = ("conv4_down", "conv5_down", "conv6_down", "conv7_down")
_FUSION = {"p6_w1": 2, "p5_w1": 2, "p4_w1": 2, "p3_w1": 2,
           "p4_w2": 3, "p5_w2": 3, "p6_w2": 3, "p7_w2": 2}
_CHANNEL_IN = {"p3_down_channel": 0, "p4_down_channel": 1, "p5_down_channel": 2,
               "p5_to_p6": 2, "p4_down_channel_2": 1, "p5_down_channel_2": 2}


def _fuse(w: torch.Tensor, *xs: torch.Tensor) -> torch.Tensor:
    w = torch.clamp_min(w, 0.0)
    w = w / (w.sum() + 1e-4)
    out = w[0] * xs[0].float()
    for i in range(1, len(xs)):
        out = out + w[i] * xs[i].float()
    return silu(out)


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
        return instance_norm(conv(getattr(self, name)[0], x))

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

        p6_up = self.conv6_up(_fuse(self.p6_w1, p6_in, upsample_nearest(p7_in, 2)))
        p5_up = self.conv5_up(_fuse(self.p5_w1, p5_in, upsample_nearest(p6_up, 2)))
        p4_up = self.conv4_up(_fuse(self.p4_w1, p4_in, upsample_nearest(p5_up, 2)))
        p3_out = self.conv3_up(_fuse(self.p3_w1, p3_in, upsample_nearest(p4_up, 2)))

        if self.first:
            p4_in = self._down_channel("p4_down_channel_2", p4)
            p5_in = self._down_channel("p5_down_channel_2", p5)

        p4_out = self.conv4_down(_fuse(self.p4_w2, p4_in, p4_up, max_pool_2x2(p3_out)))
        p5_out = self.conv5_down(_fuse(self.p5_w2, p5_in, p5_up, max_pool_2x2(p4_out)))
        p6_out = self.conv6_down(_fuse(self.p6_w2, p6_in, p6_up, max_pool_2x2(p5_out)))
        p7_out = self.conv7_down(_fuse(self.p7_w2, p7_in, max_pool_2x2(p6_out)))
        return p3_out, p4_out, p5_out, p6_out, p7_out
