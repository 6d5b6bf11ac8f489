"""Modified EfficientNet backbone (port of
``jarvis_hybridnet_tpu/models/efficientnet.py``).

The reference's deliberate deviations from stock EfficientNet are kept:
InstanceNorm instead of BatchNorm; blocks of stages 0-3 use a full conv from
``in`` to ``in * expand`` channels and never apply their expand conv (the
parameter exists, so reference state dicts load strictly); stages >= 4 feed
the expand conv straight into the depthwise conv with no norm or
activation; the squeeze-and-excitation block; the non-standard scaling
table; and the FPN wrapper's truncation before the last stride-2 block,
tapping the three maps that precede each downsampling block. In training
mode a block with an identity skip applies the JAX package's per-sample
drop-connect at rate 0.2 * index / blocks (efficientnet.py:185-186, 224),
drawn from its ``generator``; it is inert in ``eval()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from torch import nn

from ..kernels import se_gate
from .layers import conv, drop_connect, instance_norm, silu

# kernel, repeats, in, out, expand, stride, se_ratio (EfficientNet-B0)
_BASE_STAGES = [
    (3, 1, 32, 16, 1, 1, 0.25),
    (3, 2, 16, 24, 6, 2, 0.25),
    (5, 2, 24, 40, 6, 2, 0.25),
    (3, 3, 40, 80, 6, 2, 0.25),
    (5, 3, 80, 112, 6, 1, 0.25),
    (5, 4, 112, 192, 6, 2, 0.25),
    (3, 1, 192, 320, 6, 1, 0.25),
]
_SCALING = {0: (0.5, 0.5), 1: (1.0, 1.0), 2: (1.0, 1.1), 3: (1.1, 1.2)}
_PADDING = {1: 0, 3: 1, 5: 2}
DROP_CONNECT_RATE = 0.2


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    filters *= width
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


@dataclass(frozen=True)
class BlockSpec:
    stage_idx: int
    kernel: int
    stride: int
    in_filters: int
    out_filters: int
    expand: int
    se_ratio: float
    id_skip: bool = True


def build_block_plan(compound_coef: int) -> tuple[int, list[BlockSpec]]:
    """(stem filters, per-block specs of the full network)."""
    width, depth = _SCALING[compound_coef]
    stem = round_filters(32, width)
    blocks: list[BlockSpec] = []
    for stage_idx, (k, r, ci, co, e, s, se) in enumerate(_BASE_STAGES):
        ci_s = round_filters(ci, width)
        co_s = round_filters(co, width)
        blocks.append(BlockSpec(stage_idx, k, s, ci_s, co_s, e, se))
        for _ in range(round_repeats(r, depth) - 1):
            blocks.append(BlockSpec(stage_idx, k, 1, co_s, co_s, e, se))
    return stem, blocks


def truncate_and_tap(blocks: list[BlockSpec]) -> tuple[list[BlockSpec], list[int]]:
    """Cut before the last stride-2 block; tap before each stride-2 block
    (the first excepted). Returns (truncated blocks, tap indices)."""
    save_idxs = []
    ignore_first = True
    last_idx = 0
    for idx, b in enumerate(blocks):
        is_s2 = b.stride == 2
        if ignore_first and is_s2:
            ignore_first = False
            save_idxs.append(False)
        else:
            save_idxs.append(is_s2)
            if is_s2:
                last_idx = idx - 1
    truncated = blocks[: last_idx + 1]
    taps = [i for i in range(len(truncated)) if save_idxs[i + 1]]
    return truncated, taps


class MBConvBlock(nn.Module):
    """Mobile inverted residual block (reference efficientnet.py:22-123)."""

    generator = None
    draw_shard = None  # layers.set_draw_shard

    def __init__(self, spec: BlockSpec, drop_rate: float = 0.0):
        super().__init__()
        self.spec = spec
        self.drop_rate = drop_rate
        cin, oup, k = spec.in_filters, spec.in_filters * spec.expand, spec.kernel
        pad = _PADDING[k]
        if spec.expand != 1:
            # applied only from stage 4 on; dead (but present) before that
            self._expand_conv = nn.Conv2d(cin, oup, 1, bias=False)
        if spec.stage_idx < 4:
            self._depthwise_conv = nn.Conv2d(cin, oup, k, spec.stride, pad,
                                             bias=False)
        else:
            self._depthwise_conv = nn.Conv2d(oup, oup, k, spec.stride, pad,
                                             groups=oup, bias=False)
        squeezed = max(1, int(cin * spec.se_ratio))
        self._se_reduce = nn.Conv2d(oup, squeezed, 1)
        self._se_expand = nn.Conv2d(squeezed, oup, 1)
        self._project_conv = nn.Conv2d(oup, spec.out_filters, 1, bias=False)

    def forward(self, x):
        spec = self.spec
        inputs = x
        if spec.stage_idx >= 4 and spec.expand != 1:
            x = conv(self._expand_conv, x)
        x = instance_norm(conv(self._depthwise_conv, x), "silu")
        se = x.mean(dim=(2, 3), keepdim=True)
        se = conv(self._se_expand, silu(conv(self._se_reduce, se)))
        x = se_gate(x, se)  # sigmoid(se) * x: K14 where nothing records a graph
        x = instance_norm(conv(self._project_conv, x))
        if spec.id_skip and spec.stride == 1 and spec.in_filters == spec.out_filters:
            if self.training and self.drop_rate:
                x = drop_connect(x, self.drop_rate, self.generator, shard=self.draw_shard)
            x = x + inputs
        return x


class _Model(nn.Module):
    def __init__(self, stem: int, blocks: list[BlockSpec]):
        super().__init__()
        self._conv_stem = nn.Conv2d(3, stem, 3, 2, 1, bias=False)
        self._blocks = nn.ModuleList(
            MBConvBlock(s, DROP_CONNECT_RATE * i / len(blocks)) for i, s in enumerate(blocks))


class EfficientNetFeatures(nn.Module):
    """Truncated EfficientNet returning [P3 (/4), P4 (/8), P5 (/16)]."""

    def __init__(self, compound_coef: int):
        super().__init__()
        stem, full = build_block_plan(compound_coef)
        blocks, taps = truncate_and_tap(full)
        self.model = _Model(stem, blocks)
        self.taps = set(taps)

    def forward(self, x):
        x = instance_norm(conv(self.model._conv_stem, x), "silu")
        features = []
        for idx, block in enumerate(self.model._blocks):
            x = block(x)
            if idx in self.taps:
                features.append(x)
        return features
