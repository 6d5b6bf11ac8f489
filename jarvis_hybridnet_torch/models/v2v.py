"""V2V-PoseNet-style 3D CNN (port of ``jarvis_hybridnet_tpu/models/v2v.py``).

Module and parameter names are those of the reference torch V2VNet
(jarvis/hybridnet/v2vnet.py), so its state dicts load strictly:
``front_layers.{0: Basic3DBlock, 1: Res3DBlock}``, ``encoder_decoder.*`` and
``output_layer``; a Basic3DBlock's conv is ``block.0`` and a Res3DBlock's
convs are ``res_branch.0`` and ``res_branch.3``. InstanceNorm + ReLU (and
the residual add) run through K1 (K6 for the gradient). Every block ends in
the JAX package's ``Dropout(0.2)`` (v2v.py:94, 114, 126), drawn from the
block's ``generator`` in training mode and inert in ``eval()``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_upfront import fused_up_conv3d, prepare_fused_weights
from .layers import compute_dtype, conv, conv_norm, dropout, instance_norm, records_grad

DROPOUT = 0.2


class _Dropped(nn.Module):
    """A block whose output goes through ``Dropout(DROPOUT)`` in training
    mode, with masks from ``generator`` (set by ``layers.set_generator``)."""

    generator = None
    draw_shard = None  # layers.set_draw_shard

    def drop(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, DROPOUT, self.generator, shard=self.draw_shard) if self.training else x


class Basic3DBlock(_Dropped):
    """conv -> IN -> ReLU -> dropout. With ``fused_up`` the input is the
    half-res volume and the conv is the exact fused up2 + stride-2 conv."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 fused_up: bool = False):
        super().__init__()
        self.block = nn.ModuleList(
            [nn.Conv3d(cin, cout, kernel, stride, (kernel - 1) // 2)])
        # the fused kernels are transformed from the float32 weight and
        # rounded once to the compute dtype, as JAX's fused_up_conv3d does
        self.block[0].transformed = fused_up
        self.fused_up = fused_up
        self._fused = None  # (key, interior, corrections), built on first use

    # a trainer turns the cache off (``set_fused_cache``): its weights change
    # in place, and a CUDA graph's replay of the update leaves the host's
    # version counter of the weight where it was, so a key on it goes stale
    cache_fused = True

    def _fused_weights(self):
        """The transformed kernels in the compute dtype, from the float32
        weight. With grad enabled they are computed from the live weight in
        every call, so the weight gets their gradient; under ``no_grad``
        they are cached until the weight changes, where ``cache_fused`` is
        on, else computed in every call. Under ``torch.export`` the cache
        that :func:`fill_fused_cache` filled is read, so the traced graph
        holds the kernels the live module uses as its constants
        (``prediction/export.export_predictor``)."""
        w, dt = self.block[0].weight, compute_dtype(self.block[0])
        if torch.compiler.is_compiling() and self._fused is not None:
            return self._fused[1], self._fused[2]
        if ((torch.is_grad_enabled() and w.requires_grad) or not self.cache_fused
                or torch.compiler.is_compiling()):
            return prepare_fused_weights(w, dt)
        key = (w.data_ptr(), w._version, w.dtype, dt, w.device)
        if self._fused is None or self._fused[0] != key:
            with torch.no_grad():
                self._fused = (key, *prepare_fused_weights(w, dt))
        return self._fused[1], self._fused[2]

    def forward(self, x):
        if not self.fused_up:
            return self.drop(conv_norm(self.block[0], x, "relu"))
        interior, corr = self._fused_weights()
        bias = self.block[0].bias
        if records_grad(x, interior, bias):
            return self.drop(instance_norm(fused_up_conv3d(x, interior, corr, bias), "relu"))
        # K1 adds the bias as it reads the convolution (the bits of its add)
        y = fused_up_conv3d(x, interior, corr)
        return self.drop(instance_norm(y, "relu", bias=bias.to(y.dtype)))


def fill_fused_cache(module: nn.Module) -> nn.Module:
    """Compute the fused kernels of every fused ``Basic3DBlock`` under
    ``module`` from its current weights into its cache (turned on)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Basic3DBlock) and m.fused_up:
                m.cache_fused = True
                m._fused_weights()
    return module


def set_fused_cache(module: nn.Module, on: bool) -> nn.Module:
    """Turn the no-grad cache of the fused kernels of every
    ``Basic3DBlock`` under ``module`` on or off."""
    for m in module.modules():
        if isinstance(m, Basic3DBlock):
            m.cache_fused = on
            m._fused = None
    return module


class Res3DBlock(_Dropped):
    """relu(IN(conv2(relu(IN(conv1(x))))) + x) -> dropout."""

    def __init__(self, channels: int):
        super().__init__()
        self.res_branch = nn.ModuleDict({
            "0": nn.Conv3d(channels, channels, 3, 1, 1),
            "3": nn.Conv3d(channels, channels, 3, 1, 1),
        })

    def forward(self, x):
        res = conv_norm(self.res_branch["0"], x, "relu")
        return self.drop(conv_norm(self.res_branch["3"], res, "add_relu", skip=x))


class Upsample3DBlock(_Dropped):
    """ConvTranspose3d(k2, s2) -> IN -> ReLU -> dropout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.ModuleList([nn.ConvTranspose3d(cin, cout, 2, 2)])

    def forward(self, x):
        return self.drop(conv_norm(self.block[0], x, "relu"))


class _EncoderDecoder(nn.Module):
    def __init__(self, j: int):
        super().__init__()
        self.encoder_pool1 = Basic3DBlock(2 * j, 4 * j, 2, 2)
        self.mid_res = Res3DBlock(4 * j)
        self.decoder_upsample1 = Upsample3DBlock(4 * j, 2 * j)
        self.decoder_res1 = Res3DBlock(2 * j)
        self.skip_res1 = Res3DBlock(2 * j)

    def forward(self, x):
        skip = self.skip_res1(x)
        x = self.mid_res(self.encoder_pool1(x))
        x = self.decoder_res1(self.decoder_upsample1(x))
        return x + skip


class V2VNet(nn.Module):
    """(B, J, G, G, G) -> (B, J, G/2, G/2, G/2). With
    ``fused_upsample_front`` the input is the half-res (G/2)^3 volume."""

    def __init__(self, channels: int, fused_upsample_front: bool = False):
        super().__init__()
        j = channels
        self.front_layers = nn.ModuleList([
            Basic3DBlock(j, 2 * j, 3, 2, fused_up=fused_upsample_front),
            Res3DBlock(2 * j),
        ])
        self.encoder_decoder = _EncoderDecoder(j)
        self.output_layer = nn.Conv3d(2 * j, j, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.front_layers:
            x = layer(x)
        return conv(self.output_layer, self.encoder_decoder(x))
