"""Image networks of the image-NPPC line: ImageUNet, ResUNet, ResCNN.

Port of generative_audio_tpu/nn/image_nets.py (reference nppc/networks.py),
NCHW, with the reference's state-dict names, which
generative_audio_tpu/utils/torch_convert.py:222-391 (convert_image_unet,
convert_res_unet, convert_res_cnn) reads:
  * ImageUNet: `encoder_blocks.{0: in-conv, 1 + level: [MaxPool2d] + n_blocks
    x (conv, GroupNorm, LeakyReLU(0.1))}`, `bottleneck.*`,
    `decoder_blocks.{level: n_blocks x (conv, GroupNorm, LeakyReLU) +
    [Upsample], n_levels: [conv, PixelShuffle]* + 1x1 out-conv}`;
  * ResUNet: `encoder_blocks.*` (the in-conv, a stride-2 conv where a level
    downsamples, a ResBlock [+ Attention] per block), `bottleneck.{0, 1, 2}`
    (ResBlock, Attention, ResBlock), `decoder_blocks.*` and the final
    (ResBlock, GroupNorm, SiLU, [conv, PixelShuffle]*, out-conv);
  * ResBlock: `block.base.{0, 1, 3, 4}` (conv, GroupNorm, SiLU, conv,
    GroupNorm, SiLU) and `block.shortcut` (a 1x1 conv where the channels
    change); Attention: `conv_in` (Conv1d, no bias) and `conv_out`;
  * ResCNN: `net.{0: in-conv, 1..n: ShortcutBlock(base=(conv, ReLU, conv)),
    n + 1: mid-conv, n + 2: the empty ShortcutBlock, [conv, PixelShuffle]*,
    out-conv}`.

Numerics pinned to the JAX modules:
  * GroupNorm's epsilon is flax's 1e-6 (torch's default is 1e-5);
  * Attention scales its logits by heads ** -0.5, not head_dim ** -0.5 (the
    reference's attn.shape[1]);
  * ResCNN's trailing ShortcutBlock has an empty base, so it doubles its
    input (x + x), as the reference's never-filled `main_layers` does.

The initial weights are torch's defaults, with the reference's
factor_weights: Attention's conv_out scaled by 1e-6 and the out-conv by
`output_factor` where given. The nets run NCHW on the card too: channels-
last weights and activations measured no faster there (chip_smoke.py
phase 19; the steps wait on the host's launches).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResBlock", "AttentionBlock", "ImageUNet",
           "ResUNet", "ResCNN", "ShortcutBlock", "pixel_shuffle"]

GN_EPS = 1e-6          # flax.linen.GroupNorm's default epsilon


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """torch.nn.PixelShuffle on [B, C * r^2, H, W] -> [B, C, H * r, W * r]:
    channel c * r^2 + i * r + j goes to pixel (h * r + i, w * r + j), the map
    the JAX pixel_shuffle makes on NHWC."""
    return F.pixel_shuffle(x, factor)


def _factor(module: nn.Module, factor: Optional[float]) -> nn.Module:
    """The reference's factor_weights: the module's initial weight and bias
    scaled by `factor` (None leaves them)."""
    if factor is not None:
        with torch.no_grad():
            module.weight.mul_(factor)
            if module.bias is not None:
                module.bias.mul_(factor)
    return module


def _conv3(n_in: int, n_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(n_in, n_out, 3, stride=stride, padding=1)


def _upscale(ch: int, factor: int) -> List[nn.Module]:
    """(conv ch -> 4 ch, PixelShuffle(2)) per factor of 2 of `factor`."""
    if factor == 1:
        return []
    n_factors = int(np.log2(factor))
    if 2 ** n_factors != factor:
        raise ValueError(f"upscale factor must be a power of 2, got {factor}")
    layers: List[nn.Module] = []
    for _ in range(n_factors):
        layers += [_conv3(ch, ch * 4), nn.PixelShuffle(2)]
    return layers


class ShortcutBlock(nn.Module):
    """shortcut(x) (x where there is none) + base(x) (reference
    networks.py:17). An empty base is the identity, so the block then
    returns 2x."""

    def __init__(self, base: nn.Module, shortcut: Optional[nn.Module] = None):
        super().__init__()
        self.base = base
        self.shortcut = shortcut

    def forward(self, x):
        return (x if self.shortcut is None else self.shortcut(x)) + self.base(x)


class ResBlock(nn.Module):
    """(conv 3x3, GroupNorm, SiLU) x 2 with a 1x1-conv shortcut where the
    channels change (reference networks.py:36)."""

    def __init__(self, dim_in: int, dim_out: int, n_groups: int = 8):
        super().__init__()
        base = nn.Sequential(
            _conv3(dim_in, dim_out), nn.GroupNorm(n_groups, dim_out, GN_EPS),
            nn.SiLU(), _conv3(dim_out, dim_out),
            nn.GroupNorm(n_groups, dim_out, GN_EPS), nn.SiLU())
        shortcut = nn.Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else None
        self.block = ShortcutBlock(base, shortcut)

    def forward(self, x):
        return self.block(x)


class AttentionBlock(nn.Module):
    """QKV self-attention over the flattened pixels, with a residual
    (reference Attention, networks.py:56). The logits are scaled by
    heads ** -0.5; conv_in has no bias. The qkv channels are ordered
    (3, heads, head_dim), as the JAX module's Dense output."""

    def __init__(self, in_channels: int, heads: int = 4,
                 embedding_channels: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.emb = embedding_channels or in_channels
        self.conv_in = nn.Conv1d(in_channels, 3 * self.emb, 1, bias=False)
        self.conv_out = _factor(nn.Conv1d(self.emb, in_channels, 1), 1e-6)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = F.conv1d(x.reshape(b, c, h * w), self.conv_in.weight)
        q, k, v = qkv.reshape(b, 3, self.heads, self.emb // self.heads,
                              h * w).unbind(1)            # [B, heads, d, S]
        attn = torch.einsum("bhdi,bhda->bhia", q, k) * self.heads ** -0.5
        attn = attn.softmax(dim=-1)
        out = torch.einsum("bhia,bhda->bhdi", attn, v).reshape(b, self.emb,
                                                               h * w)
        out = F.conv1d(out, self.conv_out.weight, self.conv_out.bias)
        return x + out.reshape(b, c, h, w)


def _conv_gn_lrelu(n_in: int, n_out: int, n_groups: int = 8) -> List[nn.Module]:
    """Conv 3x3 + GroupNorm + LeakyReLU(0.1): the vanilla UNet's unit, as
    the three entries of a Sequential (reference networks.py:110)."""
    return [_conv3(n_in, n_out), nn.GroupNorm(n_groups, n_out, GN_EPS),
            nn.LeakyReLU(0.1)]


class ImageUNet(nn.Module):
    """The reference's vanilla image UNet (networks.py:96-203): max-pool
    downs, conv + GroupNorm + LeakyReLU units, nearest upsample, skip
    concatenation, an optional PixelShuffle upscale before the 1x1
    out-conv. [B, C, H, W] in and out."""

    def __init__(self, in_channels: int = 3,
                 out_channels: Optional[int] = None,
                 channels_list: Sequence[int] = (32, 64, 128, 256),
                 bottleneck_channels: int = 512,
                 downsample_list: Sequence[bool] = (False, True, True, True),
                 n_blocks: int = 2, n_blocks_bottleneck: int = 2,
                 min_channels_decoder: int = 64, upscale_factor: int = 1,
                 output_factor: Optional[float] = None, n_groups: int = 8):
        super().__init__()
        out_channels = out_channels or in_channels
        self.in_channels, self.out_channels = in_channels, out_channels
        self.channels_list = tuple(channels_list)
        self.downsample_list = tuple(downsample_list)
        self.n_blocks = n_blocks
        self.n_blocks_bottleneck = n_blocks_bottleneck
        self.upscale_factor = upscale_factor

        ch = channels_list[0]
        self.encoder_blocks = nn.ModuleList(
            [nn.Sequential(_conv3(in_channels, ch))])
        skips = [ch]
        for ch_, down in zip(channels_list, downsample_list):
            layers: List[nn.Module] = [nn.MaxPool2d(2)] if down else []
            for _ in range(n_blocks):
                layers += _conv_gn_lrelu(ch, ch_, n_groups)
                ch = ch_
            self.encoder_blocks.append(nn.Sequential(*layers))
            skips.append(ch)
        layers = []
        for _ in range(n_blocks_bottleneck):
            layers += _conv_gn_lrelu(ch, bottleneck_channels, n_groups)
            ch = bottleneck_channels
        self.bottleneck = nn.Sequential(*layers)
        self.decoder_blocks = nn.ModuleList()
        for i_level in reversed(range(len(channels_list))):
            ch_ = max(channels_list[i_level], min_channels_decoder)
            ch += skips.pop()
            layers = []
            for _ in range(n_blocks):
                layers += _conv_gn_lrelu(ch, ch_, n_groups)
                ch = ch_
            if downsample_list[i_level]:
                layers.append(nn.Upsample(scale_factor=2, mode="nearest"))
            self.decoder_blocks.append(nn.Sequential(*layers))
        ch += skips.pop()
        ch0 = max(channels_list[0], min_channels_decoder)
        layers = []
        if upscale_factor != 1:
            # the upscale convs map the concatenation to ch0 * 4
            layers = _upscale(ch0, upscale_factor)
            layers[0] = _conv3(ch, ch0 * 4)
            ch = ch0
        layers.append(_factor(nn.Conv2d(ch, out_channels, 1), output_factor))
        self.decoder_blocks.append(nn.Sequential(*layers))

    @property
    def max_scale_factor(self) -> int:
        return 2 ** int(np.sum(self.downsample_list))

    def forward(self, x):
        skips = []
        for block in self.encoder_blocks:
            x = block(x)
            skips.append(x)
        x = self.bottleneck(x)
        for block in self.decoder_blocks:
            x = block(torch.cat([x, skips.pop()], dim=1))
        return x


class ResUNet(nn.Module):
    """DDPM-style residual UNet (reference ResUNet, networks.py:203-325):
    stride-2 down convs, ResBlocks with attention where attn_list says,
    nearest upsample + conv. Every encoder ResBlock output and every down
    conv's output is a skip. [B, C, H, W] in and out."""

    def __init__(self, in_channels: int = 3,
                 out_channels: Optional[int] = None,
                 channels_list: Sequence[int] = (128, 128, 256, 256, 512, 512),
                 bottleneck_channels: int = 512,
                 downsample_list: Sequence[bool] = (False, True, True, True,
                                                    True, True),
                 attn_list: Sequence[bool] = (False, False, False, False,
                                              True, False),
                 n_blocks: int = 2, min_channels_decoder: int = 1,
                 upscale_factor: int = 1,
                 output_factor: Optional[float] = None, n_groups: int = 8,
                 attn_heads: int = 1):
        super().__init__()
        out_channels = out_channels or in_channels
        self.in_channels, self.out_channels = in_channels, out_channels
        self.channels_list = tuple(channels_list)
        self.downsample_list = tuple(downsample_list)
        self.attn_list = tuple(attn_list)
        self.n_blocks = n_blocks
        self.upscale_factor = upscale_factor

        def unit(n_in, n_out, attn):
            return [ResBlock(n_in, n_out, n_groups)] + (
                [AttentionBlock(n_out, attn_heads)] if attn else [])

        ch = channels_list[0]
        self.encoder_blocks = nn.ModuleList(
            [nn.Sequential(_conv3(in_channels, ch))])
        skips = [ch]
        for ch_, down, attn in zip(channels_list, downsample_list, attn_list):
            if down:
                self.encoder_blocks.append(nn.Sequential(_conv3(ch, ch, 2)))
                skips.append(ch)
            for _ in range(n_blocks):
                self.encoder_blocks.append(nn.Sequential(*unit(ch, ch_, attn)))
                ch = ch_
                skips.append(ch)
        self.bottleneck = nn.Sequential(
            ResBlock(ch, bottleneck_channels, n_groups),
            AttentionBlock(bottleneck_channels, attn_heads),
            ResBlock(bottleneck_channels, bottleneck_channels, n_groups))
        ch = bottleneck_channels
        self.decoder_blocks = nn.ModuleList()
        for i_level in reversed(range(len(channels_list))):
            ch_ = max(channels_list[i_level], min_channels_decoder)
            attn = attn_list[i_level]
            for _ in range(n_blocks):
                self.decoder_blocks.append(
                    nn.Sequential(*unit(ch + skips.pop(), ch_, attn)))
                ch = ch_
            if downsample_list[i_level]:
                self.decoder_blocks.append(nn.Sequential(
                    *unit(ch + skips.pop(), ch, attn),
                    nn.Upsample(scale_factor=2, mode="nearest"),
                    _conv3(ch, ch)))
        ch0 = max(channels_list[0], min_channels_decoder)
        layers: List[nn.Module] = [ResBlock(ch + skips.pop(), ch0, n_groups),
                                   nn.GroupNorm(n_groups, ch0, GN_EPS),
                                   nn.SiLU()]
        layers += _upscale(ch0, upscale_factor)
        layers.append(_factor(nn.Conv2d(ch0, out_channels, 1), output_factor))
        self.decoder_blocks.append(nn.Sequential(*layers))

    @property
    def max_scale_factor(self) -> int:
        return 2 ** int(np.sum(self.downsample_list))

    def forward(self, x):
        skips = []
        for block in self.encoder_blocks:
            x = block(x)
            skips.append(x)
        x = self.bottleneck(x)
        for block in self.decoder_blocks:
            x = block(torch.cat([x, skips.pop()], dim=1))
        return x


class ResCNN(nn.Module):
    """EDSR-style residual CNN (reference ResCNN, networks.py:326-385),
    with the empty trailing ShortcutBlock that doubles its input.
    [B, C, H, W] in and out."""

    max_scale_factor = 1

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 hidden_channels: int = 64, n_blocks: int = 16,
                 upscale_factor: int = 1,
                 output_factor: Optional[float] = None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.in_channels, self.out_channels = in_channels, out_channels
        self.n_blocks = n_blocks
        self.upscale_factor = upscale_factor
        ch = hidden_channels
        layers: List[nn.Module] = [_conv3(in_channels, ch)]
        layers += [ShortcutBlock(nn.Sequential(_conv3(ch, ch), nn.ReLU(),
                                               _conv3(ch, ch)))
                   for _ in range(n_blocks)]
        layers += [_conv3(ch, ch), ShortcutBlock(nn.Sequential())]
        layers += _upscale(ch, upscale_factor)
        layers.append(_factor(_conv3(ch, out_channels), output_factor))
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)
