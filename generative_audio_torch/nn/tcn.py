"""Temporal convolutional network blocks and the causal 2-D conv blocks.
Port of generative_audio_tpu/nn/tcn.py:24-133.

Parameter names and shapes are the reference checkpoint's (conv1x1 and sconv
are Conv1d weights [out, in, 1]); the 1x1 convs run as matmuls over the
channel axis. The TCN is [B, T, C] inside, as in the JAX module, and [B, C,
T] in public. The causal conv blocks take [B, C, F, T] (the reference's
layout; the JAX blocks take [B, F, T, C]) and keep flax's BatchNorm as the
JAX blocks build it (nn.unet.batch_norm at flax's default momentum 0.99,
the biased running variance), with `train` as an argument of forward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from generative_audio_torch.nn.unet import batch_norm

__all__ = ["TCNBlock", "TCNStack", "CausalConvBlock", "CausalTransConvBlock"]

# flax nn.BatchNorm's default, which the JAX causal blocks keep
_FLAX_MOMENTUM = 0.99


class _GlobalLayerNorm(nn.Module):
    """GroupNorm(1, C, eps=1e-8) over [B, T, C]: normalise over (T, C)
    jointly with the biased variance, then a per-channel affine."""

    def __init__(self, channels: int, eps: float = 1e-8, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class TCNBlock(nn.Module):
    """Residual depthwise-separable dilated conv block over [B, T, C]:
    1x1 conv -> PReLU -> norm -> depthwise dilated conv -> PReLU -> norm ->
    1x1 conv, plus the input unless use_skip_connection is off. causal pads
    the dilated conv by d * (k - 1) frames on the left only (symmetric
    otherwise). The convolutions run in compute_dtype, the rest in
    float32."""

    def __init__(self, in_channels: int, hidden_channels: int = 512,
                 out_channels: int = 257, kernel_size: int = 3,
                 dilation: int = 1, use_skip_connection: bool = True,
                 causal: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        h = hidden_channels
        self.compute_dtype = compute_dtype
        self.use_skip_connection = use_skip_connection
        self.conv1x1 = nn.Conv1d(in_channels, h, 1, device=device)
        self.prelu1 = nn.PReLU(init=0.25, device=device)
        self.norm1 = _GlobalLayerNorm(h, device=device)
        pad = dilation * (kernel_size - 1)
        self.padding = (pad, 0) if causal else (pad // 2, pad // 2)
        self.depthwise_conv = nn.Conv1d(h, h, kernel_size, dilation=dilation,
                                        groups=h, device=device)
        self.prelu2 = nn.PReLU(init=0.25, device=device)
        self.norm2 = _GlobalLayerNorm(h, device=device)
        self.sconv = nn.Conv1d(h, out_channels, 1, device=device)

    def _pointwise(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return F.linear(x.to(cdt), conv.weight[:, :, 0].to(cdt),
                        conv.bias.to(cdt)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        y = self.norm1(self.prelu1(self._pointwise(self.conv1x1, x)))
        dw = self.depthwise_conv
        y = F.conv1d(F.pad(y.transpose(1, 2).to(cdt), self.padding),
                     dw.weight.to(cdt), dw.bias.to(cdt),
                     dilation=dw.dilation, groups=dw.groups)
        y = self.norm2(self.prelu2(y.transpose(1, 2).float()))
        y = self._pointwise(self.sconv, y)
        return x + y if self.use_skip_connection else y


class TCNStack(nn.Module):
    """The reference's 8-block stack (dilations 1, 2, 5, 9 twice) and a final
    ReLU. Public layout [B, C, T]. Blocks are registered as "0".."7", the
    reference's nn.Sequential keys."""

    DILATIONS = (1, 2, 5, 9, 1, 2, 5, 9)

    def __init__(self, channels: int, hidden_channels: int = 512,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        for i, dilation in enumerate(self.DILATIONS):
            self.add_module(str(i), TCNBlock(
                channels, hidden_channels, channels, dilation=dilation,
                compute_dtype=compute_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.transpose(1, 2)
        for block in self.children():
            y = block(y)
        return torch.relu(y).transpose(1, 2)


class CausalConvBlock(nn.Module):
    """Encoder block: Conv2d(k=(3, 2), stride (2, 1), time padded by one
    frame each side) -> the last frame chomped -> BatchNorm -> activation
    (a torch.nn.functional name: "relu", "elu", ...)."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: str = "relu", device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, (3, 2), stride=(2, 1),
                              padding=(0, 1), device=device)
        self.norm = nn.BatchNorm2d(out_channels, device=device)
        self.activation = getattr(F, activation.lower())

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = self.conv(x)[..., :-1]
        return self.activation(batch_norm(self.norm, y, train,
                                          _FLAX_MOMENTUM))


class CausalTransConvBlock(nn.Module):
    """Decoder block: ConvTranspose2d(k=(3, 2), stride (2, 1), no padding)
    -> output_padding[0] zero bins appended to F -> the last frame chomped
    -> BatchNorm -> ReLU if is_last else ELU.

    flax's ConvTranspose (transpose_kernel=False) does not flip its kernel
    and torch's does: utils.convert.convert_causal_trans_conv_block flips
    both spatial axes."""

    def __init__(self, in_channels: int, out_channels: int,
                 is_last: bool = False, output_padding=(0, 0), device=None):
        super().__init__()
        self.is_last = is_last
        self.output_padding = tuple(output_padding)
        self.conv = nn.ConvTranspose2d(in_channels, out_channels, (3, 2),
                                       stride=(2, 1), device=device)
        self.norm = nn.BatchNorm2d(out_channels, device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = self.conv(x)
        if self.output_padding[0]:
            y = F.pad(y, (0, 0, 0, self.output_padding[0]))
        y = batch_norm(self.norm, y[..., :-1], train,
                       _FLAX_MOMENTUM)
        return torch.relu(y) if self.is_last else F.elu(y)
