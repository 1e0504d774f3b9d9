"""Temporal convolutional network blocks. Port of generative_audio_tpu/nn/tcn.py:24-98.

Parameter names and shapes are the reference checkpoint's (conv1x1 and sconv
are Conv1d weights [out, in, 1]); the 1x1 convs run as matmuls over the
channel axis. Internally [B, T, C], as in the JAX module; public [B, C, T].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TCNBlock", "TCNStack"]


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
    1x1 conv, plus the input. The convolutions run in compute_dtype, the
    rest in float32. The JAX block's causal and no-skip options, which no
    FullSubNet+ configuration sets, are not ported."""

    def __init__(self, in_channels: int, hidden_channels: int = 512,
                 out_channels: int = 257, kernel_size: int = 3,
                 dilation: int = 1,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        h = hidden_channels
        self.compute_dtype = compute_dtype
        self.conv1x1 = nn.Conv1d(in_channels, h, 1, device=device)
        self.prelu1 = nn.PReLU(init=0.25, device=device)
        self.norm1 = _GlobalLayerNorm(h, device=device)
        pad = dilation * (kernel_size - 1) // 2       # symmetric (non-causal)
        self.padding = (pad, pad)
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
        return x + y


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
