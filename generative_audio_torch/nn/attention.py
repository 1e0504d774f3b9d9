"""Channel attention (MulCA) and its relatives. Port of
generative_audio_tpu/nn/attention.py:33-256.

Public layout [B, C, T], as in the reference. The multi-scale branches are
depthwise (or, with subband_num > 1, grouped) time convolutions without
padding, averaged over the frames that remain. Parameter names are the
reference checkpoint's, as generative_audio_tpu/utils/torch_convert.py
reads them: `fc1` / `fc2`; TSSE `smallConv1d.0.weight`, ...; ECA
`conv.weight` [1, 1, k]; the deep TSSE's branches `.0` and `.2`; the
attention TSSE's `{branch}.conv1d` and `{branch}.attention.{q,k,v}_linear`
and `.out`.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

__all__ = ["ChannelSELayer", "ChannelTimeSenseSELayer", "ChannelCBAMLayer",
           "ChannelECALayer", "SelfAttentionLayer",
           "ChannelTimeSenseSEWeightLayer", "ChannelDeepTimeSenseSELayer",
           "ConvAttentionBlock", "ChannelTimeSenseAttentionSELayer",
           "make_channel_attention"]

_BRANCHES = ("smallConv1d", "middleConv1d", "largeConv1d")


class _SqueezeExcite(nn.Module):
    """Holds the SE MLP (C -> C / r -> C, sigmoid) that scales each channel.
    A subclass calls `_add_mlp` after its branches, so that its parameters
    keep the reference's order."""

    def _add_mlp(self, num_channels: int, reduction_ratio: int, device):
        self.fc1 = nn.Linear(num_channels, num_channels // reduction_ratio,
                             device=device)
        self.fc2 = nn.Linear(num_channels // reduction_ratio, num_channels,
                             device=device)

    def scale(self, squeeze: torch.Tensor) -> torch.Tensor:
        """[B, C] descriptor -> [B, C, 1] channel weights."""
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(squeeze))))[:, :, None]


class ChannelSELayer(_SqueezeExcite):
    """Squeeze-and-excitation over the time-pooled channels."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2,
                 device=None):
        super().__init__()
        self._add_mlp(num_channels, reduction_ratio, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale(x.mean(dim=2))


class ChannelCBAMLayer(_SqueezeExcite):
    """CBAM's channel attention: the shared fc1 over the mean- and the
    max-pooled channels, summed before fc2."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2,
                 device=None):
        super().__init__()
        self._add_mlp(num_channels, reduction_ratio, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = (torch.relu(self.fc1(x.mean(dim=2)))
             + torch.relu(self.fc1(x.amax(dim=2))))
        return x * torch.sigmoid(self.fc2(h))[:, :, None]


class ChannelECALayer(nn.Module):
    """Efficient channel attention: a k-tap convolution across the channel
    axis of the time-pooled descriptor, no bias."""

    def __init__(self, k_size: int = 3, device=None):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, k_size, padding=(k_size - 1) // 2,
                              bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.mean(dim=2)[:, None, :])[:, 0]     # [B, C]
        return x * torch.sigmoid(y)[:, :, None]


def _grouped_conv(num_channels: int, kernel_size: int, subband_num: int,
                  device) -> nn.Conv1d:
    """Conv1d(C, C, k, groups=C // subband_num) without padding; raises
    unless the groups divide C (torch and the reference need it)."""
    groups = num_channels // subband_num
    if groups < 1 or num_channels % groups:
        raise ValueError(
            f"TSSE groups its time convolutions in C // subband_num = "
            f"{num_channels} // {subband_num} = {groups} groups, which must "
            f"divide C = {num_channels}")
    return nn.Conv1d(num_channels, num_channels, kernel_size, groups=groups,
                     device=device)


class ChannelTimeSenseSELayer(_SqueezeExcite):
    """TSSE over [B, C, T]: three depthwise time convs (VALID, k = 3, 5, 10),
    each averaged over time and passed through ReLU; a Linear(3 -> 1) fuse;
    then the SE MLP scales each channel."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2,
                 kersize: Sequence[int] = (3, 5, 10), subband_num: int = 1,
                 device=None):
        super().__init__()
        for name, k in zip(_BRANCHES, kersize):
            self.add_module(name, nn.Sequential(_grouped_conv(
                num_channels, k, subband_num, device)))
        self.feature_concate_fc = nn.Linear(3, 1, device=device)
        self._add_mlp(num_channels, reduction_ratio, device)

    def weights(self, x: torch.Tensor) -> torch.Tensor:
        pooled = [torch.relu(getattr(self, name)(x).mean(dim=-1))
                  for name in _BRANCHES]
        return self.scale(
            self.feature_concate_fc(torch.stack(pooled, dim=2))[..., 0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weights(x)


class ChannelTimeSenseSEWeightLayer(ChannelTimeSenseSELayer):
    """TSSE (depthwise) that also returns its channel weights [B, C, 1]."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2,
                 kersize: Sequence[int] = (3, 5, 10), device=None):
        super().__init__(num_channels, reduction_ratio, kersize, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = self.weights(x)
        return x * scale, scale


class ChannelDeepTimeSenseSELayer(_SqueezeExcite):
    """TSSE with two stacked depthwise convs a scale: conv -> ReLU -> conv
    -> ReLU, then the mean over time (pool last, and no ReLU after it)."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2,
                 kersize: Sequence[int] = (3, 5, 10), device=None):
        super().__init__()
        for name, k in zip(_BRANCHES, kersize):
            self.add_module(name, nn.Sequential(
                _grouped_conv(num_channels, k, 1, device), nn.ReLU(),
                _grouped_conv(num_channels, k, 1, device), nn.ReLU()))
        self.feature_concate_fc = nn.Linear(3, 1, device=device)
        self._add_mlp(num_channels, reduction_ratio, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = [getattr(self, name)(x).mean(dim=-1) for name in _BRANCHES]
        squeeze = self.feature_concate_fc(torch.stack(pooled, dim=2))[..., 0]
        return x * self.scale(squeeze)


class SelfAttentionLayer(nn.Module):
    """Dot-product self attention over [B, T, F] whose scores pass through a
    sigmoid (not a softmax), scaled by sqrt(amp_dim)."""

    def __init__(self, amp_dim: int = 257, att_dim: int = 257, device=None):
        super().__init__()
        self.amp_dim = amp_dim
        self.q_linear = nn.Linear(amp_dim, att_dim, device=device)
        self.k_linear = nn.Linear(amp_dim, att_dim, device=device)
        self.v_linear = nn.Linear(amp_dim, att_dim, device=device)
        self.out = nn.Linear(att_dim, amp_dim, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        q, k, v = self.q_linear(q), self.k_linear(k), self.v_linear(v)
        scores = q @ k.transpose(1, 2) / math.sqrt(self.amp_dim)
        return self.out(torch.sigmoid(scores) @ v)


class ConvAttentionBlock(nn.Module):
    """Depthwise time conv -> self attention over time -> mean -> ReLU:
    [B, C, T] -> [B, C]."""

    def __init__(self, num_channels: int, kernel_size: int, device=None):
        super().__init__()
        self.conv1d = _grouped_conv(num_channels, kernel_size, 1, device)
        self.attention = SelfAttentionLayer(num_channels, num_channels,
                                            device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1d(x).transpose(1, 2)                 # [B, T', C]
        return torch.relu(self.attention(y, y, y).mean(dim=1))


class ChannelTimeSenseAttentionSELayer(_SqueezeExcite):
    """TSSE whose three branches are ConvAttentionBlocks."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2,
                 kersize: Sequence[int] = (3, 5, 10), device=None):
        super().__init__()
        for name, k in zip(_BRANCHES, kersize):
            self.add_module(name, ConvAttentionBlock(num_channels, k,
                                                     device=device))
        self.feature_concate_fc = nn.Linear(3, 1, device=device)
        self._add_mlp(num_channels, reduction_ratio, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = [getattr(self, name)(x) for name in _BRANCHES]
        squeeze = self.feature_concate_fc(torch.stack(pooled, dim=2))[..., 0]
        return x * self.scale(squeeze)


def make_channel_attention(kind: str, num_channels: int, kersize=(3, 5, 10),
                           subband_num: int = 1, device=None) -> nn.Module:
    """FullSubNet+'s channel_attention_model switch: SE, TSSE, CBAM, ECA."""
    if kind == "SE":
        return ChannelSELayer(num_channels, device=device)
    if kind == "TSSE":
        return ChannelTimeSenseSELayer(num_channels, kersize=tuple(kersize),
                                       subband_num=subband_num, device=device)
    if kind == "CBAM":
        return ChannelCBAMLayer(num_channels, device=device)
    if kind == "ECA":
        return ChannelECALayer(device=device)
    raise NotImplementedError(f"Unknown channel attention model {kind!r}")
