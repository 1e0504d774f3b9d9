"""Channel attention (MulCA). Port of generative_audio_tpu/nn/attention.py:47-84, 135-150.

Only TSSE, the FullSubNet+ default, is ported so far; SE, CBAM and ECA
raise until their slice lands (ROADMAP.md, queue A item 13). Parameter
names are the reference checkpoint's (`smallConv1d.0.weight`, ...).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["ChannelTimeSenseSELayer", "make_channel_attention"]


class ChannelTimeSenseSELayer(nn.Module):
    """TSSE over [B, C, T]: three depthwise time convs (VALID, k = 3, 5, 10),
    each averaged over time and passed through ReLU; a Linear(3 -> 1) fuse;
    then the SE MLP (C -> C/2 -> C, sigmoid) scales each channel."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2,
                 kersize: Sequence[int] = (3, 5, 10), subband_num: int = 1,
                 device=None):
        super().__init__()
        groups = num_channels // subband_num

        def branch(k):
            return nn.Sequential(nn.Conv1d(num_channels, num_channels, k,
                                           groups=groups, device=device))

        self.smallConv1d = branch(kersize[0])
        self.middleConv1d = branch(kersize[1])
        self.largeConv1d = branch(kersize[2])
        self.feature_concate_fc = nn.Linear(3, 1, device=device)
        self.fc1 = nn.Linear(num_channels, num_channels // reduction_ratio,
                             device=device)
        self.fc2 = nn.Linear(num_channels // reduction_ratio, num_channels,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = [torch.relu(conv(x).mean(dim=-1)) for conv in
                  (self.smallConv1d, self.middleConv1d, self.largeConv1d)]
        squeeze = self.feature_concate_fc(torch.stack(pooled, dim=2))[..., 0]
        scale = torch.sigmoid(self.fc2(torch.relu(self.fc1(squeeze))))
        return x * scale[:, :, None]


def make_channel_attention(kind: str, num_channels: int, kersize=(3, 5, 10),
                           subband_num: int = 1, device=None) -> nn.Module:
    """FullSubNet+'s channel_attention_model switch."""
    if kind == "TSSE":
        return ChannelTimeSenseSELayer(num_channels, kersize=tuple(kersize),
                                       subband_num=subband_num, device=device)
    if kind in ("SE", "CBAM", "ECA"):
        raise NotImplementedError(
            f"channel attention {kind!r} is not ported to generative_audio_torch "
            "yet (ROADMAP.md, queue A item 13)")
    raise NotImplementedError(f"Unknown channel attention model {kind!r}")
