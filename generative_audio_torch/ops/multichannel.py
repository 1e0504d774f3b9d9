"""Multichannel directional features (LPS and IPD) for microphone arrays.
Port of generative_audio_tpu/ops/multichannel.py:29-147.

Every microphone goes through ONE conv_stft ([B * M, S]). The IPD's cos and
sin come from the ratio identities (ra rb + ia ib) / (|a| |b|) and
(ia rb - ra ib) / (|a| |b|), with no atan2.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from generative_audio_torch.ops.conv_stft import conv_stft

__all__ = ["ChannelWiseLayerNorm", "DirectionalFeatureComputer",
           "ChannelDirectionalFeatureComputer", "compute_ipd"]


class ChannelWiseLayerNorm(nn.LayerNorm):
    """LayerNorm over the N axis of [B, N, K], eps 1e-5 (flax's LayerNorm;
    the reference subclasses nn.LayerNorm the same way)."""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__(num_features, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def compute_ipd(real: torch.Tensor, imag: torch.Tensor,
                ipd_left: Sequence[int], ipd_right: Sequence[int],
                eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the phase differences of the mic pairs, from (real,
    imag) [B, M, F, K] -> each [B, pairs, F, K]."""
    left, right = list(ipd_left), list(ipd_right)
    rl, il = real[:, left], imag[:, left]
    rr, ir = real[:, right], imag[:, right]
    mag = torch.sqrt((rl ** 2 + il ** 2) * (rr ** 2 + ir ** 2)) + eps
    return (rl * rr + il * ir) / mag, (il * rr - rl * ir) / mag


class _DirectionalBase(nn.Module):
    def __init__(self, n_fft: int, win_length: int, hop_length: int,
                 input_features: Sequence[str],
                 mic_pairs: Sequence[Tuple[int, int]], lps_channel: int,
                 use_cos_IPD: bool = True, use_sin_IPD: bool = False,
                 eps: float = 1e-8):
        super().__init__()
        self.n_fft, self.win_length, self.hop_length = (n_fft, win_length,
                                                        hop_length)
        self.input_features = tuple(input_features)
        self.mic_pairs = [tuple(p) for p in mic_pairs]
        self.lps_channel = lps_channel
        self.use_cos_IPD, self.use_sin_IPD = use_cos_IPD, use_sin_IPD
        self.eps = eps

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def num_mic_pairs(self) -> int:
        return len(self.mic_pairs)

    def _stft_all(self, y: torch.Tensor):
        b, m, s = y.shape
        parts = conv_stft(y.reshape(b * m, s), self.win_length,
                          self.hop_length, self.n_fft)
        f, k = parts[0].shape[-2:]
        return tuple(a.reshape(b, m, f, k) for a in parts)

    def _ipd(self, real, imag):
        return compute_ipd(real, imag, [p[0] for p in self.mic_pairs],
                           [p[1] for p in self.mic_pairs], self.eps)

    def _lps(self, mag):
        return torch.log(mag[:, self.lps_channel] ** 2 + self.eps)


class DirectionalFeatureComputer(_DirectionalBase):
    """[B, M, S] -> (directional [B, D, K], mag, phase, real, imag), D = F
    (LPS, layer-normed) + pairs * F (cos IPD) [+ pairs * F (sin IPD)]."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        if "LPS" in self.input_features:
            self.lps_layer_norm = ChannelWiseLayerNorm(self.num_freqs,
                                                       device=device)

    @property
    def directional_feature_dim(self) -> int:
        dim = 0
        if "LPS" in self.input_features:
            dim += self.num_freqs
        if "IPD" in self.input_features:
            dim += self.num_freqs * self.num_mic_pairs * (
                2 if self.use_sin_IPD else 1)
        return dim

    def forward(self, y: torch.Tensor):
        mag, phase, real, imag = self._stft_all(y)
        b, k = mag.shape[0], mag.shape[-1]
        feats = []
        if "LPS" in self.input_features:
            feats.append(self.lps_layer_norm(self._lps(mag)))
        if "IPD" in self.input_features:
            cos_ipd, sin_ipd = self._ipd(real, imag)
            feats.append(cos_ipd.reshape(b, -1, k))
            if self.use_sin_IPD:
                feats.append(sin_ipd.reshape(b, -1, k))
        return torch.cat(feats, dim=1), mag, phase, real, imag


class ChannelDirectionalFeatureComputer(_DirectionalBase):
    """The channel-stacked variant: [B, M, S] -> (directional [B, C + I, F,
    K], mag, phase, real, imag), the frequency axis kept."""

    @property
    def directional_feature_dim(self) -> int:
        dim = 0
        if "LPS" in self.input_features:
            dim += 1
        if "IPD" in self.input_features:
            dim += self.num_mic_pairs * (2 if self.use_sin_IPD else 1)
        return dim

    def forward(self, y: torch.Tensor):
        mag, phase, real, imag = self._stft_all(y)
        feats = []
        if "LPS" in self.input_features:
            feats.append(self._lps(mag)[:, None])
        if "IPD" in self.input_features:
            cos_ipd, sin_ipd = self._ipd(real, imag)
            feats.append(cos_ipd)
            if self.use_sin_IPD:
                feats.append(sin_ipd)
        return torch.cat(feats, dim=1), mag, phase, real, imag
