"""The principal-component heads of the two NPPC lines.

Port of generative_audio_tpu/models/pc_wrapper.py:26-70. AudioPCWrapper
(denoising): MultiDirectionFullSubNetPlus -> [B, n_dirs, 2, F, T] ->
complex Gram-Schmidt. AudioInpaintingPCWrapper (inpainting): a UNet with
n_dirs outputs, zeroed in the known region (mask == 1), -> real
Gram-Schmidt.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from generative_audio_torch.models.fullsubnet_plus import (
    MultiDirectionConfig, MultiDirectionFullSubNetPlus)
from generative_audio_torch.nn.unet import UNet
from generative_audio_torch.ops.gram_schmidt import (
    gram_schmidt_to_crm, gram_schmidt_to_spec_mag)

__all__ = ["AudioPCWrapper", "AudioInpaintingPCWrapper",
           "AudioInpaintingPCWrapperConfig"]


class AudioPCWrapper(nn.Module):
    """Six [B, 1, F, T] streams -> orthogonal cRM directions w_mat
    [B, n_dirs, 2, F', T], float32. The head's parameters are under `net.`."""

    def __init__(self, config: MultiDirectionConfig = MultiDirectionConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        self.net = MultiDirectionFullSubNetPlus(
            config, compute_dtype=compute_dtype, device=device)

    def forward(self, noisy_mag, noisy_real, noisy_imag, enhanced_mag,
                enhanced_real, enhanced_imag) -> torch.Tensor:
        crm = self.net(noisy_mag, noisy_real, noisy_imag, enhanced_mag,
                       enhanced_real, enhanced_imag)      # [B, 2K, F', T]
        b, _, f, t = crm.shape
        return gram_schmidt_to_crm(
            crm.reshape(b, self.config.n_directions, 2, f, t))


@dataclasses.dataclass(frozen=True)
class AudioInpaintingPCWrapperConfig:
    in_channels: int = 2
    out_channels: int = 5   # == n_dirs
    dropout: float = 0.0
    n_dirs: int = 5


class AudioInpaintingPCWrapper(nn.Module):
    """mag_spec [B, in_channels, F, T] and mask [B, 1, F, T] -> orthogonal
    directions [B, n_dirs, F, T] that live in the gap only. The UNet's
    parameters are under `net.`."""

    def __init__(self, config: AudioInpaintingPCWrapperConfig =
                 AudioInpaintingPCWrapperConfig()):
        super().__init__()
        self.config = config
        self.net = UNet(config.in_channels, config.n_dirs, config.dropout)

    def forward(self, mag_spec: torch.Tensor, mask: torch.Tensor,
                train: bool = False, generator=None) -> torch.Tensor:
        pred = self.net(mag_spec, train=train, generator=generator)
        return gram_schmidt_to_spec_mag(pred * (1.0 - mask.expand(pred.shape)))
