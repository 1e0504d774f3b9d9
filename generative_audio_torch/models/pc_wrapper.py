"""The principal-component head of the denoising-NPPC line.

Port of generative_audio_tpu/models/pc_wrapper.py:26-43 (AudioPCWrapper):
MultiDirectionFullSubNetPlus -> [B, n_dirs, 2, F, T] -> complex
Gram-Schmidt. The inpainting line's AudioInpaintingPCWrapper waits for the
UNet (ROADMAP.md, queue A item 8).
"""
from __future__ import annotations

import torch
from torch import nn

from generative_audio_torch.models.fullsubnet_plus import (
    MultiDirectionConfig, MultiDirectionFullSubNetPlus)
from generative_audio_torch.ops.gram_schmidt import gram_schmidt_to_crm

__all__ = ["AudioPCWrapper"]


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
