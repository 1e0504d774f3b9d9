"""The denoising-NPPC model: uncertainty directions in cRM space over a
frozen FullSubNet+ enhancer.

Port of generative_audio_tpu/models/nppc_model.py:41-106 (StftConfig,
DenoisingNPPCConfig, DenoisingNPPCModel): waveform -> STFT triplet -> the
frozen FullSubNet+'s compressed cRM -> the enhanced triplet -> AudioPCWrapper
over the noisy and enhanced streams -> w_mat [B, n_dirs, 2, F', T].

Where the JAX package writes stop_gradient around the enhancer's output, the
port runs the enhancer under torch.no_grad() with its parameters'
requires_grad off: in bf16 on CUDA its LSTM layers launch the inference
scan (kernel A), never the training kernels, and it gets no gradient. The
inpainting line's model waits for the UNet (ROADMAP.md, queue A item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from generative_audio_torch.models.fullsubnet_plus import (
    FullSubNetPlus, FullSubNetPlusConfig, MultiDirectionConfig)
from generative_audio_torch.models.pc_wrapper import AudioPCWrapper
from generative_audio_torch.ops.mask import (
    crm_to_stft_components, decompress_cIRM)
from generative_audio_torch.ops.stft import prepare_input_from_waveform
from generative_audio_torch.utils.device import resolve_device

__all__ = ["StftConfig", "DenoisingNPPCConfig", "DenoisingNPPCModel"]


@dataclasses.dataclass(frozen=True)
class StftConfig:
    nfft: int = 512
    hop_length: int = 256
    win_length: int = 512


@dataclasses.dataclass(frozen=True)
class DenoisingNPPCConfig:
    restoration: FullSubNetPlusConfig = FullSubNetPlusConfig()
    pc_wrapper: MultiDirectionConfig = MultiDirectionConfig()
    stft: StftConfig = StftConfig()


class DenoisingNPPCModel(nn.Module):
    """[B, L] noisy waveform -> w_mat [B, n_dirs, 2, F', T].

    Parameters: `pretrained_restoration_model.*` (the frozen FullSubNet+,
    requires_grad off) and `audio_pc_wrapper.net.*` (the head). device:
    "cuda" (default; raises without one) or "cpu"; compute_dtype: bf16 on
    the card, float32 for the CPU tests."""

    def __init__(self, config: DenoisingNPPCConfig = DenoisingNPPCConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.pretrained_restoration_model = FullSubNetPlus(
            config.restoration, compute_dtype=compute_dtype, device=dev)
        self.pretrained_restoration_model.requires_grad_(False)
        self.audio_pc_wrapper = AudioPCWrapper(
            config.pc_wrapper, compute_dtype=compute_dtype, device=dev)

    def _stft_triplet(self, waveform: torch.Tensor):
        s = self.config.stft
        return prepare_input_from_waveform(waveform.float(), s.nfft,
                                           s.hop_length, s.win_length)

    def forward(self, noisy_waveform: torch.Tensor) -> torch.Tensor:
        return self.forward_with_pred_crm(noisy_waveform)[0]

    def forward_with_pred_crm(self, noisy_waveform: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_mat, the enhancer's compressed cRM [B, 2, F, T]) from one
        enhancer forward: the training objective needs both."""
        noisy_mag, noisy_real, noisy_imag = self._stft_triplet(noisy_waveform)
        pred_crm_comp = self._enhancer(noisy_mag, noisy_real, noisy_imag)
        pred_crm = decompress_cIRM(pred_crm_comp.permute(0, 2, 3, 1))
        enhanced_mag, enhanced_real, enhanced_imag = crm_to_stft_components(
            pred_crm, noisy_real[:, 0], noisy_imag[:, 0])
        w_mat = self.audio_pc_wrapper(
            noisy_mag, noisy_real, noisy_imag, enhanced_mag[:, None],
            enhanced_real[:, None], enhanced_imag[:, None])
        return w_mat, pred_crm_comp

    def get_pred_crm(self, noisy_waveform: torch.Tensor) -> torch.Tensor:
        """The frozen enhancer's compressed cRM [B, 2, F, T]."""
        return self._enhancer(*self._stft_triplet(noisy_waveform))

    def _enhancer(self, mag, real, imag) -> torch.Tensor:
        with torch.no_grad():
            return self.pretrained_restoration_model(mag, real, imag)
