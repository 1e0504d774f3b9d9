"""The NPPC models: uncertainty directions over a frozen restoration model.

Port of generative_audio_tpu/models/nppc_model.py:41-174.
  * Denoising (StftConfig, DenoisingNPPCConfig, DenoisingNPPCModel):
    waveform -> STFT triplet -> the frozen FullSubNet+'s compressed cRM ->
    the enhanced triplet -> AudioPCWrapper over the noisy and enhanced
    streams -> w_mat [B, n_dirs, 2, F', T].
  * Inpainting (UNetModelConfig, InpaintingRestorationModel,
    InpaintingNPPCConfig, InpaintingNPPCModel): the frozen restoration UNet's
    prediction, concatenated with the masked log-magnitude, ->
    AudioInpaintingPCWrapper -> w_mat [B, n_dirs, F, T].

Where the JAX package writes stop_gradient around the frozen model's
output, the port runs it under torch.no_grad() with its parameters'
requires_grad off. The denoising enhancer in bf16 on CUDA launches the
inference scan (kernel A), never the training kernels. The frozen
restoration UNet always runs with train=False (BatchNorm on its running
statistics, which therefore never change), whatever the outer module's
mode.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from generative_audio_torch.models.fullsubnet_plus import (
    FullSubNetPlus, FullSubNetPlusConfig, MultiDirectionConfig)
from generative_audio_torch.models.pc_wrapper import (
    AudioInpaintingPCWrapper, AudioInpaintingPCWrapperConfig, AudioPCWrapper)
from generative_audio_torch.nn.unet import RestorationWrapper, UNet
from generative_audio_torch.ops.mask import (
    crm_to_stft_components, decompress_cIRM)
from generative_audio_torch.ops.stft import prepare_input_from_waveform
from generative_audio_torch.utils.device import resolve_device

__all__ = ["StftConfig", "DenoisingNPPCConfig", "DenoisingNPPCModel",
           "UNetModelConfig", "InpaintingRestorationModel",
           "InpaintingNPPCConfig", "InpaintingNPPCModel"]


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

    def forward_with_pred_crm(self, noisy_waveform: torch.Tensor,
                              head: Optional[nn.Module] = None,
                              global_rows: Optional[Tuple[int, int]] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_mat, the enhancer's compressed cRM [B, 2, F, T]) from one
        enhancer forward: the training objective needs both. head: the
        module called in place of audio_pc_wrapper (its
        DistributedDataParallel in a multi-GPU step); global_rows: the rows'
        place in a global batch split over ranks, for drop_band."""
        noisy_mag, noisy_real, noisy_imag = self._stft_triplet(noisy_waveform)
        pred_crm_comp = self._enhancer(noisy_mag, noisy_real, noisy_imag,
                                       global_rows)
        pred_crm = decompress_cIRM(pred_crm_comp.permute(0, 2, 3, 1))
        enhanced_mag, enhanced_real, enhanced_imag = crm_to_stft_components(
            pred_crm, noisy_real[:, 0], noisy_imag[:, 0])
        w_mat = (self.audio_pc_wrapper if head is None else head)(
            noisy_mag, noisy_real, noisy_imag, enhanced_mag[:, None],
            enhanced_real[:, None], enhanced_imag[:, None],
            global_rows=global_rows)
        return w_mat, pred_crm_comp

    def get_pred_crm(self, noisy_waveform: torch.Tensor) -> torch.Tensor:
        """The frozen enhancer's compressed cRM [B, 2, F, T]."""
        return self._enhancer(*self._stft_triplet(noisy_waveform))

    def _enhancer(self, mag, real, imag, global_rows=None) -> torch.Tensor:
        with torch.no_grad():
            return self.pretrained_restoration_model(
                mag, real, imag, global_rows=global_rows)


@dataclasses.dataclass(frozen=True)
class UNetModelConfig:
    in_channels: int = 1
    out_channels: int = 1
    dropout: float = 0.0


class InpaintingRestorationModel(RestorationWrapper):
    """UNet + RestorationWrapper: the prediction pasted into the gap only.
    forward(x_in, mask, train=False, mc_dropout=False, generator=None);
    mc_dropout=True turns dropout on with BatchNorm on its running
    statistics. Parameters under `net.`."""

    def __init__(self, config: UNetModelConfig = UNetModelConfig()):
        super().__init__(UNet(config.in_channels, config.out_channels,
                              config.dropout))
        self.config = config

    def forward(self, x_in, mask, train: bool = False,
                mc_dropout: bool = False, generator=None,
                global_rows: Optional[Tuple[int, int]] = None):
        return super().forward(x_in, mask, train, mc_dropout, generator,
                               global_rows)


@dataclasses.dataclass(frozen=True)
class InpaintingNPPCConfig:
    restoration: UNetModelConfig = UNetModelConfig(in_channels=1,
                                                   out_channels=1,
                                                   dropout=0.2)
    pc_wrapper: AudioInpaintingPCWrapperConfig = \
        AudioInpaintingPCWrapperConfig()


class InpaintingNPPCModel(nn.Module):
    """Masked log-magnitude [B, 1, F, T] and mask [B, 1, F, T] -> w_mat
    [B, n_dirs, F, T]. Parameters: `pretrained_restoration_model.net.*` (the
    frozen UNet, requires_grad off) and `pc_wrapper.net.*` (the PC UNet,
    whose BatchNorm updates its running statistics when train=True)."""

    def __init__(self, config: InpaintingNPPCConfig = InpaintingNPPCConfig()):
        super().__init__()
        self.config = config
        self.pretrained_restoration_model = InpaintingRestorationModel(
            config.restoration)
        self.pretrained_restoration_model.requires_grad_(False)
        self.pc_wrapper = AudioInpaintingPCWrapper(config.pc_wrapper)

    def get_pred_spec_mag_norm(self, masked_spec_mag_log: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
        """The frozen restoration prediction [B, 1, F, T]."""
        with torch.no_grad():
            return self.pretrained_restoration_model(masked_spec_mag_log,
                                                     mask, train=False)

    def mc_restoration(self, masked_spec_mag_log: torch.Tensor,
                       mask: torch.Tensor, generator=None,
                       global_rows: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
        """MC-dropout samples of the frozen restoration model: dropout on,
        BatchNorm on its running statistics. With a sequence of P
        generators the input holds P stacked passes, one per generator;
        global_rows places each pass's rows in a global batch split over
        ranks (nn.unet.dropout)."""
        with torch.no_grad():
            return self.pretrained_restoration_model(
                masked_spec_mag_log, mask, train=False, mc_dropout=True,
                generator=generator, global_rows=global_rows)

    def forward(self, masked_spec_mag_norm: torch.Tensor, mask: torch.Tensor,
                train: bool = False, generator=None) -> torch.Tensor:
        return self.forward_with_pred(masked_spec_mag_norm, mask, train,
                                      generator)[0]

    def forward_with_pred(self, masked_spec_mag_norm: torch.Tensor,
                          mask: torch.Tensor, train: bool = False,
                          generator=None, head: Optional[nn.Module] = None,
                          global_rows: Optional[Tuple[int, int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_mat, the frozen prediction) from one frozen forward: the
        training objective needs both. head: the module called in place of
        pc_wrapper (its DistributedDataParallel in a multi-GPU step);
        global_rows: the rows' place in a global batch split over ranks,
        for the dropout masks."""
        pred = self.get_pred_spec_mag_norm(masked_spec_mag_norm, mask)
        x = torch.cat([masked_spec_mag_norm, pred], dim=1)
        return (self.pc_wrapper if head is None else head)(
            x, mask, train=train, generator=generator,
            global_rows=global_rows), pred
