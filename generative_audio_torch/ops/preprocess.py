"""Log-magnitude spectrogram preprocessing of the inpainting line.

Port of generative_audio_tpu/ops/preprocess.py:28-72, with the reference's
statistics:
  * preprocess_log_magnitude takes one mean and one unbiased std over the
    whole batch tensor (0-d tensors);
  * preprocess_data normalises the masked spectrogram with the clean
    spectrogram's statistics;
  * the frame mask [B, T] expands to [B, 1, F, T].
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["normalize_spectrograms", "denormalize_spectrograms",
           "preprocess_log_magnitude", "preprocess_data", "expand_frame_mask"]


def normalize_spectrograms(spec: torch.Tensor):
    """Zero mean and unit (unbiased) std per (B, C) -> (normalised, mean,
    std), the statistics [B, C, 1, 1]."""
    b, c = spec.shape[:2]
    flat = spec.reshape(b, c, -1)
    mean = flat.mean(dim=2)[..., None, None]
    std = flat.std(dim=2)[..., None, None]
    return (spec - mean) / (std + 1e-6), mean, std


def denormalize_spectrograms(spec_norm: torch.Tensor, spec_mean, spec_std):
    return spec_norm * (spec_std + 1e-6) + spec_mean


def preprocess_log_magnitude(magnitude: torch.Tensor, eps: float = 1e-6
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """log(mag + eps) normalised by the scalar batch mean and unbiased std."""
    log_mag = torch.log(magnitude + eps)
    mean = log_mag.mean()
    std = log_mag.std()
    return (log_mag - mean) / std, mean, std


def expand_frame_mask(mask: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[B, T] frame mask -> [B, 1, F, T]."""
    return mask[:, None, None, :].expand(mask.shape[0], 1, num_freqs,
                                         mask.shape[-1])


def preprocess_data(clean_spec: torch.Tensor, masked_spec: torch.Tensor,
                    mask: torch.Tensor, return_stats: bool = False):
    """STFT pairs [B, 2, F, T] and the frame mask [B, T] -> (clean log-mag
    normalised [B, 1, F, T], mask [B, 1, F, T], masked log-mag normalised
    with the clean statistics [B, 1, F, T]) [+ (mean, std)]."""
    mask4 = expand_frame_mask(mask, clean_spec.shape[2])
    clean_mag = torch.sqrt(clean_spec[:, 0] ** 2 + clean_spec[:, 1] ** 2)[:, None]
    masked_mag = torch.sqrt(masked_spec[:, 0] ** 2
                            + masked_spec[:, 1] ** 2)[:, None]
    clean_norm_log, mean, std = preprocess_log_magnitude(clean_mag)
    masked_norm_log = (torch.log(masked_mag + 1e-6) - mean) / std
    if return_stats:
        return clean_norm_log, mask4, masked_norm_log, mean, std
    return clean_norm_log, mask4, masked_norm_log
