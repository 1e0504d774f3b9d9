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
import torch.distributed

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


def preprocess_log_magnitude(magnitude: torch.Tensor, eps: float = 1e-6,
                             group=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """log(mag + eps) normalised by the scalar batch mean and unbiased std.

    The two statistics couple the batch's rows. With a process group of
    more than one rank (DistributedDataParallel's) the batch is one rank's
    rows of a global batch, and they are the global batch's, as in the JAX
    mesh step (the count and the sum, then the centred squares, summed over
    the ranks)."""
    log_mag = torch.log(magnitude + eps)
    if group is None or torch.distributed.get_world_size(group) == 1:
        mean = log_mag.mean()
        std = log_mag.std()
        return (log_mag - mean) / std, mean, std
    from generative_audio_torch.parallel.distributed import all_reduce_sum
    count = torch.full((1,), log_mag.numel(), dtype=log_mag.dtype,
                       device=log_mag.device)
    sums = all_reduce_sum(torch.cat([log_mag.sum()[None], count]), group)
    mean = sums[0] / sums[1]
    ss = all_reduce_sum((log_mag - mean).square().sum(), group)
    std = torch.sqrt(ss / (sums[1] - 1))
    return (log_mag - mean) / std, mean, std


def expand_frame_mask(mask: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[B, T] frame mask -> [B, 1, F, T]."""
    return mask[:, None, None, :].expand(mask.shape[0], 1, num_freqs,
                                         mask.shape[-1])


def preprocess_data(clean_spec: torch.Tensor, masked_spec: torch.Tensor,
                    mask: torch.Tensor, return_stats: bool = False,
                    group=None):
    """STFT pairs [B, 2, F, T] and the frame mask [B, T] -> (clean log-mag
    normalised [B, 1, F, T], mask [B, 1, F, T], masked log-mag normalised
    with the clean statistics [B, 1, F, T]) [+ (mean, std)]. group: DDP's
    process group, whose global batch gives the statistics
    (preprocess_log_magnitude)."""
    mask4 = expand_frame_mask(mask, clean_spec.shape[2])
    clean_mag = torch.sqrt(clean_spec[:, 0] ** 2 + clean_spec[:, 1] ** 2)[:, None]
    masked_mag = torch.sqrt(masked_spec[:, 0] ** 2
                            + masked_spec[:, 1] ** 2)[:, None]
    clean_norm_log, mean, std = preprocess_log_magnitude(clean_mag,
                                                         group=group)
    masked_norm_log = (torch.log(masked_mag + 1e-6) - mean) / std
    if return_stats:
        return clean_norm_log, mask4, masked_norm_log, mean, std
    return clean_norm_log, mask4, masked_norm_log
