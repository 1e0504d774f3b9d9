"""Complex ideal ratio mask (cIRM) maths with the reference's saturation.

Port of generative_audio_tpu/ops/mask.py:28-101. The complex-valued
functions take and give complex64.
"""
from __future__ import annotations

from typing import Tuple

import torch

EPSILON = 1e-8

__all__ = ["build_ideal_ratio_mask", "build_complex_ideal_ratio_mask",
           "build_complex_ideal_ratio_mask_ri", "compress_cIRM",
           "decompress_cIRM", "complex_mul", "apply_crm",
           "crm_to_stft_components", "crm_to_spectrogram"]


def build_ideal_ratio_mask(noisy_mag: torch.Tensor,
                           clean_mag: torch.Tensor) -> torch.Tensor:
    """[B, F, T] magnitudes -> compressed IRM [B, F, T, 1]."""
    return compress_cIRM((clean_mag / (noisy_mag + EPSILON))[..., None])


def build_complex_ideal_ratio_mask_ri(noisy_real: torch.Tensor,
                                      noisy_imag: torch.Tensor,
                                      clean_real: torch.Tensor,
                                      clean_imag: torch.Tensor) -> torch.Tensor:
    """[B, F, T] components -> compressed cIRM [B, F, T, 2]."""
    denominator = noisy_real ** 2 + noisy_imag ** 2 + EPSILON
    mask_real = (noisy_real * clean_real + noisy_imag * clean_imag) / denominator
    mask_imag = (noisy_real * clean_imag - noisy_imag * clean_real) / denominator
    return compress_cIRM(torch.stack((mask_real, mask_imag), dim=-1))


def build_complex_ideal_ratio_mask(noisy: torch.Tensor,
                                   clean: torch.Tensor) -> torch.Tensor:
    """Complex [B, F, T] spectrograms -> compressed cIRM [B, F, T, 2]."""
    return build_complex_ideal_ratio_mask_ri(noisy.real, noisy.imag,
                                             clean.real, clean.imag)


def compress_cIRM(mask: torch.Tensor, K: float = 10.0,
                  C: float = 0.1) -> torch.Tensor:
    """Compress (-inf, inf) -> (-K, K), with the reference's -100 clamp."""
    mask = torch.where(mask <= -100.0, torch.full_like(mask, -100.0), mask)
    e = torch.exp(-C * mask)
    return K * (1.0 - e) / (1.0 + e)


def decompress_cIRM(mask: torch.Tensor, K: float = 10.0,
                    limit: float = 9.9) -> torch.Tensor:
    """Inverse of compress_cIRM, saturated at +/-limit."""
    mask = torch.clamp(mask, -limit, limit)
    return -K * torch.log((K - mask) / (K + mask))


def complex_mul(noisy_r: torch.Tensor, noisy_i: torch.Tensor,
                mask_r: torch.Tensor, mask_i: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex product of a spectrogram and a mask, in (real, imag) pairs."""
    return (noisy_r * mask_r - noisy_i * mask_i,
            noisy_r * mask_i + noisy_i * mask_r)


def apply_crm(crm: torch.Tensor, noisy_real: torch.Tensor,
              noisy_imag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a decompressed cRM [..., F, T, 2] to noisy STFT components."""
    enhanced_real = crm[..., 0] * noisy_real - crm[..., 1] * noisy_imag
    enhanced_imag = crm[..., 1] * noisy_real + crm[..., 0] * noisy_imag
    return enhanced_real, enhanced_imag


def crm_to_stft_components(crm: torch.Tensor, noisy_real: torch.Tensor,
                           noisy_imag: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mag, real, imag) of the spectrogram a decompressed cRM [..., F, T, 2]
    makes of the noisy one."""
    enhanced_real, enhanced_imag = apply_crm(crm, noisy_real, noisy_imag)
    enhanced_mag = torch.sqrt(enhanced_real ** 2 + enhanced_imag ** 2)
    return enhanced_mag, enhanced_real, enhanced_imag


def crm_to_spectrogram(crm: torch.Tensor,
                       noisy_complex: torch.Tensor) -> torch.Tensor:
    """A decompressed cRM [..., F, T, 2] applied to a complex noisy
    spectrogram -> the complex enhanced one."""
    return torch.complex(*apply_crm(crm, noisy_complex.real,
                                    noisy_complex.imag))
