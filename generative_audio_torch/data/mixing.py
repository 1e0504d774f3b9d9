"""SNR mixing primitives shared by the training datasets and the corpus
tools. The port's own copy of generative_audio_tpu/data/mixing.py:24-118
(numpy and scipy on both sides: the same generator gives the same mix).

References:
  simple mix  — dataset/audio_dataset.py:135-158 (_mix_with_snr: power-ratio
                scaling, 0.99 clip rescue applied to both signals)
  DNS mix     — fullsubnet_plus/dataset/dataset_train.py:129-182 (snr_mix:
                peak-norm + dBFS, RMS-ratio scaling, random noisy dBFS,
                clip rescue) with optional RIR fftconvolve.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import signal

from generative_audio_torch.ops.waveform import (
    norm_amplitude, tailor_dB_FS, is_clipped)

__all__ = ["mix_with_snr", "snr_mix", "build_noise_track", "speed_perturb"]


def speed_perturb(wav: np.ndarray, factor: float) -> np.ndarray:
    """Kaldi-style speed perturbation: resample by 1/factor and keep the
    nominal sample rate, so the signal plays `factor`x faster (shorter)
    with proportionally shifted pitch — the standard low-cost way to mint
    extra effective speakers from a small corpus. factor is snapped to a
    small rational (denominator <= 100) for an exact polyphase filter.

    Not a reference feature (the reference trains on train-clean-360 and
    needs no augmentation); provided for small-corpus regimes.
    """
    if factor <= 0:
        raise ValueError(f"speed factor must be > 0, got {factor}")
    if abs(factor - 1.0) < 1e-9:
        return np.asarray(wav, np.float32)
    from fractions import Fraction
    frac = Fraction(float(factor)).limit_denominator(100)
    # output_rate/input_rate = 1/factor: up = denominator, down = numerator
    return signal.resample_poly(
        np.asarray(wav, np.float32), frac.denominator, frac.numerator
    ).astype(np.float32)


def mix_with_snr(clean: np.ndarray, noise: np.ndarray, snr: float,
                 eps: float = 1e-8) -> Tuple[np.ndarray, np.ndarray]:
    """Power-ratio SNR mixing with shared clip rescue (AudioDataset style).
    Both inputs are assumed already dBFS-normalized."""
    clean_power = np.mean(clean ** 2)
    noise_power = np.mean(noise ** 2)
    snr_linear = 10 ** (snr / 10)
    scale = np.sqrt(clean_power / (snr_linear * noise_power + eps))
    noisy = clean + noise * scale
    max_amp = np.max(np.abs(noisy))
    if max_amp > 0.99:
        factor = 0.99 / max_amp
        noisy = noisy * factor
        clean = clean * factor
    return noisy, clean


def snr_mix(clean_y: np.ndarray, noise_y: np.ndarray, snr: float,
            target_dB_FS: float, target_dB_FS_floating_value: float,
            rir: Optional[np.ndarray] = None, eps: float = 1e-6,
            rng: Optional[np.random.Generator] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """The DNS trainer's mixing (dataset_train.py:129-182)."""
    rng = rng or np.random.default_rng()
    if rir is not None:
        if rir.ndim > 1:
            rir = rir[int(rng.integers(0, rir.shape[0]))]
        clean_y = signal.fftconvolve(clean_y, rir)[: len(clean_y)]

    clean_y, _ = norm_amplitude(clean_y)
    clean_y, _, _ = tailor_dB_FS(clean_y, target_dB_FS)
    clean_rms = np.sqrt(np.mean(clean_y ** 2))

    noise_y, _ = norm_amplitude(noise_y)
    noise_y, _, _ = tailor_dB_FS(noise_y, target_dB_FS)
    noise_rms = np.sqrt(np.mean(noise_y ** 2))

    snr_scalar = clean_rms / (10 ** (snr / 20)) / (noise_rms + eps)
    noisy_y = clean_y + noise_y * snr_scalar

    noisy_target_dB_FS = int(rng.integers(
        target_dB_FS - target_dB_FS_floating_value,
        target_dB_FS + target_dB_FS_floating_value))
    noisy_y, _, noisy_scalar = tailor_dB_FS(noisy_y, noisy_target_dB_FS)
    clean_y = clean_y * noisy_scalar

    if is_clipped(noisy_y):
        noisy_y_scalar = np.max(np.abs(noisy_y)) / (0.99 - eps)
        noisy_y = noisy_y / noisy_y_scalar
        clean_y = clean_y / noisy_y_scalar
    return noisy_y, clean_y


def build_noise_track(target_length: int, sample_noise, silence_samples: int,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Concatenate random noise clips with silence gaps, then random-crop to
    target_length (dataset_train.py:107-127, _select_noise_y)."""
    rng = rng or np.random.default_rng()
    pieces = []
    total = 0
    silence = np.zeros(silence_samples, np.float32)
    while total < target_length:
        noise = sample_noise()
        pieces.append(noise)
        total += len(noise)
        if total < target_length:
            take = min(target_length - total, silence_samples)
            pieces.append(silence[:take])
            total += take
    noise_y = np.concatenate(pieces) if pieces else np.zeros(target_length)
    if len(noise_y) > target_length:
        start = int(rng.integers(0, len(noise_y) - target_length))
        noise_y = noise_y[start:start + target_length]
    return noise_y.astype(np.float32)
