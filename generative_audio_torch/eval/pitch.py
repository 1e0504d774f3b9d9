"""Pitch tracking for the NPPC validator's pitch comparisons.

The port's own copy of generative_audio_tpu/eval/pitch.py:18-78 (numpy): a
YIN tracker (de Cheveigné & Kawahara 2002) in place of the reference's
librosa.pyin. The difference function by FFT autocorrelation,
cumulative-mean normalisation, an absolute threshold with parabolic
interpolation, and a voicing decision.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["yin_pitch_track"]


def _difference_function(frame: np.ndarray, max_tau: int) -> np.ndarray:
    """d(tau) = sum_j (x_j - x_{j+tau})^2 computed via FFT autocorrelation."""
    n = len(frame)
    size = 1
    while size < 2 * n:
        size <<= 1
    fft = np.fft.rfft(frame, size)
    acf = np.fft.irfft(fft * np.conj(fft))[:max_tau + 1]
    cumsum = np.concatenate([[0], np.cumsum(frame ** 2)])
    energies = cumsum[n] - cumsum[:max_tau + 1]          # sum x_{j}^2 tails
    head = cumsum[n - np.arange(max_tau + 1)]            # sum of first n-tau
    return head + energies - 2 * acf


def _cmndf(d: np.ndarray) -> np.ndarray:
    out = np.ones_like(d)
    running = np.cumsum(d[1:])
    out[1:] = d[1:] * np.arange(1, len(d)) / np.maximum(running, 1e-12)
    return out


def yin_pitch_track(audio: np.ndarray, sr: int = 16000,
                    fmin: float = 65.0, fmax: float = 600.0,
                    frame_length: int = 1024, hop_length: int = 256,
                    threshold: float = 0.15
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (f0 [n_frames] in Hz with NaN where unvoiced,
    voiced_flag [n_frames] bool, times [n_frames] seconds)."""
    audio = np.asarray(audio, np.float64)
    tau_min = max(2, int(sr / fmax))
    tau_max = min(frame_length - 1, int(sr / fmin))
    n_frames = max(0, 1 + (len(audio) - frame_length) // hop_length)
    f0 = np.full(n_frames, np.nan)
    voiced = np.zeros(n_frames, bool)
    for i in range(n_frames):
        frame = audio[i * hop_length:i * hop_length + frame_length]
        d = _difference_function(frame, tau_max)
        cm = _cmndf(d)
        tau = -1
        for t in range(tau_min, tau_max):
            if cm[t] < threshold:
                while t + 1 < tau_max and cm[t + 1] < cm[t]:
                    t += 1
                tau = t
                break
        if tau == -1:
            tau = int(np.argmin(cm[tau_min:tau_max])) + tau_min
            if cm[tau] >= 0.5:  # clearly unvoiced
                continue
        # parabolic interpolation around tau
        if 1 <= tau < len(cm) - 1:
            a, b, c = cm[tau - 1], cm[tau], cm[tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            tau_refined = tau + np.clip(shift, -1, 1)
        else:
            tau_refined = float(tau)
        f0[i] = sr / tau_refined
        voiced[i] = True
    times = (np.arange(n_frames) * hop_length + frame_length // 2) / sr
    return f0, voiced, times
