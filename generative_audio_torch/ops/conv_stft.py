"""Conv-kernel STFT / iSTFT (sqrt-Hann, no centring), the streaming-friendly
front end of the multichannel features. Port of
generative_audio_tpu/ops/conv_stft.py:27-83.

The [L, 2F] analysis kernel is built in float64 with numpy, rounded to
float32 and cached. Analysis is one frames @ kernel product over the
[B, T, L] frames; synthesis is the product with the kernel's transpose and
an overlap-add (`F.fold`).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from generative_audio_torch.ops.stft import _overlap_add

__all__ = ["conv_stft_kernel", "conv_stft", "conv_istft"]


@functools.lru_cache(maxsize=8)
def conv_stft_kernel(frame_len: int, frame_hop: int,
                     num_fft: Optional[int] = None) -> np.ndarray:
    """[L, 2F] float32 analysis kernel: row k is sqrt-hann(k) * (cos, -sin)
    (2 pi k f / N) / S, S = 0.5 * sqrt(N * N / hop), N the next power of two
    of L unless num_fft is given (init_stft_kernel of the reference)."""
    n = num_fft or 2 ** int(np.ceil(np.log2(frame_len)))
    f = n // 2 + 1
    window = np.sqrt(np.hanning(frame_len + 1)[:-1].astype(np.float64))
    scale = 0.5 * (n * n / frame_hop) ** 0.5
    ang = 2.0 * np.pi * np.arange(frame_len)[:, None] * np.arange(f)[None, :] / n
    real_k = np.cos(ang) / scale * window[:, None]
    imag_k = -np.sin(ang) / scale * window[:, None]
    return np.concatenate([real_k, imag_k], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _kernel_on(frame_len: int, frame_hop: int, num_fft: Optional[int],
               device: torch.device) -> torch.Tensor:
    return torch.from_numpy(conv_stft_kernel(frame_len, frame_hop,
                                             num_fft)).to(device)


def conv_stft(x: torch.Tensor, frame_len: int, frame_hop: int,
              num_fft: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """[B, S] (or [S]) -> (mag, phase, real, imag), each [B, F, T]; frames
    of frame_len every frame_hop samples, no padding."""
    if x.ndim == 1:
        x = x[None]
    kernel = _kernel_on(frame_len, frame_hop, num_fft, x.device)
    frames = x.float().unfold(-1, frame_len, frame_hop)   # [B, T, L]
    spec = (frames @ kernel).transpose(1, 2)              # [B, 2F, T]
    real, imag = spec.chunk(2, dim=1)
    mag = torch.sqrt(real ** 2 + imag ** 2)
    return mag, torch.atan2(imag, real), real, imag


def conv_istft(mag: torch.Tensor, phase: torch.Tensor, frame_len: int,
               frame_hop: int, num_fft: Optional[int] = None) -> torch.Tensor:
    """(mag, phase) [B, F, T] -> [B, (T - 1) * hop + frame_len] waveform:
    the transposed convolution with the analysis kernel, as an overlap-add
    of kernel-weighted frames."""
    if mag.ndim == 2:
        mag, phase = mag[None], phase[None]
    kernel = _kernel_on(frame_len, frame_hop, num_fft, mag.device)
    spec = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1)
    frames = spec.transpose(1, 2) @ kernel.t()            # [B, T, L]
    n_frames = frames.shape[1]
    return _overlap_add(frames, frame_hop,
                        (n_frames - 1) * frame_hop + frame_len)
