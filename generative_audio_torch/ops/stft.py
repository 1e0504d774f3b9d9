"""STFT / iSTFT front end with the reference's torch.stft conventions.

Port of generative_audio_tpu/ops/stft.py: periodic Hann window, center=True
with reflect padding, onesided and un-normalised. The analysis side is
`torch.stft`; the synthesis side is `torch.fft.irfft` plus an overlap-add
(`F.fold`) written out here, because `torch.istft` raises where the window
envelope is near zero instead of keeping the reference's `env > 1e-11`
guard, and its `length` handling is what `istft_ri` has to reproduce
exactly (crop after the centre padding, zero-fill past the end). The
complex-valued functions (`stft`, `istft`, `mc_stft`, `mag_phase`) take and
give complex64, on the card too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["hann_window", "frame_signal", "stft", "stft_ri", "istft",
           "istft_ri", "mc_stft", "mag_phase", "stft_real_imag",
           "audio_to_stft", "prepare_input_from_waveform"]


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window, torch.hann_window(win_length) computed in float64
    and rounded once to `dtype`, as the JAX package computes it."""
    return torch.hann_window(win_length, periodic=True, dtype=torch.float64,
                             device=device).to(dtype)


def _padded_window(win_length: int, n_fft: int, device) -> torch.Tensor:
    """Hann window zero-padded to n_fft, centred (torch.stft convention)."""
    w = hann_window(win_length, device=device)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        w = F.pad(w, (left, n_fft - win_length - left))
    return w


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """[..., L] -> [..., T, n_fft] frames, reflect-padded by n_fft // 2 on
    both sides if center."""
    if center:
        lead = y.shape[:-1]
        pad = n_fft // 2
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
        y = y.reshape(lead + y.shape[-1:])
    return y.unfold(-1, n_fft, hop_length)


def stft_ri(y: torch.Tensor, n_fft: int, hop_length: int,
            win_length: Optional[int] = None, center: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-valued STFT: [..., L] -> (real, imag), each [..., F, T] float32."""
    if win_length is None:
        win_length = n_fft
    lead = y.shape[:-1]
    spec = torch.stft(y.reshape(-1, y.shape[-1]).float(), n_fft, hop_length,
                      win_length, window=hann_window(win_length,
                                                     device=y.device),
                      center=center, pad_mode="reflect", normalized=False,
                      onesided=True, return_complex=True)
    spec = spec.reshape(lead + spec.shape[-2:])
    return spec.real.contiguous(), spec.imag.contiguous()


def stft(y: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, center: bool = True
         ) -> torch.Tensor:
    """torch.stft's complex64 [..., F, T] with the reference's conventions
    (one torch.stft, whichever of its two methods the JAX function takes)."""
    real, imag = stft_ri(y, n_fft, hop_length, win_length, center)
    return torch.complex(real, imag)


def _overlap_add(frames: torch.Tensor, hop_length: int,
                 out_length: int) -> torch.Tensor:
    """[N, T, n_fft] -> [N, out_length] overlap-add."""
    n, _, n_fft = frames.shape
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_length),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(n, out_length)


def istft_ri(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
             hop_length: int, win_length: Optional[int] = None,
             length: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """Real-valued inverse STFT matching torch.istft: [..., F, T] x2 -> [..., L].

    The window-square envelope divides only where it exceeds 1e-11. With
    `length`, the output starts after the centre padding and holds `length`
    samples: the tail padding serves a requested tail, zeros fill beyond it.
    """
    if win_length is None:
        win_length = n_fft
    lead = spec_real.shape[:-2]
    n_freq, n_frames = spec_real.shape[-2:]
    spec = torch.complex(spec_real.float(), spec_imag.float())
    spec = spec.reshape(-1, n_freq, n_frames).transpose(1, 2)   # [N, T, F]
    window = _padded_window(win_length, n_fft, spec_real.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    expected = (n_frames - 1) * hop_length + n_fft
    y = _overlap_add(frames, hop_length, expected)
    env = _overlap_add((window ** 2).expand(1, n_frames, n_fft), hop_length,
                       expected)
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))

    pad = n_fft // 2 if center else 0
    y = y[:, pad:]
    if length is not None:
        if length <= y.shape[-1]:
            y = y[:, :length]
        else:
            y = F.pad(y, (0, length - y.shape[-1]))
    elif center:
        y = y[:, :expected - 2 * pad]
    return y.reshape(lead + y.shape[-1:])


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None, length: Optional[int] = None,
          center: bool = True) -> torch.Tensor:
    """istft_ri over a complex [..., F, T] spectrogram."""
    return istft_ri(spec.real, spec.imag, n_fft, hop_length, win_length,
                    length=length, center=center)


def mc_stft(y_s: torch.Tensor, n_fft: int, hop_length: int,
            win_length: Optional[int] = None) -> torch.Tensor:
    """Multi-channel STFT: [B, C, L] -> complex [B, C, F, T]."""
    if y_s.ndim != 3:
        raise ValueError(f"mc_stft takes [B, C, L], got {tuple(y_s.shape)}")
    return stft(y_s, n_fft, hop_length, win_length)


def mag_phase(complex_spec: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return complex_spec.abs(), complex_spec.angle()


def stft_real_imag(waveform: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: Optional[int] = None) -> torch.Tensor:
    """Waveform [B, L] (or [L]) -> stacked [B, 2, F, T] (real, imag)."""
    if waveform.ndim == 1:
        waveform = waveform[None]
    real, imag = stft_ri(waveform, n_fft, hop_length, win_length)
    return torch.stack([real, imag], dim=1)


audio_to_stft = stft_real_imag


def prepare_input_from_waveform(waveform: torch.Tensor, n_fft: int,
                                hop_length: int,
                                win_length: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Waveform [B, L] (or [L]) -> (mag, real, imag), each [B, 1, F, T]."""
    if waveform.ndim == 1:
        waveform = waveform[None]
    real, imag = stft_ri(waveform, n_fft, hop_length, win_length)
    mag = torch.sqrt(real ** 2 + imag ** 2)
    return mag[:, None], real[:, None], imag[:, None]
