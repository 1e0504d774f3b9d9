"""AudioDataset: on-the-fly SNR mixing of clean and noise directory corpora.

The port's own copy of generative_audio_tpu/data/audio_dataset.py:43-121
(reference: dataset/audio_dataset.py:43-188, AudioDataset and
AudioDataSetConfig). Returns (noisy [T], clean [T]) float32 pairs.

One difference: item `i` of epoch `e` draws from its own generator,
`np.random.default_rng([seed, e, i])`, where the JAX dataset shares one
generator across the loader's worker threads. So an item is the same
whatever thread reads it and in whatever order, and a clip gets a new mix
each epoch (BatchLoader calls `set_epoch`). The draws within an item are the
JAX dataset's, in its order.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from generative_audio_torch.data.audio_io import load_audio
from generative_audio_torch.data.mixing import mix_with_snr

__all__ = ["AudioDataSetConfig", "AudioDataset", "item_rng"]


def item_rng(seed: int, epoch: int, item: int) -> np.random.Generator:
    """The generator of one item of one epoch."""
    return np.random.default_rng([seed, epoch, item])


def resolve_seed(seed: Optional[int]) -> int:
    """`seed`, or fresh entropy drawn once when it is None."""
    return int(np.random.SeedSequence().entropy) if seed is None else seed


@dataclasses.dataclass
class AudioDataSetConfig:
    """Mirrors dataset/audio_dataset.py:9-28 (computed lengths included)."""
    clean_path: str
    noisy_path: str
    sample_rate: int = 16000
    snr_range: Tuple[float, float] = (0, 20)
    silence_length: float = 0.2
    sub_sample_length_seconds: float = 3.0
    target_dB_FS: float = -25.0
    target_dB_FS_floating_value: float = 0.0
    file_glob: str = "*.wav"

    @property
    def sub_sample_length(self) -> int:
        return int(self.sub_sample_length_seconds * self.sample_rate)

    @property
    def silence_sample_length(self) -> int:
        return int(self.silence_length * self.sample_rate)


class AudioDataset:
    def __init__(self, config: AudioDataSetConfig,
                 seed: Optional[int] = None):
        self.config = config
        self.clean_files = sorted(
            Path(config.clean_path).resolve().rglob(config.file_glob))
        self.noise_files = sorted(
            Path(config.noisy_path).resolve().rglob(config.file_glob))
        if not self.clean_files:
            raise ValueError(
                f"No audio files found in clean directory: {config.clean_path}")
        if not self.noise_files:
            raise ValueError(
                f"No audio files found in noise directory: {config.noisy_path}")
        self.seed = resolve_seed(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.clean_files)

    def _load(self, path) -> Optional[np.ndarray]:
        try:
            data = load_audio(path, self.config.sample_rate)
        except Exception as e:  # noqa: BLE001 — skip unreadable files
            print(f"Error loading {path}: {e}")
            return None
        if data.size == 0:
            return None
        return data

    def _normalize(self, y: np.ndarray, rng: np.random.Generator
                   ) -> np.ndarray:
        c = self.config
        if c.target_dB_FS_floating_value > 0.0:
            target = rng.uniform(
                c.target_dB_FS - c.target_dB_FS_floating_value,
                c.target_dB_FS + c.target_dB_FS_floating_value)
        else:
            target = c.target_dB_FS
        rms = np.sqrt(np.mean(y ** 2))
        gain = 10 ** ((target - 20 * np.log10(rms + 1e-8)) / 20)
        return y * gain

    def _get_noise_segment(self, length: int, rng: np.random.Generator
                           ) -> np.ndarray:
        pieces = []
        total = 0
        silence = np.zeros(self.config.silence_sample_length, np.float32)
        while total < length:
            noise = self._load(self.noise_files[
                int(rng.integers(0, len(self.noise_files)))])
            if noise is None:
                continue
            noise = np.concatenate([self._normalize(noise, rng), silence])
            pieces.append(noise)
            total += len(noise)
        return np.concatenate(pieces)[:length]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = item_rng(self.seed, self.epoch, idx)
        clean = self._load(self.clean_files[idx])
        # bounded skip-forward: a fully unreadable corpus raises instead of
        # spinning forever
        for _ in range(len(self.clean_files)):
            if clean is not None:
                break
            idx = (idx + 1) % len(self.clean_files)
            clean = self._load(self.clean_files[idx])
        if clean is None:
            raise RuntimeError(
                f"No readable clean audio among {len(self.clean_files)} "
                f"files under {self.config.clean_path}")

        L = self.config.sub_sample_length
        if len(clean) > L:
            start = int(rng.integers(0, len(clean) - L))
            clean = clean[start:start + L]
        else:
            clean = np.pad(clean, (0, L - len(clean)))

        noise = self._get_noise_segment(L, rng)
        snr = rng.uniform(*self.config.snr_range)
        noisy, clean = mix_with_snr(self._normalize(clean, rng), noise, snr)
        return noisy.astype(np.float32), clean.astype(np.float32)
