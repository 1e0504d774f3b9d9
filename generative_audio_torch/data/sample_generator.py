"""TestSampleGenerator: write N (noisy, clean) wav pairs at a fixed SNR;
write_synthetic_corpus: clean and noise wavs for tests and smoke runs.

The port's own copy of generative_audio_tpu/data/sample_generator.py
(reference: dataset/sample_generator.py:27-69). The pairs come from the
port's AudioDataset, so item i is mixed from the generator of (seed, 0, i).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from generative_audio_torch.data.audio_dataset import (
    AudioDataset, AudioDataSetConfig)
from generative_audio_torch.data.audio_io import write_wav

__all__ = ["TestSampleGenerator", "write_synthetic_corpus"]


class TestSampleGenerator:
    def __init__(self, config: AudioDataSetConfig, output_dir: str,
                 snr: float = 10.0, seed: int = 0):
        self.dataset = AudioDataset(config, seed=seed)
        # pin the SNR range to a single value like the reference generator
        self.dataset.config.snr_range = (snr, snr)
        self.output_dir = Path(output_dir)
        self.sr = config.sample_rate

    def generate(self, n_samples: int):
        noisy_dir = self.output_dir / "noisy"
        clean_dir = self.output_dir / "clean"
        noisy_dir.mkdir(parents=True, exist_ok=True)
        clean_dir.mkdir(parents=True, exist_ok=True)
        for i in range(min(n_samples, len(self.dataset))):
            noisy, clean = self.dataset[i]
            write_wav(noisy_dir / f"sample_{i:04d}.wav", noisy, self.sr)
            write_wav(clean_dir / f"sample_{i:04d}.wav", clean, self.sr)


def write_synthetic_corpus(root, n_clean: int = 4, n_noise: int = 3,
                           seconds: float = 4.0, sr: int = 16000,
                           seed: int = 0):
    """Synthetic speech-like and noise wavs for tests and smoke runs (the
    repo ships no corpus): `n_clean` harmonic stacks with vibrato and an
    envelope under clean/, `n_noise` white-noise clips under noise/."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    clean_dir = root / "clean"
    noise_dir = root / "noise"
    clean_dir.mkdir(parents=True, exist_ok=True)
    noise_dir.mkdir(parents=True, exist_ok=True)
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n_clean):
        # harmonic tone stack with vibrato + envelope: crude "speech"
        f0 = 90 + 40 * rng.random()
        sig = sum(np.sin(2 * np.pi * f0 * k * t
                         + 3 * np.sin(2 * np.pi * 3.0 * t)) / k
                  for k in range(1, 6))
        env = 0.5 * (1 + np.sin(2 * np.pi * (1.5 + rng.random()) * t))
        write_wav(clean_dir / f"clean_{i}.wav",
                  0.3 * sig * env / np.max(np.abs(sig)), sr)
    for i in range(n_noise):
        noise = rng.standard_normal(int(seconds * sr)) * 0.1
        write_wav(noise_dir / f"noise_{i}.wav", noise, sr)
    return clean_dir, noise_dir
