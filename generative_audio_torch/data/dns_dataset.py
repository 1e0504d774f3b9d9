"""The inference dataset: a directory of noisy clips. The port's own copy of
generative_audio_tpu/data/dns_dataset.py:141-155 (InferenceDataset; ref
fullsubnet/dataset/dataset_inference.py:34-39)."""
from __future__ import annotations

from pathlib import Path

from generative_audio_torch.data.audio_io import load_audio

__all__ = ["InferenceDataset"]


class InferenceDataset:
    """Every file under `dataset_dir` matching `file_glob`, sorted: item i is
    (mono float32 waveform at `sr`, file stem)."""

    def __init__(self, dataset_dir: str, sr: int = 16000,
                 file_glob: str = "*.wav"):
        self.sr = sr
        self.files = sorted(Path(dataset_dir).expanduser().rglob(file_glob))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        path = self.files[idx]
        return load_audio(path, self.sr), path.stem
