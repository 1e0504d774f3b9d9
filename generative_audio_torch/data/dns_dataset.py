"""The DNS validation dataset and the inference dataset. The port's own copy
of generative_audio_tpu/data/dns_dataset.py:110-155 (DNSValidationDataset,
InferenceDataset; ref fullsubnet/dataset/dataset_validation.py:11-92 and
dataset_inference.py:34-39)."""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

from generative_audio_torch.data.audio_io import load_audio

__all__ = ["DNSValidationDataset", "InferenceDataset"]


class DNSValidationDataset:
    """Paired (noisy, clean, name) items over the DNS test-set layout: each
    directory of `dataset_dir_list` holds `noisy/` and `clean/`, and a
    noisy wav is paired with the clean wav of the same fileid (the last
    `_`-separated part of the stem), else with the clean wav of its own
    name. A directory without `noisy/` adds nothing."""

    def __init__(self, dataset_dir_list: Sequence[str], sr: int = 16000):
        self.sr = sr
        self.pairs: List[Tuple[Path, Path, str]] = []
        for dataset_dir in dataset_dir_list:
            root = Path(dataset_dir).expanduser()
            noisy_dir = root / "noisy"
            clean_dir = root / "clean"
            if not noisy_dir.exists():
                continue
            for noisy_path in sorted(noisy_dir.glob("*.wav")):
                # DNS filenames end in a fileid: clean/clean_fileid_N.wav
                stem = noisy_path.stem
                fileid = stem.split("_")[-1]
                candidates = list(clean_dir.glob(f"*_{fileid}.wav"))
                clean_path = (candidates[0] if candidates
                              else clean_dir / noisy_path.name)
                self.pairs.append((noisy_path, clean_path, stem))

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        noisy_path, clean_path, name = self.pairs[idx]
        noisy = load_audio(noisy_path, self.sr)
        clean = load_audio(clean_path, self.sr)
        return noisy, clean, name


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
