"""DNS-Challenge style datasets: the training dataset (scp-file driven
dynamic mixing), the validation dataset and the inference dataset.

The port's own copy of generative_audio_tpu/data/dns_dataset.py (reference:
fullsubnet_plus/dataset/dataset_train.py, an identical copy in fullsubnet/:
scp lists with offset/limit, noise+silence fill, RIR convolution with
probability reverb_proportion, SNR list parsing; and the validation and
inference datasets, fullsubnet/dataset/dataset_validation.py:11-92 and
dataset_inference.py:34-39).

DNSTrainDataset draws item `i` of epoch `e` from its own generator,
`np.random.default_rng([seed, e, i])` (data/audio_dataset.item_rng), where
the JAX dataset shares one generator across the loader's threads; the draws
within an item are the JAX dataset's, in its order.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from generative_audio_torch.data.audio_dataset import item_rng, resolve_seed
from generative_audio_torch.data.audio_io import load_audio
from generative_audio_torch.data.mixing import build_noise_track, snr_mix
from generative_audio_torch.ops.waveform import subsample

__all__ = ["DNSTrainConfig", "DNSTrainDataset", "DNSValidationDataset",
           "InferenceDataset", "parse_snr_range"]


def parse_snr_range(snr_range: Sequence[int]) -> List[int]:
    """[low, high] -> [low, low+1, ..., high]. Ref base_dataset.py."""
    assert len(snr_range) == 2, (
        f"The range of SNR should be [low, high], not {snr_range}")
    low, high = snr_range
    assert low <= high, "low > high in snr_range"
    return list(range(low, high + 1))


def _read_scp(path: str, offset: int = 0, limit: Optional[int] = None
              ) -> List[str]:
    with open(Path(path).expanduser()) as f:
        lines = [line.rstrip("\n") for line in f]
    if offset > 0:
        lines = lines[offset:]
    if limit:
        lines = lines[:limit]
    return lines


@dataclasses.dataclass
class DNSTrainConfig:
    """Mirrors train.toml [train_dataset.args]."""
    clean_dataset: str
    noise_dataset: str
    rir_dataset: Optional[str] = None
    clean_dataset_offset: int = 0
    clean_dataset_limit: Optional[int] = None
    noise_dataset_offset: int = 0
    noise_dataset_limit: Optional[int] = None
    rir_dataset_offset: int = 0
    rir_dataset_limit: Optional[int] = None
    snr_range: Tuple[int, int] = (-5, 20)
    reverb_proportion: float = 0.75
    silence_length: float = 0.2
    target_dB_FS: float = -25
    target_dB_FS_floating_value: float = 10
    sub_sample_length: float = 3.072
    sr: int = 16000


class DNSTrainDataset:
    def __init__(self, config: DNSTrainConfig, seed: Optional[int] = None):
        c = config
        self.config = c
        self.clean_list = _read_scp(c.clean_dataset, c.clean_dataset_offset,
                                    c.clean_dataset_limit)
        self.noise_list = _read_scp(c.noise_dataset, c.noise_dataset_offset,
                                    c.noise_dataset_limit)
        self.rir_list = (_read_scp(c.rir_dataset, c.rir_dataset_offset,
                                   c.rir_dataset_limit)
                         if c.rir_dataset else [])
        if not 0 <= c.reverb_proportion <= 1:
            raise ValueError("reverberation proportion should be in [0, 1]")
        self.snr_list = parse_snr_range(c.snr_range)
        self.seed = resolve_seed(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.clean_list)

    def __getitem__(self, item: int) -> Tuple[np.ndarray, np.ndarray]:
        c = self.config
        rng = item_rng(self.seed, self.epoch, item)
        clean_y = load_audio(self.clean_list[item], c.sr)
        clean_y = subsample(clean_y, int(c.sub_sample_length * c.sr), rng=rng)

        def sample_noise():
            path = self.noise_list[int(rng.integers(0, len(self.noise_list)))]
            return load_audio(path, c.sr)

        noise_y = build_noise_track(len(clean_y), sample_noise,
                                    int(c.sr * c.silence_length), rng=rng)
        snr = self.snr_list[int(rng.integers(0, len(self.snr_list)))]
        use_reverb = bool(rng.random() < c.reverb_proportion) and self.rir_list
        rir = (load_audio(self.rir_list[
            int(rng.integers(0, len(self.rir_list)))], c.sr)
            if use_reverb else None)

        noisy_y, clean_y = snr_mix(
            clean_y=clean_y, noise_y=noise_y, snr=snr,
            target_dB_FS=c.target_dB_FS,
            target_dB_FS_floating_value=c.target_dB_FS_floating_value,
            rir=rir, rng=rng)
        return noisy_y.astype(np.float32), clean_y.astype(np.float32)


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
