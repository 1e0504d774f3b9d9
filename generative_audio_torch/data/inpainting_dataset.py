"""AudioInpaintingDataset: a LibriSpeech-style clean corpus with a time gap
and its STFT frame mask.

Port of generative_audio_tpu/data/inpainting_dataset.py:28-280 (reference
dataset/audio_dataset_inpainting.py): the config and sample dataclasses,
time_to_spec_mask, the `*.trans.txt` transcriptions, the gap placed by a VAD
(ops.waveform's spectral-entropy or energy detector, or an injected
`vad_fn`) or at random, and collate_inpainting. The STFT is the port's
ops.stft.stft_ri on the CPU.

Item seeding: with `config.seed` set, item i draws from
np.random.default_rng(config.seed + i), the reference's per-index seeding,
in every epoch. Without it, item i of epoch e draws from its own
np.random.default_rng([seed, e, i]) (the constructor's `seed`, fresh entropy
when None), as the port's other datasets do, where the JAX dataset shares
one generator across the loader's threads. The draws within an item are the
JAX dataset's, in its order.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from generative_audio_torch.data.audio_dataset import item_rng, resolve_seed
from generative_audio_torch.data.audio_io import load_audio
from generative_audio_torch.ops.stft import stft_ri
from generative_audio_torch.ops.waveform import (
    energy_vad_segments, spectral_entropy_vad_segments)
from generative_audio_torch.utils.logging import get_logger

__all__ = ["AudioInpaintingConfig", "AudioInpaintingSample",
           "AudioInpaintingDataset", "StftSettings", "time_to_spec_mask",
           "collate_inpainting"]


@dataclasses.dataclass
class StftSettings:
    nfft: int = 255
    hop_length: int = 128
    win_length: int = 255


@dataclasses.dataclass
class AudioInpaintingConfig:
    clean_path: str
    sample_rate: int = 16000
    missing_length_seconds: float = 0.128
    missing_start_seconds: Optional[float] = None
    sub_sample_length_seconds: float = 3.0
    target_dB_FS: float = -25.0
    target_dB_FS_floating_value: float = 0.0
    stft_configuration: StftSettings = dataclasses.field(
        default_factory=StftSettings)
    use_vad: bool = False
    # "entropy": ops.waveform.spectral_entropy_vad_segments; "energy": the
    # reference's energy VAD. An injected vad_fn takes precedence.
    vad_type: str = "entropy"
    seed: Optional[int] = None
    is_random_sub_sample: bool = True
    file_glob: str = "*.flac"

    @property
    def sub_sample_length(self) -> int:
        return int(self.sub_sample_length_seconds * self.sample_rate)

    @property
    def missing_length(self) -> int:
        return int(self.missing_length_seconds * self.sample_rate)


@dataclasses.dataclass
class AudioInpaintingSample:
    stft_masked: np.ndarray        # [2, F, T]
    mask_frames: np.ndarray        # [T]
    stft_clean: np.ndarray         # [2, F, T]
    masked_audio: np.ndarray       # [1, L]
    clean_audio_path: Path
    subsample_start_idx: int
    mask_start_idx: int
    mask_end_idx: int
    mask_start_frame_idx: int
    mask_end_frame_idx: int
    transcription: str
    sample_rate: int = 16000

    def get_training_tuple(self):
        return (self.stft_masked, self.mask_frames, self.stft_clean,
                self.masked_audio)

    @property
    def mask_start_time(self) -> float:
        return self.mask_start_idx / self.sample_rate

    @property
    def mask_end_time(self) -> float:
        return self.mask_end_idx / self.sample_rate

    @property
    def mask_duration(self) -> float:
        return (self.mask_end_idx - self.mask_start_idx) / self.sample_rate


def time_to_spec_mask(mask_time: np.ndarray, t_frames: int,
                      waveform_length: int, win_length: int, hop_length: int,
                      center: bool = True) -> np.ndarray:
    """Frame mask [t_frames]: a frame is masked (0) where any sample its
    window covers is masked."""
    mask_time = np.asarray(mask_time).reshape(-1)
    half = win_length // 2
    starts = np.arange(t_frames) * hop_length - (half if center else 0)
    ends = np.minimum(starts + win_length, waveform_length)
    starts = np.maximum(starts, 0)
    masked = (mask_time == 0).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(masked)])
    counts = csum[ends] - csum[starts]
    return ((ends > starts) & (counts == 0)).astype(np.float32)


def read_transcriptions(root: Path) -> Dict[str, str]:
    """LibriSpeech `*.trans.txt` lines `{file-id} {text}` under root."""
    out: Dict[str, str] = {}
    for trans_file in root.rglob("*.trans.txt"):
        with open(trans_file, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split(maxsplit=1)
                if len(parts) == 2:
                    out[parts[0]] = parts[1]
    return out


class AudioInpaintingDataset:
    """vad_fn(audio, sr) -> [(start, end), ...] places the gap when
    config.use_vad; seed: the base seed of the per-item generators where
    config.seed is None."""

    def __init__(self, config: AudioInpaintingConfig,
                 vad_fn: Optional[Callable] = None,
                 seed: Optional[int] = None):
        self.config = config
        self.clean_path = Path(config.clean_path).resolve()
        self.clean_files = sorted(self.clean_path.rglob(config.file_glob))
        if not self.clean_files and config.file_glob == "*.flac":
            self.clean_files = sorted(self.clean_path.rglob("*.wav"))
        if not self.clean_files:
            raise ValueError(
                f"No audio files found in directory: {self.clean_path}")
        self.transcriptions = read_transcriptions(self.clean_path)
        self.vad_fn = vad_fn
        self.seed = resolve_seed(seed)
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.clean_files)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rng(self, idx: int) -> np.random.Generator:
        if self.config.seed is not None:
            return np.random.default_rng(self.config.seed + idx)
        return item_rng(self.seed, self.epoch, idx)

    def _normalize(self, y: np.ndarray, rng) -> np.ndarray:
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

    def _create_random_mask(self, audio_length: int, rng
                            ) -> Tuple[np.ndarray, int, int]:
        mask = np.ones(audio_length, np.float32)
        if self.config.missing_start_seconds is None:
            start = int(rng.integers(
                0, audio_length - self.config.missing_length + 1))
        else:
            start = int(self.config.missing_start_seconds
                        * self.config.sample_rate)
        end = start + self.config.missing_length
        mask[start:end] = 0.0
        return mask, start, end

    def _create_mask(self, audio_length: int, audio: np.ndarray, rng
                     ) -> Tuple[np.ndarray, int, int]:
        """The gap inside a speech segment longer than it, or at random."""
        c = self.config
        if not c.use_vad:
            return self._create_random_mask(audio_length, rng)
        min_ms = int(c.missing_length_seconds * 1000)
        if self.vad_fn is not None:
            vad = self.vad_fn
        elif c.vad_type == "entropy":
            vad = (lambda a, sr: spectral_entropy_vad_segments(
                a, sr, min_duration_ms=min_ms))
        else:
            vad = (lambda a, sr: energy_vad_segments(
                a, sr, min_duration_ms=min_ms))
        segments = [s for s in vad(audio, c.sample_rate)
                    if s[1] - s[0] > c.missing_length]
        if not segments:
            return self._create_random_mask(audio_length, rng)
        seg_start, seg_end = segments[int(rng.integers(0, len(segments)))]
        max_start = (seg_end - seg_start) - c.missing_length
        start = seg_start + int(rng.integers(0, max_start + 1))
        end = start + c.missing_length
        mask = np.ones(audio_length, np.float32)
        mask[start:end] = 0.0
        return mask, start, end

    def __getitem__(self, idx: int) -> AudioInpaintingSample:
        c = self.config
        # an unreadable or short file hands on to the next one, at most one
        # pass over the corpus
        for attempt in range(len(self)):
            probe = (idx + attempt) % len(self)
            rng = self._rng(probe)
            clean_file = self.clean_files[probe]
            try:
                full_audio = load_audio(clean_file, c.sample_rate)
            except Exception as e:  # noqa: BLE001
                get_logger().warning(f"Error loading {clean_file}: {e}")
                continue
            full_audio = self._normalize(full_audio, rng)
            if len(full_audio) >= c.sub_sample_length:
                break
        else:
            raise RuntimeError(
                f"No usable audio >= {c.sub_sample_length_seconds}s among "
                f"{len(self)} files under {c.clean_path}")
        transcription = self.transcriptions.get(clean_file.stem, "")

        subsample_start = 0
        if len(full_audio) > c.sub_sample_length:
            if c.is_random_sub_sample:
                subsample_start = int(rng.integers(
                    0, len(full_audio) - c.sub_sample_length + 1))
            clean_audio = full_audio[
                subsample_start:subsample_start + c.sub_sample_length]
        else:
            clean_audio = full_audio

        mask, mask_start, mask_end = self._create_mask(
            len(clean_audio), clean_audio, rng)
        masked_audio = clean_audio * mask

        s = c.stft_configuration
        real, imag = stft_ri(torch.from_numpy(
            np.asarray(clean_audio, np.float32)[None]), s.nfft, s.hop_length,
            s.win_length)
        stft_clean = np.stack([real[0].numpy(), imag[0].numpy()])

        mask_frames = time_to_spec_mask(mask, stft_clean.shape[-1],
                                        len(masked_audio), s.win_length,
                                        s.hop_length)
        zero_frames = np.where(mask_frames == 0)[0]
        mask_start_frame = int(zero_frames[0]) if len(zero_frames) else 0
        mask_end_frame = int(zero_frames[-1]) if len(zero_frames) else 0
        stft_masked = stft_clean * mask_frames[None, None, :]

        return AudioInpaintingSample(
            stft_masked=stft_masked.astype(np.float32),
            mask_frames=mask_frames,
            stft_clean=stft_clean.astype(np.float32),
            masked_audio=masked_audio[None].astype(np.float32),
            clean_audio_path=clean_file,
            subsample_start_idx=subsample_start,
            mask_start_idx=mask_start,
            mask_end_idx=mask_end,
            mask_start_frame_idx=mask_start_frame,
            mask_end_frame_idx=mask_end_frame,
            transcription=transcription,
            sample_rate=c.sample_rate,
        )


def collate_inpainting(batch: List[AudioInpaintingSample]):
    """Samples -> (stft_masked [B, 2, F, T], mask_frames [B, T], stft_clean
    [B, 2, F, T], masked_audio [B, 1, L], metadata dict of lists)."""
    stft_masked = np.stack([b.stft_masked for b in batch])
    mask_frames = np.stack([b.mask_frames for b in batch])
    stft_clean = np.stack([b.stft_clean for b in batch])
    masked_audio = np.stack([b.masked_audio for b in batch])
    metadata = {
        "clean_audio_paths": [str(b.clean_audio_path) for b in batch],
        "subsample_start_idx": [b.subsample_start_idx for b in batch],
        "mask_start_idx": [b.mask_start_idx for b in batch],
        "mask_end_idx": [b.mask_end_idx for b in batch],
        "mask_start_frame_idx": [b.mask_start_frame_idx for b in batch],
        "mask_end_frame_idx": [b.mask_end_frame_idx for b in batch],
        "transcriptions": [b.transcription for b in batch],
        "sample_rates": [b.sample_rate for b in batch],
    }
    return stft_masked, mask_frames, stft_clean, masked_audio, metadata
