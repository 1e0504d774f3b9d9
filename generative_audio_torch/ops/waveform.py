"""Host-side waveform utilities (numpy) used by the data pipelines, the
validation tools and the corpus tools: peak and dBFS normalisation, clipping
test, random crops, 50%-overlap concatenation and the energy and
spectral-entropy voice-activity detectors.

The port's own copy of generative_audio_tpu/ops/waveform.py:27-294, numpy
on both sides, so the port's results equal the JAX package's exactly.
Reference: audio_zen/acoustics/feature.py:98-253 and the inpainting dataset's
normalization (dataset/audio_dataset_inpainting.py:155-168).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "norm_amplitude",
    "tailor_dB_FS",
    "normalize_to_dbfs",
    "is_clipped",
    "subsample",
    "aligned_subsample",
    "overlap_cat",
    "activity_detector",
    "energy_vad_segments",
    "spectral_entropy_vad_segments",
]


def norm_amplitude(y: np.ndarray, scalar: Optional[float] = None,
                   eps: float = 1e-6):
    """Peak-normalize. Ref feature.py:98-102."""
    if not scalar:
        scalar = np.max(np.abs(y)) + eps
    return y / scalar, scalar


def tailor_dB_FS(y: np.ndarray, target_dB_FS: float = -25, eps: float = 1e-6):
    """Scale to target dBFS RMS. Ref feature.py:105-109."""
    rms = np.sqrt(np.mean(y ** 2))
    scalar = 10 ** (target_dB_FS / 20) / (rms + eps)
    y = y * scalar
    return y, rms, scalar


def normalize_to_dbfs(y: np.ndarray, target_dB_FS: float = -25.0,
                      eps: float = 1e-8) -> np.ndarray:
    """The inpainting dataset's log-domain variant of dBFS normalization.
    Ref dataset/audio_dataset_inpainting.py:155-168 (_normalize_audio)."""
    rms = np.sqrt(np.mean(y ** 2))
    rms_db = 20 * np.log10(rms + eps)
    gain = 10 ** ((target_dB_FS - rms_db) / 20)
    return y * gain


def is_clipped(y: np.ndarray, clipping_threshold: float = 0.999) -> bool:
    """Ref feature.py:112-113."""
    return bool(np.any(np.abs(y) > clipping_threshold))


def subsample(data: np.ndarray, sub_sample_length: int,
              start_position: int = -1, return_start_position: bool = False,
              rng: Optional[np.random.Generator] = None):
    """Random fixed-length crop (zero-pad if short). Ref feature.py:151-179."""
    assert np.ndim(data) == 1, f"Only support 1D data. The dim is {np.ndim(data)}"
    rng = rng or np.random.default_rng()
    length = len(data)
    if length > sub_sample_length:
        if start_position < 0:
            start_position = int(rng.integers(0, length - sub_sample_length))
        data = data[start_position:start_position + sub_sample_length]
    elif length < sub_sample_length:
        data = np.append(
            data, np.zeros(sub_sample_length - length, dtype=np.float32))
    assert len(data) == sub_sample_length
    if return_start_position:
        return data, start_position
    return data


def aligned_subsample(data_a: np.ndarray, data_b: np.ndarray,
                      sub_sample_length: int,
                      rng: Optional[np.random.Generator] = None):
    """Same random crop applied to two aligned signals. Ref feature.py:123-148."""
    assert data_a.shape[-1] == data_b.shape[-1], "Inconsistent dataset size."
    rng = rng or np.random.default_rng()
    length = data_a.shape[-1]
    if length > sub_sample_length:
        start = int(rng.integers(0, length - sub_sample_length + 1))
        end = start + sub_sample_length
        return data_a[..., start:end], data_b[..., start:end]
    if length < sub_sample_length:
        pad_width = [(0, 0)] * (data_a.ndim - 1) + [(0, sub_sample_length - length)]
        return (np.pad(data_a, pad_width), np.pad(data_b, pad_width))
    return data_a, data_b


def overlap_cat(chunk_list: List[np.ndarray], axis: int = -1) -> np.ndarray:
    """50%-overlap chunk concatenation (averaging the shared halves).
    Ref feature.py:182-203."""
    pieces: List[np.ndarray] = []
    for i, chunk in enumerate(chunk_list):
        half = chunk.shape[axis] // 2
        first_half = np.take(chunk, np.arange(half), axis=axis)
        last_half = np.take(chunk, np.arange(half, chunk.shape[axis]), axis=axis)
        if i == 0:
            pieces += [first_half, last_half]
        else:
            pieces[-1] = (pieces[-1] + first_half) / 2
            pieces.append(last_half)
    return np.concatenate(pieces, axis=axis)


def activity_detector(audio: np.ndarray, fs: int = 16000,
                      activity_threshold: float = 0.13,
                      target_level: float = -25, eps: float = 1e-6) -> float:
    """Percentage of 50 ms windows above a smoothed energy threshold.
    Ref feature.py:206-253."""
    audio, _, _ = tailor_dB_FS(audio, target_level)
    window_samples = int(fs * 50 / 1000)
    sample_start = 0
    cnt = 0
    prev_energy_prob = 0.0
    active_frames = 0
    a, b = -1, 0.2
    alpha_rel, alpha_att = 0.05, 0.8

    while sample_start < len(audio):
        audio_win = audio[sample_start:min(sample_start + window_samples,
                                           len(audio))]
        frame_rms = 20 * np.log10(np.sum(audio_win ** 2) + eps)
        frame_energy_prob = 1.0 / (1 + np.exp(-(a + b * frame_rms)))
        if frame_energy_prob > prev_energy_prob:
            smoothed = (frame_energy_prob * alpha_att
                        + prev_energy_prob * (1 - alpha_att))
        else:
            smoothed = (frame_energy_prob * alpha_rel
                        + prev_energy_prob * (1 - alpha_rel))
        if smoothed > activity_threshold:
            active_frames += 1
        prev_energy_prob = frame_energy_prob
        sample_start += window_samples
        cnt += 1
    return active_frames / cnt


def energy_vad_segments(audio: np.ndarray, fs: int = 16000,
                        activity_threshold: float = 0.13,
                        target_level: float = -25,
                        min_duration_ms: int = 100) -> List[Tuple[int, int]]:
    """Speech-segment detector built on the reference's energy VAD — the
    native replacement for the silero-VAD torch.hub dependency used for
    inpainting-mask placement (dataset/audio_dataset_inpainting.py:116-121,
    183-221). Returns [(start_sample, end_sample), ...] of active runs.
    """
    scaled, _, _ = tailor_dB_FS(audio.astype(np.float64), target_level)
    window_samples = int(fs * 50 / 1000)
    n_windows = int(np.ceil(len(scaled) / window_samples))
    a, b = -1, 0.2
    alpha_rel, alpha_att = 0.05, 0.8
    prev_energy_prob = 0.0
    active = np.zeros(n_windows, dtype=bool)
    for w in range(n_windows):
        win = scaled[w * window_samples:(w + 1) * window_samples]
        frame_rms = 20 * np.log10(np.sum(win ** 2) + 1e-6)
        frame_energy_prob = 1.0 / (1 + np.exp(-(a + b * frame_rms)))
        if frame_energy_prob > prev_energy_prob:
            smoothed = (frame_energy_prob * alpha_att
                        + prev_energy_prob * (1 - alpha_att))
        else:
            smoothed = (frame_energy_prob * alpha_rel
                        + prev_energy_prob * (1 - alpha_rel))
        active[w] = smoothed > activity_threshold
        prev_energy_prob = frame_energy_prob

    min_windows = max(1, int(np.ceil(min_duration_ms / 50)))
    segments: List[Tuple[int, int]] = []
    run_start = None
    for w in range(n_windows + 1):
        if w < n_windows and active[w]:
            if run_start is None:
                run_start = w
        else:
            if run_start is not None and (w - run_start) >= min_windows:
                segments.append((run_start * window_samples,
                                 min(w * window_samples, len(audio))))
            run_start = None
    return segments


def spectral_entropy_vad_segments(
        audio: np.ndarray, fs: int = 16000,
        frame_ms: int = 25, hop_ms: int = 10,
        energy_percentile: float = 60.0,
        entropy_threshold: float = 0.52,
        band_ratio_threshold: float = 0.96,
        hangover_frames: int = 4,
        edge_erosion_frames: int = 1,
        min_duration_ms: int = 100) -> List[Tuple[int, int]]:
    """Silero-class speech-segment detector for inpainting mask placement
    (upgrade of energy_vad_segments behind the dataset's `vad_fn` hook;
    ref dataset/audio_dataset_inpainting.py:116-121,189-197 used silero-VAD
    via torch.hub).

    Three per-frame features over 25 ms windows:
      * log energy vs an adaptive noise floor (the 10th-percentile frame
        energy): rejects silence regardless of recording level;
      * normalized spectral entropy of the 80-4000 Hz power spectrum:
        voiced speech is harmonic -> peaky spectrum -> LOW entropy, while
        broadband noise is flat -> entropy near 1. This is what separates
        "loud" from "speech" — the energy VAD's failure mode;
      * speech-band ratio: fraction of total power inside 80-4000 Hz
        (rejects rumble and hiss concentrated outside the speech band).

    A frame is speech when the energy gate passes AND (entropy is low OR
    the band ratio is high while entropy is moderate). A hangover keeps
    short intra-word dips attached to their segment. Returns
    [(start_sample, end_sample), ...] like energy_vad_segments.
    """
    audio = np.asarray(audio, np.float64).reshape(-1)
    frame = int(fs * frame_ms / 1000)
    hop = int(fs * hop_ms / 1000)
    if len(audio) < frame:
        return []
    n_frames = 1 + (len(audio) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = audio[idx] * np.hanning(frame)[None, :]

    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2        # [n_frames, F]
    freqs = np.fft.rfftfreq(frame, 1.0 / fs)
    total = spec.sum(axis=1) + 1e-12

    band = (freqs >= 80.0) & (freqs <= 4000.0)
    band_power = spec[:, band]
    band_total = band_power.sum(axis=1) + 1e-12
    band_ratio = band_total / total

    p = band_power / band_total[:, None]
    # normalized entropy in [0, 1]: 1 = flat (noise), ~0 = single peak
    entropy = -(p * np.log(p + 1e-12)).sum(axis=1) / np.log(p.shape[1])

    log_e = 10.0 * np.log10(total)
    floor = np.percentile(log_e, 10.0)
    gate = np.percentile(log_e, energy_percentile)
    # energy gate: clearly above the noise floor AND in the louder mass of
    # the clip (voiced speech is energetic; quiet low-entropy tails diluted
    # placement quality in the scripts/vad_ab.py sweep)
    energetic = (log_e > floor + 6.0) & (log_e > gate)

    # Thresholds fit to MEASURED per-frame stats, YIN-voiced-conditioned,
    # on the evidence corpus, then swept jointly for mask-placement
    # quality (scripts/vad_ab.py; sweep recorded in
    # artifacts/inpainting_e2e/vad_ab.json):
    #   entropy  voiced p25/50/75 0.26/0.44/0.53, unvoiced 0.53/0.61/0.70
    #   ratio    voiced p25 0.96,                unvoiced p50 0.88
    # and on synthetic probes: harmonic stack entropy ~0.5, white noise
    # ~0.91 (ratio ~0.49). The secondary branch admits near-fully-band-
    # concentrated frames with slightly higher entropy (voiced transitions).
    speechy = entropy < entropy_threshold
    speechy |= (band_ratio > band_ratio_threshold) & (entropy < 0.62)
    active = energetic & speechy

    # hangover as morphological CLOSING (dilate then erode): bridges stop
    # closures / intra-word gaps up to hangover_frames wide WITHOUT
    # extending segment outer edges into silence — plain dilation diluted
    # mask-placement quality in the scripts/vad_ab.py A/B
    if hangover_frames > 0 and active.any():
        kernel = np.ones(hangover_frames + 1, dtype=np.int64)
        dilated = np.convolve(active.astype(np.int64), kernel,
                              mode="same") > 0
        active = np.convolve((~dilated).astype(np.int64), kernel,
                             mode="same") == 0
    # then erode outer edges: the 25 ms analysis window makes boundary
    # frames half-silence — trimming one frame per side measured best
    if edge_erosion_frames > 0 and active.any():
        ke = np.ones(2 * edge_erosion_frames + 1, dtype=np.int64)
        active = np.convolve((~active).astype(np.int64), ke,
                             mode="same") == 0

    min_frames = max(1, int(np.ceil(min_duration_ms / hop_ms)))
    segments: List[Tuple[int, int]] = []
    run_start = None
    for i in range(n_frames + 1):
        if i < n_frames and active[i]:
            if run_start is None:
                run_start = i
        else:
            if run_start is not None and (i - run_start) >= min_frames:
                # segment-core quality gate: a run whose median entropy is
                # not below the voiced threshold is a marginal cluster of
                # secondary-branch frames — drop it (placement quality
                # beats recall for mask placement)
                if np.median(entropy[run_start:i]) < entropy_threshold:
                    segments.append((run_start * hop,
                                     min((i - 1) * hop + frame, len(audio))))
            run_start = None
    return segments
