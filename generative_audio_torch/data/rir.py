"""Synthetic room impulse responses (image-source method). The port's own
copy of generative_audio_tpu/data/rir.py:29-119.

The reference's DNS training mixes with probability `reverb_proportion`
against a corpus of measured RIR wavs listed in an scp file
(fullsubnet_plus/dataset/dataset_train.py:129-182; our
data/dns_dataset.py). The repo ships no RIR corpus, so the corpus is
generated: the classic Allen & Berkley image-source model for a
rectangular room with uniform frequency-independent wall reflectivity
derived from a target RT60 via Sabine's formula, fractional delays
rendered as windowed-sinc taps.

Everything is vectorized numpy on the host (this is corpus generation,
not the compute path): images are enumerated on a parity x order grid,
pruned by arrival time, and scattered into the response with np.add.at.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["image_source_rir", "make_rir_bank"]

SPEED_OF_SOUND = 343.0
_SINC_HALF = 40                      # windowed-sinc tap half-width


def _reflection_coeff(room: np.ndarray, rt60: float) -> float:
    """Uniform wall reflection coefficient from Sabine's formula:
    RT60 = 0.161 V / (alpha S)  =>  alpha = 0.161 V / (RT60 S)."""
    lx, ly, lz = room
    volume = lx * ly * lz
    surface = 2 * (lx * ly + lx * lz + ly * lz)
    alpha = 0.161 * volume / (max(rt60, 1e-3) * surface)
    alpha = float(np.clip(alpha, 0.01, 0.97))
    return float(np.sqrt(1.0 - alpha))


def image_source_rir(room: Sequence[float], src: Sequence[float],
                     mic: Sequence[float], rt60: float = 0.3,
                     sr: int = 16000, length: Optional[int] = None,
                     max_order: Optional[int] = None) -> np.ndarray:
    """RIR for a rectangular `room` (meters) between `src` and `mic`.

    Returns a float32 response of `length` samples (default 1.2 * RT60),
    peak-normalized to 0.999 like typical measured-RIR corpora so
    snr_mix's dBFS handling downstream sees comparable levels.
    """
    room = np.asarray(room, np.float64)
    src = np.asarray(src, np.float64)
    mic = np.asarray(mic, np.float64)
    assert np.all((0 < src) & (src < room)), "source outside room"
    assert np.all((0 < mic) & (mic < room)), "mic outside room"

    if length is None:
        length = int(1.2 * rt60 * sr) + 2 * _SINC_HALF + 1
    beta = _reflection_coeff(room, rt60)
    # enough image orders to cover the response length in every dimension
    if max_order is None:
        max_dist = SPEED_OF_SOUND * length / sr
        max_order = int(np.ceil(max_dist / (2 * float(room.min())))) + 1
        max_order = min(max_order, 14)

    n = np.arange(-max_order, max_order + 1)
    ns = np.stack(np.meshgrid(n, n, n, indexing="ij"), -1).reshape(-1, 3)
    out = np.zeros(length + 2 * _SINC_HALF + 1, np.float64)
    t_img = np.arange(-_SINC_HALF, _SINC_HALF + 1)
    window = 0.5 + 0.5 * np.cos(np.pi * t_img / (_SINC_HALF + 1))

    for parity in range(8):
        p = np.array([(parity >> k) & 1 for k in range(3)], np.float64)
        pos = (1 - 2 * p) * src + 2 * ns * room            # [K, 3]
        d = np.linalg.norm(pos - mic, axis=1)
        delay = d / SPEED_OF_SOUND * sr
        refl = np.abs(ns - p).sum(axis=1) + np.abs(ns).sum(axis=1)
        keep = delay < length - 1
        d, delay, refl = d[keep], delay[keep], refl[keep]
        amp = beta ** refl / (4 * np.pi * np.maximum(d, 1e-2))
        base = np.floor(delay).astype(np.int64)
        frac = delay - base
        # windowed-sinc fractional-delay taps, vectorized over images
        taps = np.sinc(t_img[None, :] - frac[:, None]) * window[None, :]
        idx = base[:, None] + t_img[None, :] + _SINC_HALF
        np.add.at(out, idx.ravel(), (amp[:, None] * taps).ravel())

    rir = out[_SINC_HALF:_SINC_HALF + length]
    peak = np.abs(rir).max()
    return (0.999 * rir / peak).astype(np.float32) if peak > 0 \
        else rir.astype(np.float32)


def make_rir_bank(out_dir, n: int = 40, seed: int = 0, sr: int = 16000,
                  rt60_range: Tuple[float, float] = (0.15, 0.6),
                  room_range: Tuple[float, float] = (3.0, 8.0)) -> Path:
    """Generate `n` random-room RIR wavs under `out_dir` and write the
    scp list data/dns_dataset.py consumes. Returns the scp path."""
    from generative_audio_torch.data.audio_io import write_wav

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        room = rng.uniform(room_range[0], room_range[1], 3)
        room[2] = rng.uniform(2.4, 3.5)                 # plausible ceiling
        src = rng.uniform(0.5, room - 0.5)
        mic = rng.uniform(0.5, room - 0.5)
        while np.linalg.norm(src - mic) < 0.3:          # avoid coincident
            mic = rng.uniform(0.5, room - 0.5)
        rt60 = float(rng.uniform(*rt60_range))
        rir = image_source_rir(room, src, mic, rt60=rt60, sr=sr)
        path = out_dir / f"rir_{i:03d}.wav"
        write_wav(path, rir, sr)
        paths.append(path)
    scp = out_dir / "rir.scp"
    scp.write_text("\n".join(str(p) for p in paths) + "\n")
    return scp
