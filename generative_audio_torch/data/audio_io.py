"""Audio file I/O for the serving path. The port's own copy of
generative_audio_tpu/data/audio_io.py (read_wav, write_wav, to_mono,
resample, load_audio): importing the JAX package's data module would pull
in JAX. WAV goes through scipy; FLAC through `soundfile` where it can be
imported (the native decoder of native/ is not bound yet)."""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

__all__ = ["read_wav", "write_wav", "to_mono", "resample", "load_audio"]


def read_wav(path) -> Tuple[int, np.ndarray]:
    """Read a WAV file -> (sample_rate, float32 array [T] or [T, C])."""
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return sr, data


def write_wav(path, data: np.ndarray, sr: int, subtype: str = "PCM_16"):
    """Write float audio to WAV: int16 by default, else float32."""
    data = np.asarray(data)
    if subtype == "PCM_16":
        clipped = np.clip(data, -1.0, 1.0)
        wavfile.write(str(path), sr, (clipped * 32767.0).astype(np.int16))
    else:
        wavfile.write(str(path), sr, data.astype(np.float32))


def to_mono(data: np.ndarray) -> np.ndarray:
    """[T] or [T, C] / [C, T] -> [T] by channel mean."""
    if data.ndim == 1:
        return data
    # wavfile gives [T, C]; torch-style gives [C, T]: take the small axis.
    axis = 1 if data.shape[1] < data.shape[0] else 0
    return data.mean(axis=axis)


def resample(data: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling by the reduced ratio target_sr / orig_sr."""
    if orig_sr == target_sr:
        return data
    g = np.gcd(orig_sr, target_sr)
    return resample_poly(data, target_sr // g, orig_sr // g).astype(np.float32)


def _load_flac(path: Path):
    try:
        import soundfile as sf
    except ImportError:
        raise ImportError(
            f"{path}: FLAC needs the soundfile package; the native decoder "
            "is not bound in generative_audio_torch yet (ROADMAP.md, queue A "
            "item 4)") from None
    data, file_sr = sf.read(str(path), dtype="float32")
    return data, file_sr


def load_audio(path, sr: Optional[int] = 16000) -> np.ndarray:
    """Load a .wav or .flac file as mono float32 at `sr` (None keeps the
    file's rate)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        file_sr, data = read_wav(path)
    elif suffix == ".flac":
        data, file_sr = _load_flac(path)
    else:
        raise ValueError(f"Unsupported audio format: {path}")
    data = to_mono(data).astype(np.float32)
    if sr is not None and file_sr != sr:
        data = resample(data, file_sr, sr)
    return data
