"""Audio file I/O for the data pipelines and serving. The port's own copy of
generative_audio_tpu/data/audio_io.py (read_wav, write_wav, to_mono,
resample, load_audio): importing the JAX package's data module would pull
in JAX. WAV goes through scipy, or through the native decoder
(data/native.py) with GAT_NATIVE_AUDIO=1; FLAC through `soundfile` where it
can be imported, else through the native decoder (data/flac.py), which is
then built at first use."""
from __future__ import annotations

import os
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


def _native_for_wav():
    """The native decoder and resampler (data/native.py) for WAV when
    GAT_NATIVE_AUDIO=1 (its library is built at first use; NativeUnavailable
    when it cannot be); else None, and scipy decodes. The port of the JAX
    package's _native_if_built, which takes the native path as soon as the
    library file exists: here load_audio's result does not depend on
    whether some process has built the library."""
    if os.environ.get("GAT_NATIVE_AUDIO") != "1":
        return None
    from generative_audio_torch.data import native
    return native


def load_audio(path, sr: Optional[int] = 16000) -> np.ndarray:
    """Load a .wav or .flac file as mono float32 at `sr` (None keeps the
    file's rate). WAV goes through scipy, or with GAT_NATIVE_AUDIO=1
    through the native decoder and resampler (scipy where the native decoder
    refuses the file's format)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        native = _native_for_wav()
        if native is not None:
            try:
                data, file_sr = native.decode_wav(path.read_bytes())
                if sr is not None and file_sr != sr:
                    data = native.resample(data, file_sr, sr)
                return data
            except ValueError:
                pass  # a format the native decoder does not take
        file_sr, data = read_wav(path)
    elif suffix == ".flac":
        data, file_sr = _load_flac(path)
    else:
        raise ValueError(f"Unsupported audio format: {path}")
    data = to_mono(data).astype(np.float32)
    if sr is not None and file_sr != sr:
        data = resample(data, file_sr, sr)
    return data


def _load_flac(path: Path):
    """FLAC through soundfile where it is installed, else through the
    native decoder (raises NativeUnavailable when it cannot be built)."""
    try:
        import soundfile as sf
    except ImportError:
        from generative_audio_torch.data import flac
        return flac.decode(path)
    data, file_sr = sf.read(str(path), dtype="float32")
    return data, file_sr
