"""WAV I/O for the serving path. The port's own copy of
generative_audio_tpu/data/audio_io.py:22-44 (read_wav, write_wav): importing
the JAX package's data module would pull in JAX."""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile

__all__ = ["read_wav", "write_wav"]


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
