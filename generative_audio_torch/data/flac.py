"""FLAC decode through the repo's native decoder.

The port's own copy of generative_audio_tpu/data/flac.py. Decoding goes to
native/audio_native.cpp's gat_decode_flac (STREAMINFO, constant / verbatim
/ fixed / LPC subframes, Rice residuals, stereo decorrelation) through
data/native.py, whose library is built at first use. audio_io._load_flac
takes soundfile instead where it is installed.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["decode"]


def decode(path) -> Tuple[np.ndarray, int]:
    """FLAC file -> (float32 mono samples, sample_rate). Raises
    native.NativeUnavailable, with the compiler's stderr, when the native
    decoder cannot be built."""
    from generative_audio_torch.data import native
    return native.decode_flac(Path(path).read_bytes())
