"""ctypes binding of the repo's native C++ audio data path
(native/audio_native.cpp): WAV and FLAC decode, polyphase resampling, the
DNS SNR mix and a threaded batch decode.

The port's own copy of generative_audio_tpu/data/native.py:46-173, with the
same exports and signatures. The library is compiled with g++ at first use
(never at import) into generative_audio_torch/_build/native/, from the
repo's source; it is rebuilt when the source is newer than the library. It
is compiled with -march=native for the machine that runs it, so a library
is never carried to another machine. `available()` answers whether the
library can be had; every other function raises NativeUnavailable, with
the compiler's stderr, when it cannot.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["available", "decode_wav", "decode_flac", "resample", "snr_mix",
           "decode_batch", "build", "NativeUnavailable"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG.parent / "native" / "audio_native.cpp"
_LIB_DIR = _PKG / "_build" / "native"
_LIB = _LIB_DIR / "libaudio_native.so"

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    """The native library cannot be built or loaded here."""


def build(force: bool = False) -> Path:
    """Compile the shared library (g++ -O3 -shared) unless a library newer
    than the source is there. The compiler writes a temporary file that
    replaces the library in one step, so a process that loads it never
    sees half a file."""
    if not _SRC.exists():
        raise NativeUnavailable(f"native source not found: {_SRC}")
    if _LIB.exists() and not force \
            and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, str(_SRC), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise NativeUnavailable(f"native build failed:\n{e.stderr}") from e
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise NativeUnavailable(f"native build failed: {e}") from e
    os.replace(tmp, _LIB)
    return _LIB


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.gat_decode_wav.restype = ctypes.c_int
        lib.gat_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        lib.gat_free.restype = None
        lib.gat_free.argtypes = [ctypes.c_void_p]
        lib.gat_decode_flac.restype = ctypes.c_int
        lib.gat_decode_flac.argtypes = lib.gat_decode_wav.argtypes
        lib.gat_resample.restype = ctypes.c_int64
        lib.gat_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
        lib.gat_snr_mix.restype = None
        lib.gat_snr_mix.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [
            ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float]
        lib.gat_decode_batch.restype = ctypes.c_int
        lib.gat_decode_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library is built or can be built and loaded here."""
    try:
        _load()
        return True
    except (NativeUnavailable, OSError):
        return False


def _take_floats(ptr, n: int) -> np.ndarray:
    lib = _load()
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else \
        np.zeros(0, np.float32)
    lib.gat_free(ptr)
    return arr


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> (float32 mono samples, sample_rate)."""
    return _decode(data, "gat_decode_wav")


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 mono samples, sample_rate). Covers the
    libFLAC-encoded corpora (LibriSpeech): 8-24 bit, 1-2 channels,
    constant/verbatim/fixed/LPC subframes, Rice residuals."""
    return _decode(data, "gat_decode_flac")


def _decode(data: bytes, fn_name: str) -> Tuple[np.ndarray, int]:
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = getattr(lib, fn_name)(data, len(data), ctypes.byref(out),
                               ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"{fn_name} failed with code {rc}")
    return _take_floats(out, n.value), sr.value


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n_out = lib.gat_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        sr_in, sr_out, ctypes.byref(out))
    return _take_floats(out, int(n_out))


def snr_mix(clean: np.ndarray, noise: np.ndarray, snr: float,
            target_dB_FS: float = -25.0,
            noisy_target_dB_FS: Optional[float] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """DNS-style SNR mix; returns (noisy, rescaled clean)."""
    lib = _load()
    clean = np.ascontiguousarray(clean, np.float32).copy()
    noise = np.ascontiguousarray(noise, np.float32).copy()
    if clean.shape != noise.shape or clean.ndim != 1:
        raise ValueError(f"clean {clean.shape} and noise {noise.shape} must "
                         "be 1-D of one length")
    noisy = np.empty_like(clean)
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.gat_snr_mix(clean.ctypes.data_as(fptr), noise.ctypes.data_as(fptr),
                    noisy.ctypes.data_as(fptr), len(clean),
                    float(snr), float(target_dB_FS),
                    float(noisy_target_dB_FS if noisy_target_dB_FS is not None
                          else target_dB_FS))
    return noisy, clean


def decode_batch(paths: Sequence, target_sr: int, target_len: int,
                 offsets: Optional[Sequence[int]] = None,
                 n_threads: int = 8) -> Tuple[np.ndarray, int]:
    """Threaded decode+resample+crop of many wavs -> ([N, target_len],
    n_failures)."""
    lib = _load()
    paths = [str(p) for p in paths]
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    n = len(paths)
    out = np.zeros((n, target_len), np.float32)
    offs = np.asarray(offsets if offsets is not None else np.zeros(n),
                      np.int64)
    if offs.shape != (n,):
        raise ValueError(f"offsets must hold one entry per path ({n})")
    failures = lib.gat_decode_batch(
        blob, n, target_sr, target_len,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return out, int(failures)
