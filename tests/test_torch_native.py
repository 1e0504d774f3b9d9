"""The port's binding of the repo's native audio library
(generative_audio_torch.data.native, data.flac, audio_io's native path)
against the JAX package's binding of the same source on the CPU.

Both bindings compile native/audio_native.cpp with the same flags, each into
its own directory, so every result must be equal (`==`), not close. FLAC
streams come from tests/flac_writer.py, which is numpy only.
"""
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from generative_audio_tpu.data import native as jax_native
from generative_audio_tpu.data.audio_io import load_audio as jax_load_audio

from generative_audio_torch.data import audio_io, flac, native, write_wav
from tests.flac_writer import _subframe_header, flac_stream, rice_write

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden"


def _sine(sr=16000, seconds=0.25, freq=440.0, amp=0.3):
    t = np.arange(int(sr * seconds))
    return (amp * np.sin(2 * np.pi * freq * t / sr)).astype(np.float32)


def _verbatim_flac(samples, block=4096):
    """16-bit mono FLAC of int16 `samples` in verbatim subframes: after the
    byte-aligned frame and subframe headers the samples go in as big-endian
    bytes."""
    samples = np.asarray(samples, np.int16)

    def frame(chunk):
        def write(bw, bs):
            _subframe_header(bw, 1)
            assert bw.nbits == 0
            bw.bytes += chunk.astype(">i2").tobytes()
        return write

    chunks = [samples[i:i + block] for i in range(0, len(samples), block)]
    return flac_stream([(len(c), 0, frame(c)) for c in chunks],
                       total=len(samples))


def test_builds_at_first_use_into_the_port_build_dir():
    assert native._LIB.parent == (Path(native.__file__).resolve().parents[1]
                                  / "_build" / "native")
    assert native._SRC.resolve() == (Path(__file__).resolve().parents[1]
                                     / "native" / "audio_native.cpp")
    assert native.available()
    assert native._LIB.exists()
    assert native._LIB.stat().st_mtime >= native._SRC.stat().st_mtime
    assert native._LIB.resolve() != jax_native._LIB.resolve()


def test_build_mtime_check_and_failure(tmp_path, monkeypatch):
    """A library newer than its source is kept; an edited source is
    rebuilt; a source that does not compile raises NativeUnavailable with
    the compiler's stderr, wherever the native decoder is asked for."""
    src = tmp_path / "lib.cpp"
    src.write_text('extern "C" int gat_answer() { return 42; }\n')
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_LIB_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", tmp_path / "build" / "lib.so")
    lib = native.build()
    first = lib.stat().st_mtime_ns
    assert native.build().stat().st_mtime_ns == first
    later = time.time() + 5
    os.utime(src, (later, later))
    assert native.build().stat().st_mtime_ns != first

    src.write_text("this is not C++\n")
    os.utime(src, (later + 5, later + 5))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeUnavailable, match="error"):
        native.build()
    assert not native.available()
    with pytest.raises(native.NativeUnavailable, match="not C"):
        flac.decode(GOLDEN / "flac_golden_16.flac")
    assert list((tmp_path / "build").iterdir()) == [lib]   # no temp left


def _wav_bytes(x, sr, channels=1):
    import io
    import wave
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("case", ["mono", "stereo", "garbage"])
def test_decode_wav_equals_jax(case):
    x = _sine()
    data = {"mono": _wav_bytes(x, 16000),
            "stereo": _wav_bytes(np.stack([x, 0.5 * x], 1).reshape(-1),
                                 22050, channels=2),
            "garbage": b"RIFF....WAVEfmt not really"}[case]
    if case == "garbage":
        for binding in (native, jax_native):
            with pytest.raises(ValueError):
                binding.decode_wav(data)
        return
    got, sr = native.decode_wav(data)
    want, jsr = jax_native.decode_wav(data)
    assert sr == jsr and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 16000), (8000, 16000),
                                          (16000, 16000), (22050, 16000)])
def test_resample_equals_jax(sr_in, sr_out):
    x = _sine(sr=sr_in, freq=300)
    np.testing.assert_array_equal(native.resample(x, sr_in, sr_out),
                                  jax_native.resample(x, sr_in, sr_out))


@pytest.mark.parametrize("snr,target,noisy_target", [
    (5.0, -25.0, None), (-5.0, -20.0, -30.0), (20.0, -35.0, -15.0)])
def test_snr_mix_equals_jax(snr, target, noisy_target):
    rng = np.random.default_rng(0)
    clean = _sine(seconds=0.5) + 0.01 * rng.standard_normal(8000).astype(
        np.float32)
    noise = rng.standard_normal(8000).astype(np.float32) * 0.2
    got = native.snr_mix(clean, noise, snr, target, noisy_target)
    want = jax_native.snr_mix(clean, noise, snr, target, noisy_target)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        native.snr_mix(clean, noise[:-1], snr)


def test_decode_batch_equals_jax(tmp_path):
    paths = []
    for i, sr in enumerate([16000, 8000, 48000]):
        p = tmp_path / f"f{i}.wav"
        write_wav(p, _sine(sr=sr, seconds=0.5, freq=200 * (i + 1)), sr)
        paths.append(p)
    paths.append(tmp_path / "missing.wav")
    for kw in ({}, {"offsets": [100, 0, 50, 0]}):
        got, failures = native.decode_batch(paths, 16000, 6000, n_threads=3,
                                            **kw)
        want, jax_failures = jax_native.decode_batch(paths, 16000, 6000,
                                                     n_threads=3, **kw)
        assert failures == jax_failures == 1
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        native.decode_batch(paths, 16000, 100, offsets=[0])


def _fixed_order2(bw, bs):
    t = np.arange(bs)
    s = np.round(1000 * np.sin(2 * np.pi * t / 32)).astype(np.int64)
    _subframe_header(bw, 8 + 2)
    bw.write_signed(int(s[0]), 16)
    bw.write_signed(int(s[1]), 16)
    rice_write(bw, [int(s[i] - 2 * s[i - 1] + s[i - 2])
                    for i in range(2, bs)], param=6)


def _lpc_order2(bw, bs):
    s = np.cumsum(np.random.default_rng(1).integers(-50, 50, bs))
    _subframe_header(bw, 32 + 1)
    bw.write_signed(int(s[0]), 16)
    bw.write_signed(int(s[1]), 16)
    bw.write(5, 4)                      # precision 6
    bw.write_signed(1, 5)               # shift
    for c in (3, -1):
        bw.write_signed(c, 6)
    rice_write(bw, [int(s[i] - ((3 * s[i - 1] - s[i - 2]) >> 1))
                    for i in range(2, bs)], param=7)


def _mid_side(bw, bs):
    rng = np.random.default_rng(2)
    left, right = (rng.integers(-5000, 5000, bs) for _ in range(2))
    _subframe_header(bw, 1)
    for s in (left + right) >> 1:
        bw.write_signed(int(s), 16)
    _subframe_header(bw, 1)
    for s in left - right:
        bw.write_signed(int(s), 17)


FLAC_STREAMS = {
    "verbatim": lambda: _verbatim_flac(
        np.random.default_rng(0).integers(-30000, 30000, 5000)),
    "fixed_order2": lambda: flac_stream([(64, 0, _fixed_order2)], total=64),
    "lpc_order2": lambda: flac_stream([(64, 0, _lpc_order2)], total=64),
    "mid_side": lambda: flac_stream([(32, 10, _mid_side)], channels=2,
                                    total=32),
    "golden_16": lambda: (GOLDEN / "flac_golden_16.flac").read_bytes(),
    "golden_24": lambda: (GOLDEN / "flac_golden_24.flac").read_bytes(),
}


@pytest.mark.parametrize("name", list(FLAC_STREAMS))
def test_decode_flac_equals_jax(name):
    data = FLAC_STREAMS[name]()
    got, sr = native.decode_flac(data)
    want, jsr = jax_native.decode_flac(data)
    assert sr == jsr and len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_decode_flac_garbage_raises():
    with pytest.raises(ValueError):
        native.decode_flac(b"not a flac stream")


@pytest.mark.parametrize("sr", [16000, 8000])
def test_load_audio_flac_without_soundfile(tmp_path, monkeypatch, sr):
    """With soundfile hidden, load_audio reads FLAC through the native
    decoder (and resamples as the JAX load_audio does); the samples are the
    int16 ones written, and equal the WAV copy's."""
    monkeypatch.setitem(sys.modules, "soundfile", None)
    pcm = (_sine(sr=sr) * 32767).astype(np.int16)
    path = tmp_path / "x.flac"
    path.write_bytes(_verbatim_flac(pcm, block=1000))
    got = audio_io.load_audio(path, sr=16000)
    np.testing.assert_array_equal(got, jax_load_audio(path, sr=16000))
    if sr == 16000:
        np.testing.assert_array_equal(got, pcm / np.float32(32768.0))
        write_wav(tmp_path / "x.wav", pcm / 32767.0, sr)
        assert np.abs(audio_io.load_audio(tmp_path / "x.wav") - got).max() \
            <= 1 / 32768


def test_load_audio_wav_native_path(tmp_path, monkeypatch):
    """With GAT_NATIVE_AUDIO=1, WAV goes through the native decoder and
    resampler, as in the JAX load_audio with its library built; without it,
    through scipy, whether the library is built or not."""
    assert native.available()
    x = _sine(sr=8000, seconds=0.5)
    p = tmp_path / "t.wav"
    write_wav(p, x, 8000)
    monkeypatch.delenv("GAT_NATIVE_AUDIO", raising=False)
    assert audio_io._native_for_wav() is None
    np.testing.assert_array_equal(
        audio_io.load_audio(p, sr=16000),
        audio_io.resample(audio_io.read_wav(p)[1], 8000, 16000))
    monkeypatch.setenv("GAT_NATIVE_AUDIO", "1")
    got = audio_io.load_audio(p, sr=16000)
    np.testing.assert_array_equal(got, jax_load_audio(p, sr=16000))
    np.testing.assert_array_equal(
        got, native.resample(native.decode_wav(p.read_bytes())[0], 8000,
                             16000))
