"""The port's StreamingEnhancer on the CPU: the JAX package's five streaming
scenarios (tests/test_eval.py:344-500) held against the port's own
overlapped_chunk, and the streamed output of a small FullSubNet+ against the
JAX StreamingEnhancer.

Against overlapped_chunk run with the same K rows the output must be equal
bit for bit: both run the same chunk program on the same shapes and the same
numpy float32 crossfade. Against JAX (float32 on both sides, weights carried
across by generative_audio_torch.utils.convert) the tolerance is the enhance
test's: 1e-4 of the waveform's peak.
"""
import numpy as np
import pytest
import torch
from torch import nn

from generative_audio_tpu.eval.inferencer import (
    Inferencer as JaxInferencer, InferencerConfig as JaxInferencerConfig)
from generative_audio_tpu.eval.streaming import (
    StreamingEnhancer as JaxStreamingEnhancer)
from generative_audio_tpu.models import (
    FullSubNetPlus as JaxFullSubNetPlus,
    FullSubNetPlusConfig as JaxFullSubNetPlusConfig)
from generative_audio_torch.eval import (
    Inferencer, InferencerConfig, StreamingEnhancer)
from generative_audio_torch.eval import inferencer as inferencer_module
from generative_audio_torch.models import FullSubNetPlus, FullSubNetPlusConfig
from generative_audio_torch.ops.mask import compress_cIRM
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
SMALL = dict(num_freqs=33, sb_num_neighbors=3, sb_model_hidden_size=16)
WAV_REL = 1e-4


def _rand(shape, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


class Halve(nn.Module):
    """A waveform model, wav * 0.5, that records the shapes it is given."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def forward(self, wav):
        self.calls.append(tuple(wav.shape))
        return wav * 0.5


class IdentityCRM(nn.Module):
    """A spectral model: the identity cRM, compressed."""

    def forward(self, mag, real, imag):
        ones = torch.ones_like(mag[:, 0])
        return compress_cIRM(torch.stack([ones, torch.zeros_like(ones)], 1))


def _inferencer(model, **cfg):
    return Inferencer(model, InferencerConfig(chunk_length_seconds=1, **cfg),
                      device="cpu")


def _stream(stream, noisy, seed, low=1, high=9000):
    """Feed `noisy` ([L] or [K, L]) in pieces of seeded random sizes, then
    flush; the concatenated output."""
    pieces, pos = [], 0
    piece_rng = np.random.default_rng(seed)
    while pos < noisy.shape[-1]:
        n = int(piece_rng.integers(low, high))
        pieces.append(stream.feed(noisy[..., pos:pos + n]))
        pos += n
    pieces.append(stream.flush())
    return np.concatenate(pieces, axis=-1)


def test_streaming_matches_offline_overlapped_chunk():
    """Pieces of random sizes give the offline bytes; the instance resets
    after flush and streams again (one big feed)."""
    inf = _inferencer(Halve())
    noisy = _rand(52123, seed=0)
    offline = inf.overlapped_chunk(noisy)
    stream = StreamingEnhancer(inf)
    streamed = _stream(stream, noisy, seed=3)
    assert streamed.shape == offline.shape
    np.testing.assert_array_equal(streamed, offline)
    assert stream.rtf is None                       # reset after flush
    assert stream.last_rtf is not None and stream.last_rtf > 0
    again = np.concatenate([stream.feed(noisy), stream.flush()])
    np.testing.assert_array_equal(again, offline)


@pytest.mark.parametrize("depth", [0, 1, 3])
@pytest.mark.parametrize("k", [2, 3])
def test_streaming_async_depth_and_streams_are_bit_identical(depth, k):
    """async_depth 0, 1 and 3 and K streams: the bytes of overlapped_chunk
    run with the same K rows; a single stream at the same depth gives the
    first row's offline bytes."""
    inf = _inferencer(Halve())
    noisy = _rand((k, 40011), seed=1)
    offline = inf.overlapped_chunk(noisy)
    streamed = _stream(StreamingEnhancer(inf, n_streams=k, async_depth=depth),
                       noisy, seed=5, low=500, high=7000)
    assert streamed.shape == offline.shape == noisy.shape
    np.testing.assert_array_equal(streamed, offline)
    single = _stream(StreamingEnhancer(inf, async_depth=depth), noisy[0],
                     seed=3)
    np.testing.assert_array_equal(single, inf.overlapped_chunk(noisy[0]))


@pytest.mark.parametrize("depth", [1, 3])
def test_streaming_holds_at_most_depth_chunks(monkeypatch, depth):
    """Results that have not landed (an event not yet passed) stay in
    flight up to async_depth chunks: each feed of one hop launches one chunk
    and returns the chunk `depth` before it, and flush drains the rest."""
    monkeypatch.setattr(inferencer_module._Pending, "ready", lambda self: False)
    inf = _inferencer(Halve())
    noisy = _rand(8 * 8000, seed=9)
    stream = StreamingEnhancer(inf, async_depth=depth)
    pieces = [stream.feed(noisy[:8000])]
    for i in range(1, 8):
        pieces.append(stream.feed(noisy[i * 8000:(i + 1) * 8000]))
        launched = i                            # chunks 0 .. i-1
        assert len(stream._inflight) == min(launched, depth)
        assert pieces[-1].shape == ((8000,) if launched > depth else (0,))
    pieces.append(stream.flush())
    np.testing.assert_array_equal(np.concatenate(pieces),
                                  inf.overlapped_chunk(noisy))


def test_streaming_spectral_model_and_latency():
    """The spectral chunk program streams too, and nothing is finalized
    before chunk_length samples have been fed."""
    inf = _inferencer(IdentityCRM())
    t = np.arange(40000) / 16000
    noisy = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32) \
        + _rand(40000, seed=2, scale=0.01)
    offline = inf.overlapped_chunk(noisy)
    stream = StreamingEnhancer(inf)
    assert stream.latency_samples == 16000
    early = stream.feed(noisy[:15999])
    assert early.shape == (0,)
    rest = [stream.feed(noisy[15999:30000]), stream.feed(noisy[30000:]),
            stream.flush()]
    streamed = np.concatenate([early] + rest)
    np.testing.assert_array_equal(streamed, offline)
    # the identity cRM: the interior follows the input
    assert np.corrcoef(streamed[8000:32000], noisy[8000:32000])[0, 1] > 0.9


def test_streaming_shape_policing():
    stream = StreamingEnhancer(_inferencer(Halve()), n_streams=3)
    noisy = _rand((3, 100), seed=4)
    with pytest.raises(ValueError):
        stream.feed(noisy[0])                  # 1-D into a K-stream group
    with pytest.raises(ValueError):
        stream.feed(noisy[:2])                 # wrong row count
    assert stream.feed(noisy).shape == (3, 0)
    assert stream.t_dispatch == 0.0 and stream.t_fetch == 0.0


def test_streaming_flush_edge_cases():
    """An empty flush returns nothing and runs no chunk; a stream shorter
    than one chunk still matches the offline mode (one zero-padded chunk)."""
    model = Halve()
    inf = _inferencer(model)
    stream = StreamingEnhancer(inf)
    out = stream.flush()
    assert out.shape == (0,) and stream.rtf is None and model.calls == []
    short = _rand(5000, seed=6)
    offline = inf.overlapped_chunk(short)
    assert model.calls == [(1, 16256)]
    assert stream.feed(short).shape == (0,)   # not finalizable yet
    np.testing.assert_array_equal(stream.flush(), offline)
    assert model.calls == [(1, 16256)] * 2
    assert StreamingEnhancer(inf, n_streams=2).flush().shape == (2, 0)
    assert len(model.calls) == 2


def test_streaming_fullsubnet_plus_matches_jax():
    """FullSubNet+ at SMALL width through the default cRM pipeline per
    chunk (n_fft=64, 1 s chunks at 4 kHz), streamed in random pieces on both
    sides, async_depth 2 on the port's."""
    kw = dict(n_fft=64, hop_length=32, win_length=64, sr=4000,
              chunk_length_seconds=1)
    params = convert.random_fullsubnet_plus_params(
        JaxFullSubNetPlusConfig(**SMALL), seed=1)
    jm = JaxFullSubNetPlus(JaxFullSubNetPlusConfig(**SMALL))
    jinf = JaxInferencer(lambda v, *inputs: jm.apply(v, *inputs),
                         {"params": params},
                         JaxInferencerConfig(chunk_model="spectral", **kw))
    tm = FullSubNetPlus(FullSubNetPlusConfig(**SMALL),
                        compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.convert_fullsubnet_plus(params))
    tinf = Inferencer(tm, InferencerConfig(**kw), device="cpu")
    noisy = _rand(9000, seed=7)
    want = _stream(JaxStreamingEnhancer(jinf), noisy, seed=8, high=3000)
    got = _stream(StreamingEnhancer(tinf, async_depth=2), noisy, seed=8,
                  high=3000)
    assert got.shape == want.shape == noisy.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=WAV_REL * np.abs(want).max())
    np.testing.assert_array_equal(got, tinf.overlapped_chunk(noisy))
