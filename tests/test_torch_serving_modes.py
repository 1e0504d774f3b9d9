"""The port's Inferencer in every inference mode against the JAX Inferencer on
the CPU, the overlapped_chunk model-kind decision, and the batched
enhance_dir (mixed buckets, batch halving on out-of-memory, a writer error,
a model error).

Each mode's model is a small 2-layer LSTM SequenceModel (H=16) behind the
reshapes the mode's convention asks for, with weights from the JAX module's
`init`, or FullSubNet+'s SMALL configuration with numpy-made params in the
JAX layout for the spectral overlapped_chunk; generative_audio_torch.utils.
convert carries the weights across, and both sides take the same seeded
wav. Both sides compute in float32 and differ only in
the order of sums, so the enhanced waveforms agree within 1e-4 of their
peak (as tests/test_torch_fullsubnet_plus.py holds the default mode). The
batched enhance_dir is held against the port's own serial path within two
int16 steps: the same model on another batch size sums in another order.
"""
import inspect
import threading

import jax
import numpy as np
import pytest
import torch
from torch import nn

from generative_audio_tpu.eval.inferencer import (
    Inferencer as JaxInferencer, InferencerConfig as JaxInferencerConfig)
from generative_audio_tpu.models import (
    FullSubNetPlus as JaxFullSubNetPlus,
    FullSubNetPlusConfig as JaxFullSubNetPlusConfig)
from generative_audio_tpu.nn import recurrent as jr
from generative_audio_torch.data.audio_io import read_wav
from generative_audio_torch.eval import Inferencer, InferencerConfig
from generative_audio_torch.eval import inferencer as inferencer_module
from generative_audio_torch.models import FullSubNetPlus, FullSubNetPlusConfig
from generative_audio_torch.nn.recurrent import SequenceModel
from generative_audio_torch.ops.mask import compress_cIRM
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
F = 33                      # n_fft=64
FRAME = 16                  # samples per time_domain frame
STFT = dict(n_fft=64, hop_length=32, win_length=64)
SMALL = dict(num_freqs=33, sb_num_neighbors=3, sb_model_hidden_size=16)
WAV_REL = 1e-4              # of the enhanced waveform's peak, float32
INT16_STEP = 1 / 32768


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _frames(x):
    return x.reshape(x.shape[0], -1, FRAME).swapaxes(1, 2)


def _unframe(y, x):
    return y.swapaxes(1, 2).reshape(x.shape[0], -1)


# mode: (SequenceModel input, output, activation, model input from the
# mode's input, model output from the SequenceModel's output and the input)
WRAPS = {
    "mag": (F, F, "ReLU", lambda x: x[:, 0], lambda y, x: y[:, None]),
    "scaled_mask": (F, 2 * F, "Tanh", lambda x: x[:, 0],
                    lambda y, x: y.reshape(x.shape[0], 2, F, -1)),
    "full_band_crm_mask": (F, 2 * F, "Tanh", lambda x: x[:, 0],
                           lambda y, x: y.reshape(x.shape[0], 2, F, -1)),
    "complex_full_band_crm_mask": (
        2 * F, 2 * F, "Tanh", lambda x: x.reshape(x.shape[0], 2 * F, -1),
        lambda y, x: y.reshape(x.shape[0], 2, F, -1)),
    "time_domain": (FRAME, FRAME, "Tanh", _frames, _unframe),
    # n_neighbor=3: [F, 7, T] in, [F, 2, T] out
    "sub_band_crm_mask": (7, 2, None, lambda x: x, lambda y, x: y),
}


class Wrapped(nn.Module):
    """A SequenceModel behind a mode's reshapes."""

    def __init__(self, seq, pre, post):
        super().__init__()
        self.seq, self.pre, self.post = seq, pre, post

    def forward(self, x):
        return self.post(self.seq(self.pre(x)), x)


def _wrapped(mode, seed=0):
    """(JAX apply-fn, its variables, the port's module) of one mode."""
    n_in, n_out, act, pre, post = WRAPS[mode]
    jm = jr.SequenceModel(input_size=n_in, output_size=n_out, hidden_size=16,
                          sequence_model="LSTM", output_activate_function=act)
    params = jm.init(jax.random.PRNGKey(seed),
                     np.zeros((1, n_in, 8), np.float32))["params"]
    seq = SequenceModel(n_in, n_out, 16, sequence_model="LSTM",
                        output_activate_function=act, device="cpu")
    seq.load_state_dict(convert.convert_sequence_model(params, "", "LSTM"))
    return (lambda v, x: post(jm.apply(v, pre(x)), x), {"params": params},
            Wrapped(seq, pre, post))


def _plus():
    """FullSubNet+ at SMALL width, with numpy-made params in the JAX layout
    (the JAX model's own init takes seconds here)."""
    jm = JaxFullSubNetPlus(JaxFullSubNetPlusConfig(**SMALL))
    params = convert.random_fullsubnet_plus_params(
        JaxFullSubNetPlusConfig(**SMALL), seed=0)
    tm = FullSubNetPlus(FullSubNetPlusConfig(**SMALL),
                        compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.convert_fullsubnet_plus(params))
    return (lambda v, *inputs: jm.apply(v, *inputs), {"params": params}, tm)


def _pair(apply, variables, module, jax_chunk_model="auto", **cfg):
    kw = dict(STFT, length_bucket=1600, n_neighbor=3, **cfg)
    return (JaxInferencer(apply, variables, JaxInferencerConfig(
                chunk_model=jax_chunk_model, **kw)),
            Inferencer(module, InferencerConfig(**kw), device="cpu"))


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=WAV_REL * np.abs(want).max())


@pytest.mark.parametrize("mode", sorted(WRAPS))
def test_mode_matches_jax(mode):
    jinf, tinf = _pair(*_wrapped(mode), inference_type=mode)
    noisy = _rand((3000,), seed=4, scale=0.1)
    got = tinf.enhance(noisy)
    _close(got, np.asarray(jinf.enhance(noisy)))
    assert tinf.last_rtf is not None and tinf.last_rtf > 0


@pytest.mark.parametrize("model", ["waveform", "spectral"])
def test_overlapped_chunk_matches_jax(model):
    """1 s chunks at 4 kHz (4000 + 256 samples a chunk), 10 000 samples: six
    chunks, the last zero-padded. The waveform model is time_domain's; the
    spectral one FullSubNet+ through the default cRM pipeline. The port
    decides chunk_model="auto" (the JAX side is told the kind, which spares
    its shape probe)."""
    parts = _wrapped("time_domain") if model == "waveform" else _plus()
    jinf, tinf = _pair(*parts, jax_chunk_model=model, sr=4000,
                       chunk_length_seconds=1,
                       inference_type="overlapped_chunk")
    assert tinf._chunk_model_is_waveform() == (model == "waveform")
    noisy = _rand((10000,), seed=5, scale=0.1)
    got = tinf.enhance(noisy)
    _close(got, np.asarray(jinf.enhance(noisy)))
    # K clips as K rows of every chunk: each row is that clip's output
    rows = np.stack([noisy, noisy[::-1] * 0.5])
    both = tinf.overlapped_chunk(rows)
    assert both.shape == rows.shape
    np.testing.assert_allclose(both[0], got, atol=WAV_REL * np.abs(got).max())


class _Forward(nn.Module):
    def __init__(self, forward):
        super().__init__()
        self.forward = forward


def _decide(forward, chunk_model="auto"):
    return Inferencer(_Forward(forward), InferencerConfig(
        chunk_model=chunk_model), device="cpu")._chunk_model_is_waveform()


def _jax_decides(forward):
    """The JAX Inferencer's answer for the same convention, with the
    variables argument in front (signature, then its shape probe)."""
    sig = inspect.signature(forward)
    params = [inspect.Parameter("v", inspect.Parameter.POSITIONAL_ONLY),
              *sig.parameters.values()]

    def apply(*args, **kwargs):
        return forward(*args[1:], **kwargs)
    apply.__signature__ = sig.replace(parameters=params)
    return JaxInferencer(apply, {},
                         JaxInferencerConfig())._chunk_model_is_waveform()


def wav_fn(wav):
    assert wav.ndim == 2
    return wav * 2.0


def wav_train(wav, train=False):
    assert wav.ndim == 2
    return wav * 2.0


def spec_fn(mag, real, imag):
    return mag + real + imag


def spec_train(mag, real, imag, train=False):
    assert mag.ndim == 4
    return mag


@pytest.mark.parametrize("forward,waveform", [
    (wav_fn, True), (wav_train, True), (spec_fn, False),
    (spec_train, False)])
def test_chunk_model_decided_by_signature(forward, waveform):
    """Where the signature decides, the port and JAX agree."""
    assert _decide(forward) is waveform
    assert _jax_decides(forward) is waveform
    assert _decide(forward, "waveform") is True
    assert _decide(forward, "spectral") is False


def wav_args(*inputs):
    assert inputs[0].ndim == 2
    return inputs[0] * 2.0


def wav_sr_pad(wav, sr=16000, pad=None):
    assert wav.ndim == 2
    return wav * 2.0


def neither(a, b):
    return a + b


@pytest.mark.parametrize("forward,jax_says", [
    (wav_args, True), (wav_sr_pad, True), (neither, None)])
def test_chunk_model_refuses_to_guess(forward, jax_says):
    """*args, or a signature both conventions can call: JAX probes the
    shapes, the port raises and asks for the kind; neither: both raise."""
    with pytest.raises(ValueError, match="'waveform' or 'spectral'"):
        _decide(forward)
    if jax_says is None:
        with pytest.raises(ValueError):
            _jax_decides(forward)
    else:
        assert _jax_decides(forward) is jax_says
    assert _decide(forward, "waveform") is True
    with pytest.raises(ValueError, match="waveform/spectral/auto"):
        _decide(forward, "wav")


def test_unknown_mode_raises():
    tinf = Inferencer(_Forward(wav_fn), InferencerConfig(
        inference_type="enhance_dir"), device="cpu")
    with pytest.raises(NotImplementedError, match="Unknown inference type"):
        tinf.enhance(np.zeros(100, np.float32))


class _Clips:
    def __init__(self, lengths, seed=10):
        self.items = [(_rand((n,), seed=seed + i, scale=0.1), f"clip{i}")
                      for i, n in enumerate(lengths)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _read(directory, clips):
    out = {}
    for noisy, name in clips.items:
        sr, wav = read_wav(directory / f"{name}.wav")
        assert sr == 16000 and wav.shape == noisy.shape
        out[name] = wav
    return out


def _serial(tinf, clips, directory):
    tinf.enhance_dir(clips, directory, log=lambda *_: None, batch_size=1)
    return _read(directory, clips)


def test_enhance_dir_mixed_buckets_match_serial(tmp_path):
    """Buckets of 3200 (three clips: batches of 2 and 1) and 1600 (two
    clips) against the serial path; the log counts every clip."""
    tinf = _pair(*_plus())[1]
    clips = _Clips([3000, 2000, 1500, 3100, 1000])
    logs = []
    tinf.enhance_dir(clips, tmp_path / "batched", log=logs.append,
                     batch_size=2)
    assert logs[-1].startswith("served 5 clips") and tinf.last_rtf > 0
    assert sorted(line for line in logs if "batch of" in line) == [
        "[2/5] batch of 2", "[4/5] batch of 2", "[5/5] batch of 1"]
    batched = _read(tmp_path / "batched", clips)
    serial = _serial(tinf, clips, tmp_path / "serial")
    for name, wav in batched.items():
        np.testing.assert_allclose(wav, serial[name], atol=2 * INT16_STEP)


class _IdentityCRM(nn.Module):
    """The identity mask, compressed; `fault` raises above two clips."""

    def __init__(self, fault=None):
        super().__init__()
        self.fault = fault

    def forward(self, mag, real, imag):
        self.batches.append(mag.shape[0])
        if self.fault is not None and mag.shape[0] > 2:
            raise self.fault
        ones = torch.ones_like(mag[:, 0])
        return compress_cIRM(torch.stack([ones, torch.zeros_like(ones)], 1))


def _identity(fault=None):
    model = _IdentityCRM(fault)
    model.batches = []
    return model, Inferencer(model, InferencerConfig(length_bucket=1000),
                             device="cpu")


def test_enhance_dir_halves_on_out_of_memory(tmp_path):
    """A model that runs out of memory above two clips: the bucket's batch
    halves 8 -> 4 -> 2 (the log says so) and every clip is written, within
    two int16 steps of the serial path. A bucket of fewer clips than
    batch_size warms at its clips (3 -> 1)."""
    model, tinf = _identity(torch.OutOfMemoryError("simulated"))
    clips = _Clips([800] * 9 + [1500] * 3)
    logs = []
    tinf.enhance_dir(clips, tmp_path / "halved", log=logs.append,
                     batch_size=8)
    assert [line for line in logs if "retrying" in line] == [
        "bucket 1000: batch 8 ran out of device memory; retrying at 4",
        "bucket 1000: batch 4 ran out of device memory; retrying at 2",
        "bucket 2000: batch 3 ran out of device memory; retrying at 1"]
    assert model.batches == [8, 4, 2, 3, 1] + [2, 2, 2, 2, 1] + [1, 1, 1]
    halved = _read(tmp_path / "halved", clips)
    serial = _serial(tinf, clips, tmp_path / "serial")
    for name, wav in halved.items():
        np.testing.assert_allclose(wav, serial[name], atol=2 * INT16_STEP)


def test_enhance_dir_model_error_is_not_halved(tmp_path):
    model, tinf = _identity(ValueError("a fault of the model"))
    logs = []
    with pytest.raises(ValueError, match="a fault of the model"):
        tinf.enhance_dir(_Clips([800] * 9), tmp_path, log=logs.append,
                         batch_size=8)
    assert model.batches == [8]
    assert not any("retrying" in str(line) for line in logs)


def test_enhance_dir_surfaces_writer_error(tmp_path, monkeypatch):
    """A failed write in the writer thread is raised after the join, the
    later batches are drained unwritten, and no writer thread is left."""
    real_write = inferencer_module.write_wav

    def write_wav(path, data, sr):
        if path.stem == "clip2":
            raise OSError("disk full")
        real_write(path, data, sr)

    monkeypatch.setattr(inferencer_module, "write_wav", write_wav)
    _, tinf = _identity()
    before = threading.active_count()
    with pytest.raises(OSError, match="disk full"):
        tinf.enhance_dir(_Clips([800] * 7), tmp_path, log=lambda *_: None,
                         batch_size=2)
    assert threading.active_count() == before
    written = sorted(p.stem for p in tmp_path.glob("*.wav"))
    assert written == ["clip0", "clip1"]
